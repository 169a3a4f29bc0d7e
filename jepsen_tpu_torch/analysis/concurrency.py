"""AST lock-discipline lint for the threaded harness modules (the
port's copy of jepsen_tpu/analysis/concurrency.py).

The observability fabric (telemetry, monitor, nodeprobe, profiler)
and the interpreter all share mutable state across threads behind
per-instance locks. The convention this lint enforces
(doc/static-analysis-torch.md):

  - A class declares which lock guards which attributes:

        _guarded_by_lock = {"_lock": ("_records", "_pending")}

    (or a bare tuple/list, meaning guarded by `self._lock`).

  - Every WRITE to a guarded attribute — assignment, augmented
    assignment, `del`, subscript store, or a known mutator call like
    `self._records.append(...)` — must happen inside a
    `with self.<lock>:` block. `__init__` is exempt (the object isn't
    shared yet).

  - Methods named `*_locked` assert "caller holds the lock": their
    bodies are analyzed as lock-held (C1 passes), and CALLING one
    outside a lock block is its own finding (C2).

  - A class that creates a `self.*lock*` but declares no
    `_guarded_by_lock` gets an advisory finding (C3) so new threaded
    classes opt into the convention.

Reads are deliberately unchecked (snapshot-read-then-copy idioms are
pervasive and safe here); the lint polices the writes that corrupt.
Nested functions are analyzed as lock-NOT-held even when defined
inside a with-block: a closure may run later, on another thread,
after the lock was released.
"""

from __future__ import annotations

import ast
import inspect

from ..gpu.lint import Finding

ANNOTATION = "_guarded_by_lock"

# Method calls on a guarded attribute that mutate it in place.
MUTATORS = frozenset({
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popitem", "remove", "discard", "clear", "appendleft",
    "popleft", "sort", "reverse",
})


def scan_module(module) -> list[Finding]:
    try:
        src = inspect.getsource(module)
        fname = inspect.getsourcefile(module)
    except (OSError, TypeError):
        return []
    modname = module.__name__.rsplit(".", 1)[-1]
    return scan_source(src, fname, modname)


def scan_source(src: str, fname: str | None,
                modname: str) -> list[Finding]:
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return []
    out: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            out.extend(_Class(node, fname, modname).scan())
    return out


def _annotation_of(cls: ast.ClassDef) -> dict[str, set[str]] | None:
    """{lock_attr: {guarded attrs}} from the class's _guarded_by_lock
    (dict, or bare sequence meaning lock '_lock'); None if absent."""
    for stmt in cls.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        if not any(isinstance(t, ast.Name) and t.id == ANNOTATION
                   for t in targets):
            continue
        try:
            val = ast.literal_eval(stmt.value)
        except ValueError:
            return None
        if isinstance(val, dict):
            return {str(k): set(map(str, v)) for k, v in val.items()}
        return {"_lock": set(map(str, val))}
    return None


def _creates_lock(cls: ast.ClassDef) -> tuple[str, int] | None:
    """(attr, line) of a `self.<something containing 'lock'> = ...`
    in __init__, for the C3 advisory."""
    for fn in cls.body:
        if isinstance(fn, ast.FunctionDef) and fn.name == "__init__":
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"
                                and "lock" in t.attr.lower()):
                            return t.attr, node.lineno
    return None


def _self_attr(node) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _Class:
    def __init__(self, cls: ast.ClassDef, fname: str | None,
                 modname: str):
        self.cls = cls
        self.fname = fname
        self.kernel = f"{modname}.{cls.name}"
        self.out: list[Finding] = []
        ann = _annotation_of(cls)
        self.attr_lock = {} if ann is None else \
            {a: lock for lock, attrs in ann.items() for a in attrs}
        self.locks = set(ann or ())
        self.annotated = ann is not None

    def scan(self) -> list[Finding]:
        if not self.annotated:
            made = _creates_lock(self.cls)
            if made is not None:
                attr, line = made
                self.out.append(Finding(
                    rule="C3", kernel=self.kernel, site=attr,
                    severity="info",
                    message=f"{self.cls.name} creates `self.{attr}` "
                            f"but declares no {ANNOTATION}: the "
                            "concurrency lint can't check its shared "
                            "writes",
                    file=self.fname, line=line,
                    hint=f"declare {ANNOTATION} = {{'{attr}': "
                         "(...guarded attrs...)}"))
            return self.out
        for fn in self.cls.body:
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue
            held = frozenset(self.locks) if fn.name.endswith("_locked") \
                else frozenset()
            self._block(fn.body, held, fn.name)
        return self.out

    # -- recursive statement walk -----------------------------------------

    def _block(self, stmts, held: frozenset, method: str) -> None:
        for stmt in stmts:
            self._stmt(stmt, held, method)

    def _stmt(self, stmt, held: frozenset, method: str) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # closures run whenever — never credited with the lock
            self._block(stmt.body, frozenset(),
                        f"{method}.{stmt.name}")
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in stmt.items:
                a = _self_attr(item.context_expr)
                if a in self.locks:
                    inner.add(a)
            # context expressions themselves run outside the new lock
            for item in stmt.items:
                self._exprs(item.context_expr, held, method)
            self._block(stmt.body, frozenset(inner), method)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._exprs(stmt.test, held, method)
            self._block(stmt.body, held, method)
            self._block(stmt.orelse, held, method)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._exprs(stmt.iter, held, method)
            self._block(stmt.body, held, method)
            self._block(stmt.orelse, held, method)
            return
        if isinstance(stmt, ast.Try):
            self._block(stmt.body, held, method)
            for h in stmt.handlers:
                self._block(h.body, held, method)
            self._block(stmt.orelse, held, method)
            self._block(stmt.finalbody, held, method)
            return
        if isinstance(stmt, ast.Match):
            self._exprs(stmt.subject, held, method)
            for case in stmt.cases:
                if case.guard is not None:
                    self._exprs(case.guard, held, method)
                self._block(case.body, held, method)
            return
        if isinstance(stmt, ast.ClassDef):
            return
        # simple statement: check writes + calls
        self._writes(stmt, held, method)
        self._exprs(stmt, held, method)

    # -- checks ------------------------------------------------------------

    def _need(self, attr: str, held: frozenset) -> str | None:
        lock = self.attr_lock.get(attr)
        if lock is not None and lock not in held:
            return lock
        return None

    def _writes(self, stmt, held: frozenset, method: str) -> None:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Delete):
            targets = list(stmt.targets)
        for t in targets:
            for el in getattr(t, "elts", None) or [t]:
                base = el.value if isinstance(
                    el, ast.Subscript) else el
                a = _self_attr(base)
                lock = a and self._need(a, held)
                if lock:
                    self.out.append(Finding(
                        rule="C1", kernel=self.kernel,
                        site=f"{method}:{a}",
                        message=f"write to `self.{a}` (guarded by "
                                f"`self.{lock}`) outside the lock "
                                f"in {method}()",
                        file=self.fname, line=stmt.lineno,
                        hint=f"wrap the write in `with self.{lock}:`"
                             " or move it into a *_locked method"))

    def _exprs(self, node, held: frozenset, method: str) -> None:
        """Mutator calls + *_locked calls anywhere inside one simple
        statement / expression. Lambda bodies are closures like
        nested defs: scanned with the lock NOT credited (they may run
        later, on another thread, after the lock was released)."""
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                self._exprs(n.body, frozenset(),
                            f"{method}.<lambda>")
                continue
            stack.extend(ast.iter_child_nodes(n))
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)):
                continue
            if n.func.attr in MUTATORS:
                base = n.func.value
                if isinstance(base, ast.Subscript):
                    base = base.value
                a = _self_attr(base)
                lock = a and self._need(a, held)
                if lock:
                    self.out.append(Finding(
                        rule="C1", kernel=self.kernel,
                        site=f"{method}:{a}",
                        message=f"mutating call `self.{a}."
                                f"{n.func.attr}(...)` (guarded by "
                                f"`self.{lock}`) outside the lock "
                                f"in {method}()",
                        file=self.fname, line=n.lineno,
                        hint=f"wrap it in `with self.{lock}:`"))
            elif n.func.attr.endswith("_locked") and \
                    _self_attr(n.func) is not None and not held:
                self.out.append(Finding(
                    rule="C2", kernel=self.kernel,
                    site=f"{method}:{n.func.attr}",
                    message=f"call to self.{n.func.attr}() outside "
                            f"any declared lock in {method}() — "
                            "*_locked methods assert the caller "
                            "holds it",
                    file=self.fname, line=n.lineno,
                    hint="acquire the lock around the call"))
