"""graftlint: static analysis of the port's kernel launches (the port's
copy of jepsen_tpu/tpu/lint.py).

The JAX package's rules read jaxprs and lowered HLO. The port has
neither: its device programs are hand-written CUDA kernels
(gpu/kernels/csrc/*.cu) launched through ctypes. The unit of analysis
is a LaunchTrace: one kernel launch at one shape bucket, read off the
launch plan its wrapper builds (gpu/kernels/*.py `launch_plan`, called
on meta tensors: no card, no nvcc). Each rule is the JAX rule's
counterpart over launches and their host code:

  R1 host-sync        a loop (for, while or comprehension) whose body
                      both launches a kernel and forces a host sync
                      (.cpu(), .numpy(), .tolist(), .item(), a
                      synchronize() call), directly or through a
                      function of the launch-site modules that does
                      (AST scan)
  R2 dtype-widening   a 64-bit argument that reaches a kernel, plus
                      explicit 64-bit numpy and torch dtypes in the host
                      feeder modules (AST scan)
  R3 copy-miss        an input of at least DONATION_MIN_BYTES that the
                      wrapper copies or casts before the kernel reads
                      it (CUDA has no donation: the cost R3 guards
                      against is a device copy per launch)
  R4 sharding         the JAX rule, unchanged: replicated operands,
                      unsharded batch axes, collectives in HLO text.
                      Every launch trace has partition None, no batch
                      axis claim and no HLO, so it finds nothing until
                      the port has a mesh
  R5 recompile-risk   a value compiled into a kernel that Python also
                      holds, where the two disagree (the mirrored
                      constants, AST on the Python side and constexpr
                      lines on the CUDA side); runtime bucket
                      cardinality over profiler.shape_buckets(). The
                      port builds one library per source hash and
                      launches exact sizes, so its bucket policy is
                      "exact" and never a finding
  R6 carry-bloat      the state a launch carries through its levels or
                      sweeps (the scratch it carves, or a block's
                      shared memory plus the frontier outputs) past
                      CARRY_WARN_BYTES

Findings carry file:line provenance, a cost in bytes where there is
one, and a fix hint. A committed baseline (lint-baseline-torch.json)
pins today's findings, so the gate fails only on NEW ones. The
registry and driver live in jepsen_tpu_torch.analysis, with the
threaded modules' lock-discipline lint (C1-C3).
"""

from __future__ import annotations

import ast
import inspect
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

# Rule identifiers, in catalog order (doc/static-analysis-torch.md).
RULES = ("R1", "R2", "R3", "R4", "R5", "R6", "C1", "C2", "C3")

# R1: the kernel wrappers (gpu/kernels/*.py); a call of one launches.
KERNEL_WRAPPERS = frozenset({"wgl_search", "scc_labels",
                             "scc_labels_to_convergence", "scc_sweep",
                             "scc_apply", "scc_retire", "scc_chunk",
                             "bank_reduce"})

# R1: method calls that wait for the card (a device tensor's download,
# or a stream, event or device synchronize).
HOST_SYNC_CALLS = frozenset({"cpu", "numpy", "tolist", "item",
                             "synchronize"})

# R2: dtypes that double the memory traffic of the int32 house style.
WIDE_DTYPES = frozenset({"int64", "uint64", "float64"})

# R3: args below this size aren't worth a copy finding.
DONATION_MIN_BYTES = 256 * 1024

# R4: a replicated operand below this costs less than the finding.
REPLICATED_MIN_BYTES = 256 * 1024

# R4: collective ops in lowered HLO that force cross-device traffic.
HLO_COLLECTIVES = ("all-gather", "all-to-all", "collective-permute")

# R5: runtime cross-check: more launch shape buckets than this per
# kernel this process.
MAX_RUNTIME_BUCKETS = 32

# R6: carry budget. Every carried byte rides through every level or
# sweep; past this the carry itself becomes the bandwidth bill.
CARRY_WARN_BYTES = 128 * 1024


@dataclass
class Finding:
    """One lint finding. `key` (rule:kernel:site) is the stable
    identity the baseline ratchet matches on — deliberately free of
    line numbers, which churn under unrelated edits; file:line ride
    along as provenance only."""

    rule: str
    kernel: str
    site: str
    message: str
    file: str | None = None
    line: int | None = None
    hint: str | None = None
    severity: str = "warn"        # "warn" | "info"
    cost_bytes: int | None = None

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.kernel}:{self.site}"

    def to_dict(self) -> dict:
        d = {"key": self.key, "rule": self.rule, "kernel": self.kernel,
             "site": self.site, "message": self.message,
             "severity": self.severity}
        if self.file:
            d["file"] = self.file
            d["line"] = self.line
        if self.hint:
            d["hint"] = self.hint
        if self.cost_bytes is not None:
            d["cost_bytes"] = int(self.cost_bytes)
        return d


@dataclass
class ArgSpec:
    """One argument of a launch as its plan hands it to the library;
    `copied`: the wrapper copied or cast it first."""

    name: str
    shape: tuple
    dtype: str
    nbytes: int
    copied: bool = False


@dataclass
class LaunchTrace:
    """One hand kernel's launch at one shape bucket, read off the
    launch plan its wrapper builds (see the module docstring).

    `args` are the tensors the kernel reads, `outputs` what the plan
    allocates for it, `scratch_bytes` the device scratch it carves,
    `smem_bytes` the dynamic shared memory one block takes and
    `carry_bytes` what R6 prices. `library` holds the library's own
    sizing answers in the driver's full mode. `partition`, `batch_axes`
    and `hlo_text` are R4's inputs: a launch on one card has none."""

    name: str                     # registry-entry name
    bucket: str                   # stable bucket label, e.g. B64xM512
    args: list[ArgSpec] = field(default_factory=list)
    outputs: list[ArgSpec] = field(default_factory=list)
    scratch_bytes: int = 0
    smem_bytes: int = 0
    carry_bytes: int = 0
    library: dict = field(default_factory=dict)
    partition: dict | None = None
    batch_axes: list = field(default_factory=list)
    hlo_text: str | None = None
    bucket_policy: str = "exact"
    file: str | None = None
    line: int | None = None


def _call_name(node: ast.Call) -> str | None:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _definitions(tree) -> list[tuple[str, ast.AST]]:
    """(dotted name, def) of every function, method and class, nested
    ones included (Class.method, outer.inner)."""
    out = []

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                name = f"{prefix}.{child.name}" if prefix else child.name
                out.append((name, child))
                visit(child, name)
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def _qualified_functions(tree) -> list[tuple[str, ast.AST]]:
    """(dotted name, def) of every function and method."""
    return [(q, d) for q, d in _definitions(tree)
            if not isinstance(d, ast.ClassDef)]


# ---------------------------------------------------------------------------
# R1 — host syncs in launch loops
# ---------------------------------------------------------------------------

_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)


def _own_nodes(fn) -> list[ast.AST]:
    """The nodes of a function's body, lambdas included (a thunk runs in
    the call it is passed to), not those of the functions and classes
    nested in it (those are functions of their own)."""
    out, stack = [], list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _wrapper_ref(n) -> str | None:
    """The kernel wrapper a node calls or names (`launch =
    kernel.scc_labels` launches when `launch` is called)."""
    name = (n.id if isinstance(n, ast.Name) else
            n.attr if isinstance(n, ast.Attribute) else None)
    return name if name in KERNEL_WRAPPERS else None


def _is_sync(n) -> bool:
    return isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
        and n.func.attr in HOST_SYNC_CALLS


def _import_bindings(tree, modname: str) -> dict[str, str]:
    """The dotted target of every name the module's imports bind,
    function-local imports included: `from ..gpu import wgl` in
    jepsen_tpu_torch.fleet.scheduler binds wgl to
    jepsen_tpu_torch.gpu.wgl, `from .wgl import analysis` binds analysis
    to jepsen_tpu_torch.gpu.wgl.analysis."""
    out: dict[str, str] = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom):
            parts = modname.split(".")[:-n.level] if n.level else []
            base = ".".join(parts + ([n.module] if n.module else []))
            for a in n.names:
                out[a.asname or a.name] = f"{base}.{a.name}"
        elif isinstance(n, ast.Import):
            for a in n.names:
                if a.asname:
                    out[a.asname] = a.name
    return out


class LaunchIndex:
    """Which functions of a set of modules launch a kernel and which
    force a host sync: those doing it in their own body, then, to a
    fixpoint, those calling one that does. `sources` maps a dotted
    module name to its source text; a function is named
    "module:Qual.name".

    A call resolves as Python would find its target where the source
    shows it: a bare name to a function nested in an enclosing
    function, then to one of the module's own, then through the
    module's imports; `self.f` / `cls.f` to the enclosing class's
    method; `mod.f` to module `mod`'s function where an import binds
    `mod`. A method call on any other receiver (`graph.scc(mask)`)
    resolves to the methods of that name in the indexed modules. A call
    of a function outside them resolves to nothing."""

    def __init__(self, sources: dict[str, str]):
        self.trees = {m: ast.parse(s) for m, s in sources.items()}
        self.imports = {m: _import_bindings(t, m)
                        for m, t in self.trees.items()}
        self.functions: dict[str, ast.AST] = {}
        self.classes: set[str] = set()
        methods: dict[str, set] = {}
        for m, tree in self.trees.items():
            for qual, d in _definitions(tree):
                fid = f"{m}:{qual}"
                if isinstance(d, ast.ClassDef):
                    self.classes.add(fid)
                    continue
                self.functions[fid] = d
                owner = fid.rsplit(".", 1)[0]
                if "." in qual and owner in self.classes:
                    methods.setdefault(d.name, set()).add(fid)
        self._methods = methods
        calls: dict[str, set] = {}
        self.launch, self.sync = set(), set()
        for fid, fn in self.functions.items():
            own = _own_nodes(fn)
            calls[fid] = set().union(*(
                self.resolve(fid, c) for c in own
                if isinstance(c, ast.Call)))
            if any(_wrapper_ref(n) for n in own):
                self.launch.add(fid)
            if any(_is_sync(n) for n in own):
                self.sync.add(fid)
        changed = True
        while changed:
            changed = False
            for fid, callees in calls.items():
                for have in (self.launch, self.sync):
                    if fid not in have and callees & have:
                        have.add(fid)
                        changed = True

    def _in_module(self, target: str) -> str | None:
        """"module:name" for a dotted target module.name where the
        module is indexed and defines the function."""
        mod, _, name = target.rpartition(".")
        fid = f"{mod}:{name}"
        return fid if fid in self.functions else None

    def resolve(self, caller: str, call: ast.Call) -> set:
        """The indexed functions a call inside function `caller` may
        reach (empty where the target lies outside the index)."""
        mod, qual = caller.split(":", 1)
        f = call.func
        if isinstance(f, ast.Name):
            scopes = qual.split(".")
            for i in range(len(scopes), -1, -1):
                fid = f"{mod}:{'.'.join(scopes[:i] + [f.id])}"
                if fid in self.functions and (
                        i == 0 or f"{mod}:{'.'.join(scopes[:i])}"
                        not in self.classes):
                    return {fid}
            target = self.imports[mod].get(f.id)
            fid = target and self._in_module(target)
            return {fid} if fid else set()
        if not isinstance(f, ast.Attribute):
            return set()
        recv = f.value
        if isinstance(recv, ast.Name) and recv.id in ("self", "cls"):
            scopes = qual.split(".")
            for i in range(len(scopes) - 1, 0, -1):
                owner = f"{mod}:{'.'.join(scopes[:i])}"
                if owner in self.classes:
                    fid = f"{owner}.{f.attr}"
                    return {fid} if fid in self.functions else set()
        if isinstance(recv, ast.Name) and recv.id in self.imports[mod]:
            target = self.imports[mod][recv.id]
            if target in self.trees:
                fid = f"{target}:{f.attr}"
                return {fid} if fid in self.functions else set()
            return set()
        return set(self._methods.get(f.attr, ()))


def launch_sync_index(sources: dict[str, str]) -> LaunchIndex:
    """The LaunchIndex of `sources` (dotted module name -> source)."""
    return LaunchIndex(sources)


def scan_source_host_sync(modname: str, fname: str | None,
                          index: LaunchIndex,
                          short: str | None = None) -> list[Finding]:
    """R1 over one launch-site module of `index`: every loop whose body
    both launches a kernel and forces a host sync, directly or through a
    call that resolves to a function the index marks as launching /
    syncing. One finding per (function, calls), keyed by the module's
    last name (or `short`), the function's name and the calls that
    launch and sync, never by line."""
    short = short or modname.rsplit(".", 1)[-1]
    out: list[Finding] = []
    seen: set[str] = set()
    for func, fn in _qualified_functions(index.trees[modname]):
        caller = f"{modname}:{func}"
        loops, stack = [], list(ast.iter_child_nodes(fn))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(n, _LOOPS):
                loops.append(n)
            stack.extend(ast.iter_child_nodes(n))
        for loop in sorted(loops, key=lambda n: n.lineno):
            if isinstance(loop, ast.While):
                # the test runs every iteration too
                body = [loop.test] + loop.body + loop.orelse
            elif isinstance(loop, (ast.For, ast.AsyncFor)):
                body = loop.body + loop.orelse
            else:
                body = [loop]
            launches, syncs = set(), set()
            for stmt in body:
                for c in ast.walk(stmt):
                    ref = _wrapper_ref(c)
                    if ref:
                        launches.add(ref)
                    if not isinstance(c, ast.Call):
                        continue
                    name = _call_name(c)
                    targets = index.resolve(caller, c)
                    if targets & index.launch:
                        launches.add(name)
                    if targets & index.sync or _is_sync(c):
                        syncs.add(name)
            if not launches or not syncs:
                continue
            site = f"{func}:{'+'.join(sorted(launches | syncs))}"
            if site in seen:
                continue
            seen.add(site)
            out.append(Finding(
                rule="R1", kernel=f"module:{short}", site=site,
                message=f"loop in {short}.{func} launches a kernel "
                        f"({', '.join(sorted(launches))}) and waits for "
                        f"the card ({', '.join(sorted(syncs))}) every "
                        "iteration: each launch is a synchronous "
                        "host round trip",
                file=fname, line=loop.lineno,
                hint="launch every iteration's work first and read the "
                     "results back after the loop, or batch the "
                     "iterations into one launch"))
    return out


# ---------------------------------------------------------------------------
# R2 — dtype widening (launch side; host-feeder AST scan below)
# ---------------------------------------------------------------------------

def rule_dtype_widening(trace: LaunchTrace) -> list[Finding]:
    out: list[Finding] = []
    for a in trace.args:
        if a.dtype not in WIDE_DTYPES:
            continue
        out.append(Finding(
            rule="R2", kernel=trace.name, site=f"arg:{a.name}:{a.dtype}",
            message=f"64-bit argument `{a.name}` ({a.dtype}"
                    f"{list(a.shape)}, {a.nbytes / 1024:.0f} KiB) reaches "
                    f"the kernel (bucket {trace.bucket}): twice the "
                    "bytes of the int32 house style",
            file=trace.file, line=trace.line,
            cost_bytes=a.nbytes // 2,
            hint="narrow it to int32/float32 unless its value range "
                 "needs 64 bits"))
    return out


# host-feeder side: explicit 64-bit numpy or torch dtypes in the modules
# that build kernel inputs. One finding per (function, dtype) so line
# churn inside a function doesn't move the baseline key.

_DTYPE_ATTRS = {"int64", "uint64", "float64"}
# torch's aliases, read as the numpy name so keys compare across modules
_TORCH_DTYPES = {"int64": "int64", "long": "int64", "uint64": "uint64",
                 "float64": "float64", "double": "float64"}


def scan_module_dtypes(module) -> list[Finding]:
    """AST scan of one host-feeder module for explicit 64-bit dtypes
    (np.int64 / torch.long / dtype="int64") inside function bodies —
    each one is host-side widening feeding the device."""
    try:
        src = inspect.getsource(module)
        fname = inspect.getsourcefile(module)
    except (OSError, TypeError):
        return []
    modname = module.__name__.rsplit(".", 1)[-1]
    return scan_source_dtypes(src, fname, modname)


def scan_source_dtypes(src: str, fname: str | None,
                       modname: str) -> list[Finding]:
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return []
    out: list[Finding] = []
    seen: set[tuple[str, str]] = set()

    def visit(node, func: str | None):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            func = node.name if func is None else f"{func}.{node.name}"
        for child in ast.iter_child_nodes(node):
            dt = _wide_dtype_of(child)
            if dt and func and (func, dt) not in seen:
                seen.add((func, dt))
                out.append(Finding(
                    rule="R2", kernel=f"module:{modname}",
                    site=f"{func}:{dt}",
                    message=f"explicit {dt} in host feeder "
                            f"{modname}.{func} (8-byte elements where "
                            "the kernels speak int32)",
                    file=fname, line=child.lineno,
                    hint="use int32/float32 unless the value range "
                         "genuinely needs 64 bits"))
            visit(child, func)

    visit(tree, None)
    return out


def _wide_dtype_of(node) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name):
        if node.attr in _DTYPE_ATTRS and \
                node.value.id in ("np", "jnp", "numpy"):
            return node.attr
        if node.value.id == "torch" and node.attr in _TORCH_DTYPES:
            return _TORCH_DTYPES[node.attr]
    if isinstance(node, ast.keyword) and node.arg == "dtype" \
            and isinstance(node.value, ast.Constant) \
            and node.value.value in _DTYPE_ATTRS:
        return str(node.value.value)
    return None


# ---------------------------------------------------------------------------
# R3 — copies before the kernel reads an input
# ---------------------------------------------------------------------------

def rule_copy(trace: LaunchTrace) -> list[Finding]:
    out: list[Finding] = []
    for a in trace.args:
        if not a.copied or a.nbytes < DONATION_MIN_BYTES:
            continue
        out.append(Finding(
            rule="R3", kernel=trace.name, site=a.name,
            message=f"arg `{a.name}` ({a.dtype}{list(a.shape)}, "
                    f"{a.nbytes / 1024:.0f} KiB) is copied or cast "
                    f"before the kernel reads it (bucket {trace.bucket}):"
                    " a device copy every launch",
            file=trace.file, line=trace.line,
            cost_bytes=a.nbytes,
            hint="have the caller build the argument in the kernel's "
                 "dtype and layout, so the wrapper passes it as it is"))
    return out


# ---------------------------------------------------------------------------
# R4 — sharding readiness (the JAX rule, unchanged)
# ---------------------------------------------------------------------------

def rule_sharding(trace: LaunchTrace) -> list[Finding]:
    out: list[Finding] = []
    part = trace.partition
    args = {a.name: a for a in trace.args}
    if part:
        for name in part.get("replicated", ()):
            a = args.get(name)
            if a is None or a.nbytes < REPLICATED_MIN_BYTES:
                continue
            out.append(Finding(
                rule="R4", kernel=trace.name,
                site=f"replicated:{name}",
                message=f"arg `{name}` ({a.nbytes / 1024:.0f} KiB) is "
                        "fully replicated across the "
                        f"'{part.get('axis')}' mesh axis (bucket "
                        f"{trace.bucket}): H2D cost and HBM footprint "
                        "scale with device count, work does not",
                file=trace.file, line=trace.line,
                cost_bytes=a.nbytes,
                hint="give it a partition rule (shard the segment/"
                     "row dimension) or slice it per shard"))
    for name, axis, why in trace.batch_axes:
        if part and name in (part.get("sharded") or ()):
            continue
        a = args.get(name)
        out.append(Finding(
            rule="R4", kernel=trace.name,
            site=f"unsharded-axis:{name}.{axis}",
            message=f"batch axis {axis} of `{name}` is embarrassingly "
                    f"parallel ({why}) but has no partition rule "
                    f"(bucket {trace.bucket}): the mesh adds devices "
                    "without adding throughput",
            file=trace.file, line=trace.line,
            cost_bytes=a.nbytes if a else None,
            hint="lay this axis out over the devices (one launch per "
                 "card over its shard)"))
    if trace.hlo_text:
        low = trace.hlo_text.lower()
        for coll in HLO_COLLECTIVES:
            if coll in low:
                out.append(Finding(
                    rule="R4", kernel=trace.name,
                    site=f"collective:{coll}",
                    message=f"lowered HLO contains `{coll}` (bucket "
                            f"{trace.bucket}): an op inside the "
                            "partitioned program forces cross-device "
                            "gathering",
                    file=trace.file, line=trace.line,
                    hint="check the op's partition spec; reformulate "
                         "to keep the batch axis local"))
    return out


# ---------------------------------------------------------------------------
# R5 — recompile risk: constants compiled into a kernel, runtime buckets
# ---------------------------------------------------------------------------

class _Unknown(Exception):
    """A name or expression the constant evaluator cannot reduce."""


_BINOPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
           ast.Mult: lambda a, b: a * b, ast.FloorDiv: lambda a, b: a // b,
           ast.LShift: lambda a, b: a << b, ast.RShift: lambda a, b: a >> b,
           ast.BitOr: lambda a, b: a | b, ast.BitAnd: lambda a, b: a & b,
           ast.BitXor: lambda a, b: a ^ b, ast.Mod: lambda a, b: a % b}
# one-argument calls that keep an integer's value
_INT_CASTS = {"int", "int8", "int16", "int32", "int64", "uint32"}


def _eval_int(node, lookup) -> int:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return int(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_eval_int(node.operand, lookup)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return ~_eval_int(node.operand, lookup)
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        return _BINOPS[type(node.op)](_eval_int(node.left, lookup),
                                      _eval_int(node.right, lookup))
    if isinstance(node, ast.Name):
        return lookup(node.id)
    if isinstance(node, ast.Call) and len(node.args) == 1 and \
            not node.keywords and _call_name(node) in _INT_CASTS:
        return _eval_int(node.args[0], lookup)
    raise _Unknown(ast.dump(node))


def python_constants(path, src: str | None = None) -> dict:
    """Module-level integer constants of a Python source, evaluated from
    its AST (names imported with `from .x import N` are read from that
    module's file); names whose value is not a constant integer
    expression are left out."""
    path = Path(path)
    tree = ast.parse(path.read_text() if src is None else src)
    exprs, imports, done = {}, {}, {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            exprs[stmt.targets[0].id] = stmt.value
        elif isinstance(stmt, ast.ImportFrom) and stmt.level:
            base = path.parent
            for _ in range(stmt.level - 1):
                base = base.parent
            mod = base.joinpath(*(stmt.module or "").split("."))
            for a in stmt.names:
                imports[a.asname or a.name] = (mod.with_suffix(".py"),
                                               a.name)

    def lookup(name: str, stack=()) -> int:
        if name in done:
            return done[name]
        if name in exprs and name not in stack:
            done[name] = _eval_int(exprs[name],
                                   lambda n: lookup(n, stack + (name,)))
            return done[name]
        if name in imports and imports[name][0].exists():
            other, orig = imports[name]
            got = python_constants(other)
            if orig in got:
                return got[orig]
        raise _Unknown(name)

    out = {}
    for name in exprs:
        try:
            out[name] = lookup(name)
        except (_Unknown, ArithmeticError, ValueError):
            pass
    return out


_CONSTEXPR = re.compile(r"^\s*constexpr\s+[\w\s]+?\s+(k\w+\s*=.*);",
                        re.MULTILINE)


def cuda_constants(src: str) -> dict:
    """The integer `constexpr` constants of a CUDA source at any scope,
    evaluated in order (integer suffixes dropped, `/` read as C's
    integer division); a constant whose expression needs anything else
    is left out."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.DOTALL)
    out: dict = {}
    for m in _CONSTEXPR.finditer(text):
        for decl in m.group(1).split(","):
            name, _, expr = decl.partition("=")
            expr = re.sub(r"\b(0[xX][0-9a-fA-F]+|\d+)[uUlL]+\b", r"\1",
                          expr.strip()).replace("/", "//")
            try:
                out[name.strip()] = _eval_int(
                    ast.parse(expr, mode="eval").body,
                    lambda n: out[n] if n in out else _raise(n))
            except (_Unknown, SyntaxError, ArithmeticError):
                pass
    return out


def _raise(name):
    raise _Unknown(name)


def mirror_findings(kernel: str, py_path, cu_path, pairs,
                    py_src: str | None = None,
                    cu_src: str | None = None) -> list[Finding]:
    """R5 over the values compiled into a kernel that its Python side
    also holds: for each (Python name, CUDA name) in `pairs`, a finding
    when the two values differ or one side has no such constant. The
    texts default to the files' own."""
    py_src = Path(py_path).read_text() if py_src is None else py_src
    py = python_constants(py_path, py_src)
    cu = cuda_constants(Path(cu_path).read_text() if cu_src is None
                        else cu_src)
    lines = {t.id: stmt.lineno for stmt in ast.parse(py_src).body
             if isinstance(stmt, ast.Assign) for t in stmt.targets
             if isinstance(t, ast.Name)}
    out = []
    for py_name, cu_name in pairs:
        a, b = py.get(py_name), cu.get(cu_name)
        if a is not None and a == b:
            continue
        out.append(Finding(
            rule="R5", kernel=kernel, site=f"mirror:{py_name}",
            message=f"{Path(py_path).name} {py_name} = {a} but "
                    f"{Path(cu_path).name} {cu_name} = {b}: the kernel is "
                    "compiled with a value the Python side does not hold",
            file=str(py_path), line=lines.get(py_name),
            hint=f"change {py_name} and {cu_name} together"))
    return out


def runtime_bucket_findings(buckets: dict[str, set],
                            max_buckets: int = MAX_RUNTIME_BUCKETS
                            ) -> list[Finding]:
    """R5's runtime cross-check over profiler.shape_buckets(): a kernel
    launched at more than max_buckets distinct shape buckets this
    process."""
    out = []
    for kernel, bs in sorted(buckets.items()):
        if len(bs) > max_buckets:
            out.append(Finding(
                rule="R5", kernel=kernel, site="bucket-cardinality",
                message=f"{len(bs)} distinct launch shape buckets this "
                        f"process (> {max_buckets}): the profiler's "
                        "per-bucket cost cache and records grow with "
                        "each",
                hint="coarsen the launch shapes "
                     "(profiler.<k>.bucket_cardinality tracks this "
                     "per run)"))
    return out


# ---------------------------------------------------------------------------
# R6 — carry bloat
# ---------------------------------------------------------------------------

def rule_carry(trace: LaunchTrace) -> list[Finding]:
    if trace.carry_bytes < CARRY_WARN_BYTES:
        return []
    parts = ", ".join(
        f"{k}={v // 1024}KiB" for k, v in (
            ("scratch", trace.scratch_bytes),
            ("shared a block", trace.smem_bytes),
            ("outputs", trace.carry_bytes - trace.scratch_bytes
             - trace.smem_bytes)) if v)
    return [Finding(
        rule="R6", kernel=trace.name, site="carry",
        message=f"the launch carries {trace.carry_bytes / 1024:.0f} KiB "
                f"through its levels or sweeps (bucket {trace.bucket}; "
                f"{parts}): every carried byte is read again each level",
        file=trace.file, line=trace.line,
        cost_bytes=trace.carry_bytes,
        hint="narrow or pack the per-node state (int8/int16), or keep "
             "per-level series out of the carried outputs")]


# ---------------------------------------------------------------------------
# Rule suite + baseline ratchet
# ---------------------------------------------------------------------------

TRACE_RULES = (rule_dtype_widening, rule_copy, rule_sharding, rule_carry)


def run_rules(trace: LaunchTrace) -> list[Finding]:
    """The launch rules (R2, R3, R4, R6) over one launch trace; R1, R2's
    host feeders and R5 read source, not a trace (analysis/driver.py)."""
    out: list[Finding] = []
    for rule in TRACE_RULES:
        out.extend(rule(trace))
    return out


BASELINE_VERSION = 1


def load_baseline(path) -> dict:
    """The committed baseline document ({"version", "findings"});
    an empty skeleton when the file doesn't exist."""
    p = Path(path)
    if not p.exists():
        return {"version": BASELINE_VERSION, "findings": []}
    with open(p) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or \
            not isinstance(doc.get("findings"), list):
        raise ValueError(f"{path}: not a lint baseline document")
    return doc


def baseline_doc(findings: list[Finding]) -> dict:
    """A baseline document pinning `findings` (sorted by key so the
    committed file diffs cleanly)."""
    return {
        "version": BASELINE_VERSION,
        "findings": sorted(
            ({"key": f.key, "rule": f.rule, "kernel": f.kernel,
              "site": f.site, "message": f.message}
             for f in findings), key=lambda d: d["key"]),
    }


def write_baseline(path, findings: list[Finding]) -> dict:
    doc = baseline_doc(findings)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc


def ratchet(findings: list[Finding], baseline: dict) -> dict:
    """The baseline comparison: {'new': [Finding], 'baselined':
    [Finding], 'stale': [keys]}. NEW findings fail the gate; STALE
    baseline entries (fixed findings) are prune candidates —
    `--update` rewrites the file without them, so the ratchet only
    ever tightens."""
    known = {e["key"] for e in baseline.get("findings", ())}
    have = {f.key for f in findings}
    return {
        "new": [f for f in findings if f.key not in known],
        "baselined": [f for f in findings if f.key in known],
        "stale": sorted(known - have),
    }
