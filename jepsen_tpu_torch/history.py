"""Operation records and histories (the port's copy of
jepsen_tpu/history.py: the port imports nothing of the JAX package).

The history is the central artifact of the framework: an append-only list
of invocations and completions. This module provides the Op record, the
History container with invocation/completion pairing, and the
structure-of-arrays (SoA) encoding that feeds the device checkers.

Capability reference: the external io.jepsen/history 0.1.3 library as used
throughout jepsen (Op construction at jepsen/src/jepsen/generator.clj:528-536;
pairing at jepsen/src/jepsen/checker.clj:782-804; parallel folds at
checker.clj:139-200). Where the reference pairs ops via per-process scans
over persistent vectors, we precompute dense int32 index columns so checkers
can operate on flat numpy/torch arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np

# Op types
INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"
SLEEP = "sleep"
LOG = "log"

_COMPLETION_TYPES = (OK, FAIL, INFO)


class Op:
    """A single operation event.

    Fields mirror jepsen.history.Op [index time type process f value]; any
    other keys (error, exception, ...) live in the `ext` dict. Ops are
    treated as immutable: use copy()/merge() to derive new ones.
    """

    __slots__ = ("index", "time", "type", "process", "f", "value", "ext")

    def __init__(self, index=-1, time=0, type=INVOKE, process=None, f=None,
                 value=None, ext=None):
        self.index = index
        self.time = time
        self.type = type
        self.process = process
        self.f = f
        self.value = value
        self.ext = ext

    # -- map-like access ----------------------------------------------------

    _CORE = ("index", "time", "type", "process", "f", "value")

    def get(self, k: str, default=None):
        if k in Op._CORE:
            return getattr(self, k)
        if self.ext:
            return self.ext.get(k, default)
        return default

    def __getitem__(self, k):
        v = self.get(k, _MISSING)
        if v is _MISSING:
            raise KeyError(k)
        return v

    def __contains__(self, k):
        return k in Op._CORE or bool(self.ext and k in self.ext)

    @property
    def error(self):
        return self.ext.get("error") if self.ext else None

    def keys(self):
        ks = list(Op._CORE)
        if self.ext:
            ks.extend(self.ext.keys())
        return ks

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in Op._CORE}
        if self.ext:
            d.update(self.ext)
        return d

    # -- derivation ---------------------------------------------------------

    def copy(self, **changes) -> "Op":
        """Returns a new Op with the given fields replaced; non-core keys go
        into ext."""
        core = {k: getattr(self, k) for k in Op._CORE}
        ext = dict(self.ext) if self.ext else {}
        for k, v in changes.items():
            if k in core:
                core[k] = v
            else:
                ext[k] = v
        return Op(ext=ext or None, **core)

    def without(self, *keys) -> "Op":
        ext = dict(self.ext) if self.ext else {}
        for k in keys:
            ext.pop(k, None)
        return Op(self.index, self.time, self.type, self.process, self.f,
                  self.value, ext or None)

    # -- dunder -------------------------------------------------------------

    def __eq__(self, other):
        if not isinstance(other, Op):
            return NotImplemented
        return (self.index == other.index and self.time == other.time
                and self.type == other.type and self.process == other.process
                and self.f == other.f and self.value == other.value
                and (self.ext or None) == (other.ext or None))

    def __hash__(self):
        return hash((self.index, self.time, self.type, self.process, self.f))

    def __repr__(self):
        parts = [f"{self.index}", f"{self.type}", f"p{self.process}",
                 f"{self.f}", f"{self.value!r}"]
        if self.ext:
            parts.append(repr(self.ext))
        return "Op<" + " ".join(parts) + ">"


_MISSING = object()


def op(**kwargs) -> Op:
    """Convenience Op constructor accepting arbitrary keys."""
    core = {k: kwargs.pop(k) for k in list(kwargs) if k in Op._CORE}
    return Op(ext=kwargs or None, **core)


# ---------------------------------------------------------------------------
# Predicates (jepsen.history: invoke?/ok?/fail?/info?/client-op?)
# ---------------------------------------------------------------------------

def is_invoke(o: Op) -> bool:
    return o.type == INVOKE


def is_ok(o: Op) -> bool:
    return o.type == OK


def is_fail(o: Op) -> bool:
    return o.type == FAIL


def is_info(o: Op) -> bool:
    return o.type == INFO


def is_completion(o: Op) -> bool:
    return o.type in _COMPLETION_TYPES


def is_client_op(o: Op) -> bool:
    return isinstance(o.process, int)


def has_f(f) -> Callable[[Op], bool]:
    fs = f if isinstance(f, (set, frozenset)) else {f}
    return lambda o: o.f in fs


# ---------------------------------------------------------------------------
# History
# ---------------------------------------------------------------------------

class History(Sequence):
    """An indexed sequence of Ops with invocation/completion pairing.

    Construction assigns dense indices if absent. Pairing: an invocation's
    completion is the next op by the same process; crashed invocations
    (whose process never completes) pair with nothing (mirrors
    jepsen.history pair-index semantics used at checker.clj:782-804).
    """

    def __init__(self, ops: Iterable, assign_indices: bool | None = None):
        lst = []
        for o in ops:
            if isinstance(o, dict):
                o = op(**o)
            lst.append(o)
        if assign_indices is None:
            assign_indices = any(o.index is None or o.index < 0 for o in lst)
        if assign_indices:
            lst = [o.copy(index=i) if o.index != i else o
                   for i, o in enumerate(lst)]
        self._ops: list[Op] = lst
        self._pair_index: np.ndarray | None = None
        self._pos_by_index: dict | None = None

    # -- Sequence protocol --------------------------------------------------

    def __len__(self):
        return len(self._ops)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return History(self._ops[i], assign_indices=False)
        return self._ops[i]

    def __iter__(self) -> Iterator[Op]:
        return iter(self._ops)

    def __repr__(self):
        return f"History<{len(self._ops)} ops>"

    def __eq__(self, other):
        if isinstance(other, History):
            return self._ops == other._ops
        if isinstance(other, list):
            return self._ops == other
        return NotImplemented

    # -- filters ------------------------------------------------------------

    def filter(self, pred: Callable[[Op], bool]) -> "History":
        return History([o for o in self._ops if pred(o)], assign_indices=False)

    def invokes(self) -> "History":
        return self.filter(is_invoke)

    def oks(self) -> "History":
        return self.filter(is_ok)

    def fails(self) -> "History":
        return self.filter(is_fail)

    def infos(self) -> "History":
        return self.filter(is_info)

    def client_ops(self) -> "History":
        return self.filter(is_client_op)

    def nemesis_ops(self) -> "History":
        return self.filter(lambda o: not is_client_op(o))

    # -- pairing ------------------------------------------------------------

    def pair_index(self) -> np.ndarray:
        """int64 array mapping each op's *position in this history* to its
        pair's position (-1 when unpaired). Invocations point at their
        completion and vice versa."""
        if self._pair_index is None:
            n = len(self._ops)
            pairs = np.full(n, -1, dtype=np.int64)
            open_invokes: dict[Any, int] = {}
            for i, o in enumerate(self._ops):
                if o.type == INVOKE:
                    open_invokes[o.process] = i
                elif o.type in _COMPLETION_TYPES:
                    j = open_invokes.pop(o.process, None)
                    if j is not None:
                        pairs[i] = j
                        pairs[j] = i
            self._pair_index = pairs
        return self._pair_index

    def _position_of(self, o: Op) -> int:
        """Position of an op in this history. O(1) when indices are dense
        positions (the common, unfiltered case); falls back to an
        index->position map for filtered/sliced histories."""
        n = len(self._ops)
        i = o.index
        if 0 <= i < n and self._ops[i] is o:
            return i
        if self._pos_by_index is None:
            self._pos_by_index = {op.index: p
                                  for p, op in enumerate(self._ops)}
        p = self._pos_by_index.get(i)
        if p is None:
            raise KeyError(f"op with index {i} is not in this history")
        return p

    def completion(self, o: Op) -> Op | None:
        """The completion op for an invocation (or None if it never
        completed)."""
        j = self.pair_index()[self._position_of(o)]
        return self._ops[j] if j >= 0 else None

    def invocation(self, o: Op) -> Op | None:
        """The invocation op for a completion."""
        j = self.pair_index()[self._position_of(o)]
        return self._ops[j] if j >= 0 else None

    # -- folds --------------------------------------------------------------

    def fold(self, f: Callable[[Any, Op], Any], init: Any) -> Any:
        """Sequential fold; the reference's parallel h/fold collapses to
        this on the host — device checkers use the SoA encoding instead."""
        acc = init
        for o in self._ops:
            acc = f(acc, o)
        return acc

    # -- SoA encoding -------------------------------------------------------

    def to_soa(self, f_codes: dict | None = None) -> "SoaHistory":
        return SoaHistory.from_history(self, f_codes=f_codes)


class SoaHistory:
    """Structure-of-arrays view of a history: dense int columns ready to be
    packed onto a device.

    Columns (all length n):
      time      int64  nanoseconds
      type      int8   0=invoke 1=ok 2=fail 3=info
      process   int32  dense process ids (nemesis & named → negative)
      f         int32  interned op function code
      pair      int64  index of pair op, -1 if none

    Values are history-specific and encoded by each checker's own packer
    (see jepsen_tpu_torch.gpu.encode)."""

    TYPE_CODES = {INVOKE: 0, OK: 1, FAIL: 2, INFO: 3}

    def __init__(self, time, type_, process, f, pair, f_codes, process_codes,
                 ops):
        self.time = time
        self.type = type_
        self.process = process
        self.f = f
        self.pair = pair
        self.f_codes = f_codes
        self.process_codes = process_codes
        self.ops = ops

    @classmethod
    def from_history(cls, h: History, f_codes: dict | None = None):
        n = len(h)
        time = np.zeros(n, dtype=np.int64)
        type_ = np.zeros(n, dtype=np.int8)
        process = np.zeros(n, dtype=np.int32)
        f_col = np.full(n, -1, dtype=np.int32)
        f_codes = dict(f_codes) if f_codes else {}
        process_codes: dict[Any, int] = {}
        next_named = -1
        for i, o in enumerate(h):
            time[i] = o.time or 0
            type_[i] = cls.TYPE_CODES.get(o.type, 3)
            p = o.process
            if isinstance(p, int):
                process[i] = p
            else:
                if p not in process_codes:
                    process_codes[p] = next_named
                    next_named -= 1
                process[i] = process_codes[p]
            if o.f is not None:
                if o.f not in f_codes:
                    f_codes[o.f] = len(f_codes)
                f_col[i] = f_codes[o.f]
        return cls(time, type_, process, f_col, h.pair_index(), f_codes,
                   process_codes, h)


def history(ops: Iterable) -> History:
    """Builds a History from Ops or dicts, assigning indices as needed."""
    return History(ops)
