"""History -> tensor encoding for the device checkers (the port's copy
of jepsen_tpu/tpu/encode.py).

Turns a single-key client history into flat int32 entry arrays (one entry
per surviving invocation, sorted by invocation order) and compiles a
sequential model (jepsen_tpu_torch.checker.models) into a dense transition table
by closing over its reachable state space.

Capability reference: knossos preprocesses histories the same way before
search (pairing invocations with completions, dropping :fail ops because
they never took effect, treating :info ops as possibly-effective forever —
behavior observed through jepsen/src/jepsen/checker.clj:202-233 and the
model-protocol mirror at jepsen/src/jepsen/tests/causal.clj:10-29). Where
knossos steps model *objects* during the search, we pre-tabulate
`trans[entry, state] -> state'` so the search itself is pure integer
gathers that run on device.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from .. import history as h
from ..checker import models as model_mod
from ..history import History, Op

# Sentinel "time" for completions that never happen (crashed ops) and for
# padding entries. Far above any real history position, still well inside
# int32.
INF = np.int32(1 << 30)


class EncodingError(Exception):
    """The history/model can't be compiled to dense tables (e.g. the
    reachable state space exceeds max_states). Callers fall back to the
    object-model host search."""


def _freeze(v: Any):
    """Hashable view of an op value (lists/dicts appear in txn values)."""
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, tuple):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, set):
        return frozenset(_freeze(x) for x in v)
    return v


class Encoded:
    """A single history compiled for the WGL kernel.

    Arrays (length m, entries sorted by invocation position):
      inv_t   int32  invocation position in the source history
      ret_t   int32  completion position (INF when crashed)
      crashed bool   completion was :info / missing (op may or may not
                     have taken effect, at any later time)
      trans   int32 [m, n_states]  next-state code, -1 = inconsistent

    State 0 is the initial model state. entry_ops[e] is the merged Op for
    witness reporting.
    """

    __slots__ = ("inv_t", "ret_t", "crashed", "trans", "m", "n_states",
                 "states", "entry_ops", "init_state")

    def __init__(self, inv_t, ret_t, crashed, trans, states, entry_ops,
                 init_state: int = 0):
        self.inv_t = inv_t
        self.ret_t = ret_t
        self.crashed = crashed
        self.trans = trans
        self.m = len(inv_t)
        self.n_states = trans.shape[1] if trans.size else 1
        self.states = states
        self.entry_ops = entry_ops
        self.init_state = init_state

    def segment(self, lo: int, hi: int, init_state: int = 0) -> "Encoded":
        """Sub-history over entries [lo, hi) starting from init_state.
        Entry positions are re-based so the window math stays in-range."""
        base = self.inv_t[lo] if hi > lo else 0
        ret = self.ret_t[lo:hi].copy()
        ret[ret < INF] -= base
        return Encoded(self.inv_t[lo:hi] - base, ret,
                       self.crashed[lo:hi], self.trans[lo:hi],
                       self.states, self.entry_ops[lo:hi], init_state)

    def suffix_min_ret(self) -> np.ndarray:
        """suffix_min_ret[i] = min(ret_t[i:]), length m+1, [m] = INF."""
        out = np.full(self.m + 1, INF, dtype=np.int32)
        if self.m:
            out[:-1] = np.minimum.accumulate(self.ret_t[::-1])[::-1]
        return out

    def with_init(self, init_state: int) -> "Encoded":
        """A view of this history starting from a different model state
        (shares all arrays)."""
        return Encoded(self.inv_t, self.ret_t, self.crashed, self.trans,
                       self.states, self.entry_ops, init_state)

    def __repr__(self):
        return f"Encoded<m={self.m} states={self.n_states}>"


def balanced_groups(weights, n_groups: int) -> list[list[int]]:
    """Shard-aligned packing: partition item indices into n_groups
    groups balanced by weight (longest-processing-time greedy), so
    the packed segment tensors slice cleanly along the device axis with
    near-even per-device search work. Groups keep ascending index
    order internally (stable layouts keep launch shapes stable);
    every group exists even when items < groups (empty groups map to
    sentinel-only shards)."""
    n_groups = max(int(n_groups), 1)
    weights = list(weights)
    order = sorted(range(len(weights)), key=lambda i: (-weights[i], i))
    loads = [0.0] * n_groups
    groups: list[list[int]] = [[] for _ in range(n_groups)]
    for i in order:
        g = loads.index(min(loads))
        groups[g].append(i)
        loads[g] += max(float(weights[i]), 1.0)
    for g in groups:
        g.sort()
    return groups


def _with_value(inv: Op, value) -> Op:
    """inv with a substituted value. A slot-direct constructor: this
    runs once per completed read in a million-op encode, where
    Op.copy's dict round trip is ~4x the cost."""
    op = Op.__new__(Op)
    op.index = inv.index
    op.time = inv.time
    op.type = inv.type
    op.process = inv.process
    op.f = inv.f
    op.value = value
    op.ext = inv.ext
    return op


def _merged_entry(inv: Op, comp: Op | None) -> tuple[Op, bool]:
    """The op a model should step, plus crashed?. For :ok completions the
    completion's value wins (reads invoke with value nil and complete with
    the observed value); crashed ops keep the invocation's value."""
    if comp is not None and comp.type == h.OK:
        op = inv if comp.value is None else _with_value(inv, comp.value)
        return op, False
    return inv, True


def entries(hist: History) -> list[tuple[int, int, bool, Op]]:
    """[(inv_pos, ret_pos, crashed, op)] for each effective invocation.
    :fail completions are dropped (the op never happened); crashed reads
    and other provably effect-free crashed ops are dropped by encode()
    once the transition table shows they're identity."""
    out = []
    open_inv: dict[Any, tuple[int, Op]] = {}
    ops = list(hist)
    for pos, op in enumerate(ops):
        if not h.is_client_op(op):
            continue
        if op.type == h.INVOKE:
            open_inv[op.process] = (pos, op)
        elif op.type in (h.OK, h.FAIL, h.INFO):
            pair = open_inv.pop(op.process, None)
            if pair is None:
                continue
            inv_pos, inv = pair
            if op.type == h.FAIL:
                continue
            merged, crashed = _merged_entry(inv, op if op.type == h.OK
                                            else None)
            out.append((inv_pos, pos if not crashed else int(INF), crashed,
                        merged))
    # invocations that never completed at all == crashed
    for inv_pos, inv in open_inv.values():
        merged, _ = _merged_entry(inv, None)
        out.append((inv_pos, int(INF), True, merged))
    out.sort(key=lambda e: e[0])
    return out


def encode(model, hist: History, max_states: int = 4096) -> Encoded:
    """Compiles (model, history) into an Encoded. Raises EncodingError if
    the reachable state space exceeds max_states or the model declares
    itself non-tabulable (step() depends on more than op.f/op.value).

    Host-encode time is the first phase of every kernel launch
    pipeline, so it's accounted to the device profiler (aggregate
    `profiler.encode.*` counters — ensembles encode thousands of
    histories, so no per-call records)."""
    from . import profiler

    t0 = time.monotonic_ns()
    enc = _encode(model, hist, max_states)
    profiler.get().record_host("encode", time.monotonic_ns() - t0,
                               entries=enc.m)
    return enc


def _encode(model, hist: History, max_states: int) -> Encoded:
    if not getattr(model, "tabulable", True):
        raise EncodingError(f"{type(model).__name__} is not tabulable")
    ents = entries(hist)

    # Distinct ops (by f, frozen value) index the transition-table rows.
    distinct: dict[Any, int] = {}
    ent_op_idx = []
    d_ops: list[Op] = []
    for _, _, _, op in ents:
        key = (op.f, _freeze(op.value))
        if key not in distinct:
            distinct[key] = len(d_ops)
            d_ops.append(op)
        ent_op_idx.append(distinct[key])

    # Close the state space under all distinct ops.
    states: dict[Any, int] = {model: 0}
    state_list = [model]
    d_trans: list[list[int]] = []  # [n_states][n_distinct]
    frontier = [model]
    while frontier:
        nxt = []
        for st in frontier:
            si = states[st]
            while len(d_trans) <= si:
                d_trans.append([-1] * len(d_ops))
            for di, dop in enumerate(d_ops):
                st2 = st.step(dop)
                if model_mod.is_inconsistent(st2):
                    d_trans[si][di] = -1
                    continue
                if st2 not in states:
                    if len(states) >= max_states:
                        raise EncodingError(
                            f"state space exceeds {max_states} states")
                    states[st2] = len(state_list)
                    state_list.append(st2)
                    nxt.append(st2)
                d_trans[si][di] = states[st2]
        frontier = nxt

    n_states = len(state_list)
    d_trans_arr = np.array(d_trans, dtype=np.int32)  # [S, D]

    # Drop crashed entries that are identity on every state (e.g. crashed
    # reads with unknown result): linearizing them never matters.
    # Identity-ness is a property of the DISTINCT op, computed once per
    # table column instead of once per entry.
    identity = np.arange(n_states, dtype=np.int32)
    id_cols = (d_trans_arr == identity[:, None]).all(axis=0)  # [D]
    op_idx = np.asarray(ent_op_idx, dtype=np.int32)
    crashed_all = np.fromiter((e[2] for e in ents), dtype=bool,
                              count=len(ents))
    keep = np.flatnonzero(~(crashed_all & id_cols[op_idx]))

    inv_t = np.fromiter((e[0] for e in ents), dtype=np.int32,
                        count=len(ents))[keep]
    ret_t = np.fromiter((e[1] for e in ents), dtype=np.int32,
                        count=len(ents))[keep]
    crashed_a = crashed_all[keep]
    # one gather instead of an m-iteration python fill
    trans = d_trans_arr[:, op_idx[keep]].T.copy()
    entry_ops = [ents[i][3] for i in keep]
    return Encoded(inv_t, ret_t, crashed_a, trans, state_list, entry_ops)
