"""Wing & Gong / Lowe linearizability checking, host + GPU: the port of
jepsen_tpu/tpu/wgl.py's main path.

The algorithm is the JAX package's, unchanged:

- A configuration is `(p, window-bitmask, state)`: every entry below `p`
  (in invocation order) is linearized; the uint32 mask covers entries
  `[p, p+W)`; `state` indexes the model's pre-tabulated state space
  (encode.py). The fixed-width encoding is exact as long as no candidate
  entry falls `>= W` past the first unlinearized entry; when that happens
  the kernel flags the row UNKNOWN and the host search decides it.
- One BFS step linearizes exactly one entry in every live configuration,
  so the device search is at most `m` levels over a fixed-size frontier
  of `F` configurations per search row, batched over rows.
- Candidate entries: `j` may linearize next iff
  `inv_t[j] < min(ret_t[unlinearized])`. Crashed (`:info`) entries never
  block (`ret_t = INF`) and may either take effect or never happen (a
  "discard" action).
- Deduplication is a sort + unique-compaction of the successor keys each
  level (kernels/wgl_search.py, csrc/wgl_search.cu).

Every device launch goes through `_launch` (or, for the one-device
ensemble layout, gpu/ensemble.py) into the hand-written CUDA kernel (or,
for tensors on the CPU, its plain PyTorch version). A launch returns
before its search ends and `_drain` waits on that launch's own event, so
the batch entry points (`analysis_batch_streamed`) overlap one chunk's
host encoding with the previous chunk's search. A kernel that fails to
build or launch raises: there is no device-failure ladder. UNKNOWN rows
(window or frontier overflow) still go to the exact host search, which
is the algorithm's own soundness rule; they are counted under
`wgl.host-resolved-rows`.
"""

from __future__ import annotations

import json
import logging
import time as _time
import zlib
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from .. import telemetry
from ..checker import models as model_mod
from ..device import resolve_device
from ..history import History
from ..store import format as sformat
from . import ckpt as ckpt_mod
from .encode import INF, Encoded, EncodingError, encode
from .kernels import wgl_search as kernel
from .kernels.wgl_search import BIG, INVALID, RUNNING, UNKNOWN, VALID

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Host search (unbounded window; correctness reference and UNKNOWN floor)
# ---------------------------------------------------------------------------

def _min_ret(p: int, wmask: int, m, sufmin, ret_t) -> int:
    """Earliest completion among unlinearized entries at config (p,
    wmask): the candidate cutoff — only entries invoked before it may
    linearize next. Shared by the searches and witness extraction."""
    span = wmask.bit_length()
    mr = int(sufmin[min(p + span, m)])
    for i in range(span):
        if not (wmask >> i) & 1 and p + i < m:
            r = int(ret_t[p + i])
            if r < mr:
                mr = r
    return mr


def search_host(enc: Encoded, witness: bool = False) -> dict:
    """Exhaustive WGL over an Encoded history. Returns {'valid?': bool}
    plus witness info (furthest entry reached, pending ops, states) when
    witness=True and the history is invalid."""
    m = enc.m
    if m == 0:
        return {"valid?": True}
    inv_t = enc.inv_t
    ret_t = enc.ret_t
    crashed = enc.crashed
    trans = enc.trans
    sufmin = enc.suffix_min_ret()

    # config = (p, wmask, state); wmask bit i == entry p+i linearized;
    # bit 0 always clear (p is the first unlinearized entry).
    s0 = enc.init_state
    seen: set[tuple[int, int, int]] = set()
    stack: list[tuple[int, int, int]] = [(0, 0, s0)]
    seen.add((0, 0, s0))
    best_p = 0
    best_cfgs: list[tuple[int, int, int]] = [(0, 0, s0)]

    while stack:
        p, wmask, st = stack.pop()
        if p >= m:
            return {"valid?": True}
        if p > best_p:
            best_p, best_cfgs = p, []
        if p == best_p and len(best_cfgs) < 8:
            best_cfgs.append((p, wmask, st))
        min_ret = _min_ret(p, wmask, m, sufmin, ret_t)
        # candidates: unlinearized j with inv_t[j] < min_ret (inv_t sorted)
        i = 0
        while p + i < m and int(inv_t[p + i]) < min_ret:
            if not (wmask >> i) & 1:
                e = p + i
                nmask = wmask | (1 << i)
                # advance past the linearized prefix
                t = _trailing_ones(nmask)
                np_, nmask_ = p + t, nmask >> t
                s2 = int(trans[e, st])
                if s2 >= 0:
                    cfg = (np_, nmask_, s2)
                    if cfg not in seen:
                        seen.add(cfg)
                        stack.append(cfg)
                if crashed[e]:
                    cfg = (np_, nmask_, st)
                    if cfg not in seen:
                        seen.add(cfg)
                        stack.append(cfg)
            i += 1

    out: dict = {"valid?": False}
    if witness:
        out["op"] = enc.entry_ops[best_p] if best_p < m else None
        # search-dynamics telemetry: where in the history the search
        # got stuck — the witness-position percentile feeding the
        # coverage atlas and ROADMAP-3's early-exit tuning
        out["witness-entry"] = int(best_p)
        out["entry-count"] = int(m)
        cfgs = []
        for p, wmask, st in best_cfgs:
            # pending = every unlinearized entry in flight at the stuck
            # point: invoked before the earliest completion among
            # unlinearized entries (can lie well past the mask span).
            min_ret = _min_ret(p, wmask, m, sufmin, ret_t)
            pending = []
            i = 0
            while p + i < m and int(inv_t[p + i]) < min_ret:
                if not (wmask >> i) & 1:
                    pending.append(enc.entry_ops[p + i])
                    if len(pending) >= 4:
                        break
                i += 1
            cfgs.append({"model": enc.states[st], "pending": pending})
        out["configs"] = cfgs
        out["previous-ok"] = enc.entry_ops[best_p - 1] if best_p else None
    return out


def search_host_reach(enc: Encoded) -> int:
    """Exhaustive host search returning the bitmask of model states the
    history can end in (0 = not linearizable). Host analog of the
    kernel's reach mode, for per-segment fallback."""
    m = enc.m
    if m == 0:
        return 1 << enc.init_state
    inv_t, ret_t, crashed, trans = (enc.inv_t, enc.ret_t, enc.crashed,
                                    enc.trans)
    sufmin = enc.suffix_min_ret()
    seen = {(0, 0, enc.init_state)}
    stack = [(0, 0, enc.init_state)]
    out = 0
    while stack:
        p, wmask, st = stack.pop()
        if p >= m:
            out |= 1 << st
            continue
        min_ret = _min_ret(p, wmask, m, sufmin, ret_t)
        i = 0
        while p + i < m and int(inv_t[p + i]) < min_ret:
            if not (wmask >> i) & 1:
                e = p + i
                nmask = wmask | (1 << i)
                t = _trailing_ones(nmask)
                np_, nmask_ = p + t, nmask >> t
                s2 = int(trans[e, st])
                nexts = [s2] if s2 >= 0 else []
                if crashed[e]:
                    nexts.append(st)
                for s_next in nexts:
                    cfg = (np_, nmask_, s_next)
                    if cfg not in seen:
                        seen.add(cfg)
                        stack.append(cfg)
            i += 1
    return out


def _trailing_ones(x: int) -> int:
    t = 0
    while x & 1:
        x >>= 1
        t += 1
    return t


def search_host_model(model, hist: History, witness: bool = False) -> dict:
    """Object-model WGL for models whose state space can't be tabulated
    (mirrors knossos stepping model values directly)."""
    from .encode import entries as entries_fn

    ents = entries_fn(hist)
    m = len(ents)
    if m == 0:
        return {"valid?": True}
    inv_t = [e[0] for e in ents]
    ret_t = [e[1] for e in ents]
    crashed = [e[2] for e in ents]
    ops = [e[3] for e in ents]
    sufmin = [BIG] * (m + 1)
    for i in range(m - 1, -1, -1):
        sufmin[i] = min(sufmin[i + 1], ret_t[i])

    seen: set = set()
    start = (0, 0, model)
    stack = [start]
    seen.add((0, 0, model))
    best_p = 0
    best: list = [start]
    while stack:
        p, wmask, st = stack.pop()
        if p >= m:
            return {"valid?": True}
        if p > best_p:
            best_p, best = p, []
        if p == best_p and len(best) < 8:
            best.append((p, wmask, st))
        span = wmask.bit_length()
        min_ret = sufmin[min(p + span, m)]
        for i in range(span):
            if not (wmask >> i) & 1 and p + i < m:
                min_ret = min(min_ret, ret_t[p + i])
        i = 0
        while p + i < m and inv_t[p + i] < min_ret:
            if not (wmask >> i) & 1:
                e = p + i
                nmask = wmask | (1 << i)
                t = _trailing_ones(nmask)
                np_, nmask_ = p + t, nmask >> t
                st2 = st.step(ops[e])
                if not model_mod.is_inconsistent(st2):
                    cfg = (np_, nmask_, st2)
                    if cfg not in seen:
                        seen.add(cfg)
                        stack.append(cfg)
                if crashed[e]:
                    cfg = (np_, nmask_, st)
                    if cfg not in seen:
                        seen.add(cfg)
                        stack.append(cfg)
            i += 1
    out: dict = {"valid?": False}
    if witness:
        out["op"] = ops[best_p] if best_p < m else None
        out["witness-entry"] = int(best_p)
        out["entry-count"] = int(m)
        out["configs"] = [{"model": st, "pending":
                           [ops[p + i] for i in range(wmask.bit_length() + 1)
                            if p + i < m and not (wmask >> i) & 1][:4]}
                          for p, wmask, st in best]
    return out


# ---------------------------------------------------------------------------
# Batched device search
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


class RangeError(Exception):
    """History too large for the kernel's position range (2m >= 2^21);
    callers use the host search."""


class PackedBatch:
    """A bucket of Encoded histories padded to common (M, S).

    Positions are rank-compressed per history: the kernel only compares
    invocation/completion positions, so each history's finite positions
    are remapped to their dense rank (< 2m). M and S are bucketed to
    powers of two (M >= 64, S >= 8), as in the JAX package: the search's
    level cap max_iters = M + 4 depends on the padded M. Row K = B is an
    empty sentinel segment that batch-padding rows point at.

    The fields are numpy views into one flat int32 buffer; tensors()
    moves the buffer and the launch's rows to the device in one copy."""

    __slots__ = ("flat", "inv_t", "ret_t", "trans", "m", "sufmin",
                 "M", "S", "B", "has_crashed")

    def __init__(self, encs: Sequence[Encoded]):
        t0 = _time.monotonic_ns()
        B = len(encs)
        self.has_crashed = any(bool(e.crashed.any()) for e in encs)
        M = _next_pow2(max(max((e.m for e in encs), default=0), 64))
        S = _next_pow2(max((e.n_states for e in encs), default=1) or 1)
        S = max(S, 8)
        K = B + 1
        self.B, self.M, self.S = B, M, S
        sizes = (K * M, K * M, K * M * S, K, K * (M + 1))
        self.flat = np.empty(sum(sizes), dtype=np.int32)
        views = np.split(self.flat, np.cumsum(sizes)[:-1])
        self.inv_t = views[0].reshape(K, M)
        self.ret_t = views[1].reshape(K, M)
        self.trans = views[2].reshape(K, M, S)
        self.m = views[3]
        self.sufmin = views[4].reshape(K, M + 1)
        self.inv_t.fill(BIG)
        self.ret_t.fill(BIG)
        self.trans.fill(-1)
        self.m.fill(0)
        self.sufmin.fill(BIG)
        for b, e in enumerate(encs):
            mm = e.m
            self.m[b] = mm
            if not mm:
                continue
            if 2 * mm >= (1 << 21):
                raise RangeError(
                    f"history with {mm} entries exceeds the kernel's "
                    "position range")
            fin = e.ret_t < INF
            order = np.unique(np.concatenate([e.inv_t, e.ret_t[fin]]))
            inv_r = np.searchsorted(order, e.inv_t).astype(np.int32)
            ret_r = np.full(mm, BIG, dtype=np.int32)
            ret_r[fin] = np.searchsorted(order, e.ret_t[fin])
            self.inv_t[b, :mm] = inv_r
            self.ret_t[b, :mm] = ret_r
            self.trans[b, :mm, :e.n_states] = e.trans
            self.sufmin[b, :mm] = np.minimum.accumulate(ret_r[::-1])[::-1]
        # batch shape profile: real entries vs padded slots
        used = int(self.m.sum())
        slots = int(B * M)
        tel = telemetry.get()
        tel.count("wgl.batch.histories", B)
        tel.count("wgl.batch.entries", used)
        tel.count("wgl.batch.slots", slots)
        if slots:
            tel.gauge("wgl.batch.occupancy", round(used / slots, 4))
            tel.gauge("wgl.batch.padding-waste",
                      round(1 - used / slots, 4))
        tel.count("wgl.batch.pack_ns", _time.monotonic_ns() - t0)

    def rows(self, rows: Sequence[tuple[int, int]]):
        """(row_seg, st0) int32 arrays for (segment, start-state) search
        rows, padded to a power of two with sentinel rows."""
        B = len(rows)
        Bp = _next_pow2(max(B, 1))
        row_seg = np.full(Bp, self.B, dtype=np.int32)  # sentinel = empty
        st0 = np.zeros(Bp, dtype=np.int32)
        for i, (k, s) in enumerate(rows):
            row_seg[i] = k
            st0[i] = s
        return row_seg, st0

    def tensors(self, row_seg: np.ndarray, st0: np.ndarray,
                device: torch.device):
        """(packed, row_seg, st0) on `device`, after one host-to-device
        copy of the packed tables and the rows together."""
        dev = _upload([self.flat, row_seg, st0], device)
        K, M, S = self.B + 1, self.M, self.S
        sizes = [K * M, K * M, K * M * S, K, K * (M + 1)]
        inv_t, ret_t, trans, m, sufmin = torch.split(dev[0], sizes)
        packed = (inv_t.view(K, M), ret_t.view(K, M), trans.view(K, M, S),
                  m, sufmin.view(K, M + 1))
        return packed, dev[1], dev[2]


def _upload(parts: Sequence[np.ndarray], device: torch.device
            ) -> list[torch.Tensor]:
    """int32 arrays on `device`, in one copy. For the card the arrays are
    staged in pinned host memory and copied with non_blocking=True: a
    copy from pageable memory would first wait for the stream's earlier
    work (the previous chunk's search), and so block the host. PyTorch's
    pinned-memory cache keeps the staging buffer from reuse until the
    copy is done."""
    sizes = [int(a.size) for a in parts]
    host = torch.empty(sum(sizes), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    buf = host.numpy()
    off = 0
    for a, n in zip(parts, sizes):
        buf[off:off + n] = a.reshape(-1)
        off += n
    return list(torch.split(host.to(device, non_blocking=True), sizes))


class Launch:
    """One search in flight: its outputs (host tensors once `done` has
    fired), the CUDA events around its device work, and `done`, the
    event recorded after the copies of its outputs to the host. On the
    CPU the outputs are ready and the events are None."""

    __slots__ = ("outs", "start", "end", "done")

    def __init__(self, outs, start=None, end=None, done=None):
        self.outs, self.start, self.end, self.done = outs, start, end, done


def _run(packed, rs, s0, W: int, F: int, max_iters: int, reach: bool,
         crash_free: bool, gather: torch.Tensor | None = None) -> Launch:
    """Launches the kernel over uploaded tensors without waiting for it.
    `gather` (int32 row indices on the same device) reorders and trims the
    per-row outputs on the device before they are read back. On the card
    the outputs are then copied into pinned host buffers with
    non_blocking=True, and an event is recorded after the copies, all in
    the current stream's order: the host returns at once, and _drain
    waits on that event alone."""
    on_card = rs.device.type == "cuda"
    start = end = done = None
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    outs = kernel.wgl_search(packed, rs, s0, W=W, F=F, max_iters=max_iters,
                             reach=reach, crash_free=crash_free)
    if gather is not None:
        n_res = 2 if reach else 1
        idx = gather.to(torch.int64)
        # uint32 masks travel as int32: the same bits, and an index_select
        # that every backend has
        outs = tuple(
            o.view(torch.int32).index_select(0, idx).view(torch.uint32)
            if o.dtype == torch.uint32 else o.index_select(0, idx)
            for o in outs[:n_res]) + tuple(outs[n_res:])
    if not on_card:
        return Launch(outs)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    host = []
    for o in outs:
        h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
        h.copy_(o, non_blocking=True)
        host.append(h)
    done = torch.cuda.Event()
    done.record()
    return Launch(tuple(host), start, end, done)


def _launch(pb: PackedBatch, rows: Sequence[tuple[int, int]], W: int,
            F: int, reach: bool, device: torch.device) -> Launch:
    """Dispatches one batched search over (segment, start-state) rows
    without waiting for it (drain it with _drain). Every wgl entry point
    funnels through here."""
    row_seg, st0 = pb.rows(list(rows))
    t0 = _time.monotonic_ns()
    packed, rs, s0 = pb.tensors(row_seg, st0, device)
    tel = telemetry.get()
    tel.count("wgl.kernel.h2d_ns", _time.monotonic_ns() - t0)
    tel.count("wgl.kernel.rows", len(row_seg))
    tel.count("wgl.kernel.launches")
    return _run(packed, rs, s0, W, F, pb.M + 4, reach,
                crash_free=not pb.has_crashed)


def _drain(out: Launch, reach: bool):
    """Waits for one launch (on its own `done` event, never on the whole
    device) and records its wait, iteration count and search-shape
    series (frontier occupancy / states explored / dedup hits per BFS
    level), plus a `wgl:drain` span whose attrs carry the rows, the wait
    and the launch's device time between its CUDA events. Returns result
    [B] (reach=False) or (out_mask, unknown) arrays (reach=True)."""
    tel = telemetry.get()
    with tel.span("wgl:drain") as rec:
        t0 = _time.monotonic_ns()
        if out.done is not None:
            out.done.synchronize()
        wait_ns = _time.monotonic_ns() - t0
        if reach:
            mask, unk, it, lvl_live, lvl_new, lvl_dup = out.outs
            res = (mask.numpy(), unk.numpy())
        else:
            r, it, lvl_live, lvl_new, lvl_dup = out.outs
            res = r.numpy()
        n_it = int(it)
        live = lvl_live[:n_it].numpy()
        new = lvl_new[:n_it].numpy()
        dup = lvl_dup[:n_it].numpy()
        device_ms = (out.start.elapsed_time(out.end)
                     if out.start is not None else None)
        rec["attrs"] = {"rows": int(len(res[0] if reach else res)),
                        "levels": n_it, "wait_ns": wait_ns,
                        "device_ms": device_ms}
    peak = int(live.max()) if live.size else 0
    tel.count("wgl.kernel.execute_ns", wait_ns)
    tel.count("wgl.kernel.iterations", n_it)
    tel.count("wgl.search.levels", n_it)
    tel.count("wgl.search.states", int(new.sum()))
    tel.count("wgl.search.dedup-hits", int(dup.sum()))
    if peak:
        tel.gauge_max("wgl.search.frontier-peak", peak)
    return res


def _host_reach(enc: Encoded) -> int:
    """search_host_reach for a row the device left UNKNOWN, counted
    (`wgl.host-resolved-rows`, `wgl.host-resolved-ns`) so a run shows
    what the exact host floor cost it."""
    t0 = _time.monotonic_ns()
    mask = search_host_reach(enc)
    tel = telemetry.get()
    tel.count("wgl.host-resolved-rows")
    tel.count("wgl.host-resolved-ns", _time.monotonic_ns() - t0)
    return mask


def check_batch(encs: Sequence[Encoded], W: int = 32, F: int = 64,
                device=None) -> np.ndarray:
    """Checks a batch of encoded histories on the device. Returns int8 [B]
    (VALID/INVALID/UNKNOWN). UNKNOWN means the fixed-width search couldn't
    decide (window or frontier overflow): the caller host-searches it.
    Raises RangeError for a history past the kernel's range."""
    device = resolve_device(device)
    pb = PackedBatch(encs)
    rows = [(i, e.init_state) for i, e in enumerate(encs)]
    res = _drain(_launch(pb, rows, W, F, reach=False, device=device),
                 reach=False)
    return res[:pb.B]


def check_batch_reach(encs: Sequence[Encoded], W: int = 32, F: int = 32,
                      device=None) -> tuple[np.ndarray, np.ndarray]:
    """Exhaustive reachability over a batch: returns (out_mask uint32 [B]
    — bit s set iff the whole history can linearize ending in state s —
    and unknown bool [B]). Requires every n_states <= 32."""
    device = resolve_device(device)
    if max((e.n_states for e in encs), default=1) > 32:
        raise ValueError("reach mode packs states into a uint32")
    pb = PackedBatch(encs)
    rows = [(i, e.init_state) for i, e in enumerate(encs)]
    out, unk = _drain(_launch(pb, rows, W, F, reach=True, device=device),
                      reach=True)
    return out[:pb.B], unk[:pb.B]


def check_slices(slices: Sequence[tuple[Encoded, int]], W: int = 24,
                 F: int = 48, device=None) -> tuple[np.ndarray, np.ndarray]:
    """The fleet's cross-run batching entry point: packs (encoded slice,
    start state) rows from many tenants' streams into ONE reach launch.
    Distinct rows may share an Encoded (one segment searched from
    several live start states costs one packed history, several rows),
    so slices dedupe by identity before packing. Returns (out_mask
    uint32 [len(slices)], unknown bool [len(slices)]), row i answering
    slices[i]. Requires every n_states <= 32 (reach packs states into a
    uint32).

    A device failure raises. UNKNOWN rows come back unknown for the
    caller to search on the host (search_host_reach), as the fleet does;
    they are counted under `wgl.slices.unknown-rows`."""
    device = resolve_device(device)
    slices = list(slices)
    if not slices:
        return np.empty(0, dtype=np.uint32), np.empty(0, dtype=bool)
    if max(e.n_states for e, _s in slices) > 32:
        raise ValueError("reach mode packs states into a uint32")
    encs: list[Encoded] = []
    idx: dict[int, int] = {}
    rows: list[tuple[int, int]] = []
    for enc, s in slices:
        j = idx.get(id(enc))
        if j is None:
            j = idx[id(enc)] = len(encs)
            encs.append(enc)
        rows.append((j, int(s)))
    pb = PackedBatch(encs)
    out, unk = _drain(_launch(pb, rows, W, F, reach=True, device=device),
                      reach=True)
    out = np.asarray(out[:len(rows)], dtype=np.uint32)
    unk = np.asarray(unk[:len(rows)], dtype=bool)
    telemetry.count("wgl.slices.rows", len(rows))
    telemetry.count("wgl.slices.unknown-rows", int(unk.sum()))
    return out, unk


# ---------------------------------------------------------------------------
# Segment-parallel checking of long histories
# ---------------------------------------------------------------------------

def valid_cut_points(enc: Encoded) -> np.ndarray:
    """Entry indices where a compositional cut is sound: every earlier
    entry completed before this entry invoked (zero ops span the cut),
    so real-time order forces all pre-cut ops before all post-cut ops
    in ANY linearization. Crashed entries (ret=INF) forbid all later
    cuts."""
    m = enc.m
    if m == 0:
        return np.empty(0, dtype=np.int32)
    prefix_max = np.maximum.accumulate(enc.ret_t)
    valid = np.zeros(m, dtype=bool)
    valid[1:] = prefix_max[:-1] < enc.inv_t[1:]
    # int32: entry indices stay < 2^21 (the kernel's rank range), so
    # the 8-byte default index type just doubles the memory traffic
    return np.flatnonzero(valid).astype(np.int32)


def segment_cuts(enc: Encoded, target_len: int = 2048,
                 vcuts: np.ndarray | None = None) -> list[int]:
    """Cut points for compositional checking (see valid_cut_points);
    segments come out a little over target_len, degrading gracefully to
    bigger trailing segments when few cuts exist. Pass vcuts to reuse
    an already-computed valid_cut_points array."""
    m = enc.m
    if m == 0:
        return [0, 0]
    idx = valid_cut_points(enc) if vcuts is None else vcuts
    cuts = [0]
    want = target_len
    while want < m:
        j = np.searchsorted(idx, want)
        if j >= len(idx):
            break
        e = int(idx[j])
        cuts.append(e)
        want = e + target_len
    cuts.append(m)
    return cuts


class _SegmentCheckpoint:
    """CRC-framed (k, s) -> mask log keyed by a fingerprint of the
    history, the transition tables and the cut layout, so a log written
    for other data or another model never poisons a check. The file is
    the JAX package's byte for byte (store/format.py framing, the same
    JSON lines), so either package resumes the other's."""

    def __init__(self, path, enc: Encoded, cuts):
        self.path = Path(path)
        self.fingerprint = self.fingerprint_of(enc, cuts)
        self._known: set = set()
        self._reset_needed = False
        self._opened = False

    @staticmethod
    def fingerprint_of(enc: Encoded, cuts) -> int:
        h = zlib.crc32(enc.inv_t.tobytes())
        h = zlib.crc32(enc.ret_t.tobytes(), h)
        h = zlib.crc32(enc.trans.tobytes(), h)  # model semantics
        h = zlib.crc32(np.asarray(cuts, dtype=np.int64).tobytes(), h)
        return int(h)

    def load(self) -> dict:
        out: dict = {}
        if not self.path.exists():
            return out
        try:
            for payload, _end in sformat._scan_path(self.path):
                d = json.loads(payload)
                if d.get("fp") != self.fingerprint:
                    # other history, model or cuts: restart the file on
                    # the next write, or mixed-fingerprint records would
                    # poison every later load
                    self._reset_needed = True
                    self._known = set()
                    return {}
                out[(d["k"], d["s"])] = d["m"]
        except (OSError, ValueError):
            self._reset_needed = True
            return {}
        self._known = set(out)
        telemetry.count("wgl.checkpoint.loaded", len(out))
        return out

    def _prepare(self):
        """First write: restart a stale or corrupt file, or truncate a
        torn tail so that appends stay readable (a record appended
        after a torn one would hide everything later)."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self._reset_needed or not self.path.exists():
            with open(self.path, "wb") as f:
                f.write(sformat.MAGIC)
            self._reset_needed = False
        else:
            end = sformat._valid_prefix_end(self.path)
            if end == 0:
                with open(self.path, "wb") as f:
                    f.write(sformat.MAGIC)
            elif end < self.path.stat().st_size:
                with open(self.path, "r+b") as f:
                    f.truncate(end)
        self._opened = True

    def save_one(self, k: int, s: int, mask: int) -> None:
        if (k, s) in self._known:
            return
        if not self._opened:
            self._prepare()
        payload = json.dumps({"fp": self.fingerprint, "k": k, "s": s,
                              "m": int(mask)}).encode()
        with open(self.path, "ab") as f:
            f.write(sformat.frame(payload))
        self._known.add((k, s))
        telemetry.count("wgl.checkpoint.saved")

    def save(self, resolved: dict) -> None:
        for (k, s), m in resolved.items():
            if m is not None:
                self.save_one(k, s, m)


def _wave_bounds(K: int, early: bool) -> list[tuple[int, int]]:
    """Segment-index waves for early-exit composition: geometric
    doubling from 4, so a witness at fraction p of the history costs
    O(p) launches + one wave of overshoot, while a valid history pays
    only ~log2(K/4) extra dispatches over the single-launch path.
    Without early exit (or for small K) everything is one wave."""
    if not early or K < 8:
        return [(0, K)]
    out = []
    lo, w = 0, 4
    while lo < K:
        out.append((lo, min(K, lo + w)))
        lo += w
        w *= 2
    return out


def _resolve_wave(enc: Encoded, segs, cuts, vcuts, lo: int, hi: int,
                  S: int, W: int, F: int, prefix_screen: int,
                  resolved: dict, device: torch.device,
                  pad_to: int | None = None) -> None:
    """Resolves every unresolved (segment, start-state) reach mask for
    segments [lo, hi): the device prefix screen first (rows whose
    time-complete prefix proves mask 0 never reach the main launch),
    then ONE batched reach launch over the survivors. UNKNOWN rows of
    the main launch stay None for the caller's lazy host search. pad_to
    pads the wave's packed batch with empty segments so wave launches
    share a few padded shapes."""
    rows: list[tuple[int, int]] = []
    if prefix_screen:
        # All (segment, start-state) prefix rows go up in one small
        # batched reach launch; rare UNKNOWN prefix rows take the exact
        # host search.
        screen_rows: list[tuple[int, int]] = []
        screen_segs: dict[int, tuple] = {}  # k -> (pre_enc, exact)
        for k in range(lo, hi):
            klo, khi = cuts[k], cuts[k + 1]
            j = np.searchsorted(vcuts, klo + prefix_screen)
            pre_end = int(vcuts[j]) if (j < len(vcuts)
                                        and vcuts[j] < khi) else khi
            if (pre_end - klo > 2 * prefix_screen
                    or enc.crashed[klo:pre_end].any()):
                # No NEARBY interior cut (one such "prefix" would pad
                # the whole screen batch up to its length), or crashed
                # entries in the prefix: leave every state to the main
                # launch.
                rows.extend((k, s) for s in range(S)
                            if resolved.get((k, s)) is None)
                continue
            exact = pre_end == khi
            pre = segs[k] if exact else enc.segment(klo, pre_end)
            screen_segs[k] = (pre, exact)
            screen_rows.extend((k, s) for s in range(S)
                               if resolved.get((k, s)) is None)
        if screen_rows:
            ks = sorted(screen_segs)
            kidx = {k: i for i, k in enumerate(ks)}
            launch_rows = [(kidx[k], s) for k, s in screen_rows]
            pre_pb = PackedBatch([screen_segs[k][0] for k in ks])
            p_out, p_unk = _drain(
                _launch(pre_pb, launch_rows, W, F, reach=True,
                        device=device), reach=True)
            p_out = p_out[:len(launch_rows)]
            p_unk = p_unk[:len(launch_rows)]
            for i, (k, s) in enumerate(screen_rows):
                pre, exact = screen_segs[k]
                mask = (_host_reach(pre.with_init(s)) if p_unk[i]
                        else int(p_out[i]))
                if exact:
                    resolved[(k, s)] = mask
                elif mask == 0:
                    resolved[(k, s)] = 0
                else:
                    rows.append((k, s))
    else:
        rows = [(k, s) for k in range(lo, hi) for s in range(S)
                if resolved.get((k, s)) is None]
    if not rows:
        return
    # One packed copy per segment; rows share it via the kernel's
    # row->segment indirection.
    wave_segs = list(segs[lo:hi])
    if pad_to and len(wave_segs) < pad_to:
        empty = enc.segment(cuts[lo], cuts[lo])
        wave_segs += [empty] * (pad_to - len(wave_segs))
    pb = PackedBatch(wave_segs)
    launch_rows = [(k - lo, s) for k, s in rows]
    out, unk = _drain(_launch(pb, launch_rows, W, F, reach=True,
                              device=device), reach=True)
    out = out[:len(launch_rows)]
    unk = unk[:len(launch_rows)]
    for i, (k, s) in enumerate(rows):
        resolved[(k, s)] = None if unk[i] else int(out[i])


def check_segmented(enc: Encoded, target_len: int | None = None,
                    W: int = 24, F: int = 48, witness: bool = False,
                    prefix_screen: int = 96, early_exit: bool = True,
                    device=None, checkpoint_path=None,
                    checkpoint_dir=None) -> dict | None:
    """Checks one long history by cutting it into segments, computing
    per-(segment, start-state) final-state reachability in batched
    device launches, and composing reachability masks across segments.
    Returns None when the history doesn't segment usefully (caller uses
    the whole-history kernel).

    prefix_screen: before the main launch, each (segment, start-state)
    row is screened over the segment's first ~prefix_screen entries
    ENDING AT A VALID CUT — a time-complete sub-history, so
    reach(prefix) == 0 soundly proves reach(segment) == 0. Wrong start
    states die in the prefix, so the main launch runs ~half the rows.

    early_exit: segments resolve in geometric waves composed as they
    land, so an invalid history witnessed at fraction p of the search
    costs ~p of the check. Verdicts, masks, witnesses and certificates
    are identical either way.

    checkpoint_path / checkpoint_dir: persists every resolved
    (segment, start-state) reach mask to a CRC-framed log as it lands
    (after each wave and after each host search), and loads it before
    the first wave, so an interrupted long check resumes without
    searching finished segments again; a mask loaded is not launched.
    The log is keyed by a fingerprint of the history, model and cuts,
    so a log of other data is ignored. checkpoint_dir derives a
    per-fingerprint file name (frontier-<fp>.jlog) in that directory, so
    checkers sharing a store directory never share a file; it is what
    Linearizable.check passes. checkpoint_path names one file instead:
    no caller in this package uses it, and it is kept so that this
    signature is the JAX package's, whose check_segmented takes both (a
    log at a path either package chose resumes in the other)."""
    device = resolve_device(device)
    if enc.n_states > 32:
        # the per-(segment, state) reach masks are uint32 bitmasks
        telemetry.count("wgl.segmented.fallback-states")
        model_name = (type(enc.states[enc.init_state]).__name__
                      if len(enc.states) else "?")
        logger.warning(
            "check_segmented: %s model has %d states (> 32, the "
            "reach-mask width); falling back to the whole-history "
            "search path", model_name, enc.n_states)
        return None
    if target_len is None:
        # long segments amortize the launch best, but small histories
        # still need >= ~8 segments for the batch dimension to exist
        target_len = min(8192, max(256, enc.m // 8))
    vcuts = valid_cut_points(enc)
    cuts = segment_cuts(enc, target_len, vcuts=vcuts)
    K = len(cuts) - 1
    if K < 2:
        return None
    if 2 * max(cuts[k + 1] - cuts[k] for k in range(K)) >= (1 << 21):
        return None  # a segment alone exceeds the kernel range
    S = enc.n_states
    segs = [enc.segment(cuts[k], cuts[k + 1]) for k in range(K)]
    # resolved mask per (segment, start-state); None = device said
    # UNKNOWN, resolved on host ONLY if the composition actually
    # reaches that state (unknown rows are the hardest searches).
    resolved: dict[tuple[int, int], int | None] = {}
    ckpt = None
    if checkpoint_path is not None:
        ckpt = _SegmentCheckpoint(checkpoint_path, enc, cuts)
    elif checkpoint_dir is not None:
        fp = _SegmentCheckpoint.fingerprint_of(enc, cuts)
        ckpt = _SegmentCheckpoint(
            Path(checkpoint_dir) / f"frontier-{fp & 0xffffffff:08x}.jlog",
            enc, cuts)
    if ckpt is not None:
        resolved.update(ckpt.load())
    waves = _wave_bounds(K, early_exit)
    reach = 1 << enc.init_state
    reaches = [reach]  # reachable-state mask entering each segment
    wstate = 0
    failed_k = None
    for lo, hi in waves:
        _resolve_wave(enc, segs, cuts, vcuts, lo, hi, S, W, F,
                      prefix_screen, resolved, device,
                      pad_to=(_next_pow2(hi - lo)
                              if len(waves) > 1 else None))
        if ckpt is not None:
            ckpt.save(resolved)
        for k in range(lo, hi):
            nreach = 0
            for s in range(S):
                if (reach >> s) & 1:
                    mask = resolved.get((k, s))
                    if mask is None:
                        mask = _host_reach(segs[k].with_init(s))
                        resolved[(k, s)] = mask
                        if ckpt is not None:
                            ckpt.save_one(k, s, mask)
                    nreach |= mask
            if nreach == 0:
                failed_k = k
                wstate = next(s for s in range(S) if (reach >> s) & 1)
                break
            reach = nreach
            reaches.append(reach)
        if failed_k is not None:
            if hi < K:
                # segments past the witness's wave were never launched
                telemetry.count("wgl.segmented.early-exit")
                telemetry.gauge(
                    "wgl.segmented.early-exit-frac",
                    round(cuts[hi] / max(enc.m, 1), 4))
            break
    if failed_k is not None:
        k = failed_k
        res: dict = {"valid?": False, "failed-segment": k,
                     "segment-range": [cuts[k], cuts[k + 1]]}
        chain = _reach_chain(resolved, reaches, k, wstate)
        if chain is not None:
            # the reach/choice data a certificate re-derives the
            # pre-witness linearization from (certify.py)
            res["search-chain"] = {"cuts": [int(c) for c in cuts],
                                   "chain": chain}
        if witness:
            w = search_host(segs[k].with_init(wstate), witness=True)
            res.update({kk: v for kk, v in w.items() if kk != "valid?"})
            if "witness-entry" in res:
                # globalize the segment-local stuck entry
                res["witness-entry"] = int(cuts[k] + res["witness-entry"])
                res["entry-count"] = int(enc.m)
        return res
    final_state = next(s for s in range(S) if (reach >> s) & 1)
    chain = _reach_chain(resolved, reaches, K, final_state)
    res = {"valid?": True, "segments": K}
    if chain is not None:
        res["search-chain"] = {"cuts": [int(c) for c in cuts],
                               "chain": chain}
    return res


def _reach_chain(resolved: dict, reaches: list[int], upto: int,
                 final_state: int) -> list[int] | None:
    """A concrete per-segment start-state chain out of the resolved
    reach masks: chain[j] is segment j's start state, chain[upto] =
    final_state, and resolved[(j, chain[j])] contains chain[j+1] for
    every j — the choice data certificates compose per-segment
    linearization orders along. Backward reconstruction; None when a
    mask is missing (shouldn't happen after composition resolved
    them)."""
    chain = [0] * (upto + 1)
    chain[upto] = int(final_state)
    for j in range(upto - 1, -1, -1):
        nxt = chain[j + 1]
        for s in range(32):
            if (reaches[j] >> s) & 1:
                mask = resolved.get((j, s))
                if mask is not None and (mask >> nxt) & 1:
                    chain[j] = s
                    break
        else:
            return None
    return chain


# ---------------------------------------------------------------------------
# Checkpoint-and-extend: incremental re-checking of grown histories
# ---------------------------------------------------------------------------

# The extend path's FIXED cut stride. check_segmented's adaptive
# target_len moves the cut layout whenever the history grows, which
# would orphan every checkpointed mask; a fixed stride makes the greedy
# cut schedule prefix-stable (entries below a valid cut are fixed by
# real time, so the same cuts, and the same reach masks, come out of the
# grown history).
EXTEND_STRIDE = 512


def _extend_fingerprint(enc: Encoded) -> int:
    """The model fingerprint of wgl-extend records: the model class and
    initial state (through the models' value-based reprs). Entry digests
    key the history prefix; this keys the model, so a record written for
    another model or initial value is never reused. Not the transition
    tables' bytes: those depend on the whole history's distinct ops,
    which grow with the suffix; each state's identity is carried by the
    record's "states" reprs instead."""
    init = enc.states[enc.init_state]
    return int(zlib.crc32(f"{type(init).__name__}:{init!r}".encode()))


def _remap_record_masks(record: dict, enc: Encoded,
                        reused_segments: int
                        ) -> dict[tuple[int, int], int] | None:
    """A record's (segment, state) -> mask entries in THIS encoding's
    state indices. A grown history can discover new distinct ops, which
    reorders state discovery: indices move, but the states (model
    objects with stable reprs) do not, and a reach mask is a set of
    model states. None when a recorded state is unknown to this
    encoding (a stale record)."""
    new_idx = {repr(s): i for i, s in enumerate(enc.states)}
    mapping = []
    for key in record["states"]:
        i = new_idx.get(key)
        if i is None:
            return None
        mapping.append(i)
    out: dict[tuple[int, int], int] = {}
    for key, mask in record["masks"].items():
        k_str, s_str = key.split(":")
        k, s = int(k_str), int(s_str)
        if k >= reused_segments or s >= len(mapping):
            continue
        new_mask = 0
        m = int(mask)
        for j in range(len(mapping)):
            if (m >> j) & 1:
                new_mask |= 1 << mapping[j]
        out[(k, mapping[s])] = new_mask
    return out


def check_extend(enc: Encoded, record: dict | None = None,
                 stride: int = EXTEND_STRIDE, W: int = 24, F: int = 48,
                 device=None) -> tuple[dict | None, dict | None]:
    """Segment-composed check with a prefix-stable cut schedule and a
    reusable (segment, state) -> reach-mask frontier. Returns (result,
    new_record); (None, None) when the history does not segment (the
    caller takes the plain paths).

    `record` is a ckpt.py "wgl-extend" record of an earlier check of a
    PREFIX of this history. Reuse is earned: the record's cuts must
    match this history's schedule position by position and digest by
    digest (sha256 over the encoded entries below each cut), so a torn,
    stale or wrong-history record costs a full check, with `ckpt.stale`
    counted when a record was offered and nothing matched. The masks of
    the matched segments are reused as they are; the others are computed
    in ONE check_slices launch on `device`, and its UNKNOWN rows by the
    exact host search. Fresh and resumed runs compose the same exact
    masks through the same composition, so verdicts, search chains and
    certificates (certify.attach_wgl derives them from the search chain)
    are identical by construction."""
    device = resolve_device(device)
    if enc.n_states > 32:
        return None, None
    vcuts = valid_cut_points(enc)
    cuts = segment_cuts(enc, stride, vcuts=vcuts)
    K = len(cuts) - 1
    if K < 2:
        return None, None
    if 2 * max(cuts[k + 1] - cuts[k] for k in range(K)) >= (1 << 21):
        return None, None  # a segment alone exceeds the kernel range
    S = enc.n_states
    digests = ckpt_mod.entry_digest_chain(enc, cuts)
    fp = _extend_fingerprint(enc)

    resolved: dict[tuple[int, int], int] = {}
    if record is not None:
        ok = (record.get("stride") == stride
              and record.get("model_fp") == fp)
        matched = 0
        if ok:
            rcuts, rdigs = record["cuts"], record["digests"]
            limit = min(len(rcuts), len(cuts))
            while matched < limit and rcuts[matched] == cuts[matched] \
                    and rdigs[matched] == digests[matched]:
                matched += 1
        # a segment is reusable when both its cut endpoints matched
        reused_segments = max(0, matched - 1)
        remapped = (_remap_record_masks(record, enc, reused_segments)
                    if reused_segments else None)
        if remapped:
            resolved.update(remapped)
            telemetry.count("ckpt.extend.reused-masks", len(resolved))
            telemetry.count("ckpt.extend.resumed")
        else:
            telemetry.count("ckpt.stale")

    segs = [enc.segment(cuts[k], cuts[k + 1]) for k in range(K)]
    need = [(k, s) for k in range(K) for s in range(S)
            if (k, s) not in resolved]
    if need:
        out, unk = check_slices([(segs[k], s) for k, s in need], W, F,
                                device=device)
        for i, (k, s) in enumerate(need):
            # UNKNOWN rows take the exact host search: resolved masks
            # are always exact, so a resumed composition is the same
            resolved[(k, s)] = (_host_reach(segs[k].with_init(s))
                                if unk[i] else int(out[i]))
    telemetry.count("ckpt.extend.computed-masks", len(need))

    reach = 1 << enc.init_state
    reaches = [reach]
    failed_k = None
    wstate = 0
    for k in range(K):
        nreach = 0
        for s in range(S):
            if (reach >> s) & 1:
                mask = resolved.get((k, s))
                if mask is None:
                    # a reused segment can miss a state the old encoding
                    # never had; the exact host search fills it
                    mask = int(search_host_reach(segs[k].with_init(s)))
                    resolved[(k, s)] = mask
                nreach |= mask
        if nreach == 0:
            failed_k = k
            wstate = next(s for s in range(S) if (reach >> s) & 1)
            break
        reach = nreach
        reaches.append(reach)

    new_record = {
        "v": ckpt_mod.VERSION, "kind": "wgl-extend",
        "stride": int(stride), "model_fp": fp,
        "cuts": [int(c) for c in cuts], "digests": digests,
        "states": [repr(s) for s in enc.states],
        "masks": {f"{k}:{s}": int(m)
                  for (k, s), m in sorted(resolved.items())},
        "n_ops": int(enc.m), "digest": digests[-1],
    }
    if failed_k is not None:
        k = failed_k
        res: dict = {"valid?": False, "failed-segment": k,
                     "segment-range": [cuts[k], cuts[k + 1]]}
        chain = _reach_chain(resolved, reaches, k, wstate)
        if chain is not None:
            res["search-chain"] = {"cuts": [int(c) for c in cuts],
                                   "chain": chain}
        w = search_host(segs[k].with_init(wstate), witness=True)
        res.update({kk: v for kk, v in w.items() if kk != "valid?"})
        if "witness-entry" in res:
            res["witness-entry"] = int(cuts[k] + res["witness-entry"])
            res["entry-count"] = int(enc.m)
        return res, new_record
    final_state = next(s for s in range(S) if (reach >> s) & 1)
    chain = _reach_chain(resolved, reaches, K, final_state)
    res = {"valid?": True, "segments": K}
    if chain is not None:
        res["search-chain"] = {"cuts": [int(c) for c in cuts],
                               "chain": chain}
    return res, new_record


# ---------------------------------------------------------------------------
# Public analysis API (knossos-analysis-shaped results)
# ---------------------------------------------------------------------------

# Below this many entries the whole-history kernel/host search is cheap
# enough that segment-localized witness extraction isn't worth a launch.
SEGMENT_MIN_M = 4096


def _witness_op_indices(out: dict) -> dict:
    """Attaches the participating op (invocation) indices to an
    invalid analysis as out['op-indices'] — anomaly provenance: the
    stuck op, its predecessor, and every pending op in the surviving
    configs. entry_ops are merged invocations, so the indices join the
    per-op trace (optrace.jsonl) and timeline anchors directly."""
    if out.get("valid?") is not False or "op-indices" in out:
        return out
    idxs = set()

    def add(o):
        i = getattr(o, "index", None)
        if i is None and isinstance(o, dict):
            i = o.get("index")
        if isinstance(i, int) and i >= 0:
            idxs.add(i)

    add(out.get("op"))
    add(out.get("previous-ok"))
    for cfg in out.get("configs") or []:
        for o in (cfg.get("pending") or []) if isinstance(cfg, dict) \
                else []:
            add(o)
    out["op-indices"] = sorted(idxs)
    return out


def _seg_kwargs(W: int | None, F: int | None, **extra) -> dict:
    """check_segmented kwargs: only overrides the leaner segmented
    defaults (W=24/F=48) when the caller tuned W/F explicitly."""
    kw = dict(extra)
    if W is not None:
        kw["W"] = W
    if F is not None:
        kw["F"] = F
    return kw


def extract_witness(enc: Encoded, W: int | None = None,
                    F: int | None = None, device=None) -> dict:
    """Bounded witness extraction for a history the device kernel
    flagged INVALID or UNKNOWN.

    For long histories (m >= SEGMENT_MIN_M), localizes the FIRST failing
    segment by reach-mask composition (batched device launches over
    segment x start-state rows) and host-searches only that segment.
    Small or unsegmentable histories take the exact whole-history host
    search. Sets result["witness-extraction"] to 'segmented' or 'host'."""
    device = resolve_device(device)
    if enc.m >= SEGMENT_MIN_M:
        seg = check_segmented(enc, witness=True, device=device,
                              **_seg_kwargs(W, F))
        if seg is not None:
            seg["witness-extraction"] = "segmented"
            return _witness_op_indices(seg)
    out = search_host(enc, witness=True)
    out["witness-extraction"] = "host"
    return _witness_op_indices(out)


def _resolve_row(enc: Encoded, W: int | None, F: int | None,
                 device: torch.device) -> dict:
    """extract_witness for a batch member the card did not answer VALID,
    counted under `wgl.host-resolved-rows` / `wgl.host-resolved-ns`."""
    t0 = _time.monotonic_ns()
    out = extract_witness(enc, W=W, F=F, device=device)
    tel = telemetry.get()
    tel.count("wgl.host-resolved-rows")
    tel.count("wgl.host-resolved-ns", _time.monotonic_ns() - t0)
    return out


def _search_stats(out: dict) -> dict:
    """Attaches out['search'] — the witness-position percentile
    ("nonlinearizable witnessed at 12% of the history") for invalid
    verdicts: the direct input for segment-level early-exit (ROADMAP
    item 3) and the coverage atlas's anomaly-localization ranking."""
    if out.get("valid?") is not False:
        return out
    we = out.get("witness-entry")
    m = out.get("entry-count")
    if we is None and "segment-range" in out:
        we = out["segment-range"][0]
    if we is not None and m:
        out["search"] = {"witness-entry": int(we),
                         "entries": int(m),
                         "witness-position": round(int(we) / int(m),
                                                   4)}
    return out


ALGORITHMS = ("gpu", "wgl", "model")


def analysis(model, hist, algorithm: str = "gpu", W: int | None = None,
             F: int | None = None, certify: bool = False,
             device=None, checkpoint_path=None,
             checkpoint_dir=None) -> dict:
    """Checks a single history against a model.

    algorithm: 'gpu'   — device kernel, host search on UNKNOWN
               'wgl'   — host search over encoded tables
               'model' — host search stepping model objects
    device: None means the CUDA card (raises without one); "cpu" runs
    the kernel's plain PyTorch version.
    Result mirrors knossos analysis maps: {'valid?': bool, 'op': ...,
    'configs': [...], 'analyzer': ...}.

    certify=True additionally attaches a machine-checkable proof of the
    verdict as result['certificate'] (certify.py). checkpoint_path /
    checkpoint_dir go to check_segmented on the segmented path (its
    docstring says which caller takes which)."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm {algorithm!r} is not one of "
                         f"{ALGORITHMS}")
    device = resolve_device(device)
    enc_box: list = [None]
    out = _analysis(model, hist, algorithm, W, F, device, checkpoint_path,
                    checkpoint_dir, enc_box)
    _search_stats(out)
    if certify:
        from . import certify as certify_mod

        certify_mod.attach_wgl(model, hist, enc_box[0], out)
    return out


def analysis_extend(model, hist, store_path=None,
                    stride: int = EXTEND_STRIDE, W: int | None = None,
                    F: int | None = None, certify: bool = False,
                    device=None) -> dict:
    """analysis(), resumable: checks through check_extend's
    prefix-stable segmentation, loading the previous frontier from the
    ckpt.py store at `store_path` and writing the grown frontier back
    after the verdict. Checking a grown history again costs O(suffix); a
    missing, torn, stale or wrong-model record costs a full check, never
    a wrong verdict. Histories that do not segment (too short, more than
    32 states, unencodable) go to analysis() on the same device, counted
    as `ckpt.extend.fallback`, so this is safe wherever analysis() is."""
    device = resolve_device(device)
    if not isinstance(hist, History):
        hist = History(hist)
    enc = None
    try:
        enc = encode(model, hist)
    except EncodingError:
        pass
    out = None
    new_rec = None
    if enc is not None:
        record = None
        if store_path is not None:
            record = ckpt_mod.load(store_path, "wgl-extend")
        out, new_rec = check_extend(enc, record=record, stride=stride,
                                    device=device, **_seg_kwargs(W, F))
    if out is None:
        telemetry.count("ckpt.extend.fallback")
        return analysis(model, hist, algorithm="gpu", W=W, F=F,
                        certify=certify, device=device)
    out["analyzer"] = "gpu-extend"
    _witness_op_indices(out)
    _search_stats(out)
    if store_path is not None and new_rec is not None:
        # a failed write (ENOSPC, EIO) leaves the previous record in
        # place: the next check is slower, and this verdict stands
        ckpt_mod.try_write(store_path, new_rec)
    if certify:
        from . import certify as certify_mod

        certify_mod.attach_wgl(model, hist, enc, out)
    return out


def _analysis(model, hist, algorithm, W, F, device, checkpoint_path=None,
              checkpoint_dir=None, enc_box: list | None = None) -> dict:
    if not isinstance(hist, History):
        hist = History(hist)
    try:
        enc = encode(model, hist)
    except EncodingError:
        out = search_host_model(model, hist, witness=True)
        out["analyzer"] = "model"
        return _witness_op_indices(out)
    if enc_box is not None:
        enc_box[0] = enc  # certificate extraction reuses the encode

    if algorithm == "model":
        out = search_host_model(model, hist, witness=True)
        out["analyzer"] = "model"
        return _witness_op_indices(out)
    if algorithm == "wgl":
        out = search_host(enc, witness=True)
        out["analyzer"] = "wgl"
        return _witness_op_indices(out)

    # Long histories: segment-parallel path. W/F default per path: the
    # prefix-screened segmented search runs leaner (24/48, unknowns
    # resolve on host) than the whole-history kernel (32/64).
    if enc.m >= SEGMENT_MIN_M:
        seg = check_segmented(enc, witness=True, device=device,
                              **_seg_kwargs(W, F,
                                            checkpoint_path=checkpoint_path,
                                            checkpoint_dir=checkpoint_dir))
        if seg is not None:
            seg["analyzer"] = "gpu-segmented"
            return _witness_op_indices(seg)

    try:
        res = int(check_batch([enc], W=W if W is not None else 32,
                              F=F if F is not None else 64,
                              device=device)[0])
    except RangeError:
        out = search_host(enc, witness=True)
        out["analyzer"] = "wgl"
        return _witness_op_indices(out)
    if res == VALID:
        return {"valid?": True, "analyzer": "gpu"}
    if res == INVALID:
        out = search_host(enc, witness=True)  # witness extraction
        out["analyzer"] = "gpu"
        return _witness_op_indices(out)
    telemetry.count("wgl.host-resolved-rows")
    out = search_host(enc, witness=True)
    out["analyzer"] = "gpu+host-fallback"
    return _witness_op_indices(out)


def analysis_batch_streamed(model, hists: Sequence, chunk: int = 256,
                            W: int | None = None, F: int | None = None,
                            certify: bool = False,
                            device=None) -> list[dict]:
    """analysis_batch with host-to-device pipelining: histories are
    encoded and launched chunk by chunk, and since a launch returns
    before its search ends (_launch), chunk i+1's encoding on the host
    overlaps chunk i's search on the card. A one-chunk drain lag keeps
    at most two chunks' buffers live. certify=True attaches a per-result
    verdict certificate (the checker batch path passes it).

    A launch or kernel failure raises. Members the card does not answer
    VALID go to extract_witness (counted as host-resolved rows); a chunk
    past the kernel's position range (RangeError) is UNKNOWN as a whole,
    counted under `wgl.batch.range-chunks`."""
    device = resolve_device(device)
    hists = [hh if isinstance(hh, History) else History(hh) for hh in hists]
    results: list[dict] = [None] * len(hists)  # type: ignore
    certify_mod = None
    if certify:
        from . import certify as certify_mod
    W_run = W if W is not None else 32
    F_run = F if F is not None else 64

    def launch(start):
        encs, idx_map = [], []
        for i in range(start, min(start + chunk, len(hists))):
            try:
                encs.append(encode(model, hists[i]))
                idx_map.append(i)
            except EncodingError:
                out = search_host_model(model, hists[i], witness=True)
                out["analyzer"] = "model"
                results[i] = _witness_op_indices(_search_stats(out))
                if certify_mod is not None:
                    certify_mod.attach_wgl(model, hists[i], None,
                                           results[i])
        if not encs:
            return None
        try:
            pb = PackedBatch(encs)
        except RangeError:
            telemetry.count("wgl.batch.range-chunks")
            return None, encs, idx_map
        rows = [(j, e.init_state) for j, e in enumerate(encs)]
        return (_launch(pb, rows, W_run, F_run, reach=False, device=device),
                encs, idx_map)

    def drain(entry):
        out_dev, encs, idx_map = entry
        res = (_drain(out_dev, reach=False)[:len(encs)]
               if out_dev is not None else [UNKNOWN] * len(encs))
        for j, i in enumerate(idx_map):
            r = int(res[j])
            if r == VALID:
                results[i] = {"valid?": True, "analyzer": "gpu"}
            else:
                out = _resolve_row(encs[j], W, F, device)
                out["analyzer"] = ("gpu" if r == INVALID
                                   else "gpu+host-fallback")
                results[i] = out
            _search_stats(results[i])
            if certify_mod is not None:
                certify_mod.attach_wgl(model, hists[i], encs[j],
                                       results[i])

    pending = None
    for start in range(0, len(hists), chunk):
        entry = launch(start)
        # drain the PREVIOUS chunk now: the current one is already
        # launched, so the card keeps searching while the host decodes
        if pending is not None:
            drain(pending)
        pending = entry
    if pending is not None:
        drain(pending)
    return results


def analysis_batch(model, hists: Sequence, W: int | None = None,
                   F: int | None = None, certify: bool = False,
                   device=None) -> list[dict]:
    """Checks many histories at once (the ensemble path: one device
    launch for the whole batch, the host only for members the card
    does not answer VALID)."""
    hists = list(hists)
    return analysis_batch_streamed(model, hists, chunk=max(len(hists), 1),
                                   W=W, F=F, certify=certify,
                                   device=device)
