"""The sharded ensemble on one card: the port of jepsen_tpu/tpu/ensemble.py.

The JAX package lays the batch dimension of the WGL search (independent
keys, ensemble histories, segments x start-states of one long history)
over a 1-D device mesh: `shard_layout` blocks the packed segment tensors
into per-device groups (LPT-balanced by search work), `shard_map` runs
one frontier search per chip, `pmax`/`psum` combine the iteration count
and the level series, and an `inv_perm` gather restores caller row
order (`_jitted_sharded`, tpu/ensemble.py:54).

On one device that program reduces to the plain search over the
one-device layout: `shard_layout(pb, rows, 1)` keeps only the segments
that rows reference, in ascending order, pads their count to a power of
two with the sentinel at K_loc, and makes `inv_perm` the identity; pmax
and psum over one shard do nothing (csrc/wgl_search.cu already takes the
batch maximum of `it` and sums the level series with integer atomics).
So the launch here is kernels.wgl_search over the layout's tensors,
with the `inv_perm` gather of the per-row results done on the card
before readback. Its multi-GPU form (one launch per card over NCCL) is
ROADMAP A6: more than one device raises NotImplementedError.

Per-row results are bit-identical to wgl.check_batch for any layout: a
search row never reads another row's state. `launches` counts launches
of the kernel made here (on the card only).
"""

from __future__ import annotations

import time as _time
from typing import Sequence

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
from ..history import History
from . import profiler
from . import wgl as wgl_mod
from .encode import Encoded, EncodingError, balanced_groups, encode
from .wgl import PackedBatch, RangeError, _drain, _next_pow2

launches = 0


class _ShardLayout:
    """The per-device blocking of one launch: segment tensors gathered
    into [n_dev * (K_loc + 1), ...] blocks (each device's K_loc
    segments + its own sentinel empty row), rows rebased to local
    segment indices, and the inverse permutation that restores caller
    row order."""

    __slots__ = ("inv_t", "ret_t", "trans", "mseg", "sufmin",
                 "row_seg", "st0", "inv_perm", "n_dev", "n_rows",
                 "device_entries")


def shard_layout(pb: PackedBatch, rows: Sequence[tuple[int, int]],
                 n_dev: int) -> _ShardLayout:
    """Blocks a PackedBatch + its search rows onto n_dev devices (numpy;
    the same arrays as jepsen_tpu's shard_layout for any n_dev).

    Segments are grouped by LPT over estimated search work
    (entries x rows referencing the segment); each device's block
    holds only its own segments. Segments no row references are left
    out."""
    t0 = _time.monotonic_ns()
    rows = list(rows)
    B = pb.B
    n_rows_seg = np.zeros(B + 1, dtype=np.int32)
    for k, _s in rows:
        n_rows_seg[k] += 1
    used = [k for k in range(B) if n_rows_seg[k]]
    weights = [(int(pb.m[k]) + 1) * int(n_rows_seg[k]) for k in used]
    groups = [[used[i] for i in g]
              for g in balanced_groups(weights, n_dev)]
    K_loc = _next_pow2(max((len(g) for g in groups), default=1))
    # device-major gather map; unfilled slots and each device's local
    # sentinel (index K_loc) point at pb's empty row B
    gmap = np.full((n_dev, K_loc + 1), B, dtype=np.int32)
    loc: dict[int, tuple[int, int]] = {}
    for d, g in enumerate(groups):
        for j, k in enumerate(g):
            gmap[d, j] = k
            loc[k] = (d, j)
    flat = gmap.reshape(-1)
    lay = _ShardLayout()
    lay.inv_t = pb.inv_t[flat]
    lay.ret_t = pb.ret_t[flat]
    lay.trans = pb.trans[flat]
    lay.mseg = pb.m[flat]
    lay.sufmin = pb.sufmin[flat]
    # rows per device, caller order preserved within each device
    per: list[list[tuple[int, int]]] = [[] for _ in range(n_dev)]
    where: list[tuple[int, int]] = []
    for k, s in rows:
        d, j = loc[k]
        where.append((d, len(per[d])))
        per[d].append((j, int(s)))
    B_loc = _next_pow2(max((len(p) for p in per), default=1))
    row_seg = np.full(n_dev * B_loc, K_loc, dtype=np.int32)
    st0 = np.zeros(n_dev * B_loc, dtype=np.int32)
    for d, p in enumerate(per):
        for slot, (j, s) in enumerate(p):
            row_seg[d * B_loc + slot] = j
            st0[d * B_loc + slot] = s
    inv_perm = np.zeros(_next_pow2(max(len(rows), 1)), dtype=np.int32)
    for i, (d, slot) in enumerate(where):
        inv_perm[i] = d * B_loc + slot
    lay.row_seg, lay.st0, lay.inv_perm = row_seg, st0, inv_perm
    lay.n_dev, lay.n_rows = n_dev, len(rows)
    lay.device_entries = [
        int(sum(int(pb.m[k]) * int(n_rows_seg[k]) for k in g))
        for g in groups]
    profiler.get().record_host("shard-layout",
                               _time.monotonic_ns() - t0)
    return lay


def one_device(devices=None) -> torch.device:
    """The one device a sharded launch runs on: None means the card; a
    list or tuple may name one device. The mesh form over several cards
    is not ported yet."""
    if isinstance(devices, (list, tuple)):
        if len(devices) > 1:
            raise NotImplementedError(
                f"the sharded ensemble over {len(devices)} devices (the "
                "multi-GPU form over NCCL) is ROADMAP A6; pass one device")
        devices = devices[0] if devices else None
    return resolve_device(devices)


def sharded_launch(pb: PackedBatch, rows: Sequence[tuple[int, int]],
                   W: int, F: int, reach: bool, devices=None):
    """Dispatches one launch over the one-device layout without waiting
    for it (drain with wgl._drain). Outputs answer rows in CALLER order,
    already trimmed to len(rows) by the on-card gather.

    Its profiler record (`wgl-sharded`) carries the per-device work
    attribution (`device_entries`, entries of search work per device)
    and the mean/max `balance` figure, as the JAX package's mesh launch
    does; with one device the balance is 1.0."""
    global launches
    dev = one_device(devices)
    rows = list(rows)
    lay = shard_layout(pb, rows, 1)
    t0 = _time.monotonic_ns()
    K, M = lay.inv_t.shape
    S = lay.trans.shape[2]
    t = wgl_mod._upload([lay.inv_t, lay.ret_t, lay.trans, lay.mseg,
                         lay.sufmin, lay.row_seg, lay.st0, lay.inv_perm],
                        dev)
    packed = (t[0].view(K, M), t[1].view(K, M), t[2].view(K, M, S), t[3],
              t[4].view(K, M + 1))
    h2d_ns = _time.monotonic_ns() - t0
    tel = telemetry.get()
    tel.count("wgl.kernel.h2d_ns", h2d_ns)
    tel.count("wgl.kernel.rows", len(lay.row_seg))
    tel.count("wgl.spmd.launches")
    tel.gauge_max("wgl.spmd.devices", lay.n_dev)
    bucket = ("one-device", lay.inv_t.shape, S, len(lay.row_seg),
              len(lay.inv_perm), W, F, pb.M + 4, reach, pb.has_crashed,
              dev.type)
    meta = {"h2d_ns": h2d_ns, "rows": len(lay.row_seg), "batch": pb.B,
            "m": pb.M, "states": pb.S, "devices": lay.n_dev,
            "device_entries": lay.device_entries,
            "balance": profiler.work_balance(lay.device_entries),
            "W": W, "entries": int(lay.mseg[np.unique(lay.row_seg)].sum())}
    out = wgl_mod._timed_launch(
        bucket, lambda: wgl_mod._run(packed, t[5], t[6], W, F, pb.M + 4,
                                     reach, crash_free=not pb.has_crashed,
                                     gather=t[7][:len(rows)]),
        kernel="wgl-sharded", meta=meta)
    if dev.type == "cuda":
        launches += 1
    return out


def check_batch_sharded(encs: Sequence[Encoded], devices=None, W: int = 32,
                        F: int = 64, reach: bool = False, rows=None):
    """check_batch / check_batch_reach over the ensemble layout. Search
    rows are (segment, start-state) pairs, default one per history.
    Returns result [len(rows)], or (out_mask, unknown) with reach=True."""
    dev = one_device(devices)
    pb = PackedBatch(encs)
    if rows is None:
        rows = [(i, e.init_state) for i, e in enumerate(encs)]
    telemetry.count("wgl.ensemble.launches")
    return _drain(sharded_launch(pb, rows, W, F, reach=reach, devices=dev),
                  reach=reach)


def analysis_batch_sharded(model, hists, devices=None, W: int | None = None,
                           F: int | None = None) -> list[dict]:
    """analysis_batch over the ensemble layout: the ensemble benchmark
    path (BASELINE config 5: 1024 generated histories checked at once).
    Members the card does not answer VALID go to extract_witness."""
    dev = one_device(devices)
    encs, idx_map, results = [], [], [None] * len(hists)
    for i, hh in enumerate(hists):
        if not isinstance(hh, History):
            hh = History(hh)
        try:
            encs.append(encode(model, hh))
            idx_map.append(i)
        except EncodingError:
            out = wgl_mod.search_host_model(model, hh, witness=True)
            out["analyzer"] = "model"
            results[i] = out
    if encs:
        try:
            res = check_batch_sharded(encs, devices=dev,
                                      W=W if W is not None else 32,
                                      F=F if F is not None else 64)
        except RangeError:
            telemetry.count("wgl.batch.range-chunks")
            res = [wgl_mod.UNKNOWN] * len(encs)
        for j, i in enumerate(idx_map):
            r = int(res[j])
            if r == wgl_mod.VALID:
                results[i] = {"valid?": True, "analyzer": "gpu-sharded"}
            else:
                out = wgl_mod._resolve_row(encs[j], W, F, dev)
                out["analyzer"] = ("gpu-sharded" if r == wgl_mod.INVALID
                                   else "gpu+host-fallback")
                results[i] = wgl_mod._search_stats(out)
    return results
