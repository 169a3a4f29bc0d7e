"""Device-mesh sharding of the WGL search: the port of
jepsen_tpu/tpu/ensemble.py.

The JAX package lays the batch dimension of the WGL search (independent
keys, ensemble histories, segments x start-states of one long history)
over a 1-D device mesh: `shard_layout` blocks the packed segment tensors
into per-device groups (LPT-balanced by search work), `shard_map` runs
one frontier search per chip, `pmax`/`psum` combine the iteration count
and the level series, and an `inv_perm` gather restores caller row
order (`_jitted_sharded`, tpu/ensemble.py:54).

Here the mesh is gpu/spmd.py's: one shard per entry, each on its own
device (a card, or the CPU for the plain version), and shards may share
a device. `sharded_launch` makes one kernels.wgl_search launch per
shard d over its block of the layout (segments [d*(K_loc+1),
(d+1)*(K_loc+1)), rows [d*B_loc, (d+1)*B_loc)), all put in flight
before any is drained; each ends when its own rows resolve, as
shard_map's local while_loop does. Then, on the device of the first
shard, `it` is the max over the shards and the level series their sum
(pmax and psum), and the per-row results go back into caller order
through `inv_perm`. In a process group (gpu/dist.py) each rank launches
the shards it owns, then one all_gather carries the per-row results and
one all_reduce the search statistics.

On one device the layout keeps only the segments that rows reference,
in ascending order, with the sentinel at K_loc and `inv_perm` the
identity, and the launch is the one-device launch of earlier slices.
Per-row results are bit-identical to wgl.check_batch for any mesh: a
search row never reads another row's state, so blocking and padding
change nothing but the wall clock. `launches` counts launches of the
kernel made here (on the card only).
"""

from __future__ import annotations

import time as _time
from typing import Sequence

import numpy as np
import torch

from .. import telemetry
from ..history import History
from . import dist, profiler, spmd
from . import wgl as wgl_mod
from .encode import Encoded, EncodingError, balanced_groups, encode
from .wgl import PackedBatch, RangeError, _drain, _next_pow2

# The sharded program's argument names, in signature order (the
# partition-rule table in gpu/spmd.py keys off these; the lint registry
# traces the same layout).
SHARD_ARGS = ("inv_t", "ret_t", "trans", "mseg", "sufmin",
              "row_seg", "st0", "inv_perm")

launches = 0


def default_mesh(n_devices: int | None = None) -> spmd.Mesh:
    """A 1-D mesh over the first n (default: every) cards, honouring the
    SPMD knobs (JEPSEN_TPU_SPMD / _SPMD_DEVICES): with sharding disabled
    or capped, the explicitly sharded entry points get a smaller mesh,
    so JEPSEN_TPU_SPMD=0 gives the differential reference everywhere.
    In a process group (gpu/dist.py) 'every' spans every rank's cards.
    Asking for more cards than there are gives them all."""
    dist.ensure_initialized()
    if n_devices is None:
        n_devices = max(1, spmd.spmd_devices())
    return spmd.mesh_for(n_devices)


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


def _shard_upload(lay, d: int, dev: torch.device):
    """Shard d's block of the layout on `dev`, in one copy: (packed
    segment tensors, row_seg, st0)."""
    n = lay.n_dev
    k1 = lay.inv_t.shape[0] // n
    b = len(lay.row_seg) // n
    seg, row = slice(d * k1, (d + 1) * k1), slice(d * b, (d + 1) * b)
    M, S = lay.inv_t.shape[1], lay.trans.shape[2]
    t = wgl_mod._upload([lay.inv_t[seg], lay.ret_t[seg], lay.trans[seg],
                         lay.mseg[seg], lay.sufmin[seg], lay.row_seg[row],
                         lay.st0[row]], dev)
    return ((t[0].view(k1, M), t[1].view(k1, M), t[2].view(k1, M, S), t[3],
             t[4].view(k1, M + 1)), t[5], t[6])


def _as_int32(o: torch.Tensor) -> torch.Tensor:
    """A per-row result as int32 (uint32 masks by their bits), the one
    dtype the collectives and the gather below take."""
    return o.view(torch.int32) if o.dtype == torch.uint32 else \
        o.to(torch.int32)


def _combine(mesh: spmd.Mesh, lay, shard_outs: list, n_res: int,
             max_iters: int):
    """(per-row results [n_res][n_dev * B_loc] int32 in shard order,
    it, level series [3][max_iters]) on this rank's home device: the
    results concatenated, `it` the max (pmax) and the series the sum
    (psum) over the shards; across ranks, one all_gather of the results
    and one all_reduce of the statistics."""
    home = mesh.home()
    b = len(lay.row_seg) // lay.n_dev
    mine = mesh.local()
    res = [torch.cat([_as_int32(o[i]).to(home) for o in shard_outs])
           if shard_outs else torch.zeros(0, dtype=torch.int32, device=home)
           for i in range(n_res)]
    L = max(max_iters, 1)
    # it and the three level series in one [4, L] block: row 0 marks the
    # levels each shard ran, so that the count of marked levels of the
    # sum is the max of the shards' `it`
    stats = torch.zeros((4, L), dtype=torch.int32, device=home)
    for o in shard_outs:
        it = o[n_res].to(home)
        stats[0] += (torch.arange(L, device=home) < it).to(torch.int32)
        for j in range(3):
            stats[1 + j] += o[n_res + 1 + j].to(home)
    if dist.world_size() > 1:
        # every rank sends as many shard blocks as the rank owning the
        # most, padded; the blocks then land at their shards' places
        most = max(mesh.ranks.count(r) for r in range(dist.world_size()))
        full = []
        for r_i in range(n_res):
            mine_pad = torch.zeros(most * b, dtype=torch.int32, device=home)
            mine_pad[:len(mine) * b] = res[r_i]
            got = dist.all_gather(mine_pad)
            out = torch.zeros(lay.n_dev * b, dtype=torch.int32, device=home)
            for r, blk in enumerate(got):
                own = [d for d, rr in enumerate(mesh.ranks) if rr == r]
                for j, d in enumerate(own):
                    out[d * b:(d + 1) * b] = blk[j * b:(j + 1) * b]
            full.append(out)
        res = full
        dist.all_reduce_(stats, "sum")
    elif len(mine) != lay.n_dev:
        raise ValueError(f"{mesh} has shards of other ranks, and this "
                         "process is no rank of a group")
    it = (stats[0] > 0).sum(dtype=torch.int32)
    return res, it, stats[1:]


def sharded_launch(pb: PackedBatch, rows: Sequence[tuple[int, int]],
                   W: int, F: int, reach: bool, mesh,
                   kernel: str = "wgl-sharded"):
    """Dispatches one launch over the mesh's layout (a Mesh, a device or
    a device list) without waiting for it (drain with wgl._drain).
    Outputs answer rows in CALLER order, already trimmed to len(rows) by
    the gather. Every input, inv_perm included, is uploaded before the
    first shard launches, so in one process nothing here waits on the
    card (a gloo group's collectives go through the host).

    Its profiler record (`kernel`: `wgl-sharded`, or `wgl`/`wgl-reach`
    when wgl._launch routes here) carries the per-device work
    attribution (`device_entries`, entries of search work per device)
    and the mean/max `balance` figure, as the JAX package's does."""
    rows = list(rows)
    mesh = spmd.as_mesh(mesh)
    n_dev = mesh.size
    lay = shard_layout(pb, rows, n_dev)
    home = mesh.home()
    k1 = lay.inv_t.shape[0] // n_dev
    b = len(lay.row_seg) // n_dev
    n_res = 2 if reach else 1
    max_iters = pb.M + 4
    # global shard-block index of each row: its segment's and its own
    gseg = (np.arange(n_dev * b) // b) * k1 + lay.row_seg
    tel = telemetry.get()
    tel.count("wgl.kernel.rows", len(lay.row_seg))
    tel.count("wgl.spmd.launches")
    tel.gauge_max("wgl.spmd.devices", n_dev)
    bucket = ("one-device" if n_dev == 1 else "mesh",
              (k1, lay.inv_t.shape[1]), lay.trans.shape[2], b,
              len(lay.inv_perm), W, F, max_iters, reach, pb.has_crashed,
              home.type)
    meta = {"rows": len(lay.row_seg), "batch": pb.B, "m": pb.M,
            "states": pb.S, "devices": n_dev,
            "device_entries": lay.device_entries,
            "balance": profiler.work_balance(lay.device_entries),
            "W": W, "entries": int(lay.mseg[np.unique(gseg)].sum())}

    t0 = _time.monotonic_ns()
    shards = [_shard_upload(lay, d, mesh.devices[d]) for d in mesh.local()]
    idx = wgl_mod._upload([lay.inv_perm[:len(rows)]], home)[0]
    meta["h2d_ns"] = h2d_ns = _time.monotonic_ns() - t0
    tel.count("wgl.kernel.h2d_ns", h2d_ns)

    def dispatch():
        # every shard's launch in flight before anything waits on one
        global launches
        shard_outs, events, held = [], [], 0
        for packed, rs, s0 in shards:
            run = wgl_mod._run(packed, rs, s0, W, F, max_iters, reach,
                               crash_free=not pb.has_crashed, to_host=False)
            if rs.device.type == "cuda":
                launches += 1
            shard_outs.append(run.outs)
            events += run.events
            held += run.held
        res, it, lvl = _combine(mesh, lay, shard_outs, n_res, max_iters)
        outs = tuple(r.index_select(0, idx) for r in res)
        outs = (outs[0].view(torch.uint32), outs[1].to(torch.bool)) \
            if reach else (outs[0].to(torch.int8),)
        held += wgl_mod._nbytes((idx, *outs))
        return wgl_mod._to_host(outs + (it, lvl[0], lvl[1], lvl[2]),
                                events, held)

    return wgl_mod._timed_launch(bucket, dispatch, kernel=kernel, meta=meta)


def check_batch_sharded(encs: Sequence[Encoded], mesh=None, W: int = 32,
                        F: int = 64, reach: bool = False, rows=None):
    """check_batch / check_batch_reach across a device mesh (None: the
    default mesh over the cards; a Mesh, one device, or a device list).
    Search rows are (segment, start-state) pairs, default one per
    history. Returns result [len(rows)], or (out_mask, unknown) with
    reach=True."""
    mesh = default_mesh() if mesh is None else spmd.as_mesh(mesh)
    pb = PackedBatch(encs)
    if rows is None:
        rows = [(i, e.init_state) for i, e in enumerate(encs)]
    telemetry.count("wgl.ensemble.launches")
    return _drain(sharded_launch(pb, rows, W, F, reach=reach, mesh=mesh,
                                 kernel="wgl-sharded"), reach=reach)


def analysis_batch_sharded(model, hists, mesh=None, W: int | None = None,
                           F: int | None = None) -> list[dict]:
    """analysis_batch across a mesh: the ensemble benchmark path
    (BASELINE config 5: 1024 generated histories checked at once).
    Members the mesh does not answer VALID go to extract_witness on the
    mesh's first device."""
    mesh = default_mesh() if mesh is None else spmd.as_mesh(mesh)
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
            res = check_batch_sharded(encs, mesh=mesh,
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
                out = wgl_mod._resolve_row(encs[j], W, F, mesh.devices[0])
                out["analyzer"] = ("gpu-sharded" if r == wgl_mod.INVALID
                                   else "gpu+host-fallback")
                results[i] = wgl_mod._search_stats(out)
    return results
