"""The WGL frontier search: wrapper of the CUDA kernel
(csrc/wgl_search.cu) and its plain PyTorch version.

Both compute what jepsen_tpu/tpu/wgl.py:518 `_kernel` computes, output
for output (all integers, so they agree exactly):

  packed = (inv_t int32 [K, M], ret_t int32 [K, M], trans int32 [K, M, S],
            mseg int32 [K], sufmin int32 [K, M+1])
  row_seg, st0: int32 [B] (segment and start state of each search row)

  reach=False -> (result int8 [B] 1 valid / 0 invalid / -1 unknown,
                  it, lvl_live, lvl_new, lvl_dup)
  reach=True  -> (out_mask uint32 [B], unknown bool [B],
                  it, lvl_live, lvl_new, lvl_dup)

`it` is a 0-d int32 tensor (levels run by the longest row) and the level
series are int32 [max_iters], summed over the batch.

wgl_search() launches the kernel for CUDA tensors and runs
wgl_search_reference() for CPU tensors; it never runs the plain version
on the card. `launches` counts kernel launches. The launch is built by
launch_plan(), which the lint (gpu/lint.py) also calls on meta tensors,
and smem_bytes() is the library's shared-memory size computed in Python.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..encode import INF
from . import LaunchPlan, build

BIG = int(INF)  # the "never" position; padding reads as BIG
VALID = 1
INVALID = 0
UNKNOWN = -1
RUNNING = -2

# csrc/wgl_search.cu's kWarps and kSeries: smem_bytes() mirrors the
# library's wgl_search_smem_bytes, so changing one side alone breaks it
_WARPS = 8
_SERIES = 64

launches = 0

_lib_lock = threading.Lock()
_lib_cache: list = []


def _lib() -> ctypes.CDLL:
    with _lib_lock:
        if not _lib_cache:
            lib = build.load("wgl_search")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.wgl_search_launch.argtypes = [p] * 7 + [i] * 8 + [p] * 11
            lib.wgl_search_launch.restype = i
            lib.wgl_search_smem_bytes.argtypes = [i, i, i]
            lib.wgl_search_smem_bytes.restype = ctypes.c_size_t
            lib.wgl_search_error_string.argtypes = [i]
            lib.wgl_search_error_string.restype = ctypes.c_char_p
            _lib_cache.append(lib)
        return _lib_cache[0]


def _check(packed, row_seg, st0, W, F, max_iters, reach):
    inv_t, ret_t, trans, mseg, sufmin = packed
    tensors = {"inv_t": inv_t, "ret_t": ret_t, "trans": trans,
               "mseg": mseg, "sufmin": sufmin, "row_seg": row_seg,
               "st0": st0}
    dev = inv_t.device
    for name, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, inv_t on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if inv_t.dim() != 2:
        raise ValueError("inv_t must be [K, M]")
    K, M = inv_t.shape
    if (ret_t.shape != (K, M) or trans.dim() != 3
            or trans.shape[:2] != (K, M) or mseg.shape != (K,)
            or sufmin.shape != (K, M + 1)):
        raise ValueError("packed tables disagree on [K, M]: "
                         f"{[tuple(t.shape) for t in packed]}")
    if row_seg.dim() != 1 or st0.shape != row_seg.shape:
        raise ValueError("row_seg and st0 must both be [B]")
    if not 1 <= W <= 32:
        raise ValueError(f"W={W}: the window mask is 32 bits")
    if F < 1 or max_iters < 0:
        raise ValueError(f"F={F}, max_iters={max_iters}")
    if reach and trans.shape[2] > 32:
        raise ValueError("reach mode packs states into a uint32 (S <= 32)")


def _successor_slots(W: int, F: int, crash_free: bool) -> int:
    cap = F * W * (1 if crash_free else 2)
    n = 1
    while n < cap:
        n <<= 1
    return n


def _ring_entries(W: int) -> int:
    r = 64
    while r < 4 * W:
        r <<= 1
    return r


def smem_bytes(W: int, F: int, crash_free: bool) -> int:
    """The dynamic shared memory one block of the search takes, in bytes,
    as the library's wgl_search_smem_bytes computes it: the successor
    buffer (a u64 key and an int state a slot), the frontier, the scan's
    partial sums, the level series and the ring."""
    return (_successor_slots(W, F, crash_free) * (8 + 4) + F * 3 * 4
            + _WARPS * 4 + _SERIES * 3 * 4 + _ring_entries(W) * 3 * 4)


def library_smem_bytes(W: int, F: int, crash_free: bool) -> int:
    """The library's own answer to smem_bytes() (builds it if needed)."""
    return int(_lib().wgl_search_smem_bytes(W, F, int(crash_free)))


def launch_plan(packed, row_seg, st0, W: int, F: int, max_iters: int,
                reach: bool = False, crash_free: bool = False
                ) -> LaunchPlan:
    """The launch wgl_search() makes on CUDA tensors: the inputs checked,
    the outputs allocated on the inputs' device (zeroed where the library
    accumulates into them) and the call's parameters."""
    _check(packed, row_seg, st0, W, F, max_iters, reach)
    inv_t, ret_t, trans, mseg, sufmin = packed
    dev = inv_t.device
    B = row_seg.shape[0]
    return LaunchPlan(
        args={"inv_t": inv_t, "ret_t": ret_t, "trans": trans,
              "mseg": mseg, "sufmin": sufmin, "row_seg": row_seg,
              "st0": st0},
        outputs={
            "result": torch.empty(B, dtype=torch.int8, device=dev),
            "out_mask": torch.empty(B, dtype=torch.uint32, device=dev),
            "unknown": torch.empty(B, dtype=torch.bool, device=dev),
            "it": torch.zeros((), dtype=torch.int32, device=dev),
            "lvl": torch.zeros((3, max(max_iters, 1)), dtype=torch.int32,
                               device=dev)},
        params={"B": B, "M": inv_t.shape[1], "S": trans.shape[2], "W": W,
                "F": F, "max_iters": max_iters, "reach": int(reach),
                "crash_free": int(crash_free)},
        smem_bytes=smem_bytes(W, F, crash_free))


def _submit(lib, plan: LaunchPlan, path_levels, stream, ev_start,
            ev_end) -> int:
    """Calls wgl_search_launch with the plan's tensors and parameters in
    the C signature's order; returns its CUDA error code."""
    o = plan.outputs
    lvl = o["lvl"]
    return lib.wgl_search_launch(
        *(t.data_ptr() for t in plan.args.values()), *plan.params.values(),
        o["result"].data_ptr(), o["out_mask"].data_ptr(),
        o["unknown"].data_ptr(), o["it"].data_ptr(), lvl[0].data_ptr(),
        lvl[1].data_ptr(), lvl[2].data_ptr(),
        None if path_levels is None else path_levels.data_ptr(), stream,
        ev_start, ev_end)


def wgl_search(packed, row_seg, st0, W: int, F: int, max_iters: int,
               reach: bool = False, crash_free: bool = False,
               path_levels: torch.Tensor | None = None, events=None):
    """The batched frontier search (see the module docstring).

    path_levels, an int32 [3] tensor on the inputs' CUDA device, gets the
    kernel's count of levels finished on its warp path (no block barrier,
    [0]), on its block path ([1]) and of the warp-path levels that sorted
    because more than F successors were unique ([2]) added, summed over
    the rows. It describes the kernel's schedule, not the search, so the
    plain version has no such count: it is refused with CPU tensors.

    events, a (start, end) pair of torch.cuda.Event(enable_timing=True),
    are recorded on the stream just before and just after the kernel, so
    that start.elapsed_time(end) is the kernel's time alone, whatever
    the host does around the call. Refused with CPU tensors."""
    global launches
    dev = packed[0].device
    if path_levels is not None and (
            path_levels.dtype != torch.int32 or path_levels.shape != (3,)
            or path_levels.device != dev or dev.type != "cuda"):
        raise ValueError("path_levels must be an int32 [3] tensor on the "
                         f"inputs' CUDA device, got {path_levels.dtype} "
                         f"{tuple(path_levels.shape)} on "
                         f"{path_levels.device} (inputs on {dev})")
    if events is not None and dev.type != "cuda":
        raise ValueError(f"events time a launch on the card, not on {dev}")
    if dev.type == "cpu":
        _check(packed, row_seg, st0, W, F, max_iters, reach)
        return wgl_search_reference(packed, row_seg, st0, W, F, max_iters,
                                    reach=reach, crash_free=crash_free)
    if dev.type != "cuda":
        raise ValueError(f"wgl_search runs on cuda or cpu, not {dev}")
    # the plan checks the inputs
    plan = launch_plan(packed, row_seg, st0, W, F, max_iters, reach=reach,
                       crash_free=crash_free)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ev_start, ev_end = build.event_handles(events)
        rc = _submit(lib, plan, path_levels, stream, ev_start, ev_end)
    if rc != 0:
        raise RuntimeError(
            f"wgl_search launch failed: CUDA error {rc} "
            f"({lib.wgl_search_error_string(rc).decode()}); {plan.params} "
            f"shared memory {plan.smem_bytes} bytes")
    if plan.params["B"]:
        # the checkers of a composed check launch from worker threads
        with _lib_lock:
            launches += 1
    o = plan.outputs
    lvl = o["lvl"][:, :max_iters]
    if reach:
        return o["out_mask"], o["unknown"], o["it"], lvl[0], lvl[1], lvl[2]
    return o["result"], o["it"], lvl[0], lvl[1], lvl[2]


def wgl_search_reference(packed, row_seg, st0, W: int, F: int,
                         max_iters: int, reach: bool = False,
                         crash_free: bool = False, on_level=None):
    """The plain PyTorch version: a Python loop over BFS levels with
    tensor ops over [B, F, W] per level, on whatever device the inputs
    lie. Masks ride in int64 (values < 2^32), so sorting the key
    p*2^32 + mask orders masks as unsigned.

    on_level(it, p, mask, live), if given, sees every level's frontier
    as kept (int64 [B, F] positions and masks, bool [B, F] live flags):
    the start (it = 0), then after each level the F smallest unique
    successors (it + 1), before those at the segment's end retire. It
    lets a test check the invariants the kernel rests on."""
    inv_t, ret_t, trans, mseg, sufmin = packed
    dev = inv_t.device
    i64 = torch.int64
    K, M = inv_t.shape
    S = trans.shape[2]
    B = row_seg.shape[0]
    seg = row_seg.to(i64)
    m = mseg.to(i64)[seg]                                      # [B]
    # BIG / -1 padding past M, so p+w and p+W read as out of range
    pad = W + 1
    inv_p = torch.cat([inv_t.to(i64),
                       torch.full((K, pad), BIG, dtype=i64, device=dev)], 1)
    ret_p = torch.cat([ret_t.to(i64),
                       torch.full((K, pad), BIG, dtype=i64, device=dev)], 1)
    suf_p = torch.cat([sufmin.to(i64),
                       torch.full((K, pad), BIG, dtype=i64, device=dev)], 1)
    tr_p = torch.cat([trans.to(i64),
                      torch.full((K, pad, S), -1, dtype=i64, device=dev)], 1)
    ar_w = torch.arange(W, dtype=i64, device=dev)
    bit_w = torch.ones_like(ar_w) << ar_w
    ar_s = torch.arange(S, dtype=i64, device=dev)
    seg2, seg3 = seg[:, None], seg[:, None, None]

    s0 = st0.to(i64)
    result = torch.where(m == 0, VALID, RUNNING)
    out_mask = torch.where(
        m == 0, torch.ones_like(s0) << torch.clamp(s0 & 0xFFFFFFFF, max=31),
        0)
    p = torch.full((B, F), BIG, dtype=i64, device=dev)
    p[:, 0] = torch.where(result == RUNNING, 0, BIG)
    mask = torch.zeros((B, F), dtype=i64, device=dev)
    st = torch.zeros((B, F), dtype=i64, device=dev)
    st[:, 0] = s0
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    lvl = torch.zeros((3, max_iters), dtype=torch.int32, device=dev)
    it = 0
    if on_level is not None:
        on_level(it, p, mask, p < BIG)
    while it < max_iters and bool((result == RUNNING).any()):
        live = p < BIG                                         # [B, F]
        pc = torch.where(live, p, 0)
        idx = pc[:, :, None] + ar_w                            # [B, F, W]
        inv_w = inv_p[seg3, idx]
        ret_w = ret_p[seg3, idx]
        unlin = (((mask[:, :, None] >> ar_w) & 1) == 0) & (inv_w < BIG)
        minret = torch.minimum(torch.where(unlin, ret_w, BIG).amin(2),
                               suf_p[seg2, pc + W])
        cand = unlin & (inv_w < minret[:, :, None])
        cfg_ovf = live & (inv_p[seg2, pc + W] < minret)
        st_ok = (st >= 0) & (st < S)
        st_nxt = torch.where(
            st_ok[:, :, None],
            tr_p[seg3, idx, torch.where(st_ok, st, 0)[:, :, None]], 0)
        nmask = mask[:, :, None] | bit_w
        # trailing ones of nmask = index of its lowest hole; frexp's
        # exponent is exact where a float log2 may round down on a card
        holes = ~nmask & 0xFFFFFFFF
        low = (holes & -holes).clamp(min=1)
        t = torch.where(holes == 0, W,
                        torch.frexp(low.to(torch.float64)).exponent - 1)
        s_p = p[:, :, None] + t
        s_mask = torch.where(t >= W, 0, nmask >> t)
        gate = (live & ~cfg_ovf & (result == RUNNING)[:, None])[:, :, None]
        ok0 = cand & (st_nxt >= 0) & gate
        gen_n = int(ok0.sum())
        if crash_free:
            sp = torch.where(ok0, s_p, BIG).reshape(B, -1)
            sm = torch.where(ok0, s_mask, 0).reshape(B, -1)
            ss = torch.where(ok0, st_nxt, 0).reshape(B, -1)
        else:
            ok1 = cand & (ret_w == BIG) & gate
            gen_n += int(ok1.sum())
            sp = torch.stack([torch.where(ok0, s_p, BIG),
                              torch.where(ok1, s_p, BIG)], 3).reshape(B, -1)
            sm = torch.stack([torch.where(ok0, s_mask, 0),
                              torch.where(ok1, s_mask, 0)], 3).reshape(B, -1)
            ss = torch.stack([torch.where(ok0, st_nxt, 0),
                              torch.where(ok1, st[:, :, None].expand_as(
                                  st_nxt), 0)], 3).reshape(B, -1)
        # lexicographic (p, mask, state): stable sort by state, then key
        key = (sp << 32) | sm
        order = torch.argsort(ss, dim=1, stable=True)
        key, ss = key.gather(1, order), ss.gather(1, order)
        order = torch.argsort(key, dim=1, stable=True)
        key, ss = key.gather(1, order), ss.gather(1, order)
        sp = key >> 32
        uniq = (key != key.roll(1, 1)) | (ss != ss.roll(1, 1))
        uniq[:, 0] = True
        uniq &= sp < BIG
        n_uniq = uniq.sum(1)                                   # [B]
        rank = uniq.cumsum(1) - 1
        rows, cols = torch.nonzero(uniq & (rank < F), as_tuple=True)
        dst = rank[rows, cols]
        p = torch.full((B, F), BIG, dtype=i64, device=dev)
        mask = torch.zeros((B, F), dtype=i64, device=dev)
        st = torch.zeros((B, F), dtype=i64, device=dev)
        p[rows, dst] = sp[rows, cols]
        mask[rows, dst] = key[rows, cols] & 0xFFFFFFFF
        st[rows, dst] = ss[rows, cols]
        if on_level is not None:
            on_level(it + 1, p, mask, p < BIG)

        done = (p < BIG) & (p >= m[:, None])                    # [B, F]
        new_ovf = ovf | (cfg_ovf & live).any(1) | (n_uniq > F)
        was_running = result == RUNNING
        if reach:
            reached = (done[:, :, None]
                       & (st[:, :, None] == ar_s)).any(1)      # [B, S]
            bits = torch.where(reached, torch.ones_like(ar_s) << ar_s,
                               0).sum(1)
            out_mask = torch.where(was_running, out_mask | bits, out_mask)
            p = torch.where(done, BIG, p)
            empty = ~(p < BIG).any(1)
            result = torch.where(
                was_running & empty,
                torch.where(new_ovf, UNKNOWN, INVALID), result)
        else:
            succeeded = done.any(1)
            result = torch.where(was_running & succeeded, VALID, result)
            result = torch.where(
                was_running & ~succeeded & (n_uniq == 0),
                torch.where(new_ovf, UNKNOWN, INVALID), result)
        p = torch.where((result != RUNNING)[:, None], BIG, p)
        ovf = new_ovf
        new_n = int(n_uniq.sum())
        lvl[0, it] = int(live.sum())
        lvl[1, it] = new_n
        lvl[2, it] = max(gen_n - new_n, 0)
        it += 1
    result = torch.where(result == RUNNING, UNKNOWN, result)
    it_t = torch.tensor(it, dtype=torch.int32, device=dev)
    if reach:
        unknown = (result == UNKNOWN) | ovf
        return (out_mask.to(torch.uint32), unknown, it_t,
                lvl[0], lvl[1], lvl[2])
    return result.to(torch.int8), it_t, lvl[0], lvl[1], lvl[2]
