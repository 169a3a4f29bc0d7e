#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, nvcc under
/usr/local/cuda (or on PATH) and PyTorch built for CUDA. It

  1. prints the card (nvidia-smi name and power limit), the toolchain and
     the compute capability, which must be 9.0;
  2. builds every kernel from jepsen_tpu_torch/gpu/kernels/csrc;
  3. holds the wgl_search kernel against its plain PyTorch version on the
     card, on seeded histories (verdict and reach mode, with and without
     crashes, a window/frontier overflow case, segment rows with an empty
     segment, one long segment of ~12k entries at M = 16384 crash-free
     at W=32 and crashed, so the kernel's shared-memory ring wraps ~93
     times, a register over 600 values, so S = 512 states), prints the
     levels each case finished on the kernel's warp path and on its
     block path and the warp-path levels that sorted, and fails unless
     all three ran; on 128 crashed 400-op ensemble rows at W=32, F=64 (over 48 KB of shared memory a block),
     and on one launch over a one-device ensemble layout with
     unreferenced and repeated segments (against the plain version and a
     numpy gather): zero mismatches allowed, every output is an integer;
  4. drives the main path: a 1M-event CAS-register history
     (register_history(500_000, n_procs=5, seed=42)) through encode and
     check_segmented(target_len=8192) on the card, with the kernel launch
     count set to 0 just before and read just after; it must come back
     valid with >= 40 segments, and the same history corrupted at 85%
     must come back invalid, with the failed segment unreachable from its
     composed start state under the host search;
  5. cross-checks the slice on a ~40k-event history: check_segmented on
     the card equals check_segmented on the CPU (the plain kernel), and
     analysis(certify=True) / the linearizable checker on the card give
     certificates the port's validator accepts;
  6. replays the main path's kernel launches to time the kernel and its
     plain version on them;
  7. holds the scc and bank_reduce kernels against their plain PyTorch
     versions on the card: seeded graphs (many large components, edge-mask
     subsets, a 3,000-node decreasing chain that hits SWEEP_CAP, one above
     DEVICE_MIN_EDGES, chains of 100 and 800 ten-node cycles; every graph that
     hits a cap also through the convergence launch, the launch scc()
     makes after a cap hit, against its plain version on the CPU and
     scipy's labels, with its rounds, sweeps, trim passes and grid syncs)
     and seeded balance matrices (one row past 2^31; 1, 2, 3, 32 and 100
     columns, also starting 8 bytes off the 16-byte grid); zero
     mismatches allowed in labels, ok, rounds, sweeps, trim passes, sums,
     flags; then times the convergence launch alone on a 100,000-node
     decreasing chain, a 100,000-node cycle, chains of 100, 800 and 2,000
     ten-node cycles and a
     100,000-node graph of large components joined to a decreasing chain
     and, through Edges.scc, a 20,001-node decreasing chain joined to a
     forward chain of 20,001 edges (one capped launch, one convergence
     launch), each held against scipy's labels;
  8. drives the Elle path at full size through the checkers, with the scc
     launch count set to 0 just before each check and read just after:
     list_append_history(100_000, seed=11) through append_checker must be
     valid with >= 1 launch, its twin with one read damaged at 85% must be
     invalid with G0 and 5 launches, rw_register_history(100_000, seed=17)
     through wr_checker must be valid; every certificate must validate,
     and every SCC of these checks must be solved by one launch of the
     kernel (no host path, no cap hit, no degradation);
  9. cross-checks the Elle path on 20,000 txns, both families, valid and
     corrupted: the device engine on the card equals the device engine on
     the CPU (the plain kernel) and the host engine;
 10. drives the bank path: bank_history(500_000, n_accounts=32, seed=11)
     through check_fast on the card must be valid with the bank_reduce
     kernel launched, and a twin with one balance raised by 1 at 85% must
     give the numpy fold's first error;
 11. replays the Elle and bank main paths' launches to time both kernels,
     their plain versions and (bank) the PyTorch reduction, prints the scc
     rounds, sweeps, grid syncs and live edges per round of each launch
     (the bytes of its bound are counted from them), bank_reduce's time
     back to back and with L2 flushed before each launch, and both
     kernels' ptxas registers and spills;
 12. drives the ensemble, BASELINE config 5: 1,024 histories of
     register_history(400, n_procs=4, seed=1000+i, crash_p=0.15) through
     analysis_batch_streamed(chunk=128) three times (all valid, 8 launches
     a run), analysis_batch (one launch) and analysis_batch_sharded (one
     launch of the one-device ensemble form), with the launch counts set
     to 0 just before each and read just after; a twin with member 700
     corrupted at 30% must be invalid at member 700 only, with a witness,
     and member 700 corrupted at 85% must not come back VALID from the
     card (TWIN_AT_FRAC says why it is not searched on the host); prints
     wall time, events/s, host-resolved rows, kernel ms per launch (CUDA
     events) and each drain's wait on its launch's event;
 13. drives the independent-key checker over the same histories folded
     into one multi-key history (~819k events): valid over 1,024 keys in
     one launch with a certificate or a counted absence for each key, the
     folded twin invalid with failures [700]; 15 seeded certificates (and
     key 700's of the twin) validated against the whole history;
 14. drives check_slices in the fleet's shape: every start state of 64
     crashed ensemble histories and of their crash-free twins in one
     launch at W=24, F=48; every known row must equal the host reach
     search, and 8 rows must equal check_slices on the CPU;
 15. replays the ensemble's launches (one streamed run's chunks and the
     sharded launch) on the kernel and its plain version;
 16. checkpoint-and-extend on the headline history: analysis_extend of
     its first 90% writes a wgl-extend record to a temporary store, and
     analysis_extend of the whole history resumes from it; the result
     and certificate must equal, byte for byte, a fresh analysis_extend
     without a store, the certificate must validate, and the resumed run
     may compute at most (K - matched segments + 1) * S masks; the
     85%-corrupted twin resumed from its clean 80% prefix must equal its
     fresh check (invalid, same failed segment and certificate); a torn
     record must count ckpt.torn and give the fresh result; prints the
     reused and computed masks, launches, rows, wall seconds and kernel
     ms of each run; the whole history's rows go through check_slices
     on the card once more, and every known row, and every mask of the
     resumed record, must equal the host reach search, and 8 rows
     check_slices on the CPU;
 17. check_segmented(enc, checkpoint_dir=...) on the headline history
     twice: the second run must load every mask the first saved and
     launch no kernel, with the same result;
 18. the linearizable checker with a store directory and extend? on the
     card: valid through analysis_extend, its certificate validated;
 19. the checker stacks a Jepsen test composes (checker.compose), each
     into a fresh store directory, with every launch count set to 0 just
     before each composed check: the register stack
     (independent.checker(linearizable) + stats + unhandled_exceptions)
     over phase 13's folded history must be valid with wgl_search
     launched and write no file, and over its twin invalid with failures
     [700] and a counterexample SVG equal, byte for byte, to the one key
     700's subhistory leaves when checked alone on the CPU; the
     list-append stack (append_checker + stats) over phase 8's history
     valid with scc launched, over its twin invalid with G0 and its
     elle/G0-<fp>.txt on disk, and phase 9's corrupted history through
     the checker on the card and on the CPU with the same files and
     bytes; the bank stack (bank.checker + stats) over phase 10's history
     valid with bank_reduce launched, over its twin with phase 10's first
     error; no sub-result may be "unknown" or carry an error; prints each
     composed check's wall seconds beside the direct check's and the
     rendering calls' seconds;
     then prints one `{"kernels": [...]}` line, whose wgl_search launches
     include those of phases 16-19, and whose scc and bank_reduce
     launches include those of phase 19.

The last line is {"ok": true, "device": {...}}. Any failure raises, and
the script exits non-zero without that line; it also exits non-zero
when no CUDA device is available.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

import numpy as np

from jepsen_tpu_torch import checker as chk
from jepsen_tpu_torch import independent, telemetry
from jepsen_tpu_torch.checker import cycle, linearizable, models
from jepsen_tpu_torch.gpu import certify, ckpt, elle, ensemble, synth, wgl
from jepsen_tpu_torch.gpu import scc as scc_mod
from jepsen_tpu_torch.history import History, op
from jepsen_tpu_torch.gpu.encode import encode
from jepsen_tpu_torch.gpu.kernels import bank_reduce as kbank
from jepsen_tpu_torch.gpu.kernels import build
from jepsen_tpu_torch.gpu.kernels import scc as kscc
from jepsen_tpu_torch.gpu.kernels import wgl_search as ws
from jepsen_tpu_torch.reports import explain
from jepsen_tpu_torch.store.format import jsonable
from jepsen_tpu_torch.workloads import bank

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bandwidth,
# and the float32 CUDA-core rate, used as the rate of the kernel's 32-bit
# integer compare/select work
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# BASELINE config 5 (bench.py:145-187): 1,024 register histories of 400
# ops, 4 processes, 15% of ops crashed, streamed in chunks of 128
ENSEMBLE_N = 1024
ENSEMBLE_CHUNK = 128
ENSEMBLE_BAD = 700
# The twin corrupts member 700 at 30% of its history. At 85% neither
# package decides that member in bounded time: the kernel answers
# UNKNOWN (frontier overflow) and the exact host search behind it is
# exponential in the crashed writes before the bad read (30 there; the
# search takes 0.2 s at 30%, 2 s at 40%, 52 s at 50% on a CPU). The 85%
# twin runs through the card only (phase 12), which must not say VALID.
TWIN_AT_FRAC = 0.3
UNDECIDED_AT_FRAC = 0.85


def ensemble_hist(i: int, crash_p: float = 0.15) -> History:
    return synth.register_history(400, n_procs=4, seed=1000 + i,
                                  crash_p=crash_p)


def fold_keys(hists) -> History:
    """One multi-key history out of single-key ones (key k = hists[k]):
    values become (k, v), process ids k * 1000 + p, and ops merge by
    (per-key time, key) with index and time renumbered."""
    events = sorted(((o.time, k, o) for k, h in enumerate(hists)
                     for o in h), key=lambda e: (e[0], e[1]))
    return History([op(index=i, time=i, type=o.type,
                       process=k * 1000 + o.process, f=o.f,
                       value=(k, o.value))
                    for i, (_t, k, o) in enumerate(events)],
                   assign_indices=False)


def emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _seeded_cases():
    """(name, encodes, rows, W, F, reach) launches of 2-20k entries."""
    m = models.cas_register()
    out = []
    for crash_p in (0.0, 0.15):
        hs = [synth.register_history(1500, n_procs=5, seed=s,
                                     crash_p=crash_p) for s in range(3)]
        hs.append(synth.corrupt_register_history(hs[0], at_frac=0.5)[0])
        encs = [encode(m, h) for h in hs]
        rows = [(i, e.init_state) for i, e in enumerate(encs)]
        tag = f"whole-crash{crash_p}"
        out.append((f"{tag}-verdict", encs, rows, 32, 64, False))
        out.append((f"{tag}-reach", encs, rows, 32, 32, True))
        out.append((f"{tag}-overflow-verdict", encs, rows, 4, 4, False))
        out.append((f"{tag}-overflow-reach", encs, rows, 4, 4, True))
        # check_segmented's shape: segments x every start state
        enc = encode(m, synth.corrupt_register_history(
            synth.register_history(10_000, n_procs=5, seed=7,
                                   crash_p=crash_p / 10), at_frac=0.6)[0])
        q = enc.m // 8
        cuts = [k * q for k in range(8)] + [enc.m]
        segs = [enc.segment(cuts[k], cuts[k + 1]) for k in range(8)]
        # and an empty segment (m == 0): its rows start VALID, mask
        # 1 << st0, and never run a level
        segs.append(enc.segment(q, q))
        rows = [(k, s) for k in range(9) for s in range(enc.n_states)]
        out.append((f"segments-crash{crash_p / 10}-reach", segs, rows, 24,
                    48, True))
    # one long segment (11,951 / 11,908 entries, M = 16384), one row: the
    # kernel's ring of R = 128 entries wraps ~93 times; W=32 crash-free
    # fills the window (no hole left in the mask), and the crashed
    # segment's levels give up to 168 successors (the block path)
    for crash_p, W, F, reach in ((0.0, 32, 64, False), (0.02, 32, 64, False),
                                 (0.02, 24, 48, True)):
        enc = encode(m, synth.register_history(15_000, n_procs=5, seed=21,
                                               crash_p=crash_p))
        out.append((f"long-crash{crash_p}-W{W}-"
                    f"{'reach' if reach else 'verdict'}", [enc],
                    [(0, enc.init_state)], W, F, reach))
    # a register over 600 values (S = 512 states): the kernel reads trans
    # from global memory, so its shared memory does not grow with S
    for crash_p in (0.0, 0.15):
        hs = [synth.register_history(1500, n_procs=5, seed=30 + s,
                                     crash_p=crash_p, n_values=600)
              for s in range(3)]
        hs.append(synth.corrupt_register_history(hs[0], at_frac=0.5)[0])
        encs = [encode(m, h) for h in hs]
        rows = [(i, e.init_state) for i, e in enumerate(encs)]
        out.append((f"values600-crash{crash_p}-verdict", encs, rows, 24, 48,
                    False))
    return out


def _mismatches(got, want) -> list[int]:
    return [int((a.to(torch.int64) != b.to(torch.int64)).sum())
            for a, b in zip(got, want)]


def _max_abs_err(got, want) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in zip(got, want))


def _path_levels(packed, rs, s0, kw, on_card: bool):
    """{"warp": n, "block": n, "warp_sorted": n}: the levels one launch
    of the kernel finished on its warp path and on its block path, and
    the warp-path levels that sorted (more than F unique successors),
    summed over its rows, from a launch of its own; None off the card."""
    if not on_card:
        return None
    buf = torch.zeros(3, dtype=torch.int32, device=rs.device)
    ws.wgl_search(packed, rs, s0, path_levels=buf, **kw)
    warp, block, warp_sorted = buf.tolist()
    return {"warp": warp, "block": block, "warp_sorted": warp_sorted}


def _us_per_level(kernel_ms, levels: int):
    return (1e3 * kernel_ms / levels) if kernel_ms is not None and levels \
        else None


def _event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _launch_bound(packed, rs, kw, out) -> tuple[float, float, float]:
    """(bytes, operations, bound ms) of one launch on this run's data:
    each packed entry the rows' segments hold is read once (inv, ret,
    sufmin and a trans row of S states), each output written once; one
    operation per (configuration, window slot) evaluated and per
    successor key sorted, from the launch's own level series."""
    inv_t, ret_t, trans, mseg, sufmin = packed
    S = trans.shape[2]
    segs = torch.unique(rs)
    entries = int(mseg[segs].to(torch.int64).sum())
    B = rs.numel()
    n_it = int(out[-4])
    live = int(out[-3][:n_it].to(torch.int64).sum())
    gen = int(out[-2][:n_it].to(torch.int64).sum()
              + out[-1][:n_it].to(torch.int64).sum())
    nbytes = entries * 4 * (3 + S) + B * 4 * 2 + B * 6 + 3 * 4 * kw[
        "max_iters"]
    ops = live * kw["W"] + gen * max(1, math.ceil(math.log2(max(gen, 2))))
    bound_ms = 1e3 * max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S)
    return nbytes, ops, bound_ms


def _norm(x):
    """A result tree with every op replaced by its to_dict()."""
    if hasattr(x, "to_dict") and not isinstance(x, dict):
        return {"op": _norm(x.to_dict())}
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _clustered_graph(seed, n, cluster, inner, cross):
    """Many large SCCs: random edges inside clusters of `cluster` nodes
    plus forward edges between clusters."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, n // cluster, inner)
    src = blk * cluster + rng.integers(0, cluster, inner)
    dst = blk * cluster + rng.integers(0, cluster, inner)
    cs = rng.integers(0, n - 2 * cluster, cross)
    cd = cs + rng.integers(1, 2 * cluster, cross)
    return np.concatenate([src, cs]), np.concatenate([dst, cd])


def _cycle_chain(k, size):
    """k cycles of `size` nodes in decreasing order, each joined to the
    one below by an edge from its first node to the lower cycle's last:
    a chain of non-trivial components, which trim cannot touch."""
    base = np.repeat(np.arange(k) * size, size)
    pos = np.tile(np.arange(size), k)
    links = np.arange(1, k) * size
    return (k * size, np.concatenate([base + pos, links]),
            np.concatenate([base + (pos + 1) % size, links - 1]))


def _scc_cases():
    """(name, n, src, dst, edge_on) seeded graphs for kernel vs plain."""
    rng = np.random.default_rng(5)
    out = []
    for seed, (n, cluster, inner, cross) in enumerate(
            [(3000, 60, 6000, 1500), (100_000, 300, 500_000, 100_000)]):
        src, dst = _clustered_graph(seed, n, cluster, inner, cross)
        ty = rng.integers(0, 5, len(src))
        for k in (1, 2, 3, 4, 5):
            out.append((f"clustered-n{n}-classes{k}", n, src, dst, ty < k))
    chain = 3000
    out.append(("decreasing-chain-3000", chain,
                np.arange(chain - 1, 0, -1), np.arange(chain - 2, -1, -1),
                np.ones(chain - 1, dtype=bool)))
    out.append(("decreasing-chain-100", 100, np.arange(99, 0, -1),
                np.arange(98, -1, -1), np.ones(99, dtype=bool)))
    out.append(("cycle-600", 600, np.arange(600), (np.arange(600) + 1) % 600,
                np.ones(600, dtype=bool)))
    for k in (100, 800):
        n, src, dst = _cycle_chain(k, 10)
        out.append((f"cycle-chain-{k}x10", n, src, dst,
                    np.ones(len(src), dtype=bool)))
    n = 2000
    src, dst = rng.integers(0, n, 4000), rng.integers(0, n, 4000)
    out.append(("random-n2000", n, src, dst, rng.random(4000) < 0.8))
    return out


def _scc_tensors(src, dst, on, dev):
    return (torch.from_numpy(np.asarray(src, np.int32)).to(dev),
            torch.from_numpy(np.asarray(dst, np.int32)).to(dev),
            torch.from_numpy(np.asarray(on, bool)).to(dev))


def _bank_cases():
    """(name, matrix, offset): an offset case lies one element past a
    16-byte boundary, so its rows start off the 16-byte grid (all of
    them for an even width, every other one for an odd width)."""
    rng = np.random.default_rng(9)
    mats = {"random-1000x32": rng.integers(-100, 100, (1000, 32)),
            "random-250000x32": rng.integers(0, 50, (250_000, 32)),
            "random-77x100": rng.integers(-2 ** 40, 2 ** 40, (77, 100)),
            "random-1000x1": rng.integers(-2 ** 40, 2 ** 40, (1000, 1)),
            "random-1000x2": rng.integers(-2 ** 40, 2 ** 40, (1000, 2)),
            "random-1000x3": rng.integers(-2 ** 40, 2 ** 40, (1000, 3))}
    past = rng.integers(0, 10, (5000, 16))
    past[17, :2] = [2 ** 31 - 1, 5]
    past[18, :3] = [2 ** 31 - 1, 2 ** 31 - 1, 2 ** 31 - 1]
    mats["past-int32-5000x16"] = past
    out = [(k, np.ascontiguousarray(v, dtype=np.int64), False)
           for k, v in mats.items()]
    for rows, cols in ((1000, 1), (1000, 2), (1000, 3), (77, 100),
                       (250_414, 32)):
        out.append((f"offset-{rows}x{cols}", np.ascontiguousarray(
            rng.integers(-2 ** 40, 2 ** 40, (rows, cols)), dtype=np.int64),
            True))
    return out


def _bank_tensor(mat, offset: bool, dev):
    if not offset:
        return torch.from_numpy(mat).to(dev)
    rows, cols = mat.shape
    flat = torch.empty(rows * cols + 1, dtype=torch.int64, device=dev)
    view = flat[1:].view(rows, cols)
    view.copy_(torch.from_numpy(mat))
    return view


def _syncs(dev, on_card: bool):
    return torch.zeros(2, dtype=torch.int32, device=dev) if on_card else None


def kernels_against_plain(dev, on_card: bool) -> int:
    """Phase 7: scc and bank_reduce against their plain versions; every
    capped case that hits a cap also through the convergence launch,
    against its plain version on the CPU and scipy's labels."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    total = 0
    for name, n, src, dst, on in _scc_cases():
        args = _scc_tensors(src, dst, on, dev)
        sync()
        t0 = time.perf_counter()
        got = kscc.scc_labels(*args, n)
        sync()
        t_kernel = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = kscc.scc_labels_reference(*args, n)
        sync()
        t_plain = time.perf_counter() - t0
        mism = int((got != want).sum())
        total += mism
        tail = want[n:].tolist()
        emit({"phase": "kernel-vs-plain", "kernel": "scc", "case": name,
              "nodes": n, "edges": len(src), "live_edges": int(on.sum()),
              "ok": tail[0], "rounds": tail[1], "sweeps": tail[2],
              "components": int(np.unique(want[:n].cpu().numpy()).size),
              "mismatches": mism, "kernel_s": t_kernel, "plain_s": t_plain})
        if (name.startswith(("decreasing-chain", "cycle"))
                and tail[0] != 0):
            raise AssertionError(f"{name} did not hit a cap: {tail}")
        if tail[0] == 0:
            # the launch scc() makes after a cap hit, against its plain
            # version on the CPU and scipy's labels; on the card also with
            # block 0 never going on alone, so the grid schedule meets
            # the plain version too
            cpu = [a.cpu() for a in args]
            want = kscc.scc_labels_to_convergence(*cpu, n)
            host = scc_mod._scc_host(n, src[on], dst[on])
            tail = want[n:].tolist()
            if tail[0] != 1:
                raise AssertionError(f"{name} to convergence: {tail}")
            total += int((want[:n].numpy() != host).sum())
            schedules = {"default": kscc.TAIL_WORK, "grid": -1}
            for schedule, tail_work in schedules.items():
                if not on_card and schedule != "default":
                    continue
                syncs = _syncs(dev, on_card)
                kscc.TAIL_WORK = tail_work
                try:
                    sync()
                    t0 = time.perf_counter()
                    got = kscc.scc_labels_to_convergence(*args, n,
                                                         syncs=syncs)
                    sync()
                    t_kernel = time.perf_counter() - t0
                finally:
                    kscc.TAIL_WORK = schedules["default"]
                mism = int((got.cpu() != want).sum())
                total += mism
                emit({"phase": "kernel-vs-plain", "kernel": "scc",
                      "case": f"{name}-to-convergence",
                      "schedule": schedule, "ok": tail[0],
                      "rounds": tail[1], "sweeps": tail[2],
                      "trim_passes": tail[3],
                      "grid_syncs": syncs.tolist() if on_card else None,
                      "mismatches": mism,
                      "equals_scipy": bool((want[:n].numpy() == host)
                                           .all()),
                      "kernel_s": t_kernel})
    for name, mat, offset in _bank_cases():
        m = _bank_tensor(mat, offset, dev)
        got = kbank.bank_reduce(m)
        want = kbank.bank_reduce_reference(m)
        sync()
        mism = [int((a != b).sum()) for a, b in zip(got, want)]
        exact = bool((got[0].cpu().numpy() == mat.sum(axis=1)).all()
                     and (got[1].cpu().numpy() == (mat < 0).any(axis=1))
                     .all())
        total += sum(mism) + (not exact)
        emit({"phase": "kernel-vs-plain", "kernel": "bank_reduce",
              "case": name, "shape": list(mat.shape),
              "data_ptr_mod_16": m.data_ptr() % 16, "mismatches": mism,
              "equals_numpy_int64": exact})
    return total


def _wide_capped(n: int):
    """A wide graph that hits SWEEP_CAP: n nodes in clusters of 300 with
    5n random edges inside them and n forward edges between them (many
    large components, 6n edges), plus a 3,000-node decreasing chain."""
    src, dst = _clustered_graph(7, n, 300, 5 * n, n)
    chain = n + np.arange(2999, 0, -1)
    return (n + 3000, np.concatenate([src, chain]),
            np.concatenate([dst, chain - 1]))


def scc_adversarial(dev, on_card: bool, n_big: int = 100_000,
                    n_chain: int = 20_001) -> dict:
    """Phase 7b: the convergence launch alone on a decreasing chain and a
    single cycle of n_big nodes, the chains of 100, 800 and 2,000
    ten-node cycles and a wide graph of n_big nodes joined to a
    decreasing chain, and a
    decreasing chain of n_chain nodes joined to a forward chain of
    n_chain edges through Edges.scc (a cap hit, then the convergence
    launch). Each is held against scipy's labels; the plain versions are
    too slow at this size on the card."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    graphs = {
        f"decreasing-chain-{n_big}": (n_big, np.arange(n_big - 1, 0, -1),
                                      np.arange(n_big - 2, -1, -1)),
        f"cycle-{n_big}": (n_big, np.arange(n_big),
                           (np.arange(n_big) + 1) % n_big),
        "cycle-chain-100x10": _cycle_chain(100, 10),
        f"clustered-{n_big}+decreasing-chain-3000": _wide_capped(n_big),
        "cycle-chain-800x10": _cycle_chain(800, 10),
        "cycle-chain-2000x10": _cycle_chain(2000, 10)}
    result = {}
    for name, (n, src, dst) in graphs.items():
        on = np.ones(len(src), dtype=bool)
        args = _scc_tensors(src, dst, on, dev)
        host = scc_mod._scc_host(n, src, dst)
        syncs = _syncs(dev, on_card)
        if on_card:  # a warm-up launch
            kscc.scc_labels_to_convergence(*args, n)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        sync()
        t0 = time.perf_counter()
        if on_card:
            start.record()
        out = kscc.scc_labels_to_convergence(*args, n, syncs=syncs)
        if on_card:
            end.record()
        sync()
        seconds = time.perf_counter() - t0
        ms = start.elapsed_time(end) if on_card else None
        o = out.cpu().numpy()
        if o[n] != 1 or (o[:n] != host).any():
            raise AssertionError(f"{name}: labels differ from scipy's: "
                                 f"{o[n:]}")
        x = {"case": name, "tail_work": kscc.TAIL_WORK, "nodes": n,
             "edges": len(src), "seconds": seconds, "kernel_ms": ms,
             "rounds": int(o[n + 1]), "sweeps": int(o[n + 2]),
             "trim_passes": int(o[n + 3]),
             "grid_syncs": syncs.tolist() if on_card else None,
             "equals_scipy": True}
        result[name] = x
        emit({"phase": "scc-adversarial", **x})
    # through the entry point: the capped launch hits SWEEP_CAP, the
    # convergence launch answers
    n = n_chain
    m = n_chain
    src = np.concatenate([np.arange(n - 1, 0, -1), np.arange(n, n + m)])
    dst = np.concatenate([np.arange(n - 2, -1, -1), np.arange(n + 1,
                                                              n + m + 1)])
    total_n = n + m + 1
    host = scc_mod._scc_host(total_n, src, dst)
    kscc.launches = kscc.converge_launches = 0
    telemetry.reset()
    sync()
    t0 = time.perf_counter()
    labels = scc_mod.scc(total_n, src, dst, device=dev)
    sync()
    seconds = time.perf_counter() - t0
    counters = telemetry.get().counters()
    counts = {"capped_launches": kscc.launches,
              "converge_launches": kscc.converge_launches,
              "nonconverged": counters.get("scc.device-nonconverged", 0),
              "device_path": counters.get("scc.path.device", 0),
              "host_path": counters.get("scc.path.host", 0)}
    if (labels != host).any():
        raise AssertionError("Edges.scc on the joined chains differs from "
                             "scipy")
    if counts["nonconverged"] != 1 or counts["device_path"] != 1 or \
            counts["host_path"] or (on_card and (
                counts["capped_launches"], counts["converge_launches"])
                != (1, 1)):
        raise AssertionError(f"Edges.scc on the joined chains: {counts}")
    x = {"case": f"decreasing-chain-{n}+forward-chain-{m} via Edges.scc",
         "nodes": total_n, "edges": len(src), "seconds": seconds,
         **counts, "equals_scipy": True}
    result["entry"] = x
    emit({"phase": "scc-adversarial", **x})
    return result


def _device_kernels(fn) -> list | str:
    """[(kernel name, device us)] of every kernel that one call of fn
    ran, in launch order, from torch.profiler's CUDA trace; the error's
    text when the profiler fails or records no kernel on this machine."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        return out or "the profiler recorded no device kernels"
    except Exception as e:  # noqa: BLE001 — a measurement, not the check
        return f"profiler failed: {e!r}"[:300]


def _span_s(name: str) -> float:
    return sum(sp["t1"] - sp["t0"] for sp in telemetry.get().spans()
               if sp["name"] == name) / 1e9


def _recording(module, name, store):
    """Replaces module.name with a wrapper that keeps each call's
    arguments and result; returns the original."""
    original = getattr(module, name)

    def wrapper(*args, **kw):
        out = original(*args, **kw)
        store.append((args, kw, out))
        return out

    setattr(module, name, wrapper)
    return original


def elle_main_path(dev, on_card: bool, n_txns: int
                   ) -> tuple[list, dict, dict]:
    """Phase 8: the Elle checkers at full size. Returns the recorded scc
    launches (check name, args, out), the launches per check, and the
    histories and wall seconds of each check (phase 19 checks them
    again through compose)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    la = synth.list_append_history(n_txns, seed=11)
    twin, bad_idx = synth.corrupt_list_append_history(la, at_frac=0.85)
    rw = synth.rw_register_history(n_txns, seed=17)
    opts = {"device": dev}
    checks = [("list-append", la, cycle.append_checker(opts), True),
              ("list-append-corrupted", twin, cycle.append_checker(opts),
               False),
              ("rw-register", rw, cycle.wr_checker(opts), True)]
    recorded, per_check = [], {}
    direct = {"histories": {name: h for name, h, _c, _v in checks},
              "check_s": {}}
    calls: list = []
    original = _recording(kscc, "scc_labels", calls)
    try:
        for name, h, chk, valid in checks:
            calls.clear()
            kscc.launches = 0
            telemetry.reset()
            t0 = time.perf_counter()
            res = chk.check({}, h)
            sync()
            t1 = time.perf_counter()
            launches = kscc.launches
            counters = telemetry.get().counters()
            family = name.removesuffix("-corrupted")
            spans = {"host_encode_s": _span_s(f"elle:{family}"),
                     "cycle_search_s": _span_s("elle:cycles"),
                     "scc_device_s": _span_s("scc:device"),
                     "certify_s": _span_s("certify.attach")}
            certify.validate(h, res["certificate"])
            t2 = time.perf_counter()
            if res["valid?"] is not valid:
                raise AssertionError(f"{name}: valid? {res['valid?']} "
                                     f"{res['anomaly-types']}")
            if on_card and launches < 1:
                raise AssertionError(f"{name}: no scc kernel launch")
            if "degradation" in res:
                raise AssertionError(f"{name}: {res['degradation']}")
            if n_txns == 100_000:
                # every graph of the full-size checks is past
                # DEVICE_MIN_EDGES: each one must be solved by one launch
                # of the kernel, none by the host or a second launch
                off = {k: counters.get(k, 0) for k in
                       ("scc.path.host", "scc.device-nonconverged")}
                if any(off.values()):
                    raise AssertionError(f"{name}: off the card {off}")
                if on_card and counters.get("scc.path.device") != launches:
                    raise AssertionError(
                        f"{name}: {launches} launches for "
                        f"{counters.get('scc.path.device')} device solves")
            if name == "list-append-corrupted" and n_txns == 100_000:
                # the full-size twin's known shape (smaller rehearsal
                # sizes damage another read)
                if "G0" not in res["anomaly-types"]:
                    raise AssertionError(f"twin: {res['anomaly-types']}")
                if on_card and launches != 5:
                    raise AssertionError(f"twin: {launches} launches")
            per_check[name] = launches
            direct["check_s"][name] = t1 - t0
            recorded += [(name, a, o) for a, _kw, o in calls]
            emit({"phase": "elle", "check": name, "txns": res["txn-count"],
                  "edges": res["edge-count"], "valid": res["valid?"],
                  "anomaly_types": res["anomaly-types"],
                  "damaged_op": bad_idx if name.endswith("corrupted")
                  else None,
                  "scc_launches": launches,
                  "scc_device_path": counters.get("scc.path.device", 0),
                  "scc_host_path": counters.get("scc.path.host", 0),
                  "scc_nonconverged": counters.get(
                      "scc.device-nonconverged", 0),
                  "certificate": ("cycle" if "cycle" in res["certificate"]
                                  else "topo-order"),
                  "check_s": t1 - t0, **spans, "validate_s": t2 - t1,
                  "txns_per_s": res["txn-count"] / (t1 - t0)})
    finally:
        kscc.scc_labels = original
    return recorded, per_check, direct


def elle_cross_check(dev, n_txns: int) -> History:
    """Phase 9: card against CPU against the host engine. Returns the
    corrupted list-append history."""
    la = synth.list_append_history(n_txns, seed=11)
    la_bad = synth.corrupt_list_append_history(la, 0.85)[0]
    rw = synth.rw_register_history(n_txns, seed=17)
    cases = [("list-append", la, elle.check_list_append),
             ("list-append-corrupted", la_bad, elle.check_list_append),
             ("rw-register", rw, elle.check_rw_register),
             ("rw-register-corrupted",
              synth.corrupt_rw_register_history(rw, 0.85)[0],
              elle.check_rw_register)]
    for name, h, check in cases:
        t0 = time.perf_counter()
        card = _norm(check(h, {"engine": "device", "device": dev}))
        t1 = time.perf_counter()
        cpu = _norm(check(h, {"engine": "device", "device": "cpu"}))
        t2 = time.perf_counter()
        host = _norm(check(h, {"engine": "host"}))
        t3 = time.perf_counter()
        if card != cpu:
            raise AssertionError(f"{name}: card {card} != cpu {cpu}")
        # the host engine alone attributes edges per key (search keys and
        # per-key-edges), as in the reference; everything else is equal
        for k in ("keys", "per-key-edges"):
            host["search"].pop(k, None)
        if card != host:
            raise AssertionError(f"{name}: card {card} != host {host}")
        if card["valid?"] is name.endswith("corrupted"):
            raise AssertionError(f"{name} judged {card['valid?']}")
        emit({"phase": "elle-cross-check", "check": name,
              "txns": card["txn-count"], "edges": card["edge-count"],
              "anomaly_types": card["anomaly-types"], "identical": True,
              "card_s": t1 - t0, "cpu_plain_s": t2 - t1,
              "host_engine_s": t3 - t2})
    return la_bad


def _raise_balance(hist, at_frac: float):
    ops = list(hist)
    for i in range(int(len(ops) * at_frac), len(ops)):
        o = ops[i]
        if o.type == "ok" and o.f == "read":
            ops[i] = o.copy(value={**o.value, 0: o.value[0] + 1})
            return type(hist)(ops, assign_indices=False), i
    raise ValueError("no ok read to corrupt")


def _numpy_fold_first_error(hist, total: int):
    """The first error of the plain numpy fold over the balance matrix."""
    reads = [o for o in hist
             if o.type == "ok" and o.f == "read" and o.value is not None]
    mat = np.array([list(o.value.values()) for o in reads], dtype=np.int64)
    sums = mat.sum(axis=1)
    bad = np.flatnonzero((sums != total) | (mat < 0).any(axis=1))
    if not bad.size:
        return None
    i = int(bad[0])
    if sums[i] != total:
        return {"type": "wrong-total", "expected": total,
                "found": int(sums[i]), "op": reads[i]}
    return {"type": "negative-value",
            "found": [int(b) for b in mat[i] if b < 0], "op": reads[i]}


def bank_path(dev, on_card: bool, n_txns: int
              ) -> tuple[list, int, dict]:
    """Phase 10: the bank checker on the card. Returns the recorded
    bank_reduce launches, the launch count of the valid check, and the
    histories, total, wall seconds and the twin's first error (phase 19
    checks them again through compose)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    accounts = 32
    total = accounts * 10
    h = synth.bank_history(n_txns, n_accounts=accounts, seed=11)
    twin, bad_idx = _raise_balance(h, 0.85)
    calls: list = []
    original = _recording(kbank, "bank_reduce", calls)
    try:
        kbank.launches = 0
        t0 = time.perf_counter()
        res = bank.check_fast(h, total, device=dev)
        sync()
        t1 = time.perf_counter()
        launches = kbank.launches
        main = list(calls)
        bres = bank.check_fast(twin, total, device=dev)
        sync()
    finally:
        kbank.bank_reduce = original
    if res["valid?"] is not True:
        raise AssertionError(f"bank history not valid: {res}")
    if on_card and launches < 1:
        raise AssertionError("the bank path launched no kernel")
    want = _numpy_fold_first_error(twin, total)
    if bres["valid?"] is not False or _norm(bres["first-error"]) != \
            _norm(want):
        raise AssertionError(f"bank twin: {bres} != numpy fold {want}")
    emit({"phase": "bank", "txns": n_txns, "accounts": accounts,
          "reads": res["read-count"], "valid": res["valid?"],
          "bank_reduce_launches": launches, "check_s": t1 - t0,
          "corrupted_op": bad_idx, "corrupted_first_error": {
              k: v for k, v in bres["first-error"].items() if k != "op"},
          "corrupted_error_count": bres["error-count"],
          "equals_numpy_fold": True})
    return main, launches, {"history": h, "twin": twin, "total": total,
                            "check_s": t1 - t0, "first_error": want}


def _scc_jacobi_bytes(src, dst, on, n: int, out) -> tuple[int, float, list]:
    """(bytes, ms at the memory rate, per-round work) of one scc launch
    as the kernel ran it before its redesign, from the live edges of each
    of its rounds (the plain version's count, which must agree with the
    kernel's rounds and sweeps). Kept so that the times before and after
    the redesign compare against one count; it is not a bound, since the
    redesigned kernel moves fewer bytes. Per round: the live mask is
    rebuilt (edge_on and the new mask over every edge, src, dst and two
    active flags for each edge of the subset) and the colours set (active
    read, c written); each forward sweep reads the mask over every edge,
    src, dst, the source's colour and the target's prop for each live
    edge, and reads and writes each node's value; the same-colour mask is
    cut (the mask, and src, dst and both colours of each live edge) and
    the membership set; each backward sweep is a forward sweep over the
    same-colour edges; the retire pass reads active and m and writes the
    labels and active."""
    E, E_on = src.numel(), int(on.sum())
    work = kscc.scc_rounds(src, dst, on, n)
    tail = out[n:].tolist()
    if len(work) != tail[1] or sum(f + b for *_x, f, b in work) != tail[2]:
        raise AssertionError(f"scc work {work} disagrees with the "
                             f"kernel's rounds and sweeps {tail}")
    nbytes = 0
    for live, same, fwd, bwd in work:
        nbytes += 2 * E + 10 * E_on + 5 * n
        nbytes += fwd * (E + 16 * live + 8 * n)
        nbytes += E + 16 * live + 9 * n
        nbytes += bwd * (E + 16 * same + 8 * n)
        nbytes += 10 * n
    return nbytes, 1e3 * nbytes / PEAK_BYTES_PER_S, work


def _scc_bound(E: int, n: int) -> tuple[int, float]:
    """(bytes, bound ms) of one scc launch: the inputs read once and the
    outputs written once, src and dst (4 bytes) and edge_on (1) for each
    edge, a 4-byte label for each node and the three counts, over the
    memory rate. The operations, a compare per edge, are far below the
    32-bit rate."""
    nbytes = 9 * E + 4 * (n + 3)
    return nbytes, 1e3 * nbytes / PEAK_BYTES_PER_S


def _ptxas(info, name: str) -> list:
    """The ptxas lines (-Xptxas -v) of one kernel source: each entry
    function, its registers, its stack and spills."""
    if not info:
        return []
    return [ln.strip() for ln in info["ptxas"].get(name, "").splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]


def scc_timing(recorded, per_check, on_card: bool, info=None) -> dict:
    """Phase 11, scc: each main-path launch replayed on the kernel (CUDA
    events, and its grid syncs) and the plain version, against the plain
    outputs."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    per_launch, max_err = [], 0
    for check, (src, dst, on, n), out in recorded:
        tail = out[n:].tolist()
        nbytes, bound_ms = _scc_bound(src.numel(), n)
        jacobi_bytes, jacobi_ms, work = _scc_jacobi_bytes(src, dst, on, n,
                                                          out)
        kernel_ms = (_event_ms(lambda: kscc.scc_labels(src, dst, on, n),
                               reps=20) if on_card else None)
        syncs = _syncs(src.device, on_card)
        if on_card:
            kscc.scc_labels(src, dst, on, n, syncs=syncs)
        sync()
        t0 = time.perf_counter()
        want = kscc.scc_labels_reference(src, dst, on, n)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        max_err = max(max_err, int((out.long() - want.long()).abs().max()))
        per_launch.append({"check": check, "nodes": n,
                           "edges": src.numel(),
                           "live_edges": int(on.sum()), "ok": tail[0],
                           "rounds": tail[1], "sweeps": tail[2],
                           "grid_syncs": (syncs.tolist()[0] if on_card
                                          else None),
                           "live_edges_per_round": [w[0] for w in work],
                           "same_colour_edges_per_round": [w[1]
                                                           for w in work],
                           "sweeps_per_round": [[w[2], w[3]]
                                                for w in work],
                           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bytes": nbytes,
                           "jacobi_bytes": jacobi_bytes,
                           "jacobi_bytes_ms": jacobi_ms})
    if on_card:
        prof = _device_kernels(lambda: [kscc.scc_labels(*a)
                                        for _c, a, _o in recorded])
        dev_us = ([us for name, us in prof if "scc_kernel" in name]
                  if isinstance(prof, list) else [])
        for x, us in zip(per_launch, dev_us):
            x["device_ms"] = us / 1e3
        if len(dev_us) != len(per_launch):
            emit({"phase": "scc-profile", "note": prof if isinstance(
                prof, str) else f"{len(dev_us)} scc kernels traced"})
    emit({"phase": "scc-launches", "launches": per_launch})
    if max_err:
        raise AssertionError(f"scc main-path launches differ from the "
                             f"plain version by up to {max_err}")
    ms = sum(x["kernel_ms"] for x in per_launch) if on_card else None
    return {
        "name": "scc",
        "route": "cuda",
        "source": "jepsen_tpu_torch/gpu/kernels/csrc/scc.cu",
        "replaces": "jepsen_tpu/tpu/scc.py:64",
        "launches": sum(per_check.values()),
        "launches_per_check": per_check,
        "max_abs_err": max_err,
        "ms": ms,
        "ms_per_launch": ms / len(per_launch) if on_card else None,
        "device_ms": (sum(x["device_ms"] for x in per_launch)
                      if per_launch and "device_ms" in per_launch[-1]
                      else None),
        "grid_syncs": (sum(x["grid_syncs"] for x in per_launch)
                       if on_card else None),
        "plain_ms": sum(x["plain_ms"] for x in per_launch),
        "bound_ms": sum(x["bound_ms"] for x in per_launch),
        "bound_by": "bytes",
        "jacobi_bytes_ms": sum(x["jacobi_bytes_ms"] for x in per_launch),
        "library_ms": None,
        "ptxas": _ptxas(info, "scc"),
    }


def _flushed_ms(fn, flush, reps: int) -> list:
    """CUDA-event ms of `reps` launches of fn, each after a write of the
    whole `flush` buffer (outside the events), so fn finds L2 cold. The
    write keeps the card busy while the host enqueues fn, so the events
    time the kernel, not the host's launch."""
    times = []
    for i in range(reps):
        flush.fill_(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


def _device_ms_by_mode(fn, flush, clean, name: str, reps: int = 9):
    """Median device ms (torch.profiler) of fn's kernel `name`: launched
    back to back (L2 as the last launch left it), after a write of
    `flush` (L2 full of dirty lines that the launch must write back), and
    after that write and a read of `clean` (L2 cold and clean)."""
    def run():
        for _ in range(reps + 1):  # the profiler may miss the first
            fn()
        for i in range(reps):
            flush.fill_(i)
            fn()
        for i in range(reps):
            flush.fill_(i)
            clean.sum()
            fn()
    prof = _device_kernels(run)
    if isinstance(prof, str):
        return {"warm": prof, "write_flushed": prof, "clean_flushed": prof}
    us = [u for n, u in prof if name in n][-3 * reps:]
    if len(us) != 3 * reps:
        note = f"{len(us)} {name} kernels traced, {3 * reps + 1} launched"
        return {"warm": note, "write_flushed": note, "clean_flushed": note}
    med = [sorted(us[k * reps:(k + 1) * reps])[reps // 2] / 1e3
           for k in range(3)]
    return {"warm": med[0], "write_flushed": med[1], "clean_flushed": med[2]}


def bank_timing(recorded, launches: int, on_card: bool, info=None) -> dict:
    """Phase 11, bank_reduce: the main path's launch replayed on the
    kernel, the plain version and the PyTorch reduction (the same two
    calls, timed as the library yardstick). Kernel and library by CUDA
    events with L2 flushed before each launch (a 256 MB write); the
    kernel also by the profiler's device time back to back, after that
    write, and after the write and a 256 MB read (clean L2), and the
    library's kernels back to back."""
    (mat,), _kw, out = recorded[0]
    want = kbank.bank_reduce_reference(mat)
    max_err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(out, want))
    rows, cols = mat.shape
    nbytes = rows * cols * 8 + rows * 9
    kernel_ms = library_ms = None
    device = library_device = {}
    if on_card:
        flush = torch.empty(64 << 20, dtype=torch.int32, device=mat.device)
        clean = torch.ones(64 << 20, dtype=torch.int32, device=mat.device)
        k = _flushed_ms(lambda: kbank.bank_reduce(mat), flush, 21)
        lib = _flushed_ms(lambda: (mat.sum(1), (mat < 0).any(1)), flush, 21)
        kernel_ms, library_ms = k[len(k) // 2], lib[len(lib) // 2]
        plain_ms = _event_ms(lambda: kbank.bank_reduce_reference(mat),
                             reps=20)
        device = _device_ms_by_mode(lambda: kbank.bank_reduce(mat), flush,
                                    clean, "bank_reduce")
        prof = _device_kernels(lambda: [(mat.sum(1), (mat < 0).any(1))
                                        for _ in range(5)])
        library_device = {"warm": (sum(u for _n, u in prof) / 5e3
                                   if isinstance(prof, list) else prof)}
        del flush, clean
    else:
        t0 = time.perf_counter()
        kbank.bank_reduce_reference(mat)
        plain_ms = 1e3 * (time.perf_counter() - t0)
    if max_err:
        raise AssertionError(f"bank_reduce differs from the plain version "
                             f"by {max_err}")
    bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    shares = {mode: (bound_ms / ms if isinstance(ms, float) else None)
              for mode, ms in device.items()}
    emit({"phase": "bank-timing", "shape": [rows, cols],
          "flushed_event_ms": kernel_ms, "device_ms": device,
          "bound_ms": bound_ms, "share_of_bound_by_device_ms": shares,
          "library_flushed_event_ms": library_ms,
          "library_device_ms": library_device})
    return {
        "name": "bank_reduce",
        "route": "cuda",
        "source": "jepsen_tpu_torch/gpu/kernels/csrc/bank_reduce.cu",
        "replaces": "jepsen_tpu/workloads/bank.py:98",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "device_ms": device,
        "library_device_ms": library_device,
        "shape": [rows, cols],
        "ptxas": _ptxas(info, "bank_reduce"),
    }


def ensemble_against_plain(dev, on_card: bool, n_rows: int) -> int:
    """Phase 3, the ensemble's shapes: n_rows crashed 400-op rows at
    W=32, F=64 (the successor buffer of 4,096 keys puts a block past the
    48 KB shared-memory default), and one launch over a one-device
    ensemble layout with unreferenced and repeated segments, against the
    plain version followed by a numpy gather."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    m = models.cas_register()
    encs = [encode(m, ensemble_hist(i)) for i in range(max(n_rows, 12))]
    total = 0
    pb = wgl.PackedBatch(encs[:n_rows])
    rows = [(i, e.init_state) for i, e in enumerate(encs[:n_rows])]
    smem = (ws._lib().wgl_search_smem_bytes(32, 64, 0) if on_card
            else None)
    for reach in (False, True):
        packed, rs, s0 = pb.tensors(*pb.rows(rows), dev)
        kw = dict(W=32, F=64, max_iters=pb.M + 4, reach=reach,
                  crash_free=False)
        sync()
        t0 = time.perf_counter()
        got = ws.wgl_search(packed, rs, s0, **kw)
        sync()
        t_kernel = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = ws.wgl_search_reference(packed, rs, s0, **kw)
        sync()
        t_plain = time.perf_counter() - t0
        mism = _mismatches(got, want)
        total += sum(mism)
        emit({"phase": "kernel-vs-plain",
              "case": f"ensemble-{n_rows}x400-crash0.15-"
                      f"{'reach' if reach else 'verdict'}",
              "M": pb.M, "rows": len(rows), "entries": int(pb.m.sum()),
              "W": 32, "F": 64, "reach": reach, "crash_free": False,
              "smem_bytes": smem, "levels": int(want[-4]),
              "path_levels": _path_levels(packed, rs, s0, kw, on_card),
              "unknown_rows": int((want[1] if reach else want[0] == -1)
                                  .sum()),
              "mismatches": mism, "kernel_s": t_kernel,
              "plain_s": t_plain})
    sub = wgl.PackedBatch(encs[:12])
    # segments 1, 2, 4, 6, 7, 8 and 10 unreferenced; 0, 3 and 9 repeated
    lrows = [(0, 0), (3, 1), (3, 0), (5, 2), (3, 1), (9, 4), (11, 0),
             (0, 3), (9, 4)]
    lay = ensemble.shard_layout(sub, lrows, 1)
    for reach in (False, True):
        calls: list = []
        original = _recording(wgl, "_run", calls)
        try:
            wgl._drain(ensemble.sharded_launch(sub, lrows, 32, 64,
                                               reach=reach, devices=dev),
                       reach=reach)
        finally:
            wgl._run = original
        r = _replay(calls[0], on_card)
        total += r["mismatches"]
        emit({"phase": "kernel-vs-plain",
              "case": f"ensemble-layout-{'reach' if reach else 'verdict'}",
              "segments": sub.B, "layout_segments": int(lay.mseg.size),
              "rows": len(lrows), "layout_rows": int(lay.row_seg.size),
              "levels": r["levels"], "mismatches": r["mismatches"]})
    return total


def _drains() -> list[dict]:
    return [sp.get("attrs", {}) for sp in telemetry.get().spans()
            if sp["name"] == "wgl:drain"]


def _ensemble_counters(c: dict) -> dict:
    return {"host_resolved_rows": c.get("wgl.host-resolved-rows", 0),
            "host_resolved_s": c.get("wgl.host-resolved-ns", 0) / 1e9,
            "encode_s": c.get("encode.ns", 0) / 1e9,
            "pack_s": c.get("wgl.batch.pack_ns", 0) / 1e9,
            "h2d_enqueue_s": c.get("wgl.kernel.h2d_ns", 0) / 1e9,
            "drain_wait_s": c.get("wgl.kernel.execute_ns", 0) / 1e9}


def ensemble_path(dev, on_card: bool, hists, chunk: int, bad: int) -> dict:
    """Phase 12: BASELINE config 5 through analysis_batch_streamed (three
    runs), analysis_batch and analysis_batch_sharded, with the kernel
    launch count set to 0 just before each and read just after; then the
    twin with member `bad` corrupted. Returns the recorded launches of
    each path and the launch counts."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    model = models.cas_register()
    n = len(hists)
    events = sum(len(h) for h in hists)
    per_path: dict = {"ensemble-streamed": []}
    recorded: dict = {}
    calls: list = []
    original = _recording(wgl, "_run", calls)
    try:
        for rep in range(3):
            calls.clear()
            ws.launches = 0
            telemetry.reset()
            t0 = time.perf_counter()
            res = wgl.analysis_batch_streamed(model, hists, chunk=chunk,
                                              device=dev)
            sync()
            t1 = time.perf_counter()
            launches = ws.launches
            not_valid = [i for i, r in enumerate(res)
                         if r["valid?"] is not True]
            if not_valid:
                raise AssertionError(f"ensemble members not valid: "
                                     f"{not_valid[:20]}")
            if on_card and launches != -(-n // chunk):
                raise AssertionError(f"{launches} launches for {n} "
                                     f"histories in chunks of {chunk}")
            drains = _drains()
            emit({"phase": "ensemble", "entry": "analysis_batch_streamed",
                  "rep": rep, "histories": n, "events": events,
                  "chunk": chunk, "wall_s": t1 - t0,
                  "events_per_s": events / (t1 - t0),
                  "wgl_search_launches": launches,
                  **_ensemble_counters(telemetry.get().counters()),
                  "kernel_ms": [d["device_ms"] for d in drains],
                  "drain_wait_ms": [d["wait_ns"] / 1e6 for d in drains],
                  "levels": [d["levels"] for d in drains],
                  "analyzers": sorted({r["analyzer"] for r in res})})
            per_path["ensemble-streamed"].append(launches)
        recorded["streamed"] = (list(calls), _drains())
        verdicts = [r["valid?"] for r in res]
        for entry in ("analysis_batch", "analysis_batch_sharded"):
            calls.clear()
            ws.launches = ensemble.launches = 0
            telemetry.reset()
            t0 = time.perf_counter()
            if entry == "analysis_batch":
                res = wgl.analysis_batch(model, hists, device=dev)
            else:
                res = ensemble.analysis_batch_sharded(model, hists,
                                                      devices=dev)
            sync()
            t1 = time.perf_counter()
            launches = ws.launches
            if [r["valid?"] for r in res] != verdicts:
                raise AssertionError(f"{entry} disagrees with the "
                                     "streamed verdicts")
            if on_card and launches != 1:
                raise AssertionError(f"{entry}: {launches} launches")
            if entry.endswith("sharded"):
                per_path["ensemble-sharded (B2)"] = ensemble.launches
                if on_card and ensemble.launches != 1:
                    raise AssertionError(f"{ensemble.launches} sharded "
                                         "launches")
            per_path[entry] = launches
            recorded[entry] = (list(calls), _drains())
            emit({"phase": "ensemble", "entry": entry, "histories": n,
                  "wall_s": t1 - t0, "events_per_s": events / (t1 - t0),
                  "wgl_search_launches": launches,
                  "sharded_launches": ensemble.launches,
                  **_ensemble_counters(telemetry.get().counters()),
                  "kernel_ms": [d["device_ms"] for d in _drains()],
                  "analyzers": sorted({r["analyzer"] for r in res})})
    finally:
        wgl._run = original
    twin = list(hists)
    twin[bad] = synth.corrupt_register_history(hists[bad],
                                               at_frac=TWIN_AT_FRAC)[0]
    telemetry.reset()
    t0 = time.perf_counter()
    tres = wgl.analysis_batch_streamed(model, twin, chunk=chunk,
                                       device=dev)
    sync()
    t1 = time.perf_counter()
    not_valid = [i for i, r in enumerate(tres) if r["valid?"] is not True]
    w = tres[bad]
    if not_valid != [bad] or w["valid?"] is not False:
        raise AssertionError(f"twin: members {not_valid[:20]} not valid")
    if w.get("op") is None and not w.get("configs"):
        raise AssertionError(f"twin member {bad} carries no witness: {w}")
    emit({"phase": "ensemble-twin", "member": bad,
          "at_frac": TWIN_AT_FRAC, "invalid_members": not_valid,
          "analyzer": w["analyzer"],
          "witness_extraction": w["witness-extraction"],
          "witness_entry": w.get("witness-entry"),
          "op_indices": w.get("op-indices"), "wall_s": t1 - t0,
          **_ensemble_counters(telemetry.get().counters())})
    und = encode(model, synth.corrupt_register_history(
        hists[bad], at_frac=UNDECIDED_AT_FRAC)[0])
    code = int(wgl.check_batch([und], device=dev)[0])
    if code == wgl.VALID:
        raise AssertionError(f"member {bad} corrupted at "
                             f"{UNDECIDED_AT_FRAC} judged VALID")
    emit({"phase": "ensemble-twin-undecided", "member": bad,
          "at_frac": UNDECIDED_AT_FRAC, "entries": und.m,
          "crashed_entries": int(und.crashed.sum()), "kernel_code": code,
          "host_search": "not run (exponential in the crashed writes "
                         "before the bad read)"})
    return {"recorded": recorded, "per_path": per_path}


def independent_path(dev, on_card: bool, hists, bad: int,
                     n_validate: int = 15) -> tuple[dict, dict]:
    """Phase 13: the independent-key checker over the ensemble folded
    into one multi-key history, and its twin. Returns the launches per
    check, and the two histories and each check's wall seconds (phase 19
    checks them again through compose)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n = len(hists)
    t0 = time.perf_counter()
    multi = fold_keys(hists)
    twin_hists = list(hists)
    twin_hists[bad] = synth.corrupt_register_history(
        hists[bad], at_frac=TWIN_AT_FRAC)[0]
    twin = fold_keys(twin_hists)
    fold_s = time.perf_counter() - t0
    chk = independent.checker(linearizable({"model": models.cas_register(),
                                            "device": dev}))
    per_path = {}
    direct = {"histories": {"independent": multi,
                            "independent-twin": twin}, "check_s": {}}
    for name, h in (("independent", multi), ("independent-twin", twin)):
        ws.launches = 0
        telemetry.reset()
        t0 = time.perf_counter()
        res = chk.check({}, h)
        sync()
        t1 = time.perf_counter()
        launches = ws.launches
        c = telemetry.get().counters()
        results = res["results"]
        if len(results) != n:
            raise AssertionError(f"{name}: {len(results)} keys, want {n}")
        odd = [k for k, r in results.items()
               if "error" in r or not isinstance(r["valid?"], bool)]
        if odd:
            raise AssertionError(f"{name}: keys {odd[:10]} errored")
        if on_card and launches != 1:
            raise AssertionError(f"{name}: {launches} wgl launches")
        n_cert = c.get("certify.extracted", 0) + c.get("certify.absent", 0)
        if n_cert != n:
            raise AssertionError(f"{name}: {n_cert} certificates for {n}")
        want_failures = [] if name == "independent" else [bad]
        if res["valid?"] is not (not want_failures) \
                or res["failures"] != want_failures:
            raise AssertionError(f"{name}: valid? {res['valid?']} "
                                 f"failures {res['failures'][:10]}")
        absent = {k: r["certificate"]["absent"] for k, r in results.items()
                  if "absent" in r["certificate"]}
        present = sorted(k for k in results if k not in absent)
        if name == "independent":
            rng = np.random.default_rng(13)
            sample = sorted(int(k) for k in rng.choice(
                present, size=min(n_validate, len(present)),
                replace=False))
        else:
            sample = [bad] if bad in present else []
        t2 = time.perf_counter()
        digest = certify.history_digest(h)
        for k in sample:
            certify.validate(h, results[k]["certificate"], digest=digest)
        t3 = time.perf_counter()
        per_path[name] = launches
        direct["check_s"][name] = t1 - t0
        emit({"phase": "independent", "check": name, "keys": n,
              "events": len(h), "valid": res["valid?"],
              "failures": res["failures"], "wgl_search_launches": launches,
              "certify_extracted": c.get("certify.extracted", 0),
              "certify_absent": c.get("certify.absent", 0),
              "absent": {str(k): v for k, v in absent.items()},
              "validated_keys": sample, "validate_s": t3 - t2,
              "fold_s": fold_s, "check_s": t1 - t0,
              "events_per_s": len(h) / (t1 - t0),
              "subhistories_s": _span_s("independent:subhistories"),
              "kernel_ms": [d["device_ms"] for d in _drains()],
              "certify_attach_s": _span_s("certify.attach"),
              **_ensemble_counters(c)})
    return per_path, direct


def _slices_against_host(dev, on_card: bool, slices, seed: int):
    """check_slices over `slices` in one launch at W=24, F=48 on `dev`;
    every row the card answers as known searched on the host
    (search_host_reach), and 8 rows picked by `seed` run again through
    check_slices on the CPU. Unknown rows are not searched (ROADMAP C3).
    Returns (out, unk, {row: host mask}, launch s, host s, CPU rows,
    whether the CPU rows equal the card's)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out, unk = wgl.check_slices(slices, W=24, F=48, device=dev)
    sync()
    t1 = time.perf_counter()
    host = {i: wgl.search_host_reach(e.with_init(s))
            for i, (e, s) in enumerate(slices) if not unk[i]}
    t2 = time.perf_counter()
    pick = sorted(int(i) for i in np.random.default_rng(seed).choice(
        len(slices), size=8, replace=False))
    cpu_out, cpu_unk = wgl.check_slices([slices[i] for i in pick], W=24,
                                        F=48, device="cpu")
    cpu_equal = (cpu_out.tolist() == out[pick].tolist()
                 and cpu_unk.tolist() == unk[pick].tolist())
    return out, unk, host, t1 - t0, t2 - t1, pick, cpu_equal


def slices_path(dev, on_card: bool, hists, n: int) -> int:
    """Phase 14: check_slices in the fleet's shape. Rows are every start
    state of the first n ensemble histories (each one Encoded object,
    shared by its rows) and of their crash-free twins (same seeds,
    crash_p 0), in one launch at W=24, F=48. Every row the card answers
    as known must equal the host reach search; unknown rows are counted
    and listed. Returns the launch count."""
    model = models.cas_register()
    groups = {"crashed": [encode(model, h) for h in hists[:n]],
              "crash-free": [encode(model, ensemble_hist(i, crash_p=0.0))
                             for i in range(n)]}
    slices, where = [], []
    for g, encs in groups.items():
        for i, e in enumerate(encs):
            for s in range(e.n_states):
                slices.append((e, s))
                where.append((g, i, s))
    ws.launches = 0
    telemetry.reset()
    out, unk, host, card_s, host_s, pick, cpu_equal = \
        _slices_against_host(dev, on_card, slices, 14)
    launches = ws.launches
    if on_card and launches != 1:
        raise AssertionError(f"check_slices: {launches} launches")
    bad = [where[i] for i, h in host.items() if h != int(out[i])]
    if bad:
        raise AssertionError(f"check_slices rows differ from the host "
                             f"reach search: {bad[:10]}")
    if not cpu_equal:
        raise AssertionError(f"check_slices card {out[pick]} {unk[pick]} "
                             f"!= cpu on rows {pick}")
    unknown = {g: sorted({i for (gg, i, _s), u in zip(where, unk)
                          if u and gg == g}) for g in groups}
    emit({"phase": "check_slices", "rows": len(slices),
          "segments": sum(len(v) for v in groups.values()),
          "wgl_search_launches": launches, "card_s": card_s,
          "known_rows": len(host), "unknown_rows": int(unk.sum()),
          "unknown_rows_by_group": {
              g: sum(1 for (gg, _i, _s), u in zip(where, unk)
                     if u and gg == g) for g in groups},
          "histories_with_unknown_rows": unknown,
          "host_reach_of_known_rows_s": host_s,
          "cpu_rows": [where[i] for i in pick], "cpu_equal": True})
    return launches


def _replay(rec, on_card: bool) -> dict:
    """One recorded `wgl._run` call replayed: the kernel (with the on-card
    gather of a sharded launch) by CUDA events, the plain version (plus
    a numpy gather), its bound, and the largest difference between the
    recorded outputs and the plain version's."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    args, kw, launch = rec
    packed, rs, s0, W, F, max_iters, reach = args
    kkw = dict(W=W, F=F, max_iters=max_iters, reach=reach,
               crash_free=kw["crash_free"])
    gather = kw.get("gather")
    n_res = 2 if reach else 1

    def card():
        outs = ws.wgl_search(packed, rs, s0, **kkw)
        if gather is not None:
            idx = gather.long()
            return [o.view(torch.int32).index_select(0, idx)
                    if o.dtype == torch.uint32 else o.index_select(0, idx)
                    for o in outs[:n_res]]
        return outs

    kernel_ms = _event_ms(card, reps=3) if on_card else None
    paths = _path_levels(packed, rs, s0, kkw, on_card)
    sync()
    t0 = time.perf_counter()
    want = list(ws.wgl_search_reference(packed, rs, s0, **kkw))
    if gather is not None:
        idx = gather.long()
        want = [w.to(torch.int64).index_select(0, idx)
                for w in want[:n_res]] + want[n_res:]
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    got = [o.to(rs.device) for o in launch.outs]
    nbytes, ops, bound_ms = _launch_bound(packed, rs, kkw, got)
    return {"rows": int(rs.numel()), "M": int(packed[0].shape[1]),
            "reach": reach, "levels": int(want[-4]),
            "kernel_ms": kernel_ms,
            "us_per_level": _us_per_level(kernel_ms, int(want[-4])),
            "path_levels": paths, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bytes": nbytes, "operations": ops,
            "max_abs_err": _max_abs_err(got, want),
            "mismatches": sum(_mismatches(got, want))}


def _cert_bytes(res: dict) -> bytes:
    return json.dumps(jsonable(res["certificate"]),
                      sort_keys=True).encode()


def _prefix(ops: list, frac: float) -> list:
    return ops[:int(len(ops) * frac)]


def _extend_run(dev, model, ops, store, certify_on: bool) -> dict:
    """One analysis_extend on the card, with the wgl_search count set to
    0 just before and read just after: its result, counters, launches,
    wall seconds and the device ms of its launches (wgl:drain spans)."""
    telemetry.reset()
    ws.launches = 0
    t0 = time.perf_counter()
    res = wgl.analysis_extend(model, History(ops), store_path=store,
                              certify=certify_on, device=dev)
    seconds = time.perf_counter() - t0
    c = telemetry.get().counters()
    return {"result": res, "counters": c, "launches": ws.launches,
            "seconds": seconds,
            "kernel_ms": sum(d.get("device_ms") or 0 for d in _drains()),
            "rows": c.get("wgl.kernel.rows", 0),
            "certify_s": _span_s("certify.attach")}


def _matched_segments(old: dict, new: dict) -> int:
    """Segments of `new` whose two cuts and digests equal `old`'s: what
    check_extend may reuse."""
    matched = 0
    for a, b, x, y in zip(old["cuts"], new["cuts"], old["digests"],
                          new["digests"]):
        if a != b or x != y:
            break
        matched += 1
    return max(0, matched - 1)


def _extend_line(name: str, r: dict, on_card: bool, **extra) -> dict:
    c = r["counters"]
    return {"phase": "extend", "run": name,
            "valid": r["result"]["valid?"],
            "failed_segment": r["result"].get("failed-segment"),
            "seconds": r["seconds"], "wgl_search_launches": r["launches"],
            "rows": r["rows"], "kernel_ms": r["kernel_ms"],
            "reused_masks": c.get("ckpt.extend.reused-masks", 0),
            "computed_masks": c.get("ckpt.extend.computed-masks", 0),
            "torn": c.get("ckpt.torn", 0), "stale": c.get("ckpt.stale", 0),
            "host_resolved_rows": c.get("wgl.host-resolved-rows", 0),
            "host_resolved_s": c.get("wgl.host-resolved-ns", 0) / 1e9,
            "encode_s": c.get("encode.ns", 0) / 1e9,
            "pack_s": c.get("wgl.batch.pack_ns", 0) / 1e9,
            "certify_s": r["certify_s"],
            **extra, "card": nvidia_smi_line() if on_card else "cpu"}


def _extend_masks(dev, on_card: bool, enc, cuts, rec) -> dict:
    """The extend path's launch held against the host: every (segment,
    state) row of the whole history through _slices_against_host, in one
    launch at check_extend's shape, as a fresh run makes it; every mask
    of the resumed run's record (reused or computed) is held against the
    same host search where the row is known."""
    K, S = len(cuts) - 1, enc.n_states
    if rec["cuts"] != [int(c) for c in cuts] or \
            rec["states"] != [repr(x) for x in enc.states]:
        raise AssertionError("the resumed record's cuts or states differ "
                             "from the history's encoding")
    segs = [enc.segment(cuts[k], cuts[k + 1]) for k in range(K)]
    keys = [(k, s) for k in range(K) for s in range(S)]
    out, unk, host, card_s, host_s, pick, cpu_equal = _slices_against_host(
        dev, on_card, [(segs[k], s) for k, s in keys], 16)
    bad = [keys[i] for i, h in host.items() if h != int(out[i])]
    masks = rec["masks"]
    on_rec = [i for i in host if f"{keys[i][0]}:{keys[i][1]}" in masks]
    bad_rec = [keys[i] for i in on_rec
               if masks[f"{keys[i][0]}:{keys[i][1]}"] != host[i]]
    line = {"phase": "extend-masks", "rows": len(keys),
            "known_rows": len(host), "unknown_rows": int(unk.sum()),
            "card_s": card_s, "mismatches": len(bad),
            "record_masks_checked": len(on_rec),
            "record_mismatches": len(bad_rec),
            "host_reach_of_known_rows_s": host_s,
            "cpu_rows": [keys[i] for i in pick], "cpu_equal": cpu_equal}
    emit(line)
    if bad or bad_rec or not cpu_equal:
        raise AssertionError(f"extend masks differ from the host reach "
                             f"search: launch {bad[:10]}, record "
                             f"{bad_rec[:10]}, cpu rows equal {cpu_equal}")
    return line


def extend_path(dev, on_card: bool, hist, bad) -> dict:
    """Phase 16: checkpoint-and-extend on the headline history. The
    first 90% of its ops writes a wgl-extend record; the whole history
    resumes from it and must equal, certificate byte for byte, a fresh
    analysis_extend without a store, computing at most (K - matched
    segments + 1) * S masks; the 85%-corrupted twin resumed from its
    clean 80% prefix must equal its fresh check (invalid, same failed
    segment, same certificate); a torn record counts ckpt.torn and
    gives the fresh verdict and certificate. The masks of the whole
    history's launch and record are held against the host
    (_extend_masks). Returns the launches of each run."""
    model = models.cas_register()
    ops, bad_ops = list(hist), list(bad)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "extend.ckpt"
        r = _extend_run(dev, model, _prefix(ops, 0.9), store, False)
        prefix_rec = ckpt.read(store)
        if prefix_rec is None or r["counters"].get("ckpt.saved") != 1:
            raise AssertionError("the 90% prefix wrote no wgl-extend "
                                 "record")
        launches["extend-prefix"] = r["launches"]
        emit(_extend_line("prefix-90%", r, on_card,
                          ops=len(ops) * 9 // 10,
                          segments=len(prefix_rec["cuts"]) - 1))
        fresh = _extend_run(dev, model, ops, None, True)
        launches["extend-fresh"] = fresh["launches"]
        torn_store = Path(tmp) / "torn.ckpt"
        torn_store.write_bytes(store.read_bytes())
        resumed = _extend_run(dev, model, ops, store, True)
        launches["extend-resumed"] = resumed["launches"]
        # the entry digest chain, which every run computes on the host
        enc = encode(model, History(ops))
        cuts = wgl.segment_cuts(enc, wgl.EXTEND_STRIDE)
        t0 = time.perf_counter()
        ckpt.entry_digest_chain(enc, cuts)
        digest_s = time.perf_counter() - t0
        new_rec = ckpt.read(store)
        checked = _extend_masks(dev, on_card, enc, cuts, new_rec)
        del enc
        K = len(new_rec["cuts"]) - 1
        S = len(new_rec["states"])
        matched = _matched_segments(prefix_rec, new_rec)
        computed = resumed["counters"].get("ckpt.extend.computed-masks")
        fr, rr = fresh["result"], resumed["result"]
        same = _norm(rr) == _norm(fr) and \
            _cert_bytes(rr) == _cert_bytes(fr)
        emit(_extend_line("fresh", fresh, on_card, segments=K, states=S,
                          digest_chain_s=digest_s,
                          mask_mismatches=checked["mismatches"]))
        emit(_extend_line("resumed-from-90%", resumed, on_card,
                          segments=K, states=S, matched_segments=matched,
                          computed_bound=(K - matched + 1) * S,
                          certificate_equal=same,
                          mask_mismatches=checked["record_mismatches"]))
        if fr["valid?"] is not True or not same:
            raise AssertionError(f"resumed extend differs from fresh: "
                                 f"valid {fr['valid?']} / {rr['valid?']}")
        if matched < 1 or computed is None or \
                computed > (K - matched + 1) * S:
            raise AssertionError(f"resumed extend computed {computed} "
                                 f"masks, K={K} matched={matched} S={S}")
        if on_card and not (fresh["launches"] and resumed["launches"]):
            raise AssertionError("an extend run launched no kernel")
        certify.validate(hist, rr["certificate"])

        # the torn record: counted, the fresh verdict and certificate
        data = torn_store.read_bytes()
        torn_store.write_bytes(data[:len(data) // 2])
        torn = _extend_run(dev, model, ops, torn_store, True)
        launches["extend-torn"] = torn["launches"]
        emit(_extend_line("torn-record", torn, on_card))
        if torn["counters"].get("ckpt.torn") != 1 or \
                _norm(torn["result"]) != _norm(fr) or \
                _cert_bytes(torn["result"]) != _cert_bytes(fr):
            raise AssertionError("a torn record changed the result")

        # the 85%-corrupted twin, resumed from its clean 80% prefix
        twin_store = Path(tmp) / "twin.ckpt"
        r = _extend_run(dev, model, _prefix(bad_ops, 0.8), twin_store,
                        False)
        launches["extend-twin-prefix"] = r["launches"]
        twin_fresh = _extend_run(dev, model, bad_ops, None, True)
        twin = _extend_run(dev, model, bad_ops, twin_store, True)
        launches["extend-twin-fresh"] = twin_fresh["launches"]
        launches["extend-twin-resumed"] = twin["launches"]
        tf, tr = twin_fresh["result"], twin["result"]
        same = _norm(tr) == _norm(tf) and \
            _cert_bytes(tr) == _cert_bytes(tf)
        emit(_extend_line("twin-fresh", twin_fresh, on_card))
        emit(_extend_line("twin-resumed-from-80%", twin, on_card,
                          certificate_equal=same))
        if tf["valid?"] is not False or not same or \
                twin["counters"].get("ckpt.extend.resumed") != 1:
            raise AssertionError(f"the twin resumed {tr['valid?']} at "
                                 f"{tr.get('failed-segment')}, fresh "
                                 f"{tf['valid?']} at "
                                 f"{tf.get('failed-segment')}")
        certify.validate(bad, tr["certificate"])
    return {"launches": launches,
            "fresh": {k: fresh[k] for k in ("seconds", "launches",
                                             "kernel_ms", "rows")},
            "resumed": {k: resumed[k] for k in ("seconds", "launches",
                                                "kernel_ms", "rows")}}


def resumable_segmented(dev, on_card: bool, enc, target_len: int) -> dict:
    """Phase 17: check_segmented(enc, checkpoint_dir=...) on the headline
    history twice. The second run loads every mask the first saved and
    launches no kernel, with the same result."""
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(2):
            telemetry.reset()
            ws.launches = 0
            t0 = time.perf_counter()
            res = wgl.check_segmented(enc, target_len=target_len,
                                      device=dev, checkpoint_dir=tmp)
            seconds = time.perf_counter() - t0
            c = telemetry.get().counters()
            runs.append((res, c, ws.launches))
            emit({"phase": "segmented-checkpoint", "rep": rep,
                  "valid": res["valid?"], "segments": res["segments"],
                  "seconds": seconds, "wgl_search_launches": ws.launches,
                  "saved": c.get("wgl.checkpoint.saved", 0),
                  "loaded": c.get("wgl.checkpoint.loaded", 0),
                  "files": sorted(p.name for p in Path(tmp).iterdir()),
                  "card": nvidia_smi_line() if on_card else "cpu"})
    (first, c1, n1), (second, c2, n2) = runs
    if first["valid?"] is not True or second != first or n2 != 0 or \
            c2.get("wgl.checkpoint.loaded") != c1.get(
                "wgl.checkpoint.saved") or (on_card and n1 == 0):
        raise AssertionError(f"resumed segmented check: {n1} then {n2} "
                             f"launches, saved "
                             f"{c1.get('wgl.checkpoint.saved')}, loaded "
                             f"{c2.get('wgl.checkpoint.loaded')}")
    return {"segmented-checkpoint-first": n1,
            "segmented-checkpoint-resumed": n2}


def checker_extend(dev, on_card: bool, hist) -> dict:
    """Phase 18: the linearizable checker with a store directory and
    extend? on the card: valid, through analysis_extend, with a
    certificate that validates."""
    with tempfile.TemporaryDirectory() as tmp:
        telemetry.reset()
        ws.launches = 0
        t0 = time.perf_counter()
        res = linearizable({"model": models.cas_register(),
                            "device": dev}).check(
            {"store_dir": tmp, "extend?": True}, hist)
        seconds = time.perf_counter() - t0
        stored = sorted(p.name for p in (Path(tmp) / "ckpt").iterdir())
    certify.validate(hist, res["certificate"])
    emit({"phase": "checker-extend", "valid": res["valid?"],
          "analyzer": res["analyzer"], "seconds": seconds,
          "wgl_search_launches": ws.launches, "stored": stored,
          "card": nvidia_smi_line() if on_card else "cpu"})
    if res["valid?"] is not True or res["analyzer"] != "gpu-extend" or \
            len(stored) != 1 or (on_card and ws.launches == 0):
        raise AssertionError(f"checker extend?: {res['valid?']} "
                             f"{res['analyzer']} {stored}")
    return {"checker-extend": ws.launches}


RENDERERS = ("render_linear_svg", "write_linear_trace_excerpt",
             "write_elle_artifacts", "write_trace_excerpts")


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(Path(d).rglob("*")) if p.is_file()}


def _unsound(res, where: str = "") -> list[str]:
    """Where a composed result holds valid? "unknown" or an error."""
    out = []
    if isinstance(res, dict):
        if res.get("valid?") == "unknown" or "error" in res:
            out.append(where or "/")
        for k, v in res.items():
            out += _unsound(v, f"{where}/{k}")
    elif isinstance(res, (list, tuple)):
        for i, v in enumerate(res):
            out += _unsound(v, f"{where}/{i}")
    return out


def _rendering_timed(seconds: dict):
    """Replaces explain's renderers with wrappers that add each call's
    wall seconds to seconds[name] (the checkers call them from Compose's
    worker threads); returns the originals."""
    lock = threading.Lock()
    originals = {name: getattr(explain, name) for name in RENDERERS}

    def timed(name, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                with lock:
                    seconds[name] = seconds.get(name, 0.0) + (
                        time.perf_counter() - t0)
        return wrapper

    for name, fn in originals.items():
        setattr(explain, name, timed(name, fn))
    return originals


def _composed(name: str, checker, history, store: Path, on_card: bool,
              direct_s, kernel: str) -> tuple[dict, dict]:
    """One composed check into `store`, every launch count set to 0 just
    before and read just after. Returns (result, line)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    render_s: dict = {}
    originals = _rendering_timed(render_s)
    ws.launches = kscc.launches = kscc.converge_launches = 0
    kbank.launches = 0
    telemetry.reset()
    try:
        t0 = time.perf_counter()
        res = checker.check({"store_dir": str(store)}, history)
        sync()
        wall = time.perf_counter() - t0
    finally:
        for fn_name, fn in originals.items():
            setattr(explain, fn_name, fn)
    launches = {"wgl_search": ws.launches, "scc": kscc.launches,
                "scc_converge": kscc.converge_launches,
                "bank_reduce": kbank.launches}
    bad = _unsound(res)
    if bad:
        raise AssertionError(f"{name}: unknown or error at {bad[:10]}")
    if on_card and launches[kernel] < 1:
        raise AssertionError(f"{name}: no {kernel} launch from compose")
    spans = {sp["name"]: (sp["t1"] - sp["t0"]) / 1e9
             for sp in telemetry.get().spans()
             if sp["name"].startswith("checker:")}
    line = {"phase": "composed", "check": name, "valid": res["valid?"],
            "wall_s": wall, "direct_s": direct_s,
            "checker_spans_s": spans, "render_s": render_s,
            "launches": launches, "files": len(_files(store)),
            "card": nvidia_smi_line() if on_card else "cpu"}
    return res, line


def composed_path(dev, on_card: bool, elle_direct: dict, la_bad_cross,
                  bank_direct: dict, ind_direct: dict, bad: int) -> dict:
    """Phase 19: the checker stacks a Jepsen test composes, on the card,
    over the histories of phases 8-10 and 13, each into a fresh store
    directory: (a) the register stack over the folded ensemble and its
    twin, whose key `bad` must leave a counterexample SVG equal to the
    one key `bad` checked alone on the CPU leaves; (b) the list-append
    stack over the 100k history and its twin (G0 artifacts), and phase
    9's corrupted history through the card and the CPU, with the same
    files; (c) the bank stack. No sub-result may be "unknown" or carry
    an error. Returns the launches per check."""
    launches = {}
    register = chk.compose({
        "linear": independent.checker(linearizable(
            {"model": models.cas_register(), "device": dev})),
        "stats": chk.stats(), "exceptions": chk.unhandled_exceptions()})
    append = chk.compose({"elle": cycle.append_checker({"device": dev}),
                          "stats": chk.stats()})
    bank_stack = chk.compose({
        "bank": bank.checker({"total-amount": bank_direct["total"],
                              "device": dev}),
        "stats": chk.stats()})
    checks = [
        ("register", register, ind_direct["histories"]["independent"],
         ind_direct["check_s"]["independent"], "wgl_search"),
        ("register-twin", register,
         ind_direct["histories"]["independent-twin"],
         ind_direct["check_s"]["independent-twin"], "wgl_search"),
        ("list-append", append, elle_direct["histories"]["list-append"],
         elle_direct["check_s"]["list-append"], "scc"),
        ("list-append-twin", append,
         elle_direct["histories"]["list-append-corrupted"],
         elle_direct["check_s"]["list-append-corrupted"], "scc"),
        ("bank", bank_stack, bank_direct["history"],
         bank_direct["check_s"], "bank_reduce"),
        ("bank-twin", bank_stack, bank_direct["twin"], None,
         "bank_reduce")]
    with tempfile.TemporaryDirectory() as tmp:
        for name, checker, h, direct_s, kernel in checks:
            store = Path(tmp) / name
            store.mkdir()
            res, line = _composed(name, checker, h, store, on_card,
                                  direct_s, kernel)
            launches[f"composed-{name}"] = line["launches"][kernel]
            twin = name.endswith("-twin")
            if res["valid?"] is twin:
                raise AssertionError(f"{name}: valid? {res['valid?']}")
            if not twin and _files(store):
                raise AssertionError(f"{name}: valid, but wrote "
                                     f"{sorted(_files(store))[:5]}")
            if name == "register-twin":
                line.update(_register_twin(res, h, bad, store, Path(tmp)))
            elif name == "list-append-twin":
                line.update(_append_twin(res, store))
            elif name == "bank-twin":
                want = _norm(bank_direct["first_error"])
                if _norm(res["bank"]["first-error"]) != want:
                    raise AssertionError(f"bank twin: "
                                         f"{res['bank']['first-error']} "
                                         f"!= phase 10's {want}")
                line["first_error_equals_phase_10"] = True
            emit(line)
        line = _append_card_against_cpu(dev, on_card, la_bad_cross,
                                        Path(tmp))
        emit(line)
    return launches


def _register_twin(res, h, bad: int, store: Path, tmp: Path) -> dict:
    """(a): key `bad` invalid alone, its SVG on disk and byte-equal to
    the one its subhistory leaves when checked alone on the CPU."""
    linear = res["linear"]
    if linear["failures"] != [bad]:
        raise AssertionError(f"register twin: failures "
                             f"{linear['failures'][:10]}")
    svg = Path(linear["results"][bad]["counterexample-svg"])
    body = svg.read_bytes()
    if not body.startswith(b"<svg"):
        raise AssertionError(f"{svg} is not an SVG")
    alone = tmp / "register-key-alone"
    alone.mkdir()
    sub = independent.subhistories(h)[bad]
    t0 = time.perf_counter()
    cpu = linearizable({"model": models.cas_register(),
                        "device": "cpu"}).check({"store_dir": str(alone)},
                                                sub)
    cpu_s = time.perf_counter() - t0
    cpu_svg = Path(cpu["counterexample-svg"])
    if cpu_svg.name != svg.name or cpu_svg.read_bytes() != body:
        raise AssertionError(f"key {bad}: card {svg.name} != CPU alone "
                             f"{cpu_svg.name}")
    return {"failures": linear["failures"], "svg": svg.name,
            "svg_bytes": len(body), "svg_equals_cpu_alone": True,
            "cpu_alone_s": cpu_s}


def _append_twin(res, store: Path) -> dict:
    """(b): the twin's G0 and its artifacts on disk."""
    elle_res = res["elle"]
    # the full-size twin's known shape (smaller rehearsal sizes damage
    # another read, as in phase 8)
    want = ("G0" if elle_res["txn-count"] == 100_000
            else elle_res["anomaly-types"][0])
    if want not in elle_res["anomaly-types"]:
        raise AssertionError(f"list-append twin: "
                             f"{elle_res['anomaly-types']}")
    paths = [Path(p) for p in elle_res.get("artifacts", [])]
    rel = [str(p.relative_to(store)) for p in paths]
    named = [r for r in rel
             if r.startswith(f"elle/{want}-") and r.endswith(".txt")]
    if not all(p.exists() for p in paths) or not named:
        raise AssertionError(f"list-append twin artifacts: {rel[:10]}")
    return {"anomaly_types": elle_res["anomaly-types"],
            "artifacts": len(rel), "anomaly_file": named[0]}


def _append_card_against_cpu(dev, on_card: bool, hist, tmp: Path) -> dict:
    """(b): phase 9's corrupted history through the list-append checker on
    the card and on the CPU: the same files, byte for byte, and the same
    result."""
    out = {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        store = tmp / f"append-20k-{side}"
        store.mkdir()
        t0 = time.perf_counter()
        res = cycle.append_checker({"device": d}).check(
            {"store_dir": str(store)}, hist)
        out[side] = (store, res, time.perf_counter() - t0)
    (cs, cres, c_s), (ps, pres, p_s) = out["card"], out["cpu"]
    cf, pf = _files(cs), _files(ps)
    if cf != pf or not cf:
        raise AssertionError(f"append 20k: card files {sorted(cf)[:5]} != "
                             f"CPU files {sorted(pf)[:5]}")
    strip = json.dumps(_norm(cres), default=repr).replace(str(cs), "")
    if strip != json.dumps(_norm(pres), default=repr).replace(str(ps), ""):
        raise AssertionError("append 20k: card and CPU results differ")
    return {"phase": "composed", "check": "list-append-20k card vs cpu",
            "anomaly_types": cres["anomaly-types"], "files": len(cf),
            "bytes": sum(len(b) for b in cf.values()),
            "identical_files": True, "identical_results": True,
            "card_s": c_s, "cpu_s": p_s,
            "card": nvidia_smi_line() if on_card else "cpu"}


def run(dev: torch.device, n_headline: int = 500_000,
        target_len: int = 8192, min_segments: int = 40,
        n_cross: int = 20_000, n_elle: int = 100_000,
        n_elle_cross: int = 20_000, n_bank: int = 500_000,
        n_ensemble: int = ENSEMBLE_N, chunk: int = ENSEMBLE_CHUNK,
        bad_member: int = ENSEMBLE_BAD, n_plain_rows: int = 128,
        n_slices: int = 64, n_adversarial: int = 100_000,
        n_adversarial_chain: int = 20_001) -> dict:
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    # 2. build
    info = None
    if on_card:
        info = build.build_all()
        emit({"phase": "build", "seconds": info["seconds"],
              "libraries": info["libraries"],
              "ptxas": {n: _ptxas(info, n) for n in info["ptxas"]}})

    # 3. kernel against its plain version on the same tensors
    total_mism = 0
    path_total = {"warp": 0, "block": 0, "warp_sorted": 0}
    for name, encs, rows, W, F, reach in _seeded_cases():
        pb = wgl.PackedBatch(encs)
        packed, rs, s0 = pb.tensors(*pb.rows(rows), dev)
        kw = dict(W=W, F=F, max_iters=pb.M + 4, reach=reach,
                  crash_free=not pb.has_crashed)
        sync()
        t0 = time.perf_counter()
        got = ws.wgl_search(packed, rs, s0, **kw)
        sync()
        t_kernel = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = ws.wgl_search_reference(packed, rs, s0, **kw)
        sync()
        t_plain = time.perf_counter() - t0
        mism = _mismatches(got, want)
        total_mism += sum(mism)
        paths = _path_levels(packed, rs, s0, kw, on_card)
        for k in path_total:
            path_total[k] += paths[k] if paths else 0
        emit({"phase": "kernel-vs-plain", "case": name, "M": pb.M,
              "S": pb.S, "rows": len(rows), "entries": int(pb.m.sum()), "W": W,
              "F": F, "reach": reach, "crash_free": kw["crash_free"],
              "levels": int(want[-4]), "mismatches": mism,
              "path_levels": paths, "kernel_s": t_kernel,
              "plain_s": t_plain})
    emit({"phase": "kernel-paths", "seeded_cases": path_total})
    if on_card and not all(path_total.values()):
        raise AssertionError(f"the seeded cases did not run every level "
                             f"path of the kernel: {path_total}")
    total_mism += ensemble_against_plain(dev, on_card, n_plain_rows)
    if total_mism:
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"in {total_mism} values")

    # 4. the main path at full size: the 1M-event headline history
    t0 = time.perf_counter()
    hist = synth.register_history(n_headline, n_procs=5, seed=42)
    gen_s = time.perf_counter() - t0
    recorded = []
    original = ws.wgl_search

    def recording(packed, rs, s0, **kw):
        out = original(packed, rs, s0, **kw)
        recorded.append((packed, rs, s0, kw, out))
        return out

    runs = []
    ws.wgl_search = recording
    try:
        for rep in range(3):
            recorded.clear()
            ws.launches = 0
            telemetry.reset()
            t0 = time.perf_counter()
            enc = encode(models.cas_register(), hist)
            t1 = time.perf_counter()
            res = wgl.check_segmented(enc, target_len=target_len,
                                      device=dev)
            sync()
            t2 = time.perf_counter()
            launches = ws.launches
            counters = telemetry.get().counters()
            if res is None or res["valid?"] is not True:
                raise AssertionError(f"headline history not valid: {res}")
            if res["segments"] < min_segments:
                raise AssertionError(f"only {res['segments']} segments")
            if on_card and launches == 0:
                raise AssertionError("the main path launched no kernel")
            runs.append({"encode_s": t1 - t0, "check_s": t2 - t1,
                         "events_per_s": len(hist) / (t2 - t0)})
            emit({"phase": "headline", "rep": rep, "events": len(hist),
                  "entries": enc.m, "segments": res["segments"],
                  "encode_s": t1 - t0, "check_s": t2 - t1,
                  "events_per_s": len(hist) / (t2 - t0),
                  "generate_s": gen_s,
                  "wgl_search_launches": launches,
                  "rows": counters.get("wgl.kernel.rows", 0),
                  "levels": counters.get("wgl.search.levels", 0),
                  "host_resolved_rows": counters.get(
                      "wgl.host-resolved-rows", 0),
                  "host_resolved_s": counters.get(
                      "wgl.host-resolved-ns", 0) / 1e9,
                  "pack_s": counters.get("wgl.batch.pack_ns", 0) / 1e9,
                  "h2d_s": counters.get("wgl.kernel.h2d_ns", 0) / 1e9,
                  "drain_s": counters.get("wgl.kernel.execute_ns", 0)
                  / 1e9,
                  "card": nvidia_smi_line() if on_card else "cpu"})
        main_launches = list(recorded)
        main_count = launches
    finally:
        ws.wgl_search = original

    bad, bad_idx = synth.corrupt_register_history(hist, at_frac=0.85)
    benc = encode(models.cas_register(), bad)
    t0 = time.perf_counter()
    bres = wgl.check_segmented(benc, target_len=target_len, device=dev)
    sync()
    bad_s = time.perf_counter() - t0
    if bres is None or bres["valid?"] is not False:
        raise AssertionError(f"corrupted history not invalid: {bres}")
    k = bres["failed-segment"]
    lo, hi = bres["segment-range"]
    start = bres["search-chain"]["chain"][k]
    reach = wgl.search_host_reach(benc.segment(lo, hi, init_state=start))
    if reach != 0:
        raise AssertionError(f"failed segment {k} reaches {reach:#x} "
                             f"from state {start} on the host")
    emit({"phase": "headline-corrupted", "bad_event": bad_idx,
          "failed_segment": k, "segment_range": [lo, hi],
          "check_s": bad_s, "host_reach_of_failed_segment": reach})

    # 5. slice cross-check: card against the CPU's plain kernel
    cross = synth.register_history(n_cross, n_procs=5, seed=7)
    cross_bad = synth.corrupt_register_history(cross, at_frac=0.5)[0]
    for label, h in (("valid", cross), ("invalid", cross_bad)):
        e = encode(models.cas_register(), h)
        t0 = time.perf_counter()
        on_dev = wgl.check_segmented(e, witness=True, device=dev)
        t1 = time.perf_counter()
        on_cpu = wgl.check_segmented(e, witness=True, device="cpu")
        t2 = time.perf_counter()
        if on_dev != on_cpu:
            raise AssertionError(f"{label}: card {on_dev} != cpu {on_cpu}")
        if on_dev["valid?"] is not (label == "valid"):
            raise AssertionError(f"{label} history judged {on_dev}")
        res = wgl.analysis(models.cas_register(), h, certify=True,
                           device=dev)
        certify.validate(h, res["certificate"])
        chk = linearizable({"model": models.cas_register(),
                            "device": dev}).check({}, h)
        if chk["valid?"] is not on_dev["valid?"]:
            raise AssertionError(f"checker disagrees: {chk['valid?']}")
        certify.validate(h, chk["certificate"])
        emit({"phase": "cross-check", "history": label, "events": len(h),
              "entries": e.m, "segments": on_dev.get("segments"),
              "card_s": t1 - t0, "cpu_plain_s": t2 - t1,
              "analyzer": res["analyzer"], "certified": True})

    # 6. the kernel on the main path's own launches
    per_launch = []
    max_err = 0
    for packed, rs, s0, kw, out in main_launches:
        nbytes, ops, bound_ms = _launch_bound(packed, rs, kw, out)
        kernel_ms = (_event_ms(lambda: original(packed, rs, s0, **kw),
                               reps=3) if on_card else None)
        paths = _path_levels(packed, rs, s0, kw, on_card)
        sync()
        t0 = time.perf_counter()
        want = ws.wgl_search_reference(packed, rs, s0, **kw)
        sync()
        per_launch.append({
            "rows": int(rs.numel()), "M": int(packed[0].shape[1]),
            "reach": kw["reach"], "levels": int(out[-4]),
            "kernel_ms": kernel_ms,
            "us_per_level": _us_per_level(kernel_ms, int(out[-4])),
            "path_levels": paths,
            "plain_ms": 1e3 * (time.perf_counter() - t0),
            "bound_ms": bound_ms, "bytes": nbytes, "operations": ops})
        max_err = max(max_err, _max_abs_err(out, want))
    if max_err:
        raise AssertionError(f"main-path launches differ from the plain "
                             f"version by up to {max_err}")
    nbytes = sum(x["bytes"] for x in per_launch)
    ops = sum(x["operations"] for x in per_launch)
    kernel_ms = (sum(x["kernel_ms"] for x in per_launch)
                 if on_card else None)

    # 7. scc and bank_reduce against their plain versions
    mism = kernels_against_plain(dev, on_card)
    if mism:
        raise AssertionError(f"scc/bank_reduce disagree with their plain "
                             f"versions in {mism} values")
    adversarial = scc_adversarial(dev, on_card, n_adversarial,
                                  n_adversarial_chain)
    # 8-10. the Elle and bank paths; 11. their kernels on their launches
    scc_recorded, scc_per_check, elle_direct = elle_main_path(
        dev, on_card, n_elle)
    la_bad_cross = elle_cross_check(dev, n_elle_cross)
    bank_recorded, bank_launches, bank_direct = bank_path(dev, on_card,
                                                          n_bank)
    scc_entry = scc_timing(scc_recorded, scc_per_check, on_card, info)
    scc_entry["convergence_launch"] = adversarial
    bank_entry = bank_timing(bank_recorded, bank_launches, on_card, info)

    # 12-14. the batch path at BASELINE config 5's size
    t0 = time.perf_counter()
    hists = [ensemble_hist(i) for i in range(n_ensemble)]
    emit({"phase": "ensemble-generate", "histories": n_ensemble,
          "events": sum(len(h) for h in hists),
          "generate_s": time.perf_counter() - t0})
    ens = ensemble_path(dev, on_card, hists, chunk, bad_member)
    per_path = {"headline": main_count, **ens["per_path"]}
    ind_launches, ind_direct = independent_path(dev, on_card, hists,
                                                bad_member)
    per_path.update(ind_launches)
    per_path["check_slices"] = slices_path(dev, on_card, hists, n_slices)

    # the ensemble launches replayed: the streamed run's chunks (B1) and
    # the sharded launch (B2)
    calls, drains = ens["recorded"]["streamed"]
    streamed = [_replay(c, on_card) for c in calls]
    for x, d in zip(streamed, drains):
        x["in_run_device_ms"] = d["device_ms"]
    sharded = [_replay(c, on_card)
               for c in ens["recorded"]["analysis_batch_sharded"][0]]
    emit({"phase": "ensemble-launches", "streamed": streamed,
          "sharded": sharded})
    max_err = max([max_err] + [x["max_abs_err"] for x in streamed])
    sh_err = max(x["max_abs_err"] for x in sharded)
    if max_err or sh_err:
        raise AssertionError(f"ensemble launches differ from the plain "
                             f"version by up to {max(max_err, sh_err)}")
    sh_bytes = sum(x["bytes"] for x in sharded)
    sh_ops = sum(x["operations"] for x in sharded)
    # 16-18. checkpoint-and-extend on the headline history
    ext = extend_path(dev, on_card, hist, bad)
    per_path.update(ext["launches"])
    per_path.update(resumable_segmented(dev, on_card, enc, target_len))
    per_path.update(checker_extend(dev, on_card, hist))
    # 19. the composed checker stacks, with the reports of invalid results
    composed = composed_path(dev, on_card, elle_direct, la_bad_cross,
                             bank_direct, ind_direct, bad_member)
    per_path.update({k: v for k, v in composed.items()
                     if k.startswith("composed-register")})
    scc_composed = {k: v for k, v in composed.items()
                    if k.startswith("composed-list-append")}
    scc_entry["launches"] += sum(scc_composed.values())
    scc_entry["launches_per_check"].update(scc_composed)
    bank_composed = {k: v for k, v in composed.items()
                     if k.startswith("composed-bank")}
    bank_entry["launches_per_check"] = {"bank": bank_entry["launches"],
                                        **bank_composed}
    bank_entry["launches"] += sum(bank_composed.values())

    by_path = {k: (sum(v) if isinstance(v, list) else v)
               for k, v in per_path.items() if k != "ensemble-sharded (B2)"}
    return {
        "kernels": [{
            "name": "wgl_search",
            "route": "cuda",
            "source": "jepsen_tpu_torch/gpu/kernels/csrc/wgl_search.cu",
            "replaces": "jepsen_tpu/tpu/wgl.py:518",
            "launches": sum(by_path.values()),
            "launches_per_path": per_path,
            "max_abs_err": max_err,
            "mismatches": total_mism,
            "ms": kernel_ms,
            "plain_ms": sum(x["plain_ms"] for x in per_launch),
            "bound_ms": sum(x["bound_ms"] for x in per_launch),
            "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S
                         >= ops / PEAK_OPS_PER_S else "operations"),
            "library_ms": None,
            "timed_path": "headline",
            "extend": {"fresh": ext["fresh"], "resumed": ext["resumed"]},
            "us_per_level": _us_per_level(
                kernel_ms, sum(x["levels"] for x in per_launch)),
            "main_path_launches": per_launch,
            "ensemble_streamed_launches": streamed,
        }, {
            "name": "wgl_search (ensemble, one-device form)",
            "route": "cuda",
            "source": "jepsen_tpu_torch/gpu/kernels/csrc/wgl_search.cu",
            "replaces": "jepsen_tpu/tpu/ensemble.py:54",
            "launches": per_path["ensemble-sharded (B2)"],
            "max_abs_err": sh_err,
            "mismatches": sum(x["mismatches"] for x in sharded),
            "ms": (sum(x["kernel_ms"] for x in sharded) if on_card
                   else None),
            "plain_ms": sum(x["plain_ms"] for x in sharded),
            "bound_ms": sum(x["bound_ms"] for x in sharded),
            "bound_by": ("bytes" if sh_bytes / PEAK_BYTES_PER_S
                         >= sh_ops / PEAK_OPS_PER_S else "operations"),
            "library_ms": None,
            "main_path_launches": sharded,
        }, scc_entry, bank_entry],
        "headline_runs": runs,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = nvidia_smi_line()
    cap = torch.cuda.get_device_capability(0)
    nvcc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "--version"], capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "capability": list(cap),
          "nvcc": nvcc[-1] if nvcc else None, "python": sys.version})
    if cap != (9, 0):
        raise AssertionError(f"compute capability {cap}, want (9, 0)")
    summary = run(torch.device("cuda"))
    emit({"kernels": summary["kernels"]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
