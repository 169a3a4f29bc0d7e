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
     crashes, a window/frontier overflow case): zero mismatches allowed,
     every output is an integer;
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
     plain version on them, and prints one `{"kernels": [...]}` line.

The last line is {"ok": true, "device": {...}}. Any failure raises, and
the script exits non-zero without that line; it also exits non-zero
when no CUDA device is available.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.checker import linearizable, models
from jepsen_tpu_torch.gpu import certify, synth, wgl
from jepsen_tpu_torch.gpu.encode import encode
from jepsen_tpu_torch.gpu.kernels import build
from jepsen_tpu_torch.gpu.kernels import wgl_search as ws

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bandwidth,
# and the float32 CUDA-core rate, used as the rate of the kernel's 32-bit
# integer compare/select work
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


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
        rows = [(k, s) for k in range(8) for s in range(enc.n_states)]
        out.append((f"segments-crash{crash_p / 10}-reach", segs, rows, 24,
                    48, True))
    return out


def _mismatches(got, want) -> list[int]:
    return [int((a.to(torch.int64) != b.to(torch.int64)).sum())
            for a, b in zip(got, want)]


def _max_abs_err(got, want) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in zip(got, want))


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


def run(dev: torch.device, n_headline: int = 500_000,
        target_len: int = 8192, min_segments: int = 40,
        n_cross: int = 20_000) -> dict:
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    # 2. build
    if on_card:
        info = build.build_all()
        emit({"phase": "build", "seconds": info["seconds"],
              "libraries": info["libraries"],
              "ptxas": {n: [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln]
                        for n, log in info["ptxas"].items()}})

    # 3. kernel against its plain version on the same tensors
    total_mism = 0
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
        emit({"phase": "kernel-vs-plain", "case": name, "M": pb.M,
              "rows": len(rows), "entries": int(pb.m.sum()), "W": W,
              "F": F, "reach": reach, "crash_free": kw["crash_free"],
              "levels": int(want[-4]), "mismatches": mism,
              "kernel_s": t_kernel, "plain_s": t_plain})
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
        sync()
        t0 = time.perf_counter()
        want = ws.wgl_search_reference(packed, rs, s0, **kw)
        sync()
        per_launch.append({
            "rows": int(rs.numel()), "M": int(packed[0].shape[1]),
            "reach": kw["reach"], "levels": int(out[-4]),
            "kernel_ms": kernel_ms,
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
    return {
        "kernels": [{
            "name": "wgl_search",
            "route": "cuda",
            "source": "jepsen_tpu_torch/gpu/kernels/csrc/wgl_search.cu",
            "replaces": "jepsen_tpu/tpu/wgl.py:518",
            "launches": main_count,
            "max_abs_err": max_err,
            "mismatches": total_mism,
            "ms": kernel_ms,
            "plain_ms": sum(x["plain_ms"] for x in per_launch),
            "bound_ms": sum(x["bound_ms"] for x in per_launch),
            "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S
                         >= ops / PEAK_OPS_PER_S else "operations"),
            "library_ms": None,
            "main_path_launches": per_launch,
        }],
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
