"""One run of one benchmark cell, driven by the files BENCHMARK.json
names: the configuration's file of sizes, the traffic mix's data file
under workloads/, and one reader a metric under metrics/, each found by
its name; the configuration's file names its entry (entries/<entry>.py:
its inputs and the program's timed entry) and its plain reference
(reference/<reference>.py).

A run: set-up (the program's import, the entry's base inputs, one
warm-up check through the timed entry), then a closed loop of one client for `seconds`, each check handed
a history the program has not seen in this process, then the judgement
of every answer due in the window against the plain reference, once the
window has closed and the device's peak memory has been read.

The program under test is jepsen_tpu_torch, imported lazily so that the
CPU tests can import this module without it. Nothing here imports JAX
or the JAX package.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import pickle
import re
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

from . import devtrace, judge

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent


# ---------------------------------------------------------------------------
# The cell's files
# ---------------------------------------------------------------------------

def applies(metric: dict, cell: str) -> bool:
    """Whether `metric` is reported in `cell`: every cell, or the cells
    its `workloads` key lists."""
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> dict:
    """The cell `name` of root/BENCHMARK.json with its configuration,
    traffic mix and metrics loaded. Raises KeyError for an unknown
    cell."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "name": name,
        "chips": int(cell["chips"]),
        "config": json.loads((root / cfg["file"]).read_text()),
        "traffic": json.loads(
            (PERFBENCH / "workloads" / f"{cell['traffic']}.json")
            .read_text()),
        "end_to_end": [m for m in bench["end_to_end"]
                       if applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, name)],
    }


def reader(name: str):
    """The `read(run)` function of metrics/<name>.py."""
    path = PERFBENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "__").replace("-", "_"),
        path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# The configuration's entry
# ---------------------------------------------------------------------------

def entry_module(config: dict):
    """The module entries/<config["entry"]>.py: `inputs(config, traffic,
    seed)` (the base), `labels(config, seed)` (one relabelling a check,
    drawn from the seed), `history(base, label)` (the history a check is
    handed: its event tuples and the witness the reference replays) and
    `checker(config, device)` (the program's timed entry)."""
    name = config["entry"]
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"bad entry name {name!r}")
    return importlib.import_module("entries." + name)


def to_history(events: list):
    """The program's History of `events`, each event's index and time
    its position."""
    from jepsen_tpu_torch.history import History, Op

    return History([Op(i, i, t, p, f, v)
                    for i, (t, p, f, v) in enumerate(events)],
                   assign_indices=False)


# ---------------------------------------------------------------------------
# Per-check readings of the program's telemetry (traced runs)
# ---------------------------------------------------------------------------

class LaunchInputs:
    """Records each wgl_search launch's input shapes, as the frozen
    roofline arithmetic counts them, by wrapping the packed batch's
    upload that every single-device launch makes (traced runs only)."""

    def __init__(self):
        self.launches: list[dict] = []
        self._orig = None

    def install(self) -> None:
        import numpy as np
        from jepsen_tpu_torch.gpu import wgl

        orig = getattr(wgl.PackedBatch, "tensors", None)
        if orig is None:
            return
        launches = self.launches

        def tensors(pb, row_seg, st0, device):
            launches.append({
                "entries": int(pb.m[np.unique(row_seg)].sum()),
                "states": int(pb.S), "rows": int(len(row_seg)),
                "max_iters": int(pb.M) + 4})
            return orig(pb, row_seg, st0, device)

        self._orig = orig
        wgl.PackedBatch.tensors = tensors

    def uninstall(self) -> None:
        if self._orig is not None:
            from jepsen_tpu_torch.gpu import wgl

            wgl.PackedBatch.tensors = self._orig
            self._orig = None

    def take(self) -> list[dict]:
        out = list(self.launches)
        self.launches.clear()
        return out


WGL_KERNELS = ("wgl", "wgl-reach", "wgl-sharded")


def snapshot(launch_inputs: LaunchInputs | None) -> dict:
    """One check's telemetry: counters, spans (name, t0, t1 on the
    program's relative clock), the wgl_search launches' kernel times
    (ns between the CUDA events around each kernel) and input shapes."""
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.gpu import profiler

    tel = telemetry.get()
    return {
        "counters": tel.counters(),
        "spans": [(s["name"], s["t0"], s["t1"]) for s in tel.spans()
                  if "t1" in s],
        "kernel_ns": [r.get("compute_ns") for r in profiler.get().records()
                      if r.get("kernel") in WGL_KERNELS],
        "launches": launch_inputs.take() if launch_inputs else [],
    }


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def cpu_seconds() -> float:
    """The process's CPU seconds so far."""
    t = os.times()
    return t.user + t.system


class Pauses:
    """Seconds of the harness's own work between checks, by reason, off
    the window's clock. The cyclic collector is paused meanwhile, so
    that none of the program's collections run off the clock."""

    def __init__(self):
        self.by_reason: dict[str, float] = {}

    @property
    def total(self) -> float:
        return sum(self.by_reason.values())

    @contextmanager
    def __call__(self, reason: str):
        t0 = time.monotonic()
        gc.disable()
        try:
            yield
        finally:
            gc.enable()
            self.by_reason[reason] = (self.by_reason.get(reason, 0.0)
                                      + time.monotonic() - t0)


def run(spec: dict, seed: int, seconds: float, trace: bool, device,
        t_process: float, log=None) -> dict:
    """One run of the cell `spec` (resolve()) on `device`. `t_process`:
    the process's start on time.monotonic(), from which set-up is
    counted. Returns the result line's object.

    The window's clock stops only for the harness's own work: building
    each check's history just before it (so a faster program never
    waits on the harness and the pool never runs out), and keeping each
    answer, pickled, and in a traced run the check's telemetry. All the
    rest runs on the clock: the check, then freeing its history and its
    answer and collecting the garbage it left (gc.collect()). The base
    history is held pickled, so the collector never scans what the
    harness keeps."""
    import torch
    from jepsen_tpu_torch import telemetry, util
    from jepsen_tpu_torch.gpu import profiler

    log = log or (lambda msg: None)
    config, traffic = spec["config"], spec["traffic"]
    if (traffic["loop"], traffic["clients"]) != ("closed", 1):
        raise ValueError("the harness drives one client in a closed loop")
    on_card = torch.device(device).type == "cuda"
    ent = entry_module(config)

    def history(label):
        return to_history(
            ent.history(pickle.loads(base_blob), label)["events"])

    t_inputs = time.monotonic()
    gc.disable()
    try:
        base_blob = pickle.dumps(ent.inputs(config, traffic, seed),
                                 protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        gc.enable()
    stream = ent.labels(config, seed)
    entry = ent.checker(config, device)
    t_warm = time.monotonic()
    entry.check({}, history(next(stream)))   # warm-up: every kernel
    if on_card:
        torch.cuda.synchronize(device)
    gc.collect()
    log(f"set-up: start and imports {t_inputs - t_process:.3f} s, inputs "
        f"{t_warm - t_inputs:.3f} s, warm-up check "
        f"{time.monotonic() - t_warm:.3f} s")

    launch_inputs = LaunchInputs() if trace else None
    tracer = devtrace.Tracer() if trace else None
    if launch_inputs:
        launch_inputs.install()
    if tracer:
        tracer.start()
    tel, prof = telemetry.get(), profiler.get()
    checks: list[dict] = []
    pause = Pauses()
    collect_s = []
    cpu0 = cpu_seconds()
    t_window = time.monotonic()
    setup_s = t_window - t_process
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")
    try:
        while time.monotonic() - t_window - pause.total < seconds:
            with pause("build"):
                label = next(stream)
                hist = history(label)
                tel.reset()
                prof.reset()
            rec: dict = {"label": label, "events": len(hist),
                         "host_t0": util.relative_time_nanos()}
            answer = None
            try:
                with (tracer.marker() if tracer else nullcontext()):
                    answer = entry.check({}, hist)
            except Exception as e:  # noqa: BLE001 — a check that raises is counted as failed
                rec["error"] = repr(e)[:500]
            rec["host_t1"] = util.relative_time_nanos()
            with pause("keep"):
                rec["answer"] = (None if "error" in rec else
                                 pickle.dumps(answer,
                                              pickle.HIGHEST_PROTOCOL))
                if trace:
                    rec["telemetry"] = snapshot(launch_inputs)
                checks.append(rec)
            t0 = time.monotonic()
            del hist, answer
            gc.collect()
            collect_s.append(time.monotonic() - t0)
            rec["done"] = time.monotonic() - t_window - pause.total
            rec["in_window"] = rec["done"] <= seconds
            if rec["answer"] is None:
                break                 # the run is not correct already
    finally:
        if launch_inputs:
            launch_inputs.uninstall()
        if tracer:
            tracer.stop()
    t_end = time.monotonic()
    cpu_s = cpu_seconds() - cpu0
    counted = [c for c in checks if c["in_window"]]
    log(f"window: {len(checks)} checks, {len(counted)} inside it; the "
        "harness's own work off the clock: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in pause.by_reason.items())
        + f"; on the clock, freeing each check's input and answer and "
        f"collecting its garbage {sum(collect_s):.3f} s ("
        + " ".join(f"{x:.3f}" for x in collect_s) + "); the process's CPU "
        f"{cpu_s:.3f} s of {t_end - t_window:.3f} s; each check's s "
        + " ".join(f"{(c['host_t1'] - c['host_t0']) / 1e9:.3f}"
                   for c in checks))

    memory_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    dev_summary = None
    if tracer and counted:
        dev_summary = tracer.reduce(
            [(c["host_t0"], c["host_t1"]) for c in counted],
            [s for c in counted for s in c["telemetry"]["spans"]])
        log(f"device trace: {tracer.trace_bytes} bytes written to and "
            "removed from TMPDIR")
        if dev_summary is not None:
            device_info["busy_s"] = dev_summary["busy_s"]
            device_info["window_s"] = dev_summary["window_s"]

    # the program's state goes before the reference runs
    del entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.monotonic()
    gc.disable()
    try:
        base = pickle.loads(base_blob)
        compared, judged = judge.judge(
            config, checks, lambda label: ent.history(base, label))
    finally:
        gc.enable()
    log(f"reference: {judged} answers judged in "
        f"{time.monotonic() - t_ref:.3f} s, "
        f"{t_ref - t_end:.3f} s after the window")

    run_view = {"cell": spec["name"], "seconds": seconds,
                "setup_s": setup_s, "checks": counted,
                "device": dev_summary}
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    metrics: dict = {}
    unread = []
    for m in wanted:
        value = reader(m["name"])(run_view)
        if value is None:
            unread.append(m["name"])
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if unread:
        log(f"no reading of {', '.join(unread)} in this run")
    # an end-to-end metric with no reading means the answers it counts
    # never came (an anomaly cell's invalid verdicts, say)
    correct = (all(v <= lim for v, lim in compared.values())
               and (trace or not unread))
    out = {"correct": correct,
           "attempted": len(checks),
           "failed": sum(1 for c in checks if c["answer"] is None),
           "metrics": metrics, "device": device_info}
    if dev_summary is not None:
        out["breakdown"] = {"device_ops": dev_summary["device_ops"],
                            "idle_gaps": dev_summary["idle_gaps"]}
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in compared.items()}
    return out
