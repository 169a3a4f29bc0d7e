"""Device-performance profiling for kernel launches (the port's copy of
jepsen_tpu/tpu/profiler.py, on CUDA events).

telemetry.py answers "where did the run spend its time?"; this module
answers "what did the device DO with it?". Every kernel launch site
(gpu/wgl.py's `_launch`/`_drain`, the ensemble launch over a mesh in
gpu/ensemble.py, gpu/scc.py's `Edges.labels_device`, the Elle device
checks in gpu/elle_device.py, plus the host-side encode, pack and
shard-layout stages that feed them) reports a per-launch record:

  - the wall vs device split: host encode / H2D copy / dispatch /
    device compute / D2H readback, each phase timed separately. On the
    card `compute_ns` is the kernel's own interval between the CUDA
    events its launcher records just around it (gpu/kernels/build.py
    `event_handles`), read after the wait the launch path already makes
    (a drain's `done.synchronize()`, scc's download of its labels): the
    profiler adds no device wait of its own. On the CPU, where the
    kernel's plain PyTorch version runs inside the dispatch, it is the
    host wait;
  - cost fields counted from the launch's shapes, so they read the same
    whatever kernel implements the launch: `bytes_accessed` is each
    input byte read once plus each output byte written once (the bytes
    PERF.md's bounds count), `flops` the operation count of wgl_search's
    bound (one per configuration and window slot evaluated, one per
    successor key and sort step; None for scc, whose bound counts only
    bytes), `peak_memory_bytes` the bytes the launch holds on the device
    (inputs, outputs and the launcher's scratch). wgl_cost() and
    scc_cost() are the formulas;
  - compile-cache accounting per shape bucket. There is no XLA compile
    here: the first sight of a launch shape in the process still counts
    as `compile.miss` (later sights `compile.hit`), and the gauge
    `bucket_cardinality` is the number of distinct shapes seen, as in
    the JAX package. `compile_ns` is the time to build or load the
    kernel's library (gpu/kernels/build.py, in its build_dir(): a warm
    kernel build cache makes it the load alone), recorded on the
    process's first recorded launch of that kernel;
  - for the ensemble layout over a mesh: the per-device work
    attribution (entries of search work per device) and its balance
    figure.

The JAX package's XLA parts have no counterpart and are not ported:
the lowered-HLO cost analysis (`_fresh_bucket_cost`), the memory
analysis of a second compile (`_memory_analysis_enabled`) and their
switches JEPSEN_TPU_PROFILE_COST and JEPSEN_TPU_PROFILE_MEMORY.

Records flow through the observability fabric as in the JAX package:
each finished launch mirrors into telemetry as a `kernel:<name>` span
(telemetry.jsonl and the Chrome trace's device track,
reports/trace.py) and as `profiler.<kernel>.*` counters and gauges
(metrics.json, which reports/profile.py renders), under the JAX
package's names. The recorder is always on and adds two dict updates a
launch.

Cross-run trending lives in ledger.py (the bench ledger);
parallel_efficiency() is the scaling metric of a device-count sweep.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable

from .. import telemetry, util

logger = logging.getLogger(__name__)

# Launch-phase keys, in pipeline order. Every *_ns field of a record
# that isn't one of these is still additive host time (compile_ns).
PHASES = ("encode_ns", "h2d_ns", "dispatch_ns", "compute_ns", "d2h_ns")

# Cost fields of a launch (None when the formula does not count one).
COST_FIELDS = ("flops", "bytes_accessed", "peak_memory_bytes")

# Per-launch records are mirrored into telemetry individually only up
# to this many launches per kernel per run; past it, only aggregates
# accumulate (a 1024-history ensemble must not write 1024 span lines).
# The cap is configurable (JEPSEN_TPU_PROFILE_MAX_SPANS) and NEVER
# silent: every launch past it counts `profiler.<k>.spans_dropped` in
# metrics.json, so a truncated telemetry mirror is visible instead of
# reading as "that's all the launches there were".
MAX_MIRRORED_LAUNCHES = 64


def max_mirrored_launches() -> int:
    try:
        return int(os.environ.get("JEPSEN_TPU_PROFILE_MAX_SPANS",
                                  MAX_MIRRORED_LAUNCHES))
    except ValueError:
        return MAX_MIRRORED_LAUNCHES


# ---------------------------------------------------------------------------
# Cost from shapes
# ---------------------------------------------------------------------------

def wgl_cost(entries: int, states: int, rows: int, max_iters: int,
             W: int, live: int, generated: int,
             held_bytes: int | None = None) -> dict:
    """Cost fields of one wgl_search launch on its data. Bytes: each
    packed entry of the rows' segments read once (inv, ret, sufmin and
    a trans row of `states`), the rows' segment and start state (8
    bytes), the per-row outputs (result, mask, unknown: 6 bytes) and the
    three level series of max_iters int32 written once. Operations: one
    per live configuration and window slot evaluated (`live`, the
    frontier summed over levels, times W) and, for the `generated`
    successor keys (new plus duplicate), one per key and sort step
    (ceil(log2)). `held_bytes`: the device bytes the launch holds."""
    nbytes = (entries * 4 * (3 + states) + rows * 4 * 2 + rows * 6
              + 3 * 4 * max_iters)
    ops = live * W + generated * max(
        1, math.ceil(math.log2(max(generated, 2))))
    return {"flops": int(ops), "bytes_accessed": int(nbytes),
            "peak_memory_bytes": held_bytes}


def scc_cost(nodes: int, edges: int, out_len: int,
             scratch_bytes: int = 0) -> dict:
    """Cost fields of one scc launch: src and dst (4 bytes) and the
    edge mask (1) of every edge read once, the int32 output of
    `out_len` (labels and counts) written once. The bound counts bytes
    only, so flops is None. Held: inputs, outputs and the launcher's
    scratch (0 for the plain version, which takes none)."""
    nbytes = 9 * edges + 4 * out_len
    return {"flops": None, "bytes_accessed": int(nbytes),
            "peak_memory_bytes": int(nbytes + scratch_bytes)}


class Profiler:
    """Per-launch device-profile recorder. Thread-safe; one global
    instance (get()) serves the process, tests may make their own.
    `enabled=False` makes it a no-op recorder: records still open and
    park (call sites mutate them unconditionally) but nothing is
    aggregated, mirrored to telemetry, or costed."""

    # these attrs are written under _lock only (or in *_locked methods
    # whose callers hold it)
    _guarded_by_lock = {"_lock": ("_records", "_pending",
                                  "_bucket_cost", "_seen_buckets",
                                  "cache_stats")}

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._records: list[dict] = []
        self._pending: dict[int, dict] = {}   # id(launch) -> record
        self._bucket_cost: dict[Any, dict] = {}
        self._seen_buckets: dict[str, set] = {}
        self.cache_stats: dict[str, dict] = {}

    # -- launch records ----------------------------------------------------

    def begin(self, kernel: str, bucket=None, **attrs) -> dict:
        """Opens a launch record. `kernel` is a dot-free site name
        ('wgl', 'scc', ...); `bucket` the launch-shape key."""
        rec: dict = {"kernel": kernel.replace(".", "-"),
                     "t0": util.relative_time_nanos(),
                     # straggler guard: a telemetry.reset() (next run
                     # starting) before this record finishes means its
                     # clock origin is stale — _finish_locked drops it
                     "_epoch": telemetry.get().epoch}
        if bucket is not None:
            rec["bucket"] = repr(bucket)
        for k, v in attrs.items():
            if v is not None:
                rec[k] = v
        return rec

    @contextmanager
    def phase(self, rec: dict | None, name: str):
        """Times one pipeline phase (see PHASES) into the record."""
        if rec is None:
            yield
            return
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            rec[name] = rec.get(name, 0) + (time.monotonic_ns() - t0)

    def cache_event(self, kernel: str, fresh: bool) -> None:
        """One launch-shape lookup: miss (first sight of the shape in
        the process) or hit (shape seen before)."""
        if not self.enabled:
            return
        kernel = kernel.replace(".", "-")
        with self._lock:
            st = self.cache_stats.setdefault(kernel,
                                             {"hits": 0, "misses": 0})
            st["misses" if fresh else "hits"] += 1
        telemetry.count(f"profiler.{kernel}.compile."
                        + ("miss" if fresh else "hit"))

    def bucket_fresh(self, site: str, bucket) -> bool:
        """First-sighting test for launch sites without their own
        bucket set (scc); counts the cache event too, and gauges the
        site's distinct-bucket cardinality (set size, NOT the miss
        counter: a failed first launch is unclaimed and retried, and
        its second miss must not inflate the gauge)."""
        with self._lock:
            seen = self._seen_buckets.setdefault(site, set())
            fresh = bucket not in seen
            if fresh:
                seen.add(bucket)
            n = len(seen)
        self.cache_event(site, fresh)
        if fresh:
            telemetry.gauge(f"profiler.{site}.bucket_cardinality", n)
        return fresh

    def bucket_unclaim(self, site: str, bucket) -> None:
        """Un-claims a bucket whose first launch failed (the analog of
        wgl._timed_launch discarding its _compiled_buckets claim): the
        next attempt is a first sight again and records a miss, not a
        phantom hit."""
        with self._lock:
            self._seen_buckets.get(site, set()).discard(bucket)

    def bucket_cost(self, bucket, cost: Callable[[], dict] | None,
                    fresh: bool) -> dict:
        """The bucket's cost fields, for sites whose cost is a function
        of the launch shape alone (scc): `cost`, a zero-arg thunk, is
        called on first sight and its answer served from cache after."""
        if not self.enabled:
            return {k: None for k in COST_FIELDS}
        with self._lock:
            cached = self._bucket_cost.get(bucket)
        if cached is not None:
            return cached
        if not fresh and cost is None:
            return {k: None for k in COST_FIELDS}
        out: dict = {k: None for k in COST_FIELDS}
        if cost is not None:
            out.update(cost())
        with self._lock:
            self._bucket_cost.setdefault(bucket, out)
        return out

    def attach(self, out, rec: dict) -> Any:
        """Parks an open record until the launch's output is drained
        (the async handoff: _launch returns, _drain waits). Keyed by
        the output object's id — the caller holds the output alive
        until drain, so the id can't be recycled underneath."""
        if rec is None:
            return out
        with self._lock:
            if len(self._pending) > 256:
                # exception paths may abandon records; cap the parking
                # lot, finalizing EVERY stray so all of them still
                # aggregate (an in-flight launch loses its parked
                # record to the sweep — its _drain finds None — but
                # its dispatch-side phases are preserved here)
                for stray in list(self._pending.values()):
                    self._finish_locked(stray)
                self._pending.clear()
            self._pending[id(out)] = rec
        return out

    def take(self, out) -> dict | None:
        with self._lock:
            return self._pending.pop(id(out), None)

    def finish(self, rec: dict | None) -> dict | None:
        """Closes a record: stamps t1, mirrors it into telemetry (span
        + per-kernel aggregate counters)."""
        if rec is None:
            return None
        with self._lock:
            self._finish_locked(rec)
        return rec

    def _finish_locked(self, rec: dict) -> None:
        if "t1" in rec:
            return
        rec["t1"] = util.relative_time_nanos()
        epoch = rec.pop("_epoch", None)
        tel = telemetry.get()
        if not self.enabled or (epoch is not None
                                and epoch != tel.epoch):
            # disabled recorder, or a straggler finishing after the
            # next run began: its t0 was measured against the previous
            # run's clock origin — dropping beats misfiling
            return
        self._records.append(rec)
        k = rec["kernel"]
        tel.count(f"profiler.{k}.launches")
        wall = max(rec["t1"] - rec["t0"], 0)
        tel.count(f"profiler.{k}.wall_ns", wall)
        for ph in PHASES:
            if rec.get(ph):
                tel.count(f"profiler.{k}.{ph}", int(rec[ph]))
        if rec.get("compile_ns"):
            tel.count(f"profiler.{k}.compile_ns", int(rec["compile_ns"]))
        if rec.get("iterations"):
            tel.count(f"profiler.{k}.iterations", int(rec["iterations"]))
        if rec.get("rows"):
            tel.count(f"profiler.{k}.rows", int(rec["rows"]))
        # search-explorer aggregates (wgl _drain attaches the series)
        if rec.get("states_explored"):
            tel.count(f"profiler.{k}.states",
                      int(rec["states_explored"]))
        if rec.get("dedup_hits"):
            tel.count(f"profiler.{k}.dedup_hits",
                      int(rec["dedup_hits"]))
        if rec.get("frontier_peak"):
            tel.gauge_max(f"profiler.{k}.frontier_peak",
                          int(rec["frontier_peak"]))
        if rec.get("flops"):
            tel.count(f"profiler.{k}.flops", int(rec["flops"]))
        if rec.get("bytes_accessed"):
            tel.count(f"profiler.{k}.bytes", int(rec["bytes_accessed"]))
        if rec.get("peak_memory_bytes"):
            tel.gauge_max(f"profiler.{k}.peak_memory_bytes",
                          int(rec["peak_memory_bytes"]))
        if rec.get("devices"):
            tel.gauge_max(f"profiler.{k}.devices", int(rec["devices"]))
        if rec.get("balance") is not None:
            tel.gauge(f"profiler.{k}.balance", rec["balance"])
        n_k = sum(1 for r in self._records if r["kernel"] == k)
        if n_k <= max_mirrored_launches():
            attrs = {kk: v for kk, v in rec.items()
                     if kk not in ("kernel", "t0", "t1")
                     and v is not None}
            tel.record_span(f"kernel:{k}", rec["t0"], rec["t1"], attrs,
                            epoch=epoch)
        else:
            # no silent caps: truncation of the telemetry mirror is
            # itself a metric (aggregates above still saw the launch)
            tel.count(f"profiler.{k}.spans_dropped")

    # -- simple sites ------------------------------------------------------

    def record_host(self, kernel: str, ns: int, **attrs) -> None:
        """Aggregate-only accounting for cheap host stages (encode,
        pack, shard-layout) that run thousands of times per analysis:
        counters only, no per-call record."""
        if not self.enabled:
            return
        k = kernel.replace(".", "-")
        tel = telemetry.get()
        tel.count(f"profiler.{k}.launches")
        tel.count(f"profiler.{k}.wall_ns", int(ns))
        tel.count(f"profiler.{k}.encode_ns", int(ns))
        for name, v in attrs.items():
            if isinstance(v, (int, float)) and v:
                tel.count(f"profiler.{k}.{name}", int(v))

    # -- views / lifecycle -------------------------------------------------

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    def reset(self) -> None:
        """Clears per-run state. Bucket cost/seen sets persist: they
        describe the process's launch shapes, which a new run still
        meets."""
        with self._lock:
            self._records = []
            self._pending = {}
            self.cache_stats = {}

    # -- shape buckets -----------------------------------------------------

    def shape_buckets(self) -> dict[str, set]:
        """Every launch-shape bucket this process has seen, per launch
        site: this recorder's own seen-sets (scc) merged with the wgl
        launch family's _compiled_buckets claim set (which the wgl and
        ensemble launch paths share)."""
        with self._lock:
            out = {site: set(s)
                   for site, s in self._seen_buckets.items()}
        from . import wgl as _wgl  # lazy: wgl imports this module

        with _wgl._buckets_lock:  # snapshot vs concurrent claims
            claimed = set(_wgl._compiled_buckets)
        out.setdefault("wgl", set()).update(claimed)
        return out


_global = Profiler()


def get() -> Profiler:
    return _global


def reset() -> None:
    _global.reset()


def shape_buckets() -> dict[str, set]:
    """Module-level façade over Profiler.shape_buckets()."""
    return _global.shape_buckets()


# ---------------------------------------------------------------------------
# Scaling attribution
# ---------------------------------------------------------------------------

def parallel_efficiency(times: dict[int, float]) -> dict[int, float]:
    """Per-device-count parallel efficiency from a {n_devices: seconds}
    sweep: eff(N) = T(1) / (T(N) * N). 1.0 = perfect linear scaling;
    a flat sweep shows ~1/N."""
    t1 = times.get(1)
    if not t1:
        return {}
    return {int(n): round(t1 / (t * n), 4)
            for n, t in sorted(times.items()) if n >= 1 and t > 0}


# Device counts at least this big with efficiency below this floor get
# a loud warning.
EFFICIENCY_WARN_N = 4
EFFICIENCY_WARN_FLOOR = 0.5


def check_efficiency(eff: dict[int, float],
                     log: Callable[[str], None] | None = None) -> list:
    """Returns [(n, eff)] for every device count >= EFFICIENCY_WARN_N
    scaling under the floor, logging each (the flat-sweep tripwire)."""
    bad = [(n, e) for n, e in sorted(eff.items())
           if n >= EFFICIENCY_WARN_N and e < EFFICIENCY_WARN_FLOOR]
    emit = log or logger.warning
    for n, e in bad:
        emit(f"parallel efficiency at {n} devices is {e:.2f} "
             f"(< {EFFICIENCY_WARN_FLOOR}): the mesh adds devices "
             "without adding throughput")
    return bad


def work_balance(work) -> float | None:
    """Load-balance figure for a sharded launch's per-device work
    attribution: mean/max — 1.0 is a perfectly even layout. None when
    no work landed."""
    import numpy as np

    work = [int(w) for w in work]
    if not work or max(work) == 0:
        return None
    return round(float(np.mean(work)) / max(work), 4)
