"""Live run monitor: streaming time-series for an in-progress test (the
port's copy of jepsen_tpu/monitor.py).

A background sampler thread snapshots the run's vitals on a fixed
cadence and appends one JSON point per tick to a `timeseries.jsonl`
artifact next to `telemetry.jsonl`:

  - ops/s and generator-stall rate (deltas between ticks)
  - in-flight ops per worker thread, with their current ages
  - streaming latency quantiles from a mergeable log-bucket histogram
    (LogHistogram: constant memory, merge-associative across workers)
  - the active nemesis set (tracked from nemesis op completions)
  - wgl/elle/scc kernel gauges from the telemetry recorder (so device
    occupancy is visible mid-analysis, not only at exit)
  - watchdog violation counts and open telemetry spans

The interpreter feeds the monitor from its main loop (on_dispatch /
on_complete / on_stall); all hooks are a few dict updates under one
uncontended lock.

Because points are appended and flushed incrementally, a different
process can tail the file while the run goes on; read_points() tolerates
a torn trailing line the same way telemetry.read_events does.
"""

from __future__ import annotations

import json
import logging
import math
import threading
from pathlib import Path
from typing import Any, Callable, Iterator

from . import telemetry, util

logger = logging.getLogger(__name__)

TIMESERIES_FILE = "timeseries.jsonl"

# Gauge prefixes worth streaming live (device-kernel health).
_LIVE_GAUGE_PREFIXES = ("wgl.", "elle.", "scc.")


# ---------------------------------------------------------------------------
# Streaming histogram
# ---------------------------------------------------------------------------

class LogHistogram:
    """A log-bucketed streaming histogram: constant memory, mergeable.

    Bucket b covers [GROWTH**b, GROWTH**(b+1)); GROWTH = 2**(1/8) puts
    every estimate within ~9% of the true value (one bucket). merge()
    is a counter add, so per-worker histograms combine associatively
    and commutatively — the property the live sampler leans on and the
    test suite checks against numpy.quantile.
    """

    GROWTH = 2 ** 0.125
    _LOG_G = math.log(GROWTH)

    def __init__(self):
        self.counts: dict[int, int] = {}
        self.zeros = 0  # values <= 0 (clock tie or skew); rank 0
        self.n = 0

    @classmethod
    def bucket_of(cls, value: float) -> int:
        return int(math.floor(math.log(value) / cls._LOG_G))

    def add(self, value: float, n: int = 1) -> None:
        if value <= 0:
            self.zeros += n
        else:
            b = self.bucket_of(value)
            self.counts[b] = self.counts.get(b, 0) + n
        self.n += n

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """A new histogram holding both datasets."""
        out = LogHistogram()
        for src in (self, other):
            for b, c in src.counts.items():
                out.counts[b] = out.counts.get(b, 0) + c
            out.zeros += src.zeros
            out.n += src.n
        return out

    def quantile(self, q: float) -> float | None:
        """Value at quantile q — the geometric midpoint of the bucket
        holding the rank-q sample; None on an empty histogram."""
        if self.n == 0:
            return None
        rank = min(self.n - 1, int(math.floor(self.n * q)))
        if rank < self.zeros:
            return 0.0
        seen = self.zeros
        for b in sorted(self.counts):
            seen += self.counts[b]
            if rank < seen:
                return self.GROWTH ** (b + 0.5)
        return self.GROWTH ** (max(self.counts) + 0.5)

    def quantiles(self, qs) -> dict:
        return {q: self.quantile(q) for q in qs}

    def to_dict(self) -> dict:
        return {"n": self.n, "zeros": self.zeros,
                "counts": {str(b): c for b, c in self.counts.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        """Inverse of to_dict, tolerant of junk (a torn snapshot
        folds as empty rather than poisoning the observer). With
        merge() this is the cross-process path: an observer folds
        persisted histograms back in."""
        out = cls()
        if not isinstance(d, dict):
            return out
        try:
            counts = {int(b): int(c)
                      for b, c in (d.get("counts") or {}).items()
                      if int(c) > 0}
            zeros = max(int(d.get("zeros") or 0), 0)
        except (AttributeError, TypeError, ValueError):
            return out
        out.counts = counts
        out.zeros = zeros
        # n is derived, not trusted: merge associativity needs the
        # invariant n == zeros + sum(counts) to survive round trips
        out.n = zeros + sum(counts.values())
        return out

    @classmethod
    def merge_dicts(cls, dicts) -> "LogHistogram":
        """Folds many serialized histograms (merge is associative and
        commutative, so observer-side folding order is irrelevant)."""
        out = cls()
        for d in dicts:
            out = out.merge(cls.from_dict(d))
        return out


# ---------------------------------------------------------------------------
# Nemesis activity tracking
# ---------------------------------------------------------------------------

def _nemesis_specs(test) -> list[dict]:
    """The test's nemesis activity specs, normalized by the single
    authority (reports/perf._nemesis_specs — what the graphs shade),
    with the monitor's defaults: unnamed specs display as 'nemesis'
    and no specs at all means the plain start/stop pair."""
    from .reports.perf import _nemesis_specs as perf_specs

    out = [{"name": s.get("name") or "nemesis",
            "start": s["start"], "stop": s["stop"]}
           for s in perf_specs(test or {})]
    return out or [{"name": "nemesis", "start": {"start"},
                    "stop": {"stop"}}]


# ---------------------------------------------------------------------------
# The monitor
# ---------------------------------------------------------------------------

class Monitor:
    """Collects per-op signals from the interpreter and samples them
    periodically into a time-series.

    Lifecycle (driven by core.run): Monitor(test) -> start(path) ->
    [interpreter feeds hooks] -> stop(). Tests may also drive hooks and
    sample() directly, without the thread.
    """

    DEFAULT_INTERVAL_S = 1.0

    # The interpreter hooks and the sampler thread race on these;
    # writes happen under _lock only. The lifecycle attrs (_out/_thread/_stopped) are driven from the
    # controlling thread and deliberately not listed.
    _guarded_by_lock = {"_lock": (
        "_hist", "_completed", "_dispatched", "_stalls", "_inflight",
        "_nemesis_active", "_probe_gauges", "_points",
        "_last_t", "_last_completed", "_last_stalls")}

    def __init__(self, test: dict | None = None,
                 interval_s: float | None = None):
        test = test or {}
        self.interval_s = float(
            interval_s if interval_s is not None
            else test.get("monitor_interval_s", self.DEFAULT_INTERVAL_S))
        self._lock = threading.RLock()
        self._hist = LogHistogram()
        self._completed = 0
        self._dispatched = 0
        self._stalls = 0
        self._inflight: dict[Any, int] = {}     # thread -> invoke t (ns)
        self._nemesis_specs = _nemesis_specs(test)
        self._nemesis_active: set = set()
        self._probe_gauges: dict[str, Any] = {}
        self._probes: list[Callable] = [
            factory() for factory in (test.get("monitor_probes") or [])]
        self._points: list[dict] = []
        self._out = None
        self._stop = threading.Event()
        self._stopped = False
        self._thread: threading.Thread | None = None
        # previous tick, for rate deltas; the construction time anchors
        # the FIRST tick, so a run short enough to see only the final
        # stop() sample still gets a real ops_s (rate since start)
        # instead of a point the post-hoc graphs must drop
        self._t0 = util.relative_time_nanos()
        self._last_t: int | None = None
        self._last_completed = 0
        self._last_stalls = 0

    # -- interpreter hooks (main-loop thread) ------------------------------

    def on_dispatch(self, op, thread, now: int) -> None:
        with self._lock:
            if op.process != "nemesis":
                self._dispatched += 1
            # in-flight tracks every worker (a stuck fault activation
            # is worth seeing), but only client ops count as ops
            self._inflight[thread] = now

    def on_complete(self, op, thread, now: int) -> None:
        with self._lock:
            t0 = self._inflight.pop(thread, None)
            if op.process == "nemesis":
                # fault activations track as nemesis state, never as
                # client latency/throughput — a multi-second partition
                # start would otherwise dominate the p99
                if op.type == "info":
                    for spec in self._nemesis_specs:
                        if op.f in spec["start"]:
                            self._nemesis_active.add(spec["name"])
                        elif op.f in spec["stop"]:
                            self._nemesis_active.discard(spec["name"])
            else:
                if t0 is not None:
                    self._hist.add(now - t0)
                self._completed += 1
            for probe in self._probes:
                try:
                    probe(op, self)
                except Exception:  # noqa: BLE001 — probes are best-effort
                    logger.exception("monitor probe failed")

    def on_stall(self) -> None:
        with self._lock:
            self._stalls += 1

    def probe_gauge(self, name: str, value) -> None:
        """Record a workload-specific live gauge (e.g. kafka consumer
        lag); included in every subsequent sample point."""
        with self._lock:
            self._probe_gauges[name] = value

    # -- sampling ----------------------------------------------------------

    def histogram(self) -> LogHistogram:
        """A snapshot copy of the cumulative latency histogram."""
        with self._lock:
            return LogHistogram().merge(self._hist)

    def sample(self) -> dict:
        """One time-series point. Rates are deltas since the previous
        sample; quantiles are cumulative (the histogram streams)."""
        now = util.relative_time_nanos()
        tel = telemetry.get()
        with self._lock:
            base_t = self._last_t if self._last_t is not None \
                else self._t0
            dt_s = (now - base_t) / 1e9
            dt_s = dt_s if dt_s > 0 else None
            d_completed = self._completed - self._last_completed
            d_stalls = self._stalls - self._last_stalls
            self._last_t = now
            self._last_completed = self._completed
            self._last_stalls = self._stalls
            qs = self._hist.quantiles((0.5, 0.95, 0.99))
            point = {
                "t": now,
                "ops_s": (round(d_completed / dt_s, 2)
                          if dt_s else None),
                "stall_rate": (round(d_stalls / dt_s, 2)
                               if dt_s else None),
                "completed": self._completed,
                "dispatched": self._dispatched,
                "inflight": {util.name_str(th): now - t0
                             for th, t0 in self._inflight.items()},
                "latency_ms": {f"p{int(q * 100)}":
                               (round(v / 1e6, 3) if v is not None
                                else None)
                               for q, v in qs.items()},
                "nemesis": sorted(self._nemesis_active),
            }
            if self._probe_gauges:
                point["probes"] = dict(self._probe_gauges)
        gauges = {k: v for k, v in tel.gauges().items()
                  if k.startswith(_LIVE_GAUGE_PREFIXES)}
        if gauges:
            point["gauges"] = gauges
        wd = tel.counters().get("watchdog.violations", 0)
        if wd:
            point["watchdog"] = wd
        open_spans = [s.get("name") for s in tel.open_spans()]
        if open_spans:
            point["open_spans"] = open_spans
        return point

    def _emit(self) -> None:
        point = self.sample()
        with self._lock:
            self._points.append(point)
            if self._out is not None:
                try:
                    self._out.write(json.dumps(point, default=repr))
                    self._out.write("\n")
                    self._out.flush()  # live tailers read mid-run
                except OSError:
                    logger.exception("monitor point write failed")
                    self._out = None

    def flush_point(self) -> None:
        """Emit one point now, outside the sampler's cadence. core.run
        calls this at the case→analyze boundary so the post-hoc graphs
        always have at least one real-rate sample of the case, even
        when the run finished inside the first sampler interval."""
        try:
            self._emit()
        except Exception:  # noqa: BLE001 — observability must not sink
            logger.exception("monitor flush failed")

    # -- lifecycle ---------------------------------------------------------

    def start(self, out_path=None) -> "Monitor":
        if out_path is not None:
            try:
                p = Path(out_path)
                p.parent.mkdir(parents=True, exist_ok=True)
                self._out = open(p, "w")
            except OSError:  # observability must never sink the run;
                logger.exception("monitor artifact unavailable")
                self._out = None  # points still accumulate in memory
        with self._lock:
            if self._last_t is None:
                # re-anchor: core.run resets the relative clock between
                # Monitor construction and start
                self._t0 = util.relative_time_nanos()
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self._emit()
                except Exception:  # noqa: BLE001 — sampler must not die
                    logger.exception("monitor sample failed")

        self._thread = threading.Thread(
            target=run, name="jepsen-monitor", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stops the sampler, emitting one final point so short runs
        always leave at least one behind. Idempotent: core.run stops
        the monitor before publishing results.json (so tailers
        see the final point before the end-of-run marker) and again in
        its crash-tolerant finally block."""
        if self._stopped:
            return
        self._stopped = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self._emit()
        finally:
            if self._out is not None:
                self._out.close()
                self._out = None

    def points(self) -> list[dict]:
        with self._lock:
            return list(self._points)


# ---------------------------------------------------------------------------
# Reading stored artifacts
# ---------------------------------------------------------------------------

def read_points(path) -> Iterator[dict]:
    """Points from a timeseries.jsonl; a torn trailing line (the
    sampler died, or the run is still writing) is dropped rather than
    raised (telemetry.read_jsonl, the shared parser)."""
    return telemetry.read_jsonl(path)
