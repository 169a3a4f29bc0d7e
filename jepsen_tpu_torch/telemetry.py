"""Framework-wide telemetry: nested spans, counters, and gauges (the
port's copy of jepsen_tpu/telemetry.py).

The checking path (encode, wgl, certify, elle, scc, the kernels'
wrappers) and the test lifecycle report through one thread-safe
recorder, under the JAX package's metric names (`wgl.kernel.launches`,
`scc.path.device`, ...), so a run of the port reads like a run of the
JAX package:

  - core.run / analyze:  lifecycle phase spans (os-setup, db-cycle,
    case, snarf-logs, teardown-*, analyze, per-checker timing)
  - interpreter:         per-worker dispatch + generator-stall counters
  - nemesis:             fault-activation spans
  - gpu/ and the kernel wrappers: launches, search states, graph sizes,
    host-vs-device path taken

Model:

  *Spans* are named intervals on the test's linear clock
  (util.relative_time_nanos, the clock ops are stamped with, so spans
  line up with the history). Nesting is per thread: a span's parent is
  the innermost open span on the SAME thread, and spans opened on
  worker threads are roots.
  *Counters* are monotonically accumulated ints; *gauges* record the
  last value set.

Serialization (written by core.run into the test's store directory):

  telemetry.jsonl   one JSON object per completed span, append order
                    (a torn last line is dropped on read)
  metrics.json      the aggregate: per-span-name {count, total_ns,
                    max_ns}, counters, gauges

The process-global recorder is always on; reset() is called at the top
of each core.run so artifacts are scoped per run.
"""

from __future__ import annotations

import json
import logging
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Iterator

from . import util

logger = logging.getLogger(__name__)

TRACE_FILE = "telemetry.jsonl"
METRICS_FILE = "metrics.json"


class Telemetry:
    """A span/counter/gauge recorder. Thread-safe; one global instance
    (get()) serves the whole process, but tests may make their own."""

    # Shared-mutable state is written under _lock only. Per-thread span stacks live in _local (unshared by
    # construction) and are deliberately not listed.
    _guarded_by_lock = {"_lock": ("_spans", "_open", "_counters",
                                  "_gauges", "_next_id", "_epoch")}

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: list[dict] = []
        self._open: dict[int, dict] = {}
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, Any] = {}
        self._next_id = 0
        self._epoch = 0

    # -- spans -------------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, **attrs):
        """Context manager recording a named interval. Yields the span
        record (mutable: add attrs mid-flight via rec['attrs'])."""
        if not self.enabled:
            yield None
            return
        with self._lock:
            self._next_id += 1
            sid = self._next_id
            epoch0 = self._epoch
        stack = self._stack()
        rec: dict = {
            "id": sid,
            "parent": stack[-1]["id"] if stack else None,
            "name": name,
            "thread": threading.current_thread().name,
            "t0": util.relative_time_nanos(),
        }
        if attrs:
            rec["attrs"] = attrs
        stack.append(rec)
        with self._lock:
            # shared open-span registry (the thread-local stacks can't
            # be enumerated across threads): the live monitor samples
            # it to stream what the run is doing *right now*
            if self._epoch == epoch0:
                self._open[sid] = rec
        try:
            yield rec
        finally:
            rec["t1"] = util.relative_time_nanos()
            stack.pop()
            with self._lock:
                self._open.pop(sid, None)
                # a straggler thread completing a span after reset()
                # must not leak it into the next run's trace: its id
                # would collide with the new run's ids and its clock
                # origin is stale (same rule as deferred counter
                # flushes — see epoch)
                if self._epoch == epoch0:
                    self._spans.append(rec)

    def record_span(self, name: str, t0: int, t1: int,
                    attrs: dict | None = None,
                    epoch: int | None = None) -> dict | None:
        """Appends an already-timed span (no nesting, parent=None) —
        the path device-launch records take: the profiler times the
        launch phases itself and mirrors the completed interval here so
        it lands in telemetry.jsonl / the Perfetto device track.
        `epoch` (captured via .epoch when the interval STARTED) applies
        the same straggler guard as span(): a reset() between capture
        and append means t0/t1 were measured against a previous run's
        clock origin, and the span is dropped, not misfiled."""
        if not self.enabled:
            return None
        rec: dict = {"name": name, "parent": None,
                     "thread": threading.current_thread().name,
                     "t0": int(t0), "t1": int(t1)}
        if attrs:
            rec["attrs"] = dict(attrs)
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return None
            self._next_id += 1
            rec["id"] = self._next_id
            self._spans.append(rec)
        return rec

    def timed(self, name: str) -> Callable:
        """Decorator form of span()."""

        def deco(f):
            def wrapper(*args, **kwargs):
                with self.span(name):
                    return f(*args, **kwargs)

            wrapper.__name__ = getattr(f, "__name__", name)
            return wrapper

        return deco

    # -- counters / gauges -------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def gauge(self, name: str, value) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = value

    def gauge_max(self, name: str, value) -> None:
        """Keeps the maximum across sets — for 'worst seen this run'
        gauges (largest SCC, deepest frontier), where last-write-wins
        would report whichever call happened to run last."""
        if not self.enabled:
            return
        with self._lock:
            cur = self._gauges.get(name)
            if cur is None or value > cur:
                self._gauges[name] = value

    # -- views -------------------------------------------------------------

    def events(self) -> list[dict]:
        """Completed spans, append order."""
        with self._lock:
            return list(self._spans)

    def open_spans(self) -> list[dict]:
        """Snapshot copies of currently-open spans (any thread), start
        order — what the process is doing right now."""
        with self._lock:
            return [dict(r) for r in sorted(self._open.values(),
                                            key=lambda r: r["id"])]

    def spans(self) -> list[dict]:
        """Completed spans, append order (the name the port's callers
        have read them by since the first slice; events() is the same)."""
        return self.events()

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict:
        with self._lock:
            return dict(self._gauges)

    def metrics(self) -> dict:
        """The aggregate view serialized as metrics.json."""
        spans: dict[str, dict] = {}
        for s in self.events():
            if "t1" not in s:
                continue
            agg = spans.setdefault(
                s["name"], {"count": 0, "total_ns": 0, "max_ns": 0})
            dur = s["t1"] - s["t0"]
            agg["count"] += 1
            agg["total_ns"] += dur
            agg["max_ns"] = max(agg["max_ns"], dur)
        return {"spans": spans, "counters": self.counters(),
                "gauges": self.gauges()}

    def summary(self) -> dict:
        """Compact per-run summary attached to checker results
        (core.analyze): lifecycle phase durations, per-checker timings
        (checker:<name> spans), and all counters/gauges — the kernel
        profile included. Durations in milliseconds."""
        m = self.metrics()
        phases: dict = {}
        checkers: dict = {}
        for name, agg in m["spans"].items():
            ms = round(agg["total_ns"] / 1e6, 3)
            if name.startswith("checker:"):
                checkers[name[len("checker:"):]] = ms
            elif ":" not in name:
                phases[name] = ms
        return {"phases": phases, "checkers": checkers,
                "counters": m["counters"], "gauges": m["gauges"]}

    # -- lifecycle ---------------------------------------------------------

    @property
    def epoch(self) -> int:
        """Bumped by every reset(). Deferred flushers (e.g. worker
        threads batching hot-loop counters) capture it at start and
        skip their flush if a reset intervened, so a straggler thread
        from a crashed run can't pollute the next run's metrics."""
        return self._epoch

    def reset(self) -> None:
        with self._lock:
            self._spans = []
            self._open = {}
            self._counters = {}
            self._gauges = {}
            self._next_id = 0
            self._epoch += 1

    def save(self, directory) -> tuple[Path, Path]:
        """Writes telemetry.jsonl + metrics.json into `directory`;
        returns the two paths."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        trace = d / TRACE_FILE
        with open(trace, "w") as f:
            for s in self.events():
                f.write(json.dumps(s, default=repr))
                f.write("\n")
        metrics = d / METRICS_FILE
        with open(metrics, "w") as f:
            json.dump(self.metrics(), f, indent=1, default=repr)
        return trace, metrics


# ---------------------------------------------------------------------------
# Process-global recorder + module-level façade
# ---------------------------------------------------------------------------

_global = Telemetry()


def get() -> Telemetry:
    return _global


def span(name: str, **attrs):
    return _global.span(name, **attrs)


def count(name: str, n: int = 1) -> None:
    _global.count(name, n)


def gauge(name: str, value) -> None:
    _global.gauge(name, value)


def gauge_max(name: str, value) -> None:
    _global.gauge_max(name, value)


def record_span(name: str, t0: int, t1: int,
                attrs: dict | None = None,
                epoch: int | None = None) -> dict | None:
    return _global.record_span(name, t0, t1, attrs, epoch)


def timed(name: str) -> Callable:
    return _global.timed(name)


def reset() -> None:
    _global.reset()


def save(directory) -> tuple[Path, Path]:
    return _global.save(directory)


# ---------------------------------------------------------------------------
# Reading stored artifacts
# ---------------------------------------------------------------------------

def read_jsonl(path) -> Iterator[dict]:
    """Records from a JSONL artifact; a torn/corrupt trailing line
    (the writer died — or is still — mid-write) is dropped rather than
    raised. The shared crash-tolerance contract of telemetry.jsonl and
    the monitor's timeseries.jsonl."""
    p = Path(path)
    if not p.exists():
        return
    with open(p) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                return


def read_events(path) -> Iterator[dict]:
    """Spans from a telemetry.jsonl (see read_jsonl)."""
    return read_jsonl(path)


def read_metrics(path) -> dict | None:
    p = Path(path)
    if not p.exists():
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def validate_metrics(metrics: dict) -> int:
    """Schema check for a metrics.json document (the tracing.
    validate_records analog for the metrics artifact, run in tier-1):
    the three sections exist with the right shapes, every span
    aggregate carries non-negative integer count/total_ns/max_ns with
    max <= total, and counters are integers. Returns the total entry
    count; raises ValueError on the first violation."""
    if not isinstance(metrics, dict):
        raise ValueError("metrics must be a dict")
    for section in ("spans", "counters", "gauges"):
        if not isinstance(metrics.get(section), dict):
            raise ValueError(f"metrics missing {section!r} dict")
    n = 0
    for name, agg in metrics["spans"].items():
        if not isinstance(agg, dict):
            raise ValueError(f"span {name!r}: aggregate must be a dict")
        for key in ("count", "total_ns", "max_ns"):
            v = agg.get(key)
            if not isinstance(v, int) or v < 0:
                raise ValueError(
                    f"span {name!r}: bad {key}: {v!r}")
        if agg["max_ns"] > agg["total_ns"]:
            raise ValueError(
                f"span {name!r}: max_ns {agg['max_ns']} exceeds "
                f"total_ns {agg['total_ns']}")
        if agg["count"] == 0 and agg["total_ns"]:
            raise ValueError(f"span {name!r}: time without count")
        n += 1
    for name, v in metrics["counters"].items():
        if not isinstance(v, int):
            raise ValueError(f"counter {name!r}: non-integer {v!r}")
        n += 1
    n += len(metrics["gauges"])
    return n
