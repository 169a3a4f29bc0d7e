"""Per-op causal tracing (the port's copy of jepsen_tpu/tracing.py): the
recorder a traced run writes optrace.jsonl with, and its reader.

The interpreter mints a trace context per invocation, and everything
that happens on behalf of that op (client calls, and in a full test
remote commands, retries, reconnects and partition changes) records as
child spans and events under it, so an anomaly can be walked back to the
calls that produced it (the dgraph trace.clj analog).

Model:

  *Trace*: one per invocation; the trace id IS the invocation's op
  index, so trace records join the history with no extra bookkeeping.
  *Span*: a timed record {trace, span, parent, kind, name, op, process,
  t0, t1, attrs}. Kinds: "op" (the worker-side invoke, the trace root),
  "client" (one client call), "remote" (one remote command). Context
  propagates per thread: a span's parent is the innermost open span on
  the same thread.
  *Event*: a zero-duration record (kind "event"). Events outside any op
  context record with trace None.

Timestamps ride the test's linear clock (util.relative_time_nanos, the
clock ops and telemetry spans are stamped with).

Serialization: `optrace.jsonl` in the run's store directory, one JSON
object per completed record, streamed by a writer thread as records
complete; a torn trailing line is dropped on read. The reader half
(read_records, describe, by_op) serves the anomaly trace excerpts
(reports/explain.py) and the timeline's hover titles
(reports/timeline.py).

The recorder is OFF by default: `test["trace?"] = True` opts a run in
(core.run resets the global tracer with enabled=True, opens it on the
store directory's optrace.jsonl, flushes it before the analysis and
closes it at the end), and every record call begins with one `enabled`
check.
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator

from . import telemetry, util

logger = logging.getLogger(__name__)

TRACE_FILE = "optrace.jsonl"

KINDS = ("op", "client", "remote", "event")

# Stream-write cadence: a background writer thread drains completed
# records every interval, serializing and writing OFF the interpreter
# hot path (the hot path pays one lock + two list appends per
# record). Rare
# interesting kinds (remote, event) wake the writer immediately so
# tailers see faults as they land.
_WRITER_INTERVAL_S = 0.3


class Tracer:
    """A per-run trace recorder. Thread-safe; one global instance
    (get()) serves the process, but tests may make their own."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._local = threading.local()
        self._records: list[dict] = []
        self._out = None
        self._pending: list[dict] = []  # completed, not yet written
        self._writer: threading.Thread | None = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._epoch = 0
        # itertools.count is atomic under the GIL: span ids without a
        # lock round-trip on the interpreter hot path
        self._ids = itertools.count(1)

    @property
    def epoch(self) -> int:
        """Bumped by every reset(). Spans capture it when they open
        and drop their record if a reset intervened before they
        closed — a straggler worker thread from an abnormally-exited
        run must not leak foreign records (with colliding span ids
        from the restarted counter) into the next run's trace. The
        same rule telemetry applies to deferred counter flushes."""
        return self._epoch

    # -- context -----------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> dict | None:
        """The innermost open span on this thread, if any."""
        st = self._stack()
        return st[-1] if st else None

    def _span_id(self) -> int:
        return next(self._ids)

    # -- recording ---------------------------------------------------------

    @contextmanager
    def op_span(self, op):
        """Root span for one invocation: mints the op's trace context
        (trace id = the invocation's op index). The interpreter wraps
        every worker invoke in this; a crash closes the span with
        status 'crashed'."""
        if not self.enabled or op.index is None or op.index < 0:
            yield None
            return
        epoch0 = self._epoch
        rec: dict = {"trace": int(op.index), "span": self._span_id(),
                     "parent": None, "kind": "op", "name": str(op.f),
                     "op": int(op.index),
                     "process": util.name_str(op.process),
                     "t0": util.relative_time_nanos()}
        st = self._stack()
        st.append(rec)
        try:
            yield rec
        except BaseException:
            rec["status"] = "crashed"
            raise
        finally:
            rec["t1"] = util.relative_time_nanos()
            st.pop()
            self._emit(rec, epoch0)

    @contextmanager
    def span(self, kind: str, name: str, **attrs):
        """A child span under the ambient op context. Yields the
        mutable record (add attrs mid-flight); yields None — and
        records nothing — when tracing is off or no op context is open
        on this thread (e.g. a remote command during db setup)."""
        if not self.enabled:
            yield None
            return
        parent = self.current()
        if parent is None:
            yield None
            return
        epoch0 = self._epoch
        rec: dict = {"trace": parent["trace"], "span": self._span_id(),
                     "parent": parent["span"], "kind": kind,
                     "name": str(name), "op": parent["op"],
                     "process": parent["process"],
                     "t0": util.relative_time_nanos()}
        if attrs:
            rec["attrs"] = {k: v for k, v in attrs.items()
                            if v is not None}
        st = self._stack()
        st.append(rec)
        try:
            yield rec
        finally:
            rec["t1"] = util.relative_time_nanos()
            st.pop()
            self._emit(rec, epoch0)

    @contextmanager
    def attach(self, parent: dict | None):
        """Binds an already-open span as this thread's ambient context
        — how a worker pool carries an op's trace across its threads,
        so work done in parallel on behalf of one op still records as
        children of the op that issued it. The parent
        record is only read (children copy its trace/span ids), so
        sharing it across threads is safe."""
        if not self.enabled or parent is None:
            yield
            return
        st = self._stack()
        st.append(parent)
        try:
            yield
        finally:
            st.pop()

    def annotate(self, **attrs) -> None:
        """Merges attrs into the innermost open span on this thread
        (how the retry layer stamps its count onto the remote span)."""
        if not self.enabled:
            return
        cur = self.current()
        if cur is not None:
            cur.setdefault("attrs", {}).update(attrs)

    def event(self, name: str, **attrs) -> None:
        """A zero-duration record: reconnects, transport failures,
        partition changes. Attaches to the ambient op context when one
        is open; records context-free (trace None) otherwise."""
        if not self.enabled:
            return
        epoch0 = self._epoch
        parent = self.current()
        now = util.relative_time_nanos()
        rec: dict = {"trace": parent["trace"] if parent else None,
                     "span": self._span_id(),
                     "parent": parent["span"] if parent else None,
                     "kind": "event", "name": str(name),
                     "op": parent["op"] if parent else None,
                     "process": parent["process"] if parent else None,
                     "t0": now, "t1": now}
        if attrs:
            rec["attrs"] = {k: v for k, v in attrs.items()
                            if v is not None}
        self._emit(rec, epoch0)

    def _emit(self, rec: dict, epoch0: int) -> None:
        with self._lock:
            if self._epoch != epoch0:
                return  # straggler from a reset-away run (see epoch)
            self._records.append(rec)
            if self._out is None:
                return
            self._pending.append(rec)
        if rec.get("kind") in ("remote", "event"):
            self._wake.set()

    def _drain(self) -> None:
        """Serializes and writes everything pending (writer thread /
        close). A record is immutable once emitted, so dumping outside
        the lock is safe."""
        with self._lock:
            batch, self._pending = self._pending, []
            out = self._out
        if not batch or out is None:
            return
        try:
            out.write("".join(
                json.dumps(r, default=repr) + "\n" for r in batch))
            out.flush()
        except (OSError, ValueError):  # closed file loses the batch
            logger.exception("optrace write failed")
            with self._lock:
                self._out = None

    def _writer_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(_WRITER_INTERVAL_S)
            self._wake.clear()
            self._drain()
        self._drain()

    # -- lifecycle ---------------------------------------------------------

    def reset(self, enabled: bool | None = None) -> None:
        """Clears records and closes any stream; optionally flips the
        enabled flag. Called once per run, before the interpreter."""
        self.close()
        with self._lock:
            self._records = []
            self._pending = []
            self._ids = itertools.count(1)
            self._epoch += 1
        if enabled is not None:
            self.enabled = enabled

    def open(self, path) -> None:
        """Starts streaming records to `path` (optrace.jsonl)."""
        try:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            with self._lock:
                self._out = open(p, "w")
                self._pending = []
        except OSError:  # tracing must never sink the run
            logger.exception("optrace artifact unavailable")
            with self._lock:
                self._out = None
            return
        self._stop.clear()
        self._wake.clear()
        self._writer = threading.Thread(
            target=self._writer_loop, name="jepsen-optrace", daemon=True)
        self._writer.start()

    def flush(self) -> None:
        """Synchronously writes everything pending: called between the
        run and its analysis, so checkers (timeline hover detail, trace
        excerpts) read a complete artifact."""
        self._drain()

    def close(self) -> None:
        if self._writer is not None:
            self._stop.set()
            self._wake.set()
            self._writer.join(timeout=5)
            self._writer = None
        self._drain()
        with self._lock:
            if self._out is not None:
                try:
                    self._out.close()
                except OSError:
                    pass
                self._out = None

    def records(self) -> list[dict]:
        """Completed records, append order."""
        with self._lock:
            return list(self._records)

    def save(self, directory) -> Path:
        """Writes optrace.jsonl into `directory` (for tracers that
        never streamed); returns the path."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        out = d / TRACE_FILE
        with open(out, "w") as f:
            for rec in self.records():
                f.write(json.dumps(rec, default=repr))
                f.write("\n")
        return out


# ---------------------------------------------------------------------------
# Process-global tracer + module-level façade
# ---------------------------------------------------------------------------

_global = Tracer()


def get() -> Tracer:
    return _global


def span(kind: str, name: str, **attrs):
    return _global.span(kind, name, **attrs)


def event(name: str, **attrs) -> None:
    _global.event(name, **attrs)


def annotate(**attrs) -> None:
    _global.annotate(**attrs)


def current_context() -> dict | None:
    """The calling thread's innermost span as a COMPACT propagatable
    context ({"trace", "span"}), or None outside any span: the seam a
    caller in another process links its own spans to this run's
    optrace through."""
    cur = _global.current()
    if not isinstance(cur, dict):
        return None
    out = {}
    for k in ("trace", "span"):
        if cur.get(k) is not None:
            out[k] = cur[k]
    return out or None


# ---------------------------------------------------------------------------
# Reading + validating stored artifacts
# ---------------------------------------------------------------------------

def read_records(path) -> Iterator[dict]:
    """Records from an optrace.jsonl; a torn trailing line is dropped
    (telemetry.read_jsonl, the shared parser)."""
    return telemetry.read_jsonl(path)


def describe(rec: dict) -> str:
    """A compact one-line description of a trace record: the shared
    formatter behind the timeline hover titles and the anomaly trace
    excerpts (reports/explain)."""
    attrs = rec.get("attrs") or {}
    parts = [f"{rec.get('kind')} {rec.get('name')}"]
    if (rec.get("kind") != "event" and isinstance(rec.get("t0"), int)
            and isinstance(rec.get("t1"), int)):
        parts.append(f"{(rec['t1'] - rec['t0']) / 1e6:.2f}ms")
    if rec.get("status"):
        parts.append(f"status={rec['status']}")
    for k in ("node", "exit", "retries", "type", "error"):
        if k in attrs:
            parts.append(f"{k}={attrs[k]}")
    if "cmd" in attrs:
        parts.append(str(attrs["cmd"])[:48])
    return " ".join(parts)


def by_op(records) -> dict[int, list[dict]]:
    """Indexes records by op (invocation) index: the join key of the
    reports and the anomaly trace excerpts. Context-free events (op
    None) are left out."""
    out: dict[int, list[dict]] = {}
    for rec in records:
        op = rec.get("op")
        if isinstance(op, int):
            out.setdefault(op, []).append(rec)
    return out


_REQUIRED = ("span", "kind", "name", "t0", "t1")


def validate_records(records) -> int:
    """Schema check for an optrace record stream: required keys,
    monotonic timestamps (t1 >= t0 >= 0), known kinds, unique span
    ids, and parent-span referential integrity (every parent id names
    a record in the same trace). Returns the record count; raises
    ValueError on the first violation. Run in tier-1 against both
    generated and stored traces."""
    records = list(records)
    spans: dict[int, dict] = {}
    for i, rec in enumerate(records):
        for key in _REQUIRED:
            if key not in rec:
                raise ValueError(f"record {i} missing {key!r}: {rec}")
        if rec["kind"] not in KINDS:
            raise ValueError(f"record {i} unknown kind: {rec['kind']!r}")
        if not (isinstance(rec["t0"], int) and isinstance(rec["t1"], int)):
            raise ValueError(f"record {i} non-integer timestamps: {rec}")
        if rec["t0"] < 0 or rec["t1"] < rec["t0"]:
            raise ValueError(f"record {i} non-monotonic ts: {rec}")
        sid = rec["span"]
        if sid in spans:
            raise ValueError(f"record {i} duplicate span id {sid}")
        spans[sid] = rec
        if rec["kind"] == "op":
            if rec.get("parent") is not None:
                raise ValueError(f"op record {i} must be a trace root")
            if rec.get("op") != rec.get("trace"):
                raise ValueError(
                    f"op record {i}: op != trace id: {rec}")
    for i, rec in enumerate(records):
        parent = rec.get("parent")
        if parent is None:
            continue
        pr = spans.get(parent)
        if pr is None:
            raise ValueError(
                f"record {i} parent {parent} not in stream: {rec}")
        if pr.get("trace") != rec.get("trace"):
            raise ValueError(
                f"record {i} parent {parent} belongs to another trace")
    return len(records)
