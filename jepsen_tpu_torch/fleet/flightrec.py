"""The fleet flight recorder: end-to-end verdict-latency SLOs and
utilization accounting for the checking service (the port's copy of
jepsen_tpu/fleet/flightrec.py).

The fleet data plane (client -> ingest -> WAL -> scheduler queue ->
batch launch -> device -> verdict write -> ack) was a black box
between the client's ack and its verdict file. This module records
that pipeline the way a serving stack records requests:

  spans     every journaled chunk, every device launch, and every
            verdict becomes a record on ONE monotonic clock
            (time.monotonic_ns — comparable across processes on the
            same host, which is how the client's `tc` trace context
            joins server-side spans). reports/trace.py's
            fleet_chrome_trace exports the records as a Perfetto
            fleet-session view.
  latency   every verdict carries a schema-validated `latency` block
            decomposing its wall-clock into the pipeline's slices:
            ingest_wait, wal_fsync, queue_wait, batching_delay,
            encode, device, certify, serialize. The device slice
            joins the kernels' own telemetry inside the launch
            window (kernel_phases: the device_ms of each `wgl:drain`
            and `scc:device` span of the launching thread, the
            kernel's time between the CUDA events its launcher
            records just around it), the certify slice the
            `certify.attach` spans; encode is the remaining host
            share of the launch wall. The block rides NEXT to
            the verdict (wire reply, results['fleet']), never inside
            the verdict file — the WAL-replay byte-identity contract
            forbids anything timing-dependent in those bytes.
  SLOs      streaming p50/p95/p99 verdict- and ack-latency via
            monitor.LogHistogram, fleet-wide and per tenant;
            histograms persist to `flightrec.json` (atomic rename)
            after every verdict, so a SIGKILL'd server's replayed
            fleet folds its history back in (LogHistogram.from_dict
            + merge — the cross-process observer path).
  util      per-launch batch occupancy as packed-rows/capacity,
            SEPARATELY per launch class (slice vs final — the old
            blended hists_per_launch over-stated utilization),
            device idle gaps between launches, per-tenant fairness
            counters, and a scheduler decision log recording WHY
            each launch fired (full / timeout / drain / breaker).

Everything is advisory: a disabled recorder (FleetServer(...,
flightrec=False)) turns every hook into an early return.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from pathlib import Path

from .. import telemetry
from ..monitor import LogHistogram

SNAPSHOT_FILE = "flightrec.json"
MAX_RECORDS = 4096

# the per-verdict critical-path decomposition, in pipeline order
LATENCY_KEYS = ("ingest_wait", "wal_fsync", "queue_wait",
                "batching_delay", "encode", "device", "certify",
                "serialize")
# why a launch fired (the scheduler decision log); "quarantine" marks
# a solo host-lane launch serving a poison-isolated run
REASONS = ("full", "timeout", "drain", "breaker", "quarantine")
CLASSES = ("slice", "final")
RECORD_KINDS = ("chunk", "launch", "verdict", "quarantine")
QUARANTINE_ACTIONS = ("quarantined", "released")
QS = (0.5, 0.95, 0.99)


def now() -> int:
    """The recorder clock: raw monotonic ns. Boot-relative on Linux,
    so a client's `tc` timestamp and the server's ingest stamp share
    one clock domain across processes on the same host."""
    return time.monotonic_ns()


def _ms(ns) -> float:
    return ns / 1e6


# ---------------------------------------------------------------------------
# The latency block
# ---------------------------------------------------------------------------

def latency_block(*, ingest_wait_ms=0.0, wal_fsync_ms=0.0,
                  queue_wait_ms=0.0, batching_delay_ms=0.0,
                  encode_ms=0.0, device_ms=0.0, certify_ms=0.0,
                  serialize_ms=0.0, replay: bool = False) -> dict:
    """Builds a schema-valid latency block (ms, rounded; negatives
    from clock ties clamp to 0). total_ms is the slice sum — the
    critical-path decomposition total, not the end-to-end SLO number
    (that one is the verdict histogram's job)."""
    vals = (ingest_wait_ms, wal_fsync_ms, queue_wait_ms,
            batching_delay_ms, encode_ms, device_ms, certify_ms,
            serialize_ms)
    block = {k: round(max(float(v), 0.0), 3)
             for k, v in zip(LATENCY_KEYS, vals)}
    block["total_ms"] = round(sum(block.values()), 3)
    if replay:
        # a crash-replayed verdict: ingest/WAL slices predate the
        # restart and are honestly zero, not remeasured
        block["replay"] = True
    return block


def replay_block() -> dict:
    """The block a recovered-from-file verdict carries: complete
    schema, every slice zero, replay-annotated."""
    return latency_block(replay=True)


def validate_latency(block) -> None:
    """Raises ValueError unless `block` is a schema-valid latency
    block: every slice key present and a non-negative number, a
    consistent total_ms, no unknown keys."""
    if not isinstance(block, dict):
        raise ValueError(f"latency block not a dict: {block!r}")
    allowed = set(LATENCY_KEYS) | {"total_ms", "replay"}
    extra = set(block) - allowed
    if extra:
        raise ValueError(f"latency block unknown keys: {sorted(extra)}")
    for k in LATENCY_KEYS + ("total_ms",):
        v = block.get(k)
        if isinstance(v, bool) or not isinstance(v, (int, float)) \
                or v < 0:
            raise ValueError(f"latency block bad {k!r}: {v!r}")
    if "replay" in block and block["replay"] is not True:
        raise ValueError(
            f"latency block bad replay: {block['replay']!r}")


def dominant_slice(block: dict) -> tuple[str, float]:
    """The slice where this verdict's wall-clock went — what `fleet
    explain` names."""
    k = max(LATENCY_KEYS, key=lambda key: block.get(key, 0.0))
    return k, float(block.get(k, 0.0))


# ---------------------------------------------------------------------------
# Record schema (the Perfetto fleet-session source)
# ---------------------------------------------------------------------------

def validate_records(records) -> int:
    """Schema check for flight-recorder records (run in tier-1 like
    tracing.validate_records): known kinds, required keys, ordered
    non-negative timestamps, occupancy within [0, 1], latency blocks
    schema-valid, and no double-counted chunk spans — a chaos
    transport's duplicated/reordered frames must journal (and so
    record) each seq exactly once. Returns the record count; raises
    ValueError on the first violation."""
    seen_chunks: set = set()
    n = 0
    for i, r in enumerate(records):
        if not isinstance(r, dict):
            raise ValueError(f"record {i}: not a dict")
        kind = r.get("kind")
        if kind not in RECORD_KINDS:
            raise ValueError(f"record {i}: unknown kind {kind!r}")
        t0, t1 = r.get("t0"), r.get("t1")
        if not isinstance(t0, int) or not isinstance(t1, int) \
                or t0 < 0 or t1 < t0:
            raise ValueError(
                f"record {i}: bad span [{t0!r}, {t1!r}]")
        if kind == "chunk":
            for k in ("tenant", "run"):
                if not isinstance(r.get(k), str):
                    raise ValueError(f"record {i}: bad {k!r}")
            seq = r.get("seq")
            if not isinstance(seq, int) or seq < 1:
                raise ValueError(f"record {i}: bad seq {seq!r}")
            key = (r["tenant"], r["run"], seq)
            if key in seen_chunks:
                raise ValueError(
                    f"record {i}: duplicate chunk span {key}")
            seen_chunks.add(key)
            for k in ("wal_ms", "ack_ms"):
                v = r.get(k)
                if not isinstance(v, (int, float)) or v < 0:
                    raise ValueError(f"record {i}: bad {k!r}: {v!r}")
        elif kind == "launch":
            if r.get("cls") not in CLASSES:
                raise ValueError(
                    f"record {i}: bad cls {r.get('cls')!r}")
            if r.get("reason") not in REASONS:
                raise ValueError(
                    f"record {i}: bad reason {r.get('reason')!r}")
            rows, cap = r.get("rows"), r.get("capacity")
            if not isinstance(rows, int) or rows < 0 \
                    or not isinstance(cap, int) or cap < 1:
                raise ValueError(
                    f"record {i}: bad rows/capacity {rows!r}/{cap!r}")
            occ = r.get("occupancy")
            if not isinstance(occ, (int, float)) or not 0 <= occ <= 1:
                raise ValueError(
                    f"record {i}: bad occupancy {occ!r}")
            if not isinstance(r.get("tenants"), list):
                raise ValueError(f"record {i}: bad tenants")
        elif kind == "verdict":
            for k in ("tenant", "run"):
                if not isinstance(r.get(k), str):
                    raise ValueError(f"record {i}: bad {k!r}")
            try:
                validate_latency(r.get("latency"))
            except ValueError as e:
                raise ValueError(f"record {i}: {e}") from e
        elif kind == "quarantine":
            for k in ("tenant", "run", "error"):
                if not isinstance(r.get(k), str):
                    raise ValueError(f"record {i}: bad {k!r}")
            if r.get("action") not in QUARANTINE_ACTIONS:
                raise ValueError(
                    f"record {i}: bad action {r.get('action')!r}")
        n += 1
    return n


def kernel_phases(r0: int, r1: int) -> tuple[float, float]:
    """(device_ms, certify_ms) of the calling thread's launch window on
    the TELEMETRY clock (util.relative_time_nanos). The device share is
    what the kernels' own telemetry measured on the card: each
    `wgl:drain` and `scc:device` span in the window carries its
    kernel's time between the CUDA events its launcher records just
    around the kernel (`device_ms`), so no host wait is in it.
    `certify.attach` spans price certificate extraction. Only spans of
    the calling thread count: another thread's launches in the same
    window are not this launch's. On the CPU no CUDA event exists
    (device_ms None), and with no device record in the window (host
    path, telemetry off) both come back 0 and the whole launch wall
    stays in the `encode` host share."""
    device_ms = 0.0
    certify = 0
    me = threading.current_thread().name
    try:
        events = telemetry.get().events()
    except Exception:  # noqa: BLE001 — accounting never breaks a launch
        return 0.0, 0.0
    for s in reversed(events):
        t0, t1 = s.get("t0"), s.get("t1")
        if t0 is None or t1 is None:
            continue
        if t1 < r0:
            break  # completion order: everything earlier predates us
        overlap = min(t1, r1) - max(t0, r0)
        if overlap <= 0 or s.get("thread") != me:
            continue
        name = str(s.get("name", ""))
        attrs = s.get("attrs") or {}
        if name in ("wgl:drain", "scc:device"):
            device_ms += float(attrs.get("device_ms") or 0.0)
        elif name == "certify.attach":
            certify += overlap
    return device_ms, _ms(certify)


# ---------------------------------------------------------------------------
# Prometheus scrape validation
# ---------------------------------------------------------------------------

_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"\\]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"\\]*")*\})?'
    r' [-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|inf|nan)$')


def validate_prometheus(text: str) -> int:
    """Parse-validates a Prometheus text exposition (every sample
    line a well-formed `name{labels} value`). Returns the sample
    count; raises ValueError on the first malformed line — the
    scrape-parse gate for the fleet's tenant-labeled samples."""
    n = 0
    for i, line in enumerate(text.splitlines()):
        if not line or line.startswith("#"):
            continue
        if not _PROM_LINE.match(line):
            raise ValueError(f"line {i}: malformed sample {line!r}")
        n += 1
    return n


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

def _qdict(h: LogHistogram) -> dict:
    out = {"n": h.n}
    for q in QS:
        v = h.quantile(q)
        out[f"p{int(q * 100)}"] = None if v is None else round(v, 3)
    return out


class FlightRecorder:
    """One per FleetServer; shared with its Scheduler. Hooks are
    called from connection handler threads, the scheduler batch loop,
    and verdict threads — every mutation holds `_lock` (hooks are a
    few dict updates; the device launch itself is never under it)."""

    _guarded_by_lock = {"_lock": (
        "_records", "_verdict_ms", "_ack_ms", "_tenant_verdict",
        "_tenant_ack", "_classes", "_decisions", "_fairness",
        "_idle_ms", "_idle_gaps", "_last_launch_end", "_verdicts",
        "_quarantine_events")}

    def __init__(self, enabled: bool = True,
                 max_records: int = MAX_RECORDS):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._save_lock = threading.Lock()  # one snapshot at a time
        self._records: deque = deque(maxlen=max_records)
        self._verdict_ms = LogHistogram()
        self._ack_ms = LogHistogram()
        self._tenant_verdict: dict[str, LogHistogram] = {}
        self._tenant_ack: dict[str, LogHistogram] = {}
        # per launch class: launches / packed rows / occupancy sum
        self._classes = {c: {"launches": 0, "rows": 0,
                             "occupancy_sum": 0.0} for c in CLASSES}
        self._decisions = {r: 0 for r in REASONS}
        self._fairness: dict[str, dict] = {}
        self._idle_ms = 0.0
        self._idle_gaps = 0
        self._last_launch_end: int | None = None
        self._verdicts = 0
        self._quarantine_events = {a: 0 for a in QUARANTINE_ACTIONS}

    # -- ingest path (server) -------------------------------------------

    def chunk(self, tenant: str, run: str, seq: int, t0: int,
              t1: int, wal_ns: int, n_ops: int,
              client_t=None, trace=None) -> None:
        """One JOURNALED chunk: recv -> WAL append -> ack. Duplicate
        re-acks and resyncs never reach here, so chaos dup/reorder
        cannot double-count a span. `client_t` (the tc trace context)
        extends the span back to the client's send when the clocks
        are plausibly the same domain."""
        if not self.enabled:
            return
        if isinstance(client_t, int) and 0 < client_t <= t0 \
                and t0 - client_t < 60_000_000_000:
            t_start = client_t
        else:
            t_start = t0
        ack_ms = _ms(t1 - t_start)
        rec = {"kind": "chunk", "tenant": tenant, "run": run,
               "seq": seq, "t0": t_start, "t1": t1,
               "wal_ms": round(_ms(wal_ns), 3), "ops": n_ops,
               "ack_ms": round(ack_ms, 3)}
        if trace is not None:
            rec["trace"] = trace
        with self._lock:
            self._records.append(rec)
            self._ack_ms.add(ack_ms)
            h = self._tenant_ack.get(tenant)
            if h is None:
                h = self._tenant_ack[tenant] = LogHistogram()
            h.add(ack_ms)

    # -- scheduler path --------------------------------------------------

    def launch(self, cls: str, reason: str, t0: int, t1: int,
               rows: int, capacity: int, items,
               device_ms: float = 0.0,
               certify_ms: float = 0.0) -> None:
        """One device launch = one decision-log entry. Occupancy is
        packed rows over the launch class's capacity; the gap since
        the previous launch ended is device idle time."""
        if not self.enabled:
            return
        tenants = sorted({i.tenant for i in items})
        occupancy = min(rows / max(capacity, 1), 1.0)
        rec = {"kind": "launch", "cls": cls, "reason": reason,
               "t0": t0, "t1": t1, "rows": rows,
               "capacity": capacity,
               "occupancy": round(occupancy, 4),
               "tenants": tenants,
               "device_ms": round(device_ms, 3),
               "certify_ms": round(certify_ms, 3)}
        with self._lock:
            self._records.append(rec)
            c = self._classes[cls]
            c["launches"] += 1
            c["rows"] += rows
            c["occupancy_sum"] += occupancy
            self._decisions[reason] = \
                self._decisions.get(reason, 0) + 1
            if self._last_launch_end is not None \
                    and t0 > self._last_launch_end:
                self._idle_ms += _ms(t0 - self._last_launch_end)
                self._idle_gaps += 1
            self._last_launch_end = max(
                self._last_launch_end or 0, t1)
            per = {t: sum(1 for i in items if i.tenant == t)
                   for t in tenants}
            total_items = max(len(items), 1)
            for t, k in per.items():
                f = self._fairness.get(t)
                if f is None:
                    f = self._fairness[t] = {
                        "items": 0, "rows": 0, "launches": 0}
                f["items"] += k
                f["launches"] += 1
                # rows split by the tenant's item share of the launch
                f["rows"] += round(rows * k / total_items)

    # -- verdict path ----------------------------------------------------

    def verdict(self, tenant: str, run: str, t0: int, t1: int,
                latency: dict) -> None:
        """One verdict: fin (or recovery submit) -> verdict written.
        Feeds the SLO histograms and the per-tenant tracks."""
        if not self.enabled:
            return
        verdict_ms = _ms(max(t1 - t0, 0))
        rec = {"kind": "verdict", "tenant": tenant, "run": run,
               "t0": min(t0, t1), "t1": t1, "latency": latency}
        with self._lock:
            self._records.append(rec)
            self._verdicts += 1
            self._verdict_ms.add(verdict_ms)
            h = self._tenant_verdict.get(tenant)
            if h is None:
                h = self._tenant_verdict[tenant] = LogHistogram()
            h.add(verdict_ms)

    # -- quarantine path -------------------------------------------------

    def quarantine(self, tenant: str, run: str, action: str,
                   error: str) -> None:
        """One poison-isolation transition: a run entering or leaving
        the solo host lane. Instantaneous events on the recorder
        clock (t0 == t1)."""
        if not self.enabled:
            return
        t = now()
        rec = {"kind": "quarantine", "tenant": tenant, "run": run,
               "action": action, "error": str(error)[:200],
               "t0": t, "t1": t}
        with self._lock:
            self._records.append(rec)
            self._quarantine_events[action] = \
                self._quarantine_events.get(action, 0) + 1

    # -- views -----------------------------------------------------------

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    def snapshot(self) -> dict:
        """The stats()['flightrec'] block: SLO quantiles, per-class
        occupancy, the decision-log counts (their sum == total
        launches recorded), idle accounting, fairness counters."""
        if not self.enabled:
            return {"enabled": False}
        with self._lock:
            classes = {}
            for cls, c in self._classes.items():
                launches = c["launches"]
                classes[cls] = {
                    "launches": launches,
                    "rows": c["rows"],
                    "rows_per_launch": round(
                        c["rows"] / launches, 3) if launches else 0.0,
                    "occupancy": round(
                        c["occupancy_sum"] / launches, 4)
                    if launches else 0.0}
            tenants = sorted(set(self._tenant_verdict)
                             | set(self._tenant_ack))
            return {
                "enabled": True,
                "verdicts": self._verdicts,
                "verdict_ms": _qdict(self._verdict_ms),
                "ack_ms": _qdict(self._ack_ms),
                "tenants": {
                    t: {"verdict_ms": _qdict(
                            self._tenant_verdict.get(t)
                            or LogHistogram()),
                        "ack_ms": _qdict(
                            self._tenant_ack.get(t)
                            or LogHistogram())}
                    for t in tenants},
                "classes": classes,
                "launches": sum(c["launches"]
                                for c in self._classes.values()),
                "decisions": dict(self._decisions),
                "quarantine": dict(self._quarantine_events),
                "idle": {"gaps": self._idle_gaps,
                         "total_ms": round(self._idle_ms, 3)},
                "fairness": {t: dict(f)
                             for t, f in self._fairness.items()}}

    # -- persistence (SIGKILL survival + cross-process folding) ----------

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "verdicts": self._verdicts,
                "verdict_ms": self._verdict_ms.to_dict(),
                "ack_ms": self._ack_ms.to_dict(),
                "tenant_verdict": {
                    t: h.to_dict()
                    for t, h in self._tenant_verdict.items()},
                "tenant_ack": {
                    t: h.to_dict()
                    for t, h in self._tenant_ack.items()},
                "classes": {c: dict(v)
                            for c, v in self._classes.items()},
                "decisions": dict(self._decisions),
                "quarantine": dict(self._quarantine_events),
                "idle_ms": self._idle_ms,
                "idle_gaps": self._idle_gaps,
                "fairness": {t: dict(f)
                             for t, f in self._fairness.items()},
                "records": list(self._records)}

    def fold(self, d: dict) -> None:
        """Folds a persisted snapshot back in (restart recovery, or
        an observer merging several servers' files). Histograms merge
        associatively (LogHistogram); counters add."""
        if not isinstance(d, dict):
            return
        with self._lock:
            self._verdicts += int(d.get("verdicts") or 0)
            self._verdict_ms = self._verdict_ms.merge(
                LogHistogram.from_dict(d.get("verdict_ms") or {}))
            self._ack_ms = self._ack_ms.merge(
                LogHistogram.from_dict(d.get("ack_ms") or {}))
            for key, dst in (("tenant_verdict", self._tenant_verdict),
                             ("tenant_ack", self._tenant_ack)):
                for t, hd in (d.get(key) or {}).items():
                    cur = dst.get(t) or LogHistogram()
                    dst[t] = cur.merge(LogHistogram.from_dict(hd))
            for cls, v in (d.get("classes") or {}).items():
                if cls in self._classes and isinstance(v, dict):
                    c = self._classes[cls]
                    c["launches"] += int(v.get("launches") or 0)
                    c["rows"] += int(v.get("rows") or 0)
                    c["occupancy_sum"] += float(
                        v.get("occupancy_sum") or 0.0)
            for r, k in (d.get("decisions") or {}).items():
                self._decisions[r] = \
                    self._decisions.get(r, 0) + int(k)
            for a, k in (d.get("quarantine") or {}).items():
                self._quarantine_events[a] = \
                    self._quarantine_events.get(a, 0) + int(k)
            self._idle_ms += float(d.get("idle_ms") or 0.0)
            self._idle_gaps += int(d.get("idle_gaps") or 0)
            for t, f in (d.get("fairness") or {}).items():
                cur = self._fairness.setdefault(
                    t, {"items": 0, "rows": 0, "launches": 0})
                for k in cur:
                    cur[k] += int((f or {}).get(k) or 0)
            for rec in (d.get("records") or []):
                self._records.append(rec)

    def save(self, path) -> None:
        """Atomic tmp+rename, after every verdict: the durability
        cadence matches the WAL's promise — what was acked (and
        decided) survives the SIGKILL."""
        if not self.enabled:
            return
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_name(p.name + ".tmp")
        # concurrent verdict threads all save; the lock keeps one
        # writer's tmp from being renamed out from under another's
        with self._save_lock:
            tmp.write_text(json.dumps(self.to_dict(),
                                      separators=(",", ":")))
            os.replace(tmp, p)

    def load(self, path) -> bool:
        if not self.enabled:
            return False
        try:
            d = json.loads(Path(path).read_text())
        except (OSError, ValueError):
            return False
        self.fold(d)
        return True
