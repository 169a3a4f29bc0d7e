"""Chrome-trace / Perfetto export for stored runs (the port's copy of
jepsen_tpu/reports/trace.py; for the same records its documents are the
JAX module's, event for event).

Converts a run's time-aligned records — telemetry spans, the history's
op invoke→complete lifetimes, nemesis activation windows and node-plane
records — into one Chrome Trace Event Format JSON (`trace.json`)
openable directly in https://ui.perfetto.dev (or chrome://tracing).
Everything shares the test's linear clock (util.relative_time_nanos),
so a kernel launch, the client op it was checking, and the fault
window it raced all line up on one timeline.

Track layout (pid/tid are synthetic; names ride in `M` metadata
events, per the trace-event spec):

  harness  one thread-track per recorder thread, nesting spans as the
           usual flame layout (`X` complete events)
  clients  one track per process: each op is an `X` slice from its
           invocation to its completion, colored by completion type.
           When the run carried the per-op causal trace
           (optrace.jsonl, tracing.py), each op slice grows nested
           child slices — the worker-side invoke, client calls, remote
           commands with exit/retry args — plus instant markers, all
           on the same linear clock so they nest by containment.
  nemesis  one track per nemesis spec, a slice per activation window
  device   one track per kernel (wgl, wgl-reach, scc, elle-append,
           ...): each launch record (gpu/profiler.py) is a slice
           carrying its bytes/operations/phase-split attrs, its CUDA-
           event compute time among them, and a `C` counter track of
           its BFS frontier curve
  node <n> one process per DB node (nodeprobe.py): counter tracks
           (`C` events) for CPU/memory/network/clock-offset — the
           offset series merges the probe ticks with the history's
           check-offsets observations — plus instant markers for
           tagged DB-log events, probe gaps, and quarantine-breaker
           transitions

fleet_chrome_trace renders the fleet flight recorder's records
(fleet/flightrec.py) as a session view. write_trace writes a stored
run's `trace.json`; `ops` pre-filters the export to the ops of an
anomaly; the CLI's `trace` subcommand and the web UI's `/trace/` route
call them. The device timeline of
the card itself, kernel by kernel, is the torch.profiler trace of a
profiled analysis (util.profile_trace).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

from .. import util
from ..history import History, is_info, is_invoke, is_ok

logger = logging.getLogger(__name__)

TRACE_JSON = "trace.json"

# Perfetto/catapult reserved color names, keyed by completion type.
_CNAME = {"ok": "good", "info": "bad", "fail": "terrible"}

_PID_HARNESS = 1
_PID_CLIENTS = 2
_PID_NEMESIS = 3
_PID_DEVICE = 4
_PID_NODE_BASE = 10  # node i gets pid _PID_NODE_BASE + i
# the fleet flight recorder's session view (fleet_chrome_trace) —
# far from the node range so a combined viewer never collides
_PID_FLEET_TENANTS = 90
_PID_FLEET_SVC = 91


def _us(ns: int) -> float:
    """Trace-event timestamps are microseconds."""
    return ns / 1e3


class _Tids:
    """Allocates stable integer tids per track name, emitting the
    thread_name metadata event on first use."""

    def __init__(self, events: list, pid: int, sort_index: int = 0):
        self.events = events
        self.pid = pid
        self.by_name: dict = {}
        self.events.append({"ph": "M", "name": "process_sort_index",
                            "pid": pid, "tid": 0,
                            "args": {"sort_index": sort_index}})

    def tid(self, name: str) -> int:
        t = self.by_name.get(name)
        if t is None:
            t = self.by_name[name] = len(self.by_name) + 1
            self.events.append({"ph": "M", "name": "thread_name",
                                "pid": self.pid, "tid": t,
                                "args": {"name": str(name)}})
        return t


def _process_meta(events: list, pid: int, name: str) -> None:
    events.append({"ph": "M", "name": "process_name", "pid": pid,
                   "tid": 0, "args": {"name": name}})


def _span_events(events: list, spans) -> int:
    """Telemetry spans as one flame-track per recorder thread. Device
    launch records (`kernel:` spans) are excluded here — they get
    their own per-kernel device tracks (_device_events) instead of
    hiding inside the harness flame."""
    _process_meta(events, _PID_HARNESS, "harness")
    tids = _Tids(events, _PID_HARNESS, sort_index=0)
    n = 0
    for s in spans:
        if "t0" not in s or "t1" not in s:
            continue
        if str(s.get("name", "")).startswith("kernel:"):
            continue
        ev = {"ph": "X", "cat": "span",
              "name": str(s.get("name", "?")),
              "pid": _PID_HARNESS,
              "tid": tids.tid(s.get("thread") or "main"),
              "ts": _us(s["t0"]),
              "dur": max(_us(s["t1"] - s["t0"]), 0.001)}
        if s.get("attrs"):
            ev["args"] = {k: repr(v) for k, v in s["attrs"].items()}
        events.append(ev)
        n += 1
    return n


def _device_events(events: list, spans) -> int:
    """Device-launch records (the profiler's `kernel:<name>` telemetry
    spans) as one track per kernel: each launch is a slice carrying
    its cost/phase attrs (operations, bytes, compile/compute split), so a
    kernel launch lines up against the checker phase and the ops it
    was checking on the shared clock."""
    launches = [s for s in spans
                if str(s.get("name", "")).startswith("kernel:")
                and "t0" in s and "t1" in s]
    if not launches:
        return 0
    _process_meta(events, _PID_DEVICE, "device")
    tids = _Tids(events, _PID_DEVICE, sort_index=3)
    n = 0
    for s in launches:
        kernel = str(s["name"])[len("kernel:"):]
        ev = {"ph": "X", "cat": "kernel",
              "name": kernel,
              "pid": _PID_DEVICE,
              "tid": tids.tid(kernel),
              "ts": _us(s["t0"]),
              "dur": max(_us(s["t1"] - s["t0"]), 0.001)}
        if s.get("attrs"):
            ev["args"] = {k: (v if isinstance(v, (int, float, str))
                              else repr(v))
                          for k, v in s["attrs"].items()}
        events.append(ev)
        n += 1
        # search-explorer counter track: the launch's BFS frontier
        # occupancy curve (gpu/wgl.py _drain) spread over the
        # launch's wall window, one `C` track per kernel
        curve = (s.get("attrs") or {}).get("frontier_curve")
        if isinstance(curve, list) and curve and all(
                isinstance(x, (int, float)) for x in curve):
            track = f"{kernel} frontier"
            span_ns = max(s["t1"] - s["t0"], 1)
            step = span_ns / len(curve)
            for i, x in enumerate(curve):
                events.append({
                    "ph": "C", "name": track, "pid": _PID_DEVICE,
                    "tid": tids.tid(track),
                    "ts": _us(s["t0"] + i * step),
                    "args": {"frontier": float(x)}})
                n += 1
    return n


def _op_events(events: list, history, ops_filter=None) -> "_Tids":
    """Op lifetimes: one track per process, one slice per
    invoke→complete pair. Uncompleted invokes extend to history end
    (the same convention the timeline report uses). Returns the track
    allocator so the optrace child spans land on the same tracks."""
    _process_meta(events, _PID_CLIENTS, "clients")
    tids = _Tids(events, _PID_CLIENTS, sort_index=1)
    if not isinstance(history, History):
        history = History(history)
    tmax = history[-1].time if len(history) else 0
    n = 0
    for op in history:
        if not is_invoke(op):
            continue
        if ops_filter is not None and op.index not in ops_filter:
            continue
        comp = history.completion(op)
        t1 = comp.time if comp is not None else tmax
        ctype = ("info" if comp is None or is_info(comp)
                 else "ok" if is_ok(comp) else "fail")
        ev = {"ph": "X", "cat": "op",
              "name": str(op.f),
              "pid": _PID_CLIENTS,
              "tid": tids.tid(util.name_str(op.process)),
              "ts": _us(op.time),
              "dur": max(_us(t1 - op.time), 0.001),
              "cname": _CNAME[ctype],
              "args": {"type": ctype, "process": str(op.process),
                       "value": repr(op.value)}}
        if comp is not None and comp.value != op.value:
            ev["args"]["result"] = repr(comp.value)
        events.append(ev)
        n += 1
    logger.debug("trace: %d op slices", n)
    return tids


def _optrace_events(events: list, tids: "_Tids", records,
                    ops_filter=None) -> int:
    """Per-op causal trace records as nested slices under the op
    lifetimes: same pid/tid as the op's process track, so Perfetto
    nests them by time containment. Spans (op/client/remote kinds)
    become `X` slices carrying their attrs (cmd, node, exit, retries);
    events become `i` instant markers."""
    n = 0
    for rec in records or []:
        opi = rec.get("op")
        if ops_filter is not None and opi not in ops_filter:
            continue
        if rec.get("process") is None or "t0" not in rec:
            continue  # context-free events have no op track to sit on
        kind = str(rec.get("kind", "span"))
        # the op-kind record is the worker-side invoke nested inside
        # the history's op-lifetime slice (cat "op") — name it apart
        base = {"cat": "invoke" if kind == "op" else kind,
                "name": str(rec.get("name", "?")),
                "pid": _PID_CLIENTS,
                "tid": tids.tid(str(rec["process"])),
                "ts": _us(rec["t0"])}
        args = {"trace": rec.get("trace"), "span": rec.get("span")}
        if rec.get("status"):
            args["status"] = str(rec["status"])
        for k, v in (rec.get("attrs") or {}).items():
            args[k] = v if isinstance(v, (int, float, str)) else repr(v)
        base["args"] = args
        if rec.get("kind") == "event":
            base.update(ph="i", s="t")
        else:
            if "t1" not in rec:
                continue
            base.update(ph="X",
                        dur=max(_us(rec["t1"] - rec["t0"]), 0.001))
        events.append(base)
        n += 1
    return n


def _nemesis_events(events: list, test, history) -> int:
    """Fault-activation windows, one track per nemesis spec — the same
    intervals reports/perf.py shades."""
    from .perf import _nemesis_specs

    if not isinstance(history, History):
        history = History(history)
    specs = _nemesis_specs(test or {}) or [
        {"name": "nemesis", "start": {"start"}, "stop": {"stop"}}]
    _process_meta(events, _PID_NEMESIS, "nemesis")
    tids = _Tids(events, _PID_NEMESIS, sort_index=2)
    tmax = history[-1].time if len(history) else 0
    n = 0
    for spec in specs:
        name = spec.get("name") or "nemesis"
        ints = util.nemesis_intervals(
            history, [{"start": spec["start"], "stop": spec["stop"]}])
        for start, stop in ints:
            t1 = stop.time if stop is not None else tmax
            events.append({
                "ph": "X", "cat": "nemesis",
                "name": str(name),
                "pid": _PID_NEMESIS, "tid": tids.tid(str(name)),
                "ts": _us(start.time),
                "dur": max(_us(t1 - start.time), 0.001),
                "cname": "terrible",
                "args": {"start": str(start.f),
                         "stop": str(stop.f) if stop else "(open)"}})
            n += 1
    return n


def _node_events(events: list, noderecs, history=None) -> int:
    """Node-plane records (nodeprobe.py) as one process per DB
    node: `C` counter events for the resource series, instant markers
    for log events / gaps / breaker transitions. The clock-offset
    counter uses the MERGED series (probe ticks + the history's
    check-offsets observations), so skew readings that previously sat
    unrendered in the history finally land on the timeline."""
    from .. import nodeprobe

    noderecs = list(noderecs or [])
    offsets = nodeprobe.clock_series(noderecs, history)
    nodes = sorted({str(r.get("node")) for r in noderecs}
                   | set(offsets))
    if not nodes:
        return 0
    n = 0
    for i, node in enumerate(nodes):
        pid = _PID_NODE_BASE + i
        _process_meta(events, pid, f"node {node}")
        tids = _Tids(events, pid, sort_index=10 + i)
        mark_tid = tids.tid("events")

        def counter(name, t, value):
            events.append({"ph": "C", "name": name, "pid": pid,
                           "tid": tids.tid(name), "ts": _us(t),
                           "args": {name: value}})

        for t, off in offsets.get(node, []):
            counter("clock_offset_ms", t, round(off * 1e3, 3))
            n += 1
        for rec in noderecs:
            if str(rec.get("node")) != node:
                continue
            kind = rec.get("kind")
            t = rec.get("t", 0)
            if kind == "sample":
                busy = (rec.get("cpu") or {}).get("busy")
                if busy is not None:
                    counter("cpu_busy", t, busy)
                used = (rec.get("mem") or {}).get("used_frac")
                if used is not None:
                    counter("mem_used_frac", t, used)
                net = rec.get("net") or {}
                if "rx_bytes_s" in net:
                    counter("net_rx_bytes_s", t, net["rx_bytes_s"])
                if "tx_bytes_s" in net:
                    counter("net_tx_bytes_s", t, net["tx_bytes_s"])
                n += 1
            elif kind == "log":
                events.append({
                    "ph": "i", "s": "t", "cat": "node-log",
                    "name": f"log:{rec.get('class')}",
                    "pid": pid, "tid": mark_tid, "ts": _us(t),
                    "args": {"file": str(rec.get("file")),
                             "line": str(rec.get("line"))[:200],
                             "ts_source": str(rec.get("ts"))}})
                n += 1
            elif kind == "gap":
                events.append({
                    "ph": "i", "s": "t", "cat": "node-gap",
                    "name": f"gap:{rec.get('reason')}",
                    "pid": pid, "tid": mark_tid, "ts": _us(t),
                    "args": {}})
                n += 1
            elif kind == "breaker":
                events.append({
                    "ph": "i", "s": "t", "cat": "node-breaker",
                    "name": f"breaker:{rec.get('state')}",
                    "pid": pid, "tid": mark_tid, "ts": _us(t),
                    "args": {}})
                n += 1
    return n


def expand_op_filter(history, ops) -> set | None:
    """An anomaly's op references may be completion indices; the trace
    and timeline join on invocation indices. Expands the given index
    set so each index's pair is included too."""
    if ops is None:
        return None
    if not isinstance(history, History):
        history = History(history)
    out = set(int(i) for i in ops)
    for op in history:
        if op.index in out:
            try:
                pair = (history.completion(op) if is_invoke(op)
                        else history.invocation(op))
            except KeyError:
                pair = None
            if pair is not None:
                out.add(pair.index)
    return out


def chrome_trace(test: dict | None, history, spans,
                 optrace=None, ops=None, noderecs=None) -> dict:
    """The complete trace document for a run. `test` may be the loaded
    test.json dict (for nemesis plot specs), `history` a History or op
    list, `spans` telemetry span records, `optrace` per-op trace
    records (tracing.py), `noderecs` node-plane records
    (nodeprobe.py). `ops`: restrict the client tracks to
    these op indices — the pre-filtered anomaly drill-down view."""
    history = history if history is not None else []
    ops_filter = expand_op_filter(history, ops)
    events: list[dict] = []
    n_spans = _span_events(events, spans or [])
    n_dev = _device_events(events, spans or [])
    tids = _op_events(events, history, ops_filter)
    n_rec = _optrace_events(events, tids, optrace, ops_filter)
    n_nem = _nemesis_events(events, test, history)
    n_node = _node_events(events, noderecs, history)
    logger.info("trace: %d spans, %d device launches, %d optrace "
                "records, %d nemesis windows, %d node records",
                n_spans, n_dev, n_rec, n_nem, n_node)
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"source": "jepsen_tpu",
                          "test": str((test or {}).get("name"))}}


def write_trace(run_dir, out_path=None, ops=None) -> Path:
    """Loads a stored run and writes its trace.json; returns the
    path. Works on runs that predate telemetry (spans just come back
    empty) and on crashed runs (history read is torn-tolerant). `ops`
    pre-filters the client tracks to the given op indices (anomaly
    provenance drill-down)."""
    from .. import store as jstore

    d = Path(run_dir)
    test = jstore.load(d)
    events, _metrics = jstore.load_telemetry(d)
    optrace = jstore.load_optrace(d)
    noderecs = jstore.load_nodes(d)
    doc = chrome_trace(test, test.get("history") or [], events,
                       optrace=optrace, ops=ops, noderecs=noderecs)
    out = Path(out_path) if out_path else d / TRACE_JSON
    with open(out, "w") as f:
        json.dump(doc, f)
    return out


def fleet_chrome_trace(records) -> dict:
    """The fleet flight recorder's session view: renders
    fleet/flightrec.py records (FlightRecorder.records()) as a Chrome
    trace — one track per tenant (chunk ack spans + verdict spans,
    args carrying the latency decomposition), a device-launch track
    with a batch-occupancy counter, and WAL + scheduler swimlanes.
    Timestamps rebase to the earliest record so the raw monotonic
    clock starts at zero. The document passes
    validate_chrome_trace."""
    recs = [r for r in records or [] if isinstance(r, dict)
            and isinstance(r.get("t0"), int)
            and isinstance(r.get("t1"), int)]
    events: list[dict] = []
    _process_meta(events, _PID_FLEET_TENANTS, "fleet tenants")
    _process_meta(events, _PID_FLEET_SVC, "fleet service")
    ten = _Tids(events, _PID_FLEET_TENANTS, sort_index=0)
    svc = _Tids(events, _PID_FLEET_SVC, sort_index=1)
    t_base = min((r["t0"] for r in recs), default=0)

    def ts(ns: int) -> float:
        return _us(ns - t_base)

    for r in recs:
        kind = r.get("kind")
        dur = max(_us(r["t1"] - r["t0"]), 0.001)
        if kind == "chunk":
            args = {k: r[k] for k in ("wal_ms", "ack_ms", "ops")
                    if k in r}
            if r.get("trace") is not None:
                args["trace"] = str(r["trace"])
            events.append({
                "ph": "X", "cat": "fleet.chunk",
                "name": f"chunk {r.get('run')}#{r.get('seq')}",
                "pid": _PID_FLEET_TENANTS,
                "tid": ten.tid(str(r.get("tenant"))),
                "ts": ts(r["t0"]), "dur": dur, "args": args})
            wal_ms = r.get("wal_ms")
            if isinstance(wal_ms, (int, float)) and wal_ms > 0:
                # the append's fsync share, right-aligned at the ack
                events.append({
                    "ph": "X", "cat": "fleet.wal", "name": "append",
                    "pid": _PID_FLEET_SVC, "tid": svc.tid("wal"),
                    "ts": max(ts(r["t1"]) - wal_ms * 1e3, 0.0),
                    "dur": max(wal_ms * 1e3, 0.001)})
        elif kind == "launch":
            args = {k: r[k] for k in
                    ("cls", "reason", "rows", "capacity",
                     "occupancy", "device_ms", "certify_ms")
                    if k in r}
            args["tenants"] = ",".join(
                str(t) for t in (r.get("tenants") or []))
            events.append({
                "ph": "X", "cat": "fleet.launch",
                "name": f"{r.get('cls')} [{r.get('reason')}]",
                "pid": _PID_FLEET_SVC,
                "tid": svc.tid("device launches"),
                "ts": ts(r["t0"]), "dur": dur, "args": args})
            occ = r.get("occupancy")
            if isinstance(occ, (int, float)):
                events.append({
                    "ph": "C", "name": "batch occupancy",
                    "pid": _PID_FLEET_SVC,
                    "tid": svc.tid("batch occupancy"),
                    "ts": ts(r["t0"]),
                    "args": {str(r.get("cls")): float(occ)}})
            # the decision log: WHY this launch fired, as an instant
            # on the scheduler swimlane
            events.append({
                "ph": "i", "cat": "fleet.decision", "s": "t",
                "name": str(r.get("reason")),
                "pid": _PID_FLEET_SVC, "tid": svc.tid("scheduler"),
                "ts": ts(r["t0"])})
        elif kind == "verdict":
            lat = r.get("latency") or {}
            args = {k: v for k, v in lat.items()
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)}
            if lat.get("replay"):
                args["replay"] = 1
            events.append({
                "ph": "X", "cat": "fleet.verdict",
                "name": f"verdict {r.get('run')}",
                "pid": _PID_FLEET_TENANTS,
                "tid": ten.tid(str(r.get("tenant"))),
                "ts": ts(r["t0"]), "dur": dur, "args": args})
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"source": "jepsen_tpu.fleet.flightrec"}}


def validate_chrome_trace(doc: dict) -> int:
    """Schema check for an exported Chrome-trace document: required
    keys per event phase, non-negative microsecond timestamps and
    durations, and metadata referential integrity (every slice's
    pid/tid carries process_name/thread_name metadata). Returns the
    event count; raises ValueError on the first violation."""
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    named_pids: set = set()
    named_tids: set = set()
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("X", "M", "i", "C"):
            raise ValueError(f"event {i}: unknown ph {ph!r}")
        if "name" not in ev or "pid" not in ev:
            raise ValueError(f"event {i}: missing name/pid: {ev}")
        if ph == "M":
            if not isinstance(ev.get("args"), dict):
                raise ValueError(f"metadata event {i} missing args")
            if ev["name"] == "process_name":
                named_pids.add(ev["pid"])
            elif ev["name"] == "thread_name":
                named_tids.add((ev["pid"], ev["tid"]))
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: bad dur {dur!r}")
        if ph == "C":
            # counter events (node resource/skew series): args is the
            # series map and every value must be numeric
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float))
                    for v in args.values()):
                raise ValueError(
                    f"counter event {i}: non-numeric args "
                    f"{ev.get('args')!r}")
        if ev["pid"] not in named_pids:
            raise ValueError(f"event {i}: pid {ev['pid']} unnamed")
        if (ev["pid"], ev.get("tid")) not in named_tids:
            raise ValueError(
                f"event {i}: tid {ev.get('tid')} unnamed in pid "
                f"{ev['pid']}")
    return len(events)
