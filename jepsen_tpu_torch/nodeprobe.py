"""Node observability plane: per-node resource, clock-skew, and DB-log
telemetry for the nodes *under test* (the port's copy of
jepsen_tpu/nodeprobe.py: the recorder, its parsers and validators, and
the readers of nodes.jsonl).

  *Sampler.* One lightweight compound shell probe per node per tick
  over the remote layer: a single `execute()` reading `/proc/stat`,
  `/proc/meminfo`, `/proc/diskstats`, `/proc/net/dev`, a clock reading
  (`date +%s.%N`, turned into a control-vs-node offset via
  nemesis/time.clock_offset), and incremental byte-offset tails of the
  DB's log files. Each tick appends schema-validated records to
  `nodes.jsonl` in the run's store directory.

  *Honest gaps.* A node that can't be probed gets a `gap` record naming
  the reason. Missing samples are never interpolated.

  *Log taxonomy.* Tailed log bytes are scanned against a small pattern
  taxonomy (panic/assert, OOM-kill, election/leader-change, corruption,
  restart) producing structured `log` records. A parseable in-line
  timestamp is normalized by the node's measured clock offset onto the
  run's clock; lines without one are stamped at observation time
  (`ts: "observed"`).

  *Clock-skew series.* The per-tick offsets merge with the history's
  `check-offsets` observations into one per-node skew series; its worst
  absolute value is the `clock-skew-bound` that core.analyze stamps
  onto realtime-order verdicts (wgl linearizability, elle strict
  variants).

The dummy remote answers the probe with seeded synthetic `/proc` data
(synthetic_responder), so a run exercises the full path clusterless.
With the quarantine breakers on (test["health"], control/health.py),
a quarantined node gets `gap` records without any transport traffic,
breaker transitions are recorded as `breaker` records, and memory or
CPU pressure goes to the registry as an advisory, never a breaker
verdict. prometheus_lines renders the latest samples for the web UI's
/metrics scrape (web.py).
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time as _time
from decimal import Decimal, InvalidOperation
from pathlib import Path
from typing import Any, Iterable

from . import telemetry, util

logger = logging.getLogger(__name__)

NODES_FILE = "nodes.jsonl"
SCHEMA = 1

DEFAULT_INTERVAL_S = 1.0
TAIL_MAX_BYTES = 65536
MAX_EVENTS_PER_TICK = 32   # per file — a log storm can't flood the plane
LINE_LIMIT = 240           # stored log-line excerpt length

# One marker line per probe section; echoed by the compound command,
# split on read. The string never occurs in /proc output or sane logs.
MARK = "=====jepsen-nodeprobe"
# Echoed immediately after each log tail: `echo` starts at the cursor,
# so the sentinel lands on its own line iff the tail ended with a
# newline — which makes the byte-offset accounting exact even though
# the transport hands us the output re-split into lines.
EOT = "=====jepsen-probe-tail-eot"  # NOT a MARK prefix: it must
# survive parse_probe's section split as ordinary content

KINDS = ("sample", "gap", "log", "breaker")
GAP_REASONS = ("unreachable", "quarantined", "no-data")
BREAKER_STATES = ("closed", "open", "half-open")

# The DB-log pattern taxonomy, first match wins (a panic line that
# mentions the leader is a panic). Patterns are deliberately broad —
# they tag *candidate* events for a human/correlator, they are not
# verdicts.
LOG_PATTERNS: list[tuple[str, re.Pattern]] = [
    ("panic-assert", re.compile(
        r"panic|assert(ion)?\s+fail|fatal error|segfault|stack trace",
        re.IGNORECASE)),
    ("oom-kill", re.compile(
        r"out of memory|oom[- ]?kill|killed process|"
        r"cannot allocate memory", re.IGNORECASE)),
    ("corruption", re.compile(
        r"corrupt|checksum mismatch|checksum error|bad magic|"
        r"invalid block", re.IGNORECASE)),
    ("election", re.compile(
        r"election|elected|became leader|leader.{0,16}(change|lost|"
        r"down|elect)|new leader|stepping down|became follower|"
        r"voted for", re.IGNORECASE)),
    ("restart", re.compile(
        r"starting server|server started|shutting down|"
        r"received signal|restarting|ready to accept", re.IGNORECASE)),
]

LOG_CLASSES = tuple(name for name, _p in LOG_PATTERNS)


def classify_line(line: str) -> str | None:
    """The taxonomy class of one log line, or None for lines the node
    plane has nothing to say about."""
    for name, pat in LOG_PATTERNS:
        if pat.search(line):
            return name
    return None


# Timestamps the tailer can normalize: ISO-8601-ish (the common DB log
# prefix) and bracketed epoch seconds.
_ISO_TS = re.compile(
    r"(\d{4})-(\d{2})-(\d{2})[T ](\d{2}):(\d{2}):(\d{2})(\.\d+)?")
_EPOCH_TS = re.compile(r"[\[(](\d{9,10}(?:\.\d+)?)[\])]")


def parse_log_timestamp(line: str) -> float | None:
    """Node-clock epoch seconds parsed from a log line, or None.
    ISO timestamps are taken as UTC — DB logs under test overwhelmingly
    log UTC, and a timezone mis-guess is bounded and visible next to
    the raw line, unlike a silently dropped timestamp."""
    m = _ISO_TS.search(line)
    if m:
        import calendar

        y, mo, d, h, mi, s = (int(m.group(i)) for i in range(1, 7))
        frac = float(m.group(7) or 0.0)
        try:
            return calendar.timegm((y, mo, d, h, mi, s)) + frac
        except (ValueError, OverflowError):
            return None
    m = _EPOCH_TS.search(line)
    if m:
        try:
            return float(m.group(1))
        except ValueError:
            return None
    return None


# ---------------------------------------------------------------------------
# The compound probe command + its parse
# ---------------------------------------------------------------------------

def probe_cmd(log_files: dict[str, int] | None = None) -> str:
    """The one shell command a tick runs: echoes a marker line before
    each section so the reply splits unambiguously. `log_files` maps
    log path -> byte offset already consumed (tail resumes there)."""
    from .control.core import escape

    parts = []
    for name, path in (("stat", "/proc/stat"),
                       ("meminfo", "/proc/meminfo"),
                       ("diskstats", "/proc/diskstats"),
                       ("net", "/proc/net/dev")):
        parts.append(f"echo '{MARK} {name}'; cat {path} 2>/dev/null")
    for path, off in (log_files or {}).items():
        # tr maps bytes 1:1, so replacing every byte that isn't
        # printable-ASCII/\n/\t with '?' keeps the offset accounting
        # exact while guaranteeing the reply survives the transport:
        # a binary splat in a crashed DB's log (the corruption
        # taxonomy's own target) must not wedge a strict-UTF-8
        # transport into permanent gaps, and \r must die HERE —
        # text-mode transports translate \r\n to \n, which would
        # silently eat one byte per CRLF line and drift the offsets
        parts.append(f"echo '{MARK} log {path}'; "
                     f"tail -c +{int(off) + 1} {escape(path)} "
                     f"2>/dev/null | head -c {TAIL_MAX_BYTES} "
                     "| tr -c '[:print:]\\n\\t' '?'; "
                     f"echo '{EOT}'")
    # clock LAST: the reading is compared against control time when
    # the reply is parsed, so everything between `date` running and
    # that comparison (here: just the reply transfer, not also the
    # 64KB-per-file log tails) biases the offset negative. The
    # residual one-way latency is inherent — the same bias the
    # nemesis's check-offsets reading carries.
    parts.append(f"echo '{MARK} clock'; date +%s.%N")
    return "; ".join(parts)


def split_tail(section: str) -> str | None:
    """The exact bytes a log tail returned, recovered from its
    section text via the EOT sentinel: a trailing newline survives as
    the sentinel sitting on its own line. None when the sentinel is
    missing (reply torn mid-section — consume nothing, retry next
    tick)."""
    if section == EOT:
        return ""
    if section.endswith("\n" + EOT):
        return section[:-len(EOT)]          # tail ended with \n
    if section.endswith(EOT):
        return section[:-len(EOT)]          # tail ended mid-line
    return None


def parse_probe(out: str) -> dict:
    """Splits a probe reply into {'stat': text, ..., 'clock': text,
    'logs': {path: text}} by marker line."""
    sections: dict[str, Any] = {"logs": {}}
    name = None
    buf: list[str] = []

    def flush():
        if name is None:
            return
        text = "\n".join(buf)
        if name.startswith("log "):
            sections["logs"][name[len("log "):]] = text
        else:
            sections[name] = text

    # split on "\n" ONLY (not splitlines): a CRLF log line keeps its
    # \r byte and \x85/U+2028-style characters stay intact, so the
    # tail sections rejoin to the EXACT bytes the node sent and the
    # byte-offset accounting in _scan_logs cannot drift
    for line in out.split("\n"):
        if line.startswith(MARK):
            flush()
            name = line[len(MARK):].strip()
            buf = []
        else:
            buf.append(line)
    flush()
    return sections


def parse_stat(text: str) -> dict | None:
    """Aggregate cpu jiffies from /proc/stat's first `cpu ` line:
    {'busy': j, 'total': j} (busy = total - idle - iowait)."""
    for line in text.splitlines():
        if line.startswith("cpu "):
            try:
                fields = [int(x) for x in line.split()[1:]]
            except ValueError:
                return None
            if len(fields) < 4:
                return None
            total = sum(fields)
            idle = fields[3] + (fields[4] if len(fields) > 4 else 0)
            return {"busy": total - idle, "total": total}
    return None


def parse_meminfo(text: str) -> dict | None:
    """{'total_kb': n, 'free_kb': n} (MemAvailable preferred over
    MemFree — it is what the OOM killer effectively reasons about)."""
    vals: dict[str, int] = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) >= 2 and parts[0].rstrip(":") in (
                "MemTotal", "MemFree", "MemAvailable"):
            try:
                vals[parts[0].rstrip(":")] = int(parts[1])
            except ValueError:
                pass
    if "MemTotal" not in vals:
        return None
    free = vals.get("MemAvailable", vals.get("MemFree"))
    if free is None:
        return None
    return {"total_kb": vals["MemTotal"], "free_kb": free}


def parse_diskstats(text: str) -> dict | None:
    """Summed sectors read/written across real devices (loop/ram
    excluded)."""
    read = written = 0
    seen = False
    for line in text.splitlines():
        f = line.split()
        if len(f) < 10 or f[2].startswith(("loop", "ram")):
            continue
        try:
            read += int(f[5])
            written += int(f[9])
            seen = True
        except ValueError:
            continue
    return {"read_sectors": read, "write_sectors": written} if seen \
        else None


def parse_netdev(text: str) -> dict | None:
    """Summed rx/tx bytes across interfaces, loopback excluded."""
    rx = tx = 0
    seen = False
    for line in text.splitlines():
        if ":" not in line:
            continue
        iface, rest = line.split(":", 1)
        if iface.strip() == "lo":
            continue
        f = rest.split()
        if len(f) < 9:
            continue
        try:
            rx += int(f[0])
            tx += int(f[8])
            seen = True
        except ValueError:
            continue
    return {"rx_bytes": rx, "tx_bytes": tx} if seen else None


def parse_clock(text: str) -> float | None:
    """Control-vs-node clock offset in seconds from a `date +%s.%N`
    reading (nemesis/time.clock_offset — the check-offsets math)."""
    from .nemesis.time import clock_offset

    try:
        return clock_offset(Decimal(text.strip()))
    except (InvalidOperation, ValueError, ArithmeticError):
        return None


# ---------------------------------------------------------------------------
# The probe
# ---------------------------------------------------------------------------

class _NodeState:
    """Per-node tail offsets + previous counters for rate deltas."""

    def __init__(self, log_files: list[str]):
        self.offsets: dict[str, int] = {p: 0 for p in log_files}
        self.carry: dict[str, str] = {p: "" for p in log_files}
        self.prev: dict | None = None
        self.prev_t: int | None = None
        self.last_offset: float | None = None  # last MEASURED clock
        self.session = None
        self.breaker_state: str | None = None
        self.advised: set[str] = set()


class NodeProbe:
    """Background per-node sampler. Lifecycle mirrors the monitor:
    NodeProbe(test) -> start(path) -> [samples] -> stop(). Tests may
    drive `tick(node)` directly, without threads.

    Each node gets its own thread and its own control session (not the
    run's shared worker sessions — a hung probe must never stall a
    client op), reconnecting lazily after transport failures. With
    quarantine active (test["health"]), an open-circuit node is
    skipped entirely — one `gap` record, zero transport traffic."""

    # advisory thresholds: health summaries feed the registry as
    # warnings, never as breaker verdicts
    MEM_FREE_WARN_FRAC = 0.05
    CPU_BUSY_WARN_FRAC = 0.98

    # Per-node threads all funnel records through _emit under _lock. Per-node _NodeState objects are
    # owned by their node's thread (unshared) and the lifecycle
    # attrs by the controlling thread; neither is listed.
    _guarded_by_lock = {"_lock": ("_records",)}

    def __init__(self, test: dict | None = None,
                 interval_s: float | None = None):
        test = test or {}
        self.test = test
        self.interval_s = float(
            interval_s if interval_s is not None
            else test.get("nodeprobe_interval_s", DEFAULT_INTERVAL_S))
        self.nodes = list(test.get("nodes") or [])
        self._lock = threading.Lock()
        self._records: list[dict] = []
        self._out = None
        self._stop = threading.Event()
        self._stopped = False
        self._threads: list[threading.Thread] = []
        self._states = {n: _NodeState(self._log_files(test, n))
                        for n in self.nodes}
        # run-clock origin in epoch seconds: what normalizes parsed
        # node-log timestamps onto the relative timeline
        self.origin_epoch = (_time.time()
                             - util.relative_time_nanos() / 1e9)

    @staticmethod
    def _log_files(test: dict, node) -> list[str]:
        """Log paths to tail on `node`: the explicit
        test["node_log_files"] override (clusterless runs, tests), else
        whatever the DB declares via the LogFiles protocol."""
        explicit = test.get("node_log_files")
        if explicit:
            return [str(p) for p in explicit]
        db = test.get("db")
        if db is None:
            return []
        try:
            from . import db as jdb

            return list(jdb.log_files_map(db, test, node))
        except Exception:  # noqa: BLE001 — probing must never raise
            logger.exception("resolving log files for %s failed", node)
            return []

    # -- record plumbing ---------------------------------------------------

    def _emit(self, rec: dict) -> None:
        with self._lock:
            self._records.append(rec)
            if self._out is not None:
                try:
                    self._out.write(json.dumps(rec, default=repr))
                    self._out.write("\n")
                    self._out.flush()  # readers tail this cross-process
                except OSError:
                    logger.exception("nodes.jsonl write failed")
                    self._out = None

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    # -- one tick ----------------------------------------------------------

    def _gap(self, node, reason: str) -> None:
        telemetry.count(f"nodeprobe.gaps.{reason}")
        self._emit({"kind": "gap", "node": str(node),
                    "t": util.relative_time_nanos(),
                    "reason": reason})

    def _breaker(self, node):
        hr = self.test.get("health")
        if hr is None:
            return None
        try:
            return hr.breaker(node)
        except Exception:  # noqa: BLE001
            return None

    def _record_breaker_transition(self, node, st: _NodeState) -> None:
        b = self._breaker(node)
        if b is None:
            return
        state = b.state()
        if state != st.breaker_state:
            st.breaker_state = state
            self._emit({"kind": "breaker", "node": str(node),
                        "t": util.relative_time_nanos(),
                        "state": state})

    def _session(self, node, st: _NodeState):
        if st.session is None:
            from . import control

            # UNguarded: probe traffic must never feed the quarantine
            # breakers — a probe failure/s during a partition would
            # open every circuit on its own, and a probe success
            # would reset the consecutive-failure count between real
            # client failures. The probe only READS breaker state
            # (tick() skips open circuits).
            st.session = control.session(self.test, node,
                                         guarded=False)
        return st.session

    def _drop_session(self, st: _NodeState) -> None:
        sess, st.session = st.session, None
        if sess is not None:
            try:
                sess.disconnect()
            except Exception:  # noqa: BLE001 — already failing
                pass

    def tick(self, node) -> None:
        """One probe of one node: sample + log tail, or an honest gap.
        Never raises."""
        from .control.core import Action, TransportError

        st = self._states.setdefault(
            node, _NodeState(self._log_files(self.test, node)))
        self._record_breaker_transition(node, st)
        b = self._breaker(node)
        if b is not None and b.is_open:
            # quarantined: skipped without touching the transport (the
            # breaker would fail-fast anyway; skipping also spares the
            # rejected-command counter noise)
            self._gap(node, "quarantined")
            return
        cmd = probe_cmd(st.offsets)
        try:
            sess = self._session(node, st)
            res = sess.execute(Action(
                cmd=cmd, timeout=max(10.0, self.interval_s * 5)))
            out = res.out if res.exit == 0 else ""
        except TransportError:
            self._drop_session(st)
            self._gap(node, "unreachable")
            return
        except Exception:  # noqa: BLE001 — the probe must never die
            logger.exception("nodeprobe tick failed on %s", node)
            self._drop_session(st)
            self._gap(node, "unreachable")
            return
        self._record_breaker_transition(node, st)
        t = util.relative_time_nanos()
        sections = parse_probe(out or "")
        sample = self._build_sample(node, st, sections, t)
        if sample is None:
            # reachable but mute (e.g. the bare dummy remote's empty
            # success): an honest no-data gap, not a zeroed sample
            self._gap(node, "no-data")
        else:
            telemetry.count("nodeprobe.samples")
            self._emit(sample)
            self._advise(node, st, sample)
        # normalize log timestamps with the freshest MEASURED offset;
        # a tick whose clock section was torn falls back to the last
        # measurement, and with none ever taken the events are
        # stamped "observed", never "parsed"-with-a-made-up-zero
        offset = (sample or {}).get("clock_offset_s")
        if offset is not None:
            st.last_offset = offset
        self._scan_logs(node, st, sections.get("logs") or {}, t,
                        st.last_offset)

    def _build_sample(self, node, st: _NodeState, sections: dict,
                      t: int) -> dict | None:
        cpu = parse_stat(sections.get("stat", ""))
        mem = parse_meminfo(sections.get("meminfo", ""))
        disk = parse_diskstats(sections.get("diskstats", ""))
        net = parse_netdev(sections.get("net", ""))
        offset = parse_clock(sections.get("clock", ""))
        if cpu is None and mem is None and offset is None:
            return None
        rec: dict = {"kind": "sample", "node": str(node), "t": t}
        if mem is not None:
            used = mem["total_kb"] - mem["free_kb"]
            rec["mem"] = {"total_kb": mem["total_kb"],
                          "free_kb": mem["free_kb"],
                          "used_frac": round(
                              used / mem["total_kb"], 4)
                          if mem["total_kb"] else 0.0}
        if offset is not None:
            rec["clock_offset_s"] = round(offset, 6)
        # rate-like series need a previous tick; the first sample
        # carries only absolutes (never a made-up zero rate)
        prev, prev_t = st.prev, st.prev_t
        dt_s = (t - prev_t) / 1e9 if prev_t is not None else None
        if cpu is not None and prev and prev.get("cpu") and dt_s:
            d_busy = cpu["busy"] - prev["cpu"]["busy"]
            d_total = cpu["total"] - prev["cpu"]["total"]
            if d_total > 0:
                rec["cpu"] = {"busy": round(
                    max(0.0, min(1.0, d_busy / d_total)), 4)}
        if disk is not None and prev and prev.get("disk") and dt_s:
            rec["disk"] = {
                "read_bytes_s": round(max(0, (
                    disk["read_sectors"]
                    - prev["disk"]["read_sectors"])) * 512 / dt_s, 1),
                "write_bytes_s": round(max(0, (
                    disk["write_sectors"]
                    - prev["disk"]["write_sectors"])) * 512 / dt_s, 1)}
        if net is not None and prev and prev.get("net") and dt_s:
            rec["net"] = {
                "rx_bytes_s": round(max(0, (
                    net["rx_bytes"]
                    - prev["net"]["rx_bytes"])) / dt_s, 1),
                "tx_bytes_s": round(max(0, (
                    net["tx_bytes"]
                    - prev["net"]["tx_bytes"])) / dt_s, 1)}
        st.prev = {"cpu": cpu, "disk": disk, "net": net}
        st.prev_t = t
        return rec

    def _scan_logs(self, node, st: _NodeState, logs: dict[str, str],
                   t: int, clock_offset_s: float | None) -> None:
        for path, section in logs.items():
            text = split_tail(section)
            if not text:
                continue  # empty tail, or torn reply: retry next tick
            st.offsets[path] = st.offsets.get(path, 0) \
                + len(text.encode("utf-8", "replace"))
            # the tail may end mid-line (head -c truncation, or the
            # writer caught mid-append); carry the fragment into the
            # next tick instead of classifying half a line
            text = st.carry.get(path, "") + text
            lines = text.split("\n")
            st.carry[path] = lines.pop() if lines else ""
            n = 0
            for line in lines:
                cls = classify_line(line)
                if cls is None:
                    continue
                if n >= MAX_EVENTS_PER_TICK:
                    telemetry.count("nodeprobe.log-events-dropped")
                    break
                n += 1
                self._emit(self._log_event(node, path, line, cls, t,
                                           clock_offset_s))
            if st.carry[path] and len(st.carry[path]) > TAIL_MAX_BYTES:
                st.carry[path] = ""  # a pathological unterminated line

    def _log_event(self, node, path: str, line: str, cls: str,
                   t: int, clock_offset_s: float | None) -> dict:
        telemetry.count(f"nodeprobe.log.{cls}")
        rec = {"kind": "log", "node": str(node), "file": path,
               "class": cls, "line": line.strip()[:LINE_LIMIT]}
        ts_node = parse_log_timestamp(line)
        if ts_node is not None and clock_offset_s is not None:
            # node-clock epoch -> control epoch -> run-relative ns;
            # the measured offset is the normalizer (a bumped clock's
            # "future" log lines land where they really happened)
            rel = (ts_node - clock_offset_s - self.origin_epoch) * 1e9
            rec["t"] = max(0, int(rel))
            rec["ts"] = "parsed"
            rec["t_node_s"] = round(ts_node, 3)
        else:
            rec["t"] = t
            rec["ts"] = "observed"
        return rec

    def _advise(self, node, st: _NodeState, sample: dict) -> None:
        """Advisory health summaries for the breaker registry: warn,
        never trip — a loaded node is not a dead node."""
        hr = self.test.get("health")
        if hr is None or not hasattr(hr, "advise"):
            return
        worries = {}
        mem = sample.get("mem") or {}
        if mem.get("total_kb") and (mem.get("free_kb", 0)
                                    / mem["total_kb"]
                                    < self.MEM_FREE_WARN_FRAC):
            worries["low-memory"] = mem.get("free_kb")
        cpu = sample.get("cpu") or {}
        if cpu.get("busy", 0.0) > self.CPU_BUSY_WARN_FRAC:
            worries["cpu-saturated"] = cpu["busy"]
        for reason, value in worries.items():
            if reason not in st.advised:
                st.advised.add(reason)
                hr.advise(node, reason, value)
        st.advised &= set(worries)  # cleared worries may re-warn later

    # -- lifecycle ---------------------------------------------------------

    def start(self, out_path=None) -> "NodeProbe":
        if out_path is not None:
            try:
                p = Path(out_path)
                p.parent.mkdir(parents=True, exist_ok=True)
                self._out = open(p, "w")
            except OSError:  # observability must never sink the run
                logger.exception("nodes.jsonl unavailable")
                self._out = None
        self._stop.clear()

        def run(node):
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick(node)
                except Exception:  # noqa: BLE001 — sampler must not die
                    logger.exception("nodeprobe loop failed on %s",
                                     node)

        for node in self.nodes:
            th = threading.Thread(target=run, args=(node,),
                                  name=f"jepsen-nodeprobe-{node}",
                                  daemon=True)
            th.start()
            self._threads.append(th)
        return self

    def stop(self) -> None:
        """Stops the samplers and closes sessions + the output file.
        Idempotent (core.run stops before analyze AND in its finally)."""
        if self._stopped:
            return
        self._stopped = True
        self._stop.set()
        for th in self._threads:
            th.join(timeout=5)
        self._threads = []
        for st in self._states.values():
            self._drop_session(st)
        with self._lock:
            if self._out is not None:
                self._out.close()
                self._out = None


# ---------------------------------------------------------------------------
# Reading + validating stored records
# ---------------------------------------------------------------------------

def read_records(path) -> Iterable[dict]:
    """Records from a nodes.jsonl; torn trailing line dropped (the
    shared jsonl crash-tolerance contract)."""
    return telemetry.read_jsonl(path)


def load_records(store_dir) -> list[dict]:
    """All node-plane records of a stored run ([] when the run
    predates, or disabled, the probe)."""
    if not store_dir:
        return []
    return list(read_records(Path(store_dir) / NODES_FILE))


def validate_records(records) -> int:
    """Schema check for nodes.jsonl records (tier-1, the house style
    alongside the telemetry and coverage validators): every record has
    a known kind, a node, and a non-negative integer t; samples carry
    numeric metrics and non-decreasing per-node times; gaps/breakers
    carry known reasons/states; log events carry a taxonomy class and
    a ts provenance tag. Returns the record count; raises ValueError
    on the first violation."""
    n = 0
    last_sample_t: dict[str, int] = {}
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            raise ValueError(f"record {i}: not a dict")
        kind = rec.get("kind")
        if kind not in KINDS:
            raise ValueError(f"record {i}: unknown kind {kind!r}")
        node = rec.get("node")
        if not isinstance(node, str) or not node:
            raise ValueError(f"record {i}: bad node {node!r}")
        t = rec.get("t")
        if not isinstance(t, int) or t < 0:
            raise ValueError(f"record {i}: bad t {t!r}")
        if kind == "sample":
            if t < last_sample_t.get(node, 0):
                raise ValueError(
                    f"record {i}: sample time regressed on {node}")
            last_sample_t[node] = t
            for section in ("cpu", "mem", "disk", "net"):
                v = rec.get(section)
                if v is None:
                    continue
                if not isinstance(v, dict) or not all(
                        isinstance(x, (int, float))
                        for x in v.values()):
                    raise ValueError(
                        f"record {i}: bad {section}: {v!r}")
            off = rec.get("clock_offset_s")
            if off is not None and not isinstance(off, (int, float)):
                raise ValueError(f"record {i}: bad clock_offset_s")
        elif kind == "gap":
            if rec.get("reason") not in GAP_REASONS:
                raise ValueError(
                    f"record {i}: bad gap reason {rec.get('reason')!r}")
        elif kind == "breaker":
            if rec.get("state") not in BREAKER_STATES:
                raise ValueError(
                    f"record {i}: bad breaker state "
                    f"{rec.get('state')!r}")
        elif kind == "log":
            if rec.get("class") not in LOG_CLASSES:
                raise ValueError(
                    f"record {i}: unknown log class "
                    f"{rec.get('class')!r}")
            if rec.get("ts") not in ("parsed", "observed"):
                raise ValueError(
                    f"record {i}: bad ts provenance {rec.get('ts')!r}")
            if not isinstance(rec.get("line"), str):
                raise ValueError(f"record {i}: log without line")
        n += 1
    return n


# ---------------------------------------------------------------------------
# Clock-skew series: probe samples merged with check-offsets history
# ---------------------------------------------------------------------------

def clock_series(records, history=None) -> dict[str, list]:
    """{node: [[t_ns, offset_s], ...]} merging the probe's per-tick
    clock offsets with the history's `check-offsets` observations
    (`clock-offsets` completions — recorded since the clock nemesis
    landed, surfaced here for the first time), time-sorted."""
    series: dict[str, list] = {}
    for rec in records or []:
        if rec.get("kind") == "sample" and "clock_offset_s" in rec:
            series.setdefault(str(rec["node"]), []).append(
                [rec["t"], rec["clock_offset_s"]])
    for op in history or []:
        offsets = None
        try:
            offsets = op.get("clock-offsets")
        except AttributeError:
            pass
        if not offsets:
            continue
        t = getattr(op, "time", 0) or 0
        for node, off in offsets.items():
            if isinstance(off, (int, float)):
                series.setdefault(str(node), []).append(
                    [int(t), float(off)])
    for pts in series.values():
        pts.sort(key=lambda p: p[0])
    return series


def clock_skew_bound(records, history=None) -> float | None:
    """The worst absolute clock offset observed across the merged
    probe + check-offsets series, in seconds — the bound a realtime
    verdict honestly carries. None when nothing was measured (an
    unmeasured run must not claim a zero bound)."""
    worst = None
    for pts in clock_series(records, history).values():
        for _t, off in pts:
            a = abs(off)
            if worst is None or a > worst:
                worst = a
    return round(worst, 6) if worst is not None else None


# Anomaly classes whose checks lean on realtime order: the wgl
# linearizability verdict, and the elle graphs (both engines build
# realtime edges — cycles closing only through them get -realtime
# names). A result tagged with any of these gets the bound.
_REALTIME_MARKERS = ("nonlinearizable", "G0", "G-single")


def _uses_realtime(result: dict) -> bool:
    classes = result.get("anomaly-classes")
    if not isinstance(classes, dict):
        return False
    return any(m in classes for m in _REALTIME_MARKERS) or any(
        str(c).endswith("-realtime") for c in classes)


def stamp_results(results, bound: float, depth: int = 0) -> int:
    """Attaches `clock-skew-bound` to every realtime-order verdict in
    a results tree (wgl linearizability, elle strict variants) — the
    AccelSync framing: a `-realtime` claim carries the measured skew
    that bounds it. Returns the number of verdicts stamped."""
    if not isinstance(results, dict) or depth > 6:
        return 0
    n = 0
    if _uses_realtime(results):
        results["clock-skew-bound"] = bound
        n += 1
    for k, v in results.items():
        if k in ("anomalies", "anomaly-classes"):
            continue
        if isinstance(v, dict):
            n += stamp_results(v, bound, depth + 1)
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, dict):
                    n += stamp_results(item, bound, depth + 1)
    return n


# ---------------------------------------------------------------------------
# Prometheus exposition (web.py /metrics?run=)
# ---------------------------------------------------------------------------

def _prom_label(v) -> str:
    return str(v).replace("\\", "_").replace('"', "_")


def prometheus_lines(records) -> list[str]:
    """Node-plane samples for the run's /metrics scrape: the latest
    resource gauges per node, plus log-event / gap counters."""
    latest: dict[str, dict] = {}
    logs: dict[tuple, int] = {}
    gaps: dict[tuple, int] = {}
    for rec in records or []:
        node = _prom_label(rec.get("node"))
        if rec.get("kind") == "sample":
            latest[node] = rec
        elif rec.get("kind") == "log":
            key = (node, _prom_label(rec.get("class")))
            logs[key] = logs.get(key, 0) + 1
        elif rec.get("kind") == "gap":
            key = (node, _prom_label(rec.get("reason")))
            gaps[key] = gaps.get(key, 0) + 1
    lines: list[str] = []
    gauges = (
        ("jepsen_tpu_node_cpu_busy", lambda r: (r.get("cpu") or {})
         .get("busy")),
        ("jepsen_tpu_node_mem_used_fraction",
         lambda r: (r.get("mem") or {}).get("used_frac")),
        ("jepsen_tpu_node_clock_offset_seconds",
         lambda r: r.get("clock_offset_s")),
        ("jepsen_tpu_node_net_rx_bytes_per_second",
         lambda r: (r.get("net") or {}).get("rx_bytes_s")),
        ("jepsen_tpu_node_net_tx_bytes_per_second",
         lambda r: (r.get("net") or {}).get("tx_bytes_s")),
    )
    for name, getter in gauges:
        rows = [(node, getter(rec)) for node, rec in sorted(
            latest.items())]
        rows = [(node, v) for node, v in rows if v is not None]
        if not rows:
            continue
        lines.append(f"# TYPE {name} gauge")
        lines.extend(f'{name}{{node="{node}"}} {v}'
                     for node, v in rows)
    if logs:
        lines.append("# TYPE jepsen_tpu_node_log_events counter")
        lines.extend(
            f'jepsen_tpu_node_log_events{{node="{n}",class="{c}"}} {v}'
            for (n, c), v in sorted(logs.items()))
    if gaps:
        lines.append("# TYPE jepsen_tpu_node_probe_gaps counter")
        lines.extend(
            f'jepsen_tpu_node_probe_gaps{{node="{n}",reason="{r}"}} {v}'
            for (n, r), v in sorted(gaps.items()))
    return lines


# ---------------------------------------------------------------------------
# Seeded synthetic /proc responder (the dummy remote's node state)
# ---------------------------------------------------------------------------

_TAIL_RE = re.compile(r"tail -c \+(\d+) (\S+)")
_LOG_MARK_RE = re.compile(re.escape(MARK) + r" log (\S+)'")


class synthetic_responder:  # noqa: N801 — callable factory, used as one
    """A DummyRemote responder answering the probe with deterministic,
    seeded, *evolving* synthetic node state: counters grow tick over
    tick, each node's clock carries a distinct constant skew, and the
    synthetic DB log gains seeded taxonomy lines (one election early,
    one OOM-kill later) so clusterless runs produce tagged node events.

    Composable: returns None for commands it doesn't recognize, so it
    chains behind other responders (behind the partitioner's
    getent/ip-link answers, say)."""

    # The dummy remote calls this from every probe thread; node state
    # mutates under _lock only
    _guarded_by_lock = {"_lock": ("_nodes",)}

    def __init__(self, seed: int = 7):
        self.seed = seed
        self._lock = threading.Lock()
        self._nodes: dict[str, dict] = {}

    # per-tick increments are seeded per node: deterministic across
    # runs, distinct across nodes; _locked suffix = caller holds _lock
    def _state_locked(self, node) -> dict:
        key = str(node)
        st = self._nodes.get(key)
        if st is None:
            import random

            rng = random.Random(f"{self.seed}:{key}")
            idx = len(self._nodes)
            st = self._nodes[key] = {
                "rng": rng, "tick": 0,
                "busy": 0, "idle": 0, "rd": 0, "wr": 0,
                "rx": 0, "tx": 0,
                # distinct, finite skew per node; n1 gets -120ms,
                # n2 +240ms, ... — visibly nonzero, obviously bounded
                "skew": ((-1) ** idx) * 0.12 * (idx + 1),
                "log": "",
            }
        return st

    def _advance(self, st: dict) -> None:
        rng = st["rng"]
        st["tick"] += 1
        st["busy"] += rng.randrange(20, 80)
        st["idle"] += rng.randrange(100, 300)
        st["rd"] += rng.randrange(0, 512)
        st["wr"] += rng.randrange(0, 2048)
        st["rx"] += rng.randrange(1_000, 50_000)
        st["tx"] += rng.randrange(1_000, 50_000)
        # the seeded log schedule: a leader election on tick 2, an
        # OOM-kill on tick 4, chatter otherwise
        t = st["tick"]
        iso = _time.strftime("%Y-%m-%d %H:%M:%S",
                             _time.gmtime(_time.time() + st["skew"]))
        if t == 2:
            line = f"{iso} I | raft: became leader at term {t}\n"
        elif t == 4:
            line = (f"{iso} W | Out of memory: Killed process 4242 "
                    "(db-server)\n")
        else:
            line = f"{iso} D | compaction pass {t} ok\n"
        st["log"] += line

    def __call__(self, node, action):
        cmd = getattr(action, "cmd", "") or ""
        if MARK not in cmd:
            return None
        with self._lock:
            st = self._state_locked(node)
            self._advance(st)
            mem_free = max(512_000, 4_096_000 - st["tick"] * 37_000)
            out = [
                f"{MARK} stat",
                f"cpu  {st['busy']} 0 0 {st['idle']} 0 0 0 0",
                f"{MARK} meminfo",
                "MemTotal:        8192000 kB",
                f"MemFree:         {mem_free} kB",
                f"MemAvailable:    {mem_free} kB",
                f"{MARK} diskstats",
                f"   8       0 sda 100 0 {st['rd']} 10 50 0 "
                f"{st['wr']} 20 0 30 30",
                f"{MARK} net",
                "Inter-|   Receive  |  Transmit",
                f" eth0: {st['rx']} 10 0 0 0 0 0 0 {st['tx']} "
                "10 0 0 0 0 0 0",
                f"{MARK} clock",
                f"{_time.time() + st['skew']:.9f}",
            ]
            # answer each log section the command asked for, honoring
            # its tail offset against the synthetic log's full content
            offsets = {path: int(off) - 1 for off, path
                       in _TAIL_RE.findall(cmd)}
            for path in _LOG_MARK_RE.findall(cmd):
                off = max(0, offsets.get(path, 0))
                out.append(f"{MARK} log {path}")
                chunk = st["log"].encode()[off:off + TAIL_MAX_BYTES]
                # exactly what `tail | head; echo EOT` would print:
                # the sentinel follows the chunk's own (non-)newline
                out.append(chunk.decode("utf-8", "replace") + EOT)
            return "\n".join(out)
