"""The fleet server: a persistent, crash-safe, multi-tenant checking
service (the port's copy of jepsen_tpu/fleet/server.py).

Lifecycle of one tenant stream:

  hello   admission control decides: admitted streams get a resume
          point (last journaled seq, so a reconnecting client re-sends
          only what the crash lost); saturated quotas get a `reject`
          with retry-after — NEW streams are shed, in-flight ones are
          never degraded
  chunk   the frame is CRC-checked by the wire layer, journaled to the
          run's WAL, and only THEN acked — the ack is a durability
          promise a SIGKILL cannot revoke
  fin     the completed history is submitted to the scheduler, which
          packs it with other tenants' work into shared device
          launches; the verdict (with its certificate) is written
          atomically to the verdict file, then sent
  claim   a reconnecting client (or a cold CLI) waits for / fetches an
          already-computed verdict

Crash recovery (`recover()`, run at every start): the WAL directory is
the source of truth. Runs with a journaled fin and no verdict file are
re-submitted; runs mid-stream restore their resume point and keep
accepting chunks. Because verdict serialization is deterministic and
analysis is seeded by the journaled bytes alone, a replayed verdict
file is byte-identical to the one the crash interrupted.

kill() is the test hook for SIGKILL-equivalence: it abandons all
state without flushing or handshaking (WAL appends are already on
disk per-ack, which is the point).

`device` (None: the card; "cpu": the kernels' plain versions) builds
the default scheduler, which runs every check there; a scheduler passed
in brings its own.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from pathlib import Path

from .. import telemetry
from ..history import History
from ..gpu import ckpt as tckpt
from . import elle_checks, wgl_models, wire
from . import flightrec as frec
from . import scheduler as fsched
from . import wal as fwal

logger = logging.getLogger(__name__)

ADDR_FILE = "fleet.addr"
VERDICT_TIMEOUT_S = 300.0
# an unfinished run with no live connection and no ingest for this
# long is abandoned: it stops counting against the tenant quota (its
# WAL stays — a late reconnect still resumes it)
ABANDONED_S = 900.0


class Quotas:
    """Admission-control knobs (doc/fleet.md). Defaults size the demo
    pool: 8 concurrent tenants, so the 9th is REJECTED (with
    retry-after) rather than letting overload degrade anyone already
    admitted."""

    def __init__(self, max_tenants: int = 8,
                 max_streams_per_tenant: int = 4,
                 max_total_streams: int = 16,
                 max_ops_per_run: int = 2_000_000,
                 retry_after_s: float = 2.0):
        self.max_tenants = max_tenants
        self.max_streams_per_tenant = max_streams_per_tenant
        self.max_total_streams = max_total_streams
        self.max_ops_per_run = max_ops_per_run
        self.retry_after_s = retry_after_s


class RunState:
    """One (tenant, run) stream. Ingest (chunk/fin) is serialized
    under `lock` — reconnects may hand the run to a new handler thread
    while a half-dead one lingers, and the WAL append + seq advance
    must stay atomic."""

    _guarded_by_lock = {"lock": ("last_seq", "n_ops", "fin",
                                 "verdict", "wal", "t_first", "t_fin",
                                 "wal_ns", "latency", "cum_ops")}

    def __init__(self, tenant: str, run: str, model: str,
                 wal: fwal.RunWAL | None, stream=None, initial=None):
        self.tenant = tenant
        self.run = run
        self.model = model
        self.initial = initial
        self.wal = wal  # None once complete (no fd squatting)
        self.stream = stream  # StreamingRun | None
        self.lock = threading.Lock()
        self.last_seq = 0
        self.n_ops = 0
        # seq -> cumulative op count through that seq: the map that
        # turns a checkpoint's raw-op cut into the highest WAL seq
        # safe to compact through
        self.cum_ops: dict[int, int] = {}
        self.fin = False
        self.touched = time.monotonic()  # last hello/ingest
        self.verdict: dict | None = None
        self.verdict_ready = threading.Event()
        # flight-recorder stamps (frec.now() ns / accumulated append
        # ns). These feed the verdict's latency block — which rides
        # the wire NEXT to the verdict, never inside the verdict file
        # (the byte-identical replay contract).
        self.t_first: int | None = None  # first journaled chunk
        self.t_fin: int | None = None    # fin journaled
        self.wal_ns = 0                  # summed WAL-append wall
        self.latency: dict | None = None

    def retire_wal(self) -> None:
        """Closes the WAL fd once the run can never append again (fin
        + verdict): a long-lived server over thousands of past runs
        must not hold one fd per historical run."""
        with self.lock:
            wal, self.wal = self.wal, None
        if wal is not None:
            wal.close()


def prometheus_from_stats(st: dict) -> str:
    """Prometheus text exposition of a fleet stats dict — per-tenant
    labels on the tenant series (a scraper fetches the stats over the
    wire, so it needs no in-process server handle)."""
    lines = []

    def g(name, value, labels=""):
        lines.append(f"jepsen_fleet_{name}{labels} {value}")

    for k in ("accepted", "rejected", "chunks", "ops", "verdicts",
              "recovered", "frame_errors", "runs", "active_streams"):
        g(k, st.get(k, 0))
    g("wal_sheds", st.get("wal_sheds", 0))
    sch = st.get("scheduler") or {}
    for k in ("launches", "slice_launches", "final_launches",
              "items", "slice_rows", "final_hists",
              "cross_tenant_launches", "pending",
              "quarantine_items", "bisect_launches"):
        g(f"scheduler_{k}", sch.get(k, 0))
    g("quarantined_runs", len(sch.get("quarantine") or []))
    for tenant, ts in sorted((st.get("tenants") or {}).items()):
        lab = '{tenant="%s"}' % tenant
        for k in ("streams", "chunks", "ops", "verdicts",
                  "rejected"):
            g(f"tenant_{k}", ts.get(k, 0), lab)
    # flight-recorder series (fleet/flightrec.py): SLO
    # quantiles fleet-wide and per tenant, per-class occupancy, the
    # scheduler decision log, device idle. Every sample here must
    # pass flightrec.validate_prometheus (tests gate it).
    fr = st.get("flightrec") or {}
    if fr.get("enabled"):
        def quants(name, qd, extra=""):
            for q in ("p50", "p95", "p99"):
                v = (qd or {}).get(q)
                if isinstance(v, (int, float)):
                    g(name, v, '{%sq="%s"}' % (extra, q))

        quants("verdict_latency_ms", fr.get("verdict_ms"))
        quants("ack_latency_ms", fr.get("ack_ms"))
        for tenant, td in sorted((fr.get("tenants") or {}).items()):
            quants("tenant_verdict_latency_ms",
                   td.get("verdict_ms"), f'tenant="{tenant}",')
            quants("tenant_ack_latency_ms",
                   td.get("ack_ms"), f'tenant="{tenant}",')
        for cls, cd in sorted((fr.get("classes") or {}).items()):
            lab = '{cls="%s"}' % cls
            g("class_launches", cd.get("launches", 0), lab)
            g("class_rows", cd.get("rows", 0), lab)
            g("class_occupancy", cd.get("occupancy", 0.0), lab)
        for reason, n in sorted((fr.get("decisions") or {}).items()):
            g("decisions_total", n, '{reason="%s"}' % reason)
        for action, n in sorted((fr.get("quarantine") or {}).items()):
            g("quarantine_events_total", n, '{action="%s"}' % action)
        idle = fr.get("idle") or {}
        g("device_idle_ms_total", idle.get("total_ms", 0.0))
        g("device_idle_gaps", idle.get("gaps", 0))
    return "\n".join(lines) + "\n"


class FleetServer:
    _guarded_by_lock = {"_lock": ("_runs", "_active", "_stats",
                                  "_conns")}

    def __init__(self, base, host: str = "127.0.0.1", port: int = 0,
                 quotas: Quotas | None = None,
                 scheduler: fsched.Scheduler | None = None,
                 stream_checks: bool = True,
                 flightrec: bool = True, device=None):
        self.base = Path(base)
        self.host = host
        self.port = port
        self.quotas = quotas if quotas is not None else Quotas()
        if scheduler is None:
            scheduler = fsched.Scheduler(device=device)
        self.scheduler = scheduler
        self.stream_checks = stream_checks
        # the flight recorder is shared with the scheduler (its
        # launch/decision records land in the same session); disabled
        # it costs nothing
        self.flightrec = frec.FlightRecorder(enabled=bool(flightrec))
        if self.scheduler.flightrec is None and flightrec:
            self.scheduler.flightrec = self.flightrec
        self._lock = threading.Lock()
        self._runs: dict[tuple[str, str], RunState] = {}
        self._active: dict[tuple[str, str], int] = {}  # open streams
        self._stats: dict = {"accepted": 0, "rejected": 0,
                             "chunks": 0, "ops": 0, "verdicts": 0,
                             "recovered": 0, "frame_errors": 0,
                             "tenants": {}}
        self._sock: socket.socket | None = None
        self._conns: set = set()  # accepted sockets (for kill/stop)
        self._accept_thread: threading.Thread | None = None
        self._stopping = threading.Event()
        self._killed = False

    # -- lifecycle -------------------------------------------------------

    @property
    def addr(self) -> tuple[str, int]:
        assert self._sock is not None, "server not started"
        return self._sock.getsockname()[:2]

    def start(self) -> "FleetServer":
        self.base.mkdir(parents=True, exist_ok=True)
        # fold the previous incarnation's SLO histograms BEFORE
        # recovery, so replayed verdicts land on restored history
        self.flightrec.load(self.base / frec.SNAPSHOT_FILE)
        self.recover()
        self.scheduler.start()
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # a restarted server must re-bind its advertised port while
        # the killed instance's connections are still draining
        # (FIN_WAIT sockets held open by clients that are about to
        # reconnect); REUSEADDR alone doesn't cover those on Linux
        if hasattr(socket, "SO_REUSEPORT"):
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT,
                             1)
            except OSError:  # pragma: no cover — platform quirk
                pass
        s.bind((self.host, self.port))
        s.listen(64)
        self._sock = s
        self._stopping.clear()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-accept", daemon=True)
        self._accept_thread.start()
        host, port = self.addr
        (self.base / ADDR_FILE).write_text(
            f"{host}:{port}\n{os.getpid()}\n")
        logger.info("fleet server on %s:%d (base %s)", host, port,
                    self.base)
        return self

    def stop(self) -> None:
        """Graceful: stop accepting, let the scheduler drain, retire
        the addr file."""
        self._stopping.set()
        self._close_listener()
        self.scheduler.stop()
        self._close_conns()
        with self._lock:
            runs = list(self._runs.values())
        for r in runs:
            # under the run's lock: the batch thread may be retiring the
            # same WAL after its verdict, and a second os.close of its fd
            # raises EBADF or closes a reused fd (ROADMAP C8)
            r.retire_wal()
        try:
            (self.base / ADDR_FILE).unlink()
        except OSError:
            pass

    def kill(self) -> None:
        """SIGKILL-equivalent for tests: abandon everything. No WAL
        flush (appends are already on disk — that's the contract), no
        scheduler drain, no addr-file cleanup, connections die
        mid-frame (a killed process's fds ALL close — and the port
        must be immediately re-bindable by the restarted server)."""
        self._killed = True
        self._stopping.set()
        self._close_listener()
        self._close_conns()
        # scheduler threads are daemons; in-flight items are abandoned
        # exactly as a real SIGKILL would abandon them
        self.scheduler._stop.set()

    @staticmethod
    def _shut(sock) -> None:
        """Closes a socket as a dead process's fds close: shutdown()
        first, because on Linux a bare close() from another thread
        leaves a thread blocked in accept() or recv() holding the socket
        open (a listener beside the restarted server's on the same
        port, or a connection whose peer waits out its timeout for an
        ack that never comes)."""
        for step in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
            try:
                step()
            except OSError:
                pass

    def _close_listener(self) -> None:
        if self._sock is not None:
            self._shut(self._sock)

    def _close_conns(self) -> None:
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            self._shut(c)

    # -- streaming checkpoints (checkpoint-and-extend) -------------------

    def _make_ckpt_sink(self, rs: RunState):
        """The StreamingRun's checkpoint sink: atomically persist the
        stream-wgl record, then compact the WAL through the highest
        seq the certified raw-op cut covers — acked bytes before the
        cut no longer need one-by-one replay. Both steps are
        best-effort: a durability fault degrades resume cost, never
        verdicts (and never the ack path — this runs on the stream's
        worker thread)."""
        path = tckpt.fleet_path(self.base, rs.tenant, rs.run)

        def sink(rec: dict) -> None:
            if not tckpt.try_write(path, rec):
                return  # counted in ckpt; stale-but-valid file wins
            cut = rec.get("n_ops", 0)
            with rs.lock:
                through = max(
                    (s for s, c in rs.cum_ops.items() if c <= cut),
                    default=0)
                if through and rs.wal is not None:
                    # compact_through closes/reopens the append fd, so
                    # it must hold the same lock that serializes
                    # appends; the rewrite itself is atomic
                    try:
                        rs.wal.compact_through(through)
                    except OSError:
                        logger.exception("WAL compaction failed")

        return sink

    def _attach_stream(self, rs: RunState):
        if rs.model in wgl_models():
            stream = fsched.StreamingRun(rs.model, self.scheduler,
                                         rs.tenant, rs.run,
                                         initial=rs.initial)
        else:
            from ..gpu import elle as telle

            stream = telle.StreamingElle(rs.model, rs.tenant, rs.run)
        stream.ckpt_sink = self._make_ckpt_sink(rs)
        return stream

    # -- crash recovery --------------------------------------------------

    def recover(self) -> int:
        """Replays every WAL under the base dir; re-submits finished
        runs that never got their verdict written. Returns how many
        verdicts were re-scheduled."""
        n = 0
        for tenant, run, path in fwal.scan_runs(self.base):
            folded = fwal.replay(path)
            hello = folded["hello"] or {}
            model = hello.get("model", "cas-register")
            verdict = fwal.read_verdict(self.base, tenant, run)
            # complete runs are served from their verdict file: no
            # appends can ever happen, so no WAL fd is held (a long
            # base dir of past runs must not exhaust the fd table)
            wal = None if verdict is not None else fwal.RunWAL(path)
            rs = RunState(tenant, run, model, wal,
                          initial=hello.get("initial"))
            rs.last_seq = folded["last_seq"]
            base = folded["base"]
            cum = len(base["ops"]) if base else 0
            if base:
                rs.cum_ops[base["seq"]] = cum
            floor = base["seq"] if base else 0
            for seq in range(floor + 1, folded["last_seq"] + 1):
                cum += len(folded["chunks"][seq])
                rs.cum_ops[seq] = cum
            rs.n_ops = cum
            rs.fin = folded["fin"] is not None
            if not rs.fin and verdict is None and self.stream_checks \
                    and (model in wgl_models()
                         or model in elle_checks()):
                # mid-stream crash: resume the live stream from its
                # last checkpoint (digest-verified against the
                # replayed ops) instead of re-checking from entry 0;
                # a stale/torn/absent checkpoint falls back to full
                rs.stream = self._attach_stream(rs)
                kind = "stream-wgl" if model in wgl_models() \
                    else "elle"
                rs.stream.seed(
                    fwal.replay_ops(folded),
                    tckpt.load(tckpt.fleet_path(self.base, tenant,
                                                run), kind))
                rs.stream.step()
            if verdict is not None:
                rs.verdict = verdict
                # a recovered-from-file verdict still carries a
                # complete latency block — replay-annotated, every
                # slice honestly zero (its timings died with the
                # crashed process)
                if self.flightrec.enabled:
                    rs.latency = frec.replay_block()
                rs.verdict_ready.set()
            with self._lock:
                self._runs[(tenant, run)] = rs
            if rs.fin and verdict is None:
                ops = fwal.replay_ops(folded)
                self._submit_final(rs, ops, replay=True)
                n += 1
                with self._lock:
                    self._stats["recovered"] += 1
        if n:
            logger.info("fleet recovery: re-scheduled %d verdict(s)",
                        n)
        return n

    # -- stats / metrics -------------------------------------------------

    def _tstat_locked(self, tenant: str) -> dict:
        t = self._stats["tenants"].get(tenant)
        if t is None:
            t = self._stats["tenants"][tenant] = {
                "streams": 0, "chunks": 0, "ops": 0, "verdicts": 0,
                "rejected": 0}
        return t

    def stats(self) -> dict:
        with self._lock:
            out = {k: (dict(v) if isinstance(v, dict) else v)
                   for k, v in self._stats.items()}
            out["tenants"] = {t: dict(s)
                              for t, s in self._stats["tenants"].items()}
            out["runs"] = len(self._runs)
            out["active_streams"] = sum(self._active.values())
            streams = [(f"{t}/{r}", rs.stream)
                       for (t, r), rs in self._runs.items()]
        # snapshot first: a handler may null rs.stream concurrently
        streaming = {k: s.status() for k, s in streams
                     if s is not None}
        out["streams"] = streaming
        out["scheduler"] = self.scheduler.stats()
        out["flightrec"] = self.flightrec.snapshot()
        return out

    def prometheus_text(self) -> str:
        return prometheus_from_stats(self.stats())

    # -- accept / connection handling ------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _peer = self._sock.accept()
            except OSError:
                return  # closed
            threading.Thread(target=self._handle, args=(conn,),
                             name="fleet-conn", daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        conn.settimeout(60.0)
        with self._lock:
            self._conns.add(conn)
        rs: RunState | None = None
        streams_key = None
        try:
            wire.recv_magic(conn)
            while not self._stopping.is_set():
                msg = wire.recv_msg(conn)
                t = msg["type"]
                if t == "hello" and msg.get("observe"):
                    # an observer (a status client, a scraper): no
                    # admission, no run state, no WAL — just a live
                    # socket for status/claim-free queries
                    wire.send_msg(conn, {"type": "helloed",
                                         "last_seq": 0})
                elif t == "hello":
                    rs, streams_key = self._hello(conn, msg,
                                                  streams_key)
                    if rs is None:
                        return  # rejected (reply already sent)
                elif t == "status":
                    wire.send_msg(conn, {"type": "stats",
                                         "stats": self.stats()})
                elif rs is None:
                    wire.send_msg(conn, {"type": "error",
                                         "reason": "hello first"})
                    return
                elif t == "chunk":
                    self._chunk(conn, rs, msg)
                elif t == "fin":
                    self._fin(conn, rs, msg)
                elif t == "claim":
                    self._claim(conn, rs)
                else:
                    wire.send_msg(conn, {"type": "error",
                                         "reason": f"bad type {t!r}"})
                    return
        except wire.FrameError:
            # torn/corrupt frame or dead peer: the client's retry
            # layer resyncs from its acked seq on a fresh connection
            with self._lock:
                self._stats["frame_errors"] += 1
            telemetry.count("fleet.frame-errors")
        except Exception:  # noqa: BLE001 — one conn never kills the server
            logger.exception("fleet connection handler failed")
        finally:
            with self._lock:
                self._conns.discard(conn)
                if streams_key is not None:
                    n = self._active.get(streams_key, 0)
                    if n <= 1:
                        self._active.pop(streams_key, None)
                    else:
                        self._active[streams_key] = n - 1
            try:
                conn.close()
            except OSError:
                pass

    # -- message handlers ------------------------------------------------

    def _hello(self, conn, msg, prev_key):
        tenant = msg.get("tenant")
        run = msg.get("run")
        model = msg.get("model", "cas-register")
        initial = msg.get("initial")
        if initial is not None and not isinstance(
                initial, (int, float, str, bool)):
            wire.send_msg(conn, {"type": "reject",
                                 "reason": "initial must be a JSON "
                                           "scalar",
                                 "retry_after": None})
            return None, prev_key
        if not (fwal.safe_name(tenant) and fwal.safe_name(run)):
            wire.send_msg(conn, {"type": "reject",
                                 "reason": "bad tenant/run name",
                                 "retry_after": None})
            return None, prev_key
        if model not in wgl_models() and model not in elle_checks():
            wire.send_msg(conn, {"type": "reject",
                                 "reason": f"unknown model {model!r}",
                                 "retry_after": None})
            return None, prev_key
        key = (tenant, run)
        with self._lock:
            rs = self._runs.get(key)
            resuming = rs is not None
            if not resuming:
                # admission control: shed NEW streams only
                reason = self._admit_locked(tenant)
                if reason is not None:
                    self._stats["rejected"] += 1
                    self._tstat_locked(tenant)["rejected"] += 1
                    telemetry.count("fleet.rejected")
                    wire.send_msg(
                        conn, {"type": "reject", "reason": reason,
                               "retry_after":
                                   self.quotas.retry_after_s})
                    return None, prev_key
            if prev_key != key:
                if prev_key is not None:  # re-hello moved streams
                    n = self._active.get(prev_key, 0)
                    if n <= 1:
                        self._active.pop(prev_key, None)
                    else:
                        self._active[prev_key] = n - 1
                self._active[key] = self._active.get(key, 0) + 1
            self._stats["accepted"] += 1
            ts = self._tstat_locked(tenant)
            if not resuming:
                ts["streams"] += 1
        if rs is None:
            weight = msg.get("weight")
            with self._lock:
                # WAL creation + registration are ONE atomic step:
                # two racing first-hellos must not both see a fresh
                # file (each would append its own magic, corrupting
                # every later record) — only the registration winner
                # opens the WAL, so there is exactly one creator
                rs = self._runs.get(key)
                if rs is None:
                    wal = fwal.RunWAL(
                        fwal.wal_path(self.base, tenant, run))
                    rs = RunState(tenant, run, model, wal,
                                  initial=initial)
                    if self.stream_checks:
                        rs.stream = self._attach_stream(rs)
                    hello_rec = {"t": "hello", "tenant": tenant,
                                 "run": run, "model": model,
                                 "weight": weight or 1.0}
                    if initial is not None:
                        hello_rec["initial"] = initial
                    rs.wal.append(hello_rec)
                    self._runs[key] = rs
            if isinstance(weight, (int, float)) and weight > 0:
                self.scheduler.set_weight(tenant, weight)
        rs.touched = time.monotonic()
        reply = {"type": "helloed", "last_seq": rs.last_seq}
        if rs.verdict is not None:
            reply["verdict"] = rs.verdict
            if rs.latency is not None:
                reply["latency"] = rs.latency
        wire.send_msg(conn, reply)
        return rs, key

    def _admit_locked(self, tenant: str) -> str | None:
        """Reason to reject, or None to admit. Caller holds _lock.
        A tenant counts against the tenant quota while it has live
        connections or runs still awaiting their verdict — finished
        tenants age out, they don't squat the pool forever."""
        q = self.quotas
        now = time.monotonic()
        tenants = {t for (t, _r), n in self._active.items() if n} | \
            {t for (t, _r), rs in self._runs.items()
             if not rs.verdict_ready.is_set()
             and now - rs.touched < ABANDONED_S}
        total = sum(self._active.values())
        if tenant not in tenants and len(tenants) >= q.max_tenants:
            return (f"tenant quota saturated "
                    f"({q.max_tenants} tenants)")
        if total >= q.max_total_streams:
            return f"stream quota saturated ({total} streams)"
        per = sum(n for (t, _r), n in self._active.items()
                  if t == tenant)
        if per >= q.max_streams_per_tenant:
            return (f"per-tenant stream quota saturated "
                    f"({per} streams)")
        return None

    def _chunk(self, conn, rs: RunState, msg) -> None:
        t_recv = frec.now()
        seq = msg.get("seq")
        ops = msg.get("ops")
        if not isinstance(seq, int) or seq < 1 \
                or not isinstance(ops, list):
            wire.send_msg(conn, {"type": "error",
                                 "reason": "malformed chunk"})
            return
        with rs.lock:
            if rs.fin:
                wire.send_msg(conn, {"type": "error",
                                     "reason": "stream finished"})
                return
            if seq <= rs.last_seq:
                # duplicate (retransmit after a lost ack, or a chaos
                # duplicate): idempotent re-ack, no re-journal
                wire.send_msg(conn, {"type": "ack",
                                     "seq": rs.last_seq})
                return
            if seq > rs.last_seq + 1:
                # gap (reordered frame): don't journal out of order —
                # re-ack the resume point so the client rewinds
                wire.send_msg(conn, {"type": "ack",
                                     "seq": rs.last_seq,
                                     "resync": True})
                return
            if rs.n_ops + len(ops) > self.quotas.max_ops_per_run:
                wire.send_msg(
                    conn, {"type": "reject",
                           "reason": "run op quota exceeded",
                           "retry_after": None})
                return
            if rs.wal is None:
                # completed/retired run: nothing may append
                wire.send_msg(conn, {"type": "error",
                                     "reason": "stream finished"})
                return
            # WAL BEFORE ack: the ack promises durability
            w0 = frec.now()
            try:
                rs.wal.append({"t": "chunk", "seq": seq, "ops": ops})
            except OSError as e:
                # durability fault (ENOSPC/EIO, real or chaos): the
                # chunk was NOT journaled so it must NOT be acked —
                # shed it with retry-after and an honest degraded
                # stamp; the client re-sends from its acked seq once
                # the store recovers. The server never crashes and
                # never promises durability it doesn't have.
                telemetry.count("fleet.shed.wal")
                with self._lock:
                    self._stats["wal_sheds"] = \
                        self._stats.get("wal_sheds", 0) + 1
                wire.send_msg(
                    conn, {"type": "reject",
                           "reason": f"durability fault: {e}",
                           "degraded": True,
                           "retry_after": self.quotas.retry_after_s})
                return
            wal_ns = frec.now() - w0
            rs.wal_ns += wal_ns
            if rs.t_first is None:
                rs.t_first = t_recv
            rs.last_seq = seq
            rs.n_ops += len(ops)
            rs.cum_ops[seq] = rs.n_ops
            rs.touched = time.monotonic()
            if rs.stream is not None:
                # under rs.lock so a half-dead old handler racing a
                # reconnected one can't feed the stream out of order
                # (add_ops is cheap: the encode runs on the stream's
                # own worker thread, never on this ack path)
                try:
                    rs.stream.add_ops(wire.ops_from_wire(ops))
                except Exception:  # noqa: BLE001 — streaming is
                    logger.exception("streaming check failed")
                    rs.stream = None  # advisory; final check stays
        with self._lock:
            self._stats["chunks"] += 1
            self._stats["ops"] += len(ops)
            ts = self._tstat_locked(rs.tenant)
            ts["chunks"] += 1
            ts["ops"] += len(ops)
        telemetry.count("fleet.chunks")
        wire.send_msg(conn, {"type": "ack", "seq": seq})
        # the span closes at the ack — the durability promise's wall
        # clock. Only JOURNALED chunks reach here: dup re-acks and
        # resync acks above return early, so chaos duplication can
        # never double-count a span.
        tc = msg.get("tc") if isinstance(msg.get("tc"), dict) else {}
        self.flightrec.chunk(
            rs.tenant, rs.run, seq, t_recv, frec.now(), wal_ns,
            len(ops), client_t=tc.get("t"), trace=tc.get("trace"))

    def _fin(self, conn, rs: RunState, msg) -> None:
        with rs.lock:
            chunks = msg.get("chunks")
            if isinstance(chunks, int) and chunks != rs.last_seq:
                # the client believes it sent more than we journaled:
                # NOT a completed stream — make it rewind and re-send
                wire.send_msg(conn, {"type": "ack",
                                     "seq": rs.last_seq,
                                     "resync": True})
                return
            first_fin = not rs.fin and rs.wal is not None
            if first_fin:
                w0 = frec.now()
                try:
                    rs.wal.append({"t": "fin",
                                   "chunks": rs.last_seq})
                except OSError as e:
                    # an un-journaled fin must not produce a verdict
                    # a restarted server wouldn't reproduce: shed
                    telemetry.count("fleet.shed.wal")
                    with self._lock:
                        self._stats["wal_sheds"] = \
                            self._stats.get("wal_sheds", 0) + 1
                    wire.send_msg(
                        conn, {"type": "reject",
                               "reason": f"durability fault: {e}",
                               "degraded": True,
                               "retry_after":
                                   self.quotas.retry_after_s})
                    return
                rs.wal_ns += frec.now() - w0
                rs.t_fin = frec.now()
                rs.fin = True
        if first_fin:
            folded = fwal.replay(fwal.wal_path(self.base, rs.tenant,
                                               rs.run))
            self._submit_final(rs, fwal.replay_ops(folded))
        self._claim(conn, rs)

    def _submit_final(self, rs: RunState, ops: list,
                      replay: bool = False) -> None:
        engine = "wgl" if rs.model in wgl_models() else "elle"
        item = self.scheduler.submit(
            "final", rs.tenant, rs.run,
            {"engine": engine, "model": rs.model,
             "initial": rs.initial, "history": History(ops)})
        threading.Thread(target=self._await_verdict,
                         args=(rs, item, replay),
                         name=f"fleet-verdict-{rs.tenant}-{rs.run}",
                         daemon=True).start()

    def _latency_block(self, rs: RunState, item, serialize_ms: float,
                       replay: bool) -> dict:
        """The per-verdict critical-path decomposition from the run's
        ingest stamps and the item's scheduler stamp sheet. Replayed
        runs (recover()) lost their ingest timings with the crash —
        their slices are zero and the block says so."""
        tm = item.times
        ingest = _wal = 0.0
        if not replay:
            with rs.lock:
                if rs.t_first is not None and rs.t_fin is not None:
                    ingest = (rs.t_fin - rs.t_first) / 1e6
                _wal = rs.wal_ns / 1e6
        queue = batching = 0.0
        if "drain" in tm:
            queue = (tm["drain"] - tm["submit"]) / 1e6
        if "launch0" in tm and "drain" in tm:
            batching = (tm["launch0"] - tm["drain"]) / 1e6
        return frec.latency_block(
            ingest_wait_ms=ingest, wal_fsync_ms=_wal,
            queue_wait_ms=queue, batching_delay_ms=batching,
            encode_ms=tm.get("encode_ms", 0.0),
            device_ms=tm.get("device_ms", 0.0),
            certify_ms=tm.get("certify_ms", 0.0),
            serialize_ms=serialize_ms, replay=replay)

    def _await_verdict(self, rs: RunState, item,
                       replay: bool = False) -> None:
        item.done.wait(timeout=VERDICT_TIMEOUT_S)
        result = item.result if item.done.is_set() else \
            {"valid?": "unknown", "error": "fleet verdict timeout"}
        # NOTE: nothing timing-dependent goes in here — the verdict
        # file must replay byte-identical after a crash (the latency
        # block below rides NEXT to the verdict on the wire and in
        # stats, never inside these bytes; streaming status likewise)
        verdict = {"tenant": rs.tenant, "run": rs.run,
                   "model": rs.model, "n_ops": rs.n_ops,
                   "result": fwal.json_safe(result)}
        s0 = frec.now()
        try:
            fwal.write_verdict(self.base, rs.tenant, rs.run, verdict)
        except OSError:
            logger.exception("writing verdict file failed")
        serialize_ms = (frec.now() - s0) / 1e6
        # a disabled recorder means NO latency accounting anywhere —
        # the wire envelope matches a pre-flightrec server's exactly
        latency = self._latency_block(rs, item, serialize_ms, replay) \
            if self.flightrec.enabled else None
        with rs.lock:
            rs.verdict = verdict
            rs.latency = latency
        # all accounting lands BEFORE verdict_ready fires: a client
        # whose finish() returns must already see the verdict in
        # stats()/prometheus and in the recorder's SLO histograms
        with self._lock:
            self._stats["verdicts"] += 1
            self._tstat_locked(rs.tenant)["verdicts"] += 1
        telemetry.count("fleet.verdicts")
        # SLO clock: fin -> verdict ready (a replayed run's fin died
        # with the crash; its re-submit time is the honest start)
        t0 = rs.t_fin if rs.t_fin is not None \
            else item.times["submit"]
        self.flightrec.verdict(rs.tenant, rs.run, t0, frec.now(),
                               latency)
        # the snapshot also lands before verdict_ready: a client that
        # kills the server the instant finish() returns still finds
        # this verdict's SLO history on disk for the successor to fold
        try:
            self.flightrec.save(self.base / frec.SNAPSHOT_FILE)
        except OSError:  # pragma: no cover — accounting is advisory
            logger.exception("flightrec snapshot failed")
        rs.verdict_ready.set()
        rs.retire_wal()  # the run can never append again
        # post-verdict compaction: the historical journal folds to
        # hello + one base + fin. Replay stays byte-identical (the
        # crash-replay tests pin this); a fault here costs disk, not
        # correctness.
        try:
            fwal.compact(fwal.wal_path(self.base, rs.tenant, rs.run),
                         rs.last_seq)
        except OSError:  # pragma: no cover — compaction is advisory
            logger.exception("post-verdict WAL compaction failed")

    def _claim(self, conn, rs: RunState) -> None:
        deadline = time.monotonic() + VERDICT_TIMEOUT_S
        while time.monotonic() < deadline \
                and not self._stopping.is_set():
            if rs.verdict_ready.wait(timeout=1.0):
                reply = {"type": "verdict", "result": rs.verdict}
                if rs.latency is not None:
                    reply["latency"] = rs.latency
                wire.send_msg(conn, reply)
                return
        wire.send_msg(conn, {"type": "error",
                             "reason": "verdict not ready"})
