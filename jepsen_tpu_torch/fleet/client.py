"""The fleet client: streams a run's history chunks to the service
mid-run, survives transport chaos, and falls back to local checking
(the port's copy of jepsen_tpu/fleet/client.py).

Retry discipline is the control plane's (control/retry.py): transport
failures reconnect with DECORRELATED JITTER (a fleet of clients
hammering a restarting server must not arrive in waves) and spend a
per-stream RetryBudget — a genuinely dead fleet stops costing the run
anything beyond the budget, and the client honestly reports
`fallen_back` so the caller keeps its local checking authoritative.

Idempotence: chunks carry sequence numbers; the server acks a chunk
only after journaling it, duplicates re-ack without re-journaling, and
the hello handshake returns the server's resume point, so a client can
crash-reconnect-resend forever without the journaled stream ever
diverging. The client keeps its sent chunks until acked+resynced (op
payloads are already in the run's memory; the fleet copy is bounded by
the same run).

`transport` is injectable — chaos.ChaosFleetTransport wraps it to
drop/duplicate/reorder/truncate frames with seeded probabilities.
"""

from __future__ import annotations

import logging
import socket
import threading
import time

from .. import telemetry, tracing
from ..control.retry import RetryBudget, decorrelated_jitter
from ..monitor import LogHistogram
from . import flightrec as frec
from . import wire

logger = logging.getLogger(__name__)

CONNECT_TIMEOUT_S = 5.0
IO_TIMEOUT_S = 15.0
DEFAULT_CHUNK_OPS = 64
RETRIES_PER_OP = 5


class FleetError(Exception):
    """The fleet is unusable for this stream (budget exhausted,
    rejected without retry-after, protocol violation)."""


class FleetRejected(FleetError):
    """Admission control said no. retry_after is the server's backoff
    hint (None = don't retry: the request itself was invalid)."""

    def __init__(self, reason: str, retry_after):
        super().__init__(reason)
        self.reason = reason
        self.retry_after = retry_after


class Transport:
    """The frame I/O seam. The default sends/receives wire frames
    verbatim; chaos wraps this interface."""

    def send(self, sock, msg: dict) -> None:
        wire.send_msg(sock, msg)

    def recv(self, sock) -> dict:
        return wire.recv_msg(sock)


class FleetClient:
    """One (tenant, run) stream. NOT thread-safe: the run's streamer
    owns it from one thread (the interpreter hook uses a dedicated
    flusher thread)."""

    def __init__(self, addr, tenant: str, run: str,
                 model: str = "cas-register", initial=None,
                 weight: float = 1.0,
                 transport: Transport | None = None,
                 budget: RetryBudget | None = None,
                 io_timeout_s: float = IO_TIMEOUT_S,
                 observe: bool = False,
                 connect_timeout_s: float = CONNECT_TIMEOUT_S):
        if isinstance(addr, str):
            host, _, port = addr.rpartition(":")
            addr = (host or "127.0.0.1", int(port))
        self.addr = tuple(addr)
        self.tenant = tenant
        self.run = run
        self.model = model
        self.initial = initial  # register-family starting value
        self.weight = weight
        self.transport = transport if transport is not None \
            else Transport()
        self.budget = budget if budget is not None else RetryBudget()
        self.io_timeout_s = io_timeout_s
        self.observe = observe  # status-only: no run state, no WAL
        self.connect_timeout_s = connect_timeout_s
        self._sock: socket.socket | None = None
        self._chunks: list[list[dict]] = []  # payloads by seq-1
        self._acked = 0
        self._pending_failed = False  # last send_chunk raised
        self._claim_only = False      # claim(): resume is expected
        self.last_verdict: dict | None = None
        # client-observed ack latency (send -> journaled ack), the
        # tenant's half of the fleet SLO story; rides into
        # results['fleet'] via FleetStreamer.result_summary
        self.ack_ms = LogHistogram()
        self.last_latency: dict | None = None  # server's block

    # -- connection ------------------------------------------------------

    def _connect(self) -> None:
        self._disconnect()
        s = socket.create_connection(self.addr,
                                     timeout=self.connect_timeout_s)
        s.settimeout(self.io_timeout_s)
        try:
            wire.send_magic(s)
            hello = {"type": "hello", "tenant": self.tenant,
                     "run": self.run, "model": self.model,
                     "weight": self.weight}
            if self.initial is not None:
                hello["initial"] = self.initial
            if self.observe:
                hello["observe"] = True
            self.transport.send(s, hello)
            reply = self.transport.recv(s)
        except wire.FrameError:
            try:
                s.close()
            except OSError:
                pass
            raise
        if reply["type"] == "reject":
            try:
                s.close()
            except OSError:
                pass
            telemetry.count("fleet.client.rejected")
            raise FleetRejected(reply.get("reason", "rejected"),
                                reply.get("retry_after"))
        if reply["type"] != "helloed":
            try:
                s.close()
            except OSError:
                pass
            raise FleetError(f"unexpected hello reply {reply!r}")
        self._sock = s
        # the server's resume point: everything at or below is
        # durable. It can never exceed what THIS client sent — more
        # journaled chunks mean the run name collides with an older
        # stream, and silently treating its journal as our acks would
        # return a verdict computed on someone else's data.
        srv_seq = int(reply.get("last_seq", 0))
        if isinstance(reply.get("verdict"), dict) \
                and isinstance(reply.get("latency"), dict):
            self.last_latency = reply["latency"]
        if not self.observe and not self._claim_only \
                and srv_seq > len(self._chunks):
            self._disconnect()
            raise FleetError(
                f"run {self.run!r} already has {srv_seq} journaled "
                f"chunk(s) on the server (we sent "
                f"{len(self._chunks)}): stale or colliding run name "
                "— pick a fresh one, or use claim() to fetch the "
                "existing verdict")
        self._acked = srv_seq
        if isinstance(reply.get("verdict"), dict):
            self.last_verdict = reply["verdict"]

    def _disconnect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _with_retry(self, f):
        """Runs f() against a live connection, reconnecting + resyncing
        on transport failure with decorrelated jitter, bounded by the
        stream's RetryBudget. FleetRejected propagates — admission
        rejections are decisions, not failures."""
        tries = RETRIES_PER_OP
        sleep_s = 0.0
        while True:
            try:
                if self._sock is None:
                    self._connect()
                return f()
            except (wire.FrameError, OSError, socket.timeout) as e:
                self._disconnect()
                tries -= 1
                if tries <= 0 or not self.budget.try_spend():
                    telemetry.count("fleet.client.gave-up")
                    raise FleetError(
                        f"fleet unreachable: {e}") from e
                telemetry.count("fleet.client.retries")
                sleep_s = decorrelated_jitter(sleep_s or 0.05,
                                              base_s=0.05, cap_s=1.0)
                time.sleep(sleep_s)

    # -- the stream ------------------------------------------------------

    def send_chunk(self, ops) -> int:
        """Frames `ops` as the next chunk and drives the stream until
        the server has ACKED (journaled) it. Returns the chunk's seq.

        Retry-safe: a failed send leaves the chunk staged (the server
        may already have journaled it — only its seq can dedup it), so
        a caller retrying the SAME ops resumes that chunk instead of
        double-journaling it under a new seq."""
        payload = wire.ops_to_wire(ops)
        if self._pending_failed and self._chunks \
                and self._chunks[-1] == payload:
            self._pending_failed = False  # the caller's retry
        else:
            self._chunks.append(payload)
            self._pending_failed = False
        seq = len(self._chunks)
        try:
            self._with_retry(lambda: self._drive_to(seq))
        except FleetError:
            self._pending_failed = True
            raise
        self.budget.refund()  # the fleet answered: it is alive
        return seq

    def _tc(self) -> dict:
        """The flight-recorder trace context minted per frame: the
        send stamp on the cross-process monotonic clock, plus the
        caller's optrace span ids when it is inside one — the link
        that joins server-side flight-recorder spans back to the
        run's own trace (wire.py documents the field)."""
        tc = {"t": frec.now()}
        ctx = tracing.current_context()
        if ctx:
            tc.update(ctx)
        return tc

    def _drive_to(self, seq: int) -> None:
        """Sends chunks (self._acked, seq] and consumes acks until the
        server's journal covers seq, rewinding on resync acks."""
        while self._acked < seq:
            nxt = self._acked + 1
            tc = self._tc()
            self.transport.send(self._sock, {
                "type": "chunk", "seq": nxt,
                "ops": self._chunks[nxt - 1], "tc": tc})
            reply = self.transport.recv(self._sock)
            t = reply.get("type")
            if t == "ack":
                acked = int(reply.get("seq", 0))
                if acked >= nxt:
                    # a real advance (not a resync rewind): the
                    # durability promise's round trip, client-side
                    self.ack_ms.add((frec.now() - tc["t"]) / 1e6)
                # a resync ack rewinds; a normal ack advances. Either
                # way the server's number is the truth.
                self._acked = min(max(acked, 0), len(self._chunks))
            elif t == "reject":
                raise FleetRejected(reply.get("reason", "rejected"),
                                    reply.get("retry_after"))
            else:
                raise wire.FrameError(f"unexpected reply {reply!r}")

    def finish(self, timeout_s: float = 120.0) -> dict:
        """Completes the stream and returns the run's verdict (with
        certificate). Reconnect-safe: a lost verdict reply is
        re-claimed on a fresh connection."""
        deadline = time.monotonic() + timeout_s

        def once():
            self._drive_to(len(self._chunks))
            self.transport.send(self._sock, {
                "type": "fin", "chunks": len(self._chunks),
                "tc": self._tc()})
            reply = self.transport.recv(self._sock)
            if reply.get("type") == "ack" and reply.get("resync"):
                raise wire.FrameError("fin resync")  # rewind + retry
            if reply.get("type") != "verdict":
                raise wire.FrameError(
                    f"unexpected fin reply {reply!r}")
            if isinstance(reply.get("latency"), dict):
                self.last_latency = reply["latency"]
            return reply["result"]

        while True:
            try:
                v = self._with_latency(self._with_retry(once))
                self.last_verdict = v
                self.budget.refund()
                return v
            except FleetRejected as e:
                # an admission DECISION: retry only when the server
                # says so (retry_after None = permanently invalid)
                if e.retry_after is None \
                        or time.monotonic() >= deadline:
                    raise
                time.sleep(min(float(e.retry_after),
                               max(deadline - time.monotonic(), 0)))
            except FleetError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)

    def claim(self) -> dict:
        """Fetches (waiting if needed) an already-streamed run's
        verdict without re-driving the stream — the recovery/CLI path:
        a fresh client can claim what a crashed one streamed (the
        one legitimate case where the server knows MORE chunks than
        this client ever sent)."""

        def once():
            self.transport.send(self._sock, {"type": "claim"})
            reply = self.transport.recv(self._sock)
            if reply.get("type") != "verdict":
                raise wire.FrameError(
                    f"unexpected claim reply {reply!r}")
            if isinstance(reply.get("latency"), dict):
                self.last_latency = reply["latency"]
            return reply["result"]

        self._claim_only = True
        try:
            v = self._with_latency(self._with_retry(once))
        finally:
            self._claim_only = False
        self.last_verdict = v
        return v

    def _with_latency(self, v):
        """Attaches the verdict's latency block (flightrec critical-
        path decomposition, ridden next to the verdict on the wire)
        onto a COPY of the returned env — the server's verdict dict
        itself stays exactly the verdict file's content."""
        if isinstance(v, dict) and "latency" not in v \
                and isinstance(self.last_latency, dict):
            v = dict(v)
            v["latency"] = self.last_latency
        return v

    def status(self) -> dict:
        return self._with_retry(self._status_once)

    def _status_once(self) -> dict:
        self.transport.send(self._sock, {"type": "status"})
        reply = self.transport.recv(self._sock)
        if reply.get("type") != "stats":
            raise wire.FrameError(f"unexpected reply {reply!r}")
        return reply["stats"]

    def close(self) -> None:
        self._disconnect()


# ---------------------------------------------------------------------------
# The interpreter hook: mirror a live run's history into the fleet
# ---------------------------------------------------------------------------

class FleetStreamer:
    """Wraps the run's history writer: every journaled op ALSO streams
    to the fleet in chunks, from a background flusher thread so the
    interpreter's hot loop never blocks on the network. If the fleet
    becomes unreachable (budget exhausted) the streamer falls back —
    the local run continues untouched and the results carry an honest
    `unavailable` marker instead of a verdict. Local checking stays
    authoritative either way; the fleet verdict (and its certificate)
    rides NEXT to it as results['fleet']."""

    _guarded_by_lock = {"_lock": ("_buf", "_fallen")}

    def __init__(self, inner, client: FleetClient,
                 chunk_ops: int = DEFAULT_CHUNK_OPS,
                 flush_s: float = 0.25):
        self.inner = inner
        self.client = client
        self.chunk_ops = chunk_ops
        self.flush_s = flush_s
        self._lock = threading.Lock()
        self._buf: list = []
        self._fallen: str | None = None
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._flusher,
                                        name="fleet-streamer",
                                        daemon=True)
        self._started = False

    # the history-writer interface (interpreter.run)
    def append(self, op) -> None:
        self.inner.append(op)
        if self._fallen is not None:
            return
        if not self._started:
            self._started = True
            self._thread.start()
        with self._lock:
            self._buf.append(op)

    def close(self) -> None:
        self._closed.set()
        if self._started:
            self._thread.join(timeout=30)
        self.inner.close()

    def read_back(self):
        return self.inner.read_back()

    # -- flusher ---------------------------------------------------------

    # upper bound on ops per wire chunk: a backlog accumulated while
    # the flusher was stuck reconnecting must drain as several frames,
    # not one frame that trips wire.MAX_FRAME and kills the stream
    MAX_TAKE = 8192

    def _take(self, everything: bool = False) -> list:
        with self._lock:
            if not self._buf:
                return []
            if everything or len(self._buf) >= self.chunk_ops:
                out = self._buf[:self.MAX_TAKE]
                self._buf = self._buf[self.MAX_TAKE:]
                return out
            return []

    def _flusher(self) -> None:
        while not self._closed.wait(timeout=self.flush_s):
            self._flush_some(False)
        self._flush_some(True)  # the tail rides out at close

    def _flush_some(self, everything: bool) -> None:
        while True:
            ops = self._take(everything)
            if not ops or self._fallen is not None:
                return
            try:
                self.client.send_chunk(ops)
            except Exception as e:  # noqa: BLE001 — the stream is
                # advisory: ANY failure falls back to local checking
                with self._lock:
                    self._fallen = str(e)[:200]
                telemetry.count("fleet.client.fallback")
                logger.warning("fleet unreachable; falling back to "
                               "local checking: %s", e)
                return
            if len(ops) < self.MAX_TAKE:
                return  # backlog drained

    @property
    def fallen_back(self) -> str | None:
        with self._lock:
            return self._fallen

    def result_summary(self, timeout_s: float = 60.0) -> dict:
        """The results['fleet'] block: the fleet's verdict or an
        honest unavailability marker."""
        if self.fallen_back is not None:
            self.client.close()
            return {"unavailable": self.fallen_back}
        try:
            v = self.client.finish(timeout_s=timeout_s)
            out = {"verdict": v, "addr": list(self.client.addr),
                   "tenant": self.client.tenant}
            h = self.client.ack_ms
            if h.n:  # the client's own view of the durability SLO
                out["ack_ms"] = {"n": h.n,
                                 "p50": round(h.quantile(0.5), 3),
                                 "p99": round(h.quantile(0.99), 3)}
            return out
        except Exception as e:  # noqa: BLE001 — honest absence
            return {"unavailable": str(e)[:200]}
        finally:
            self.client.close()  # one socket per run, never leaked


class NoStream:
    """The honest stand-in when fleet streaming was REQUESTED but
    could not be attached (no history writer, attach crash): the run
    still gets results['fleet'] = {'unavailable': reason} instead of
    silently missing the key."""

    def __init__(self, reason: str):
        self.reason = reason

    def result_summary(self, timeout_s: float = 0.0) -> dict:
        return {"unavailable": self.reason}


def attach(test: dict):
    """Builds the interpreter hook from test['fleet'] (a dict: addr,
    tenant, model?, run?, weight?, chunk_ops?) and wraps the test's
    history writer. Returns (writer, streamer)."""
    from . import wal as fwal

    cfg = dict(test.get("fleet") or {})
    inner = test.get("history_writer")
    assert inner is not None, "fleet streaming needs a history writer"
    run = str(cfg.get("run") or test.get("name", "run"))
    if not fwal.safe_name(run):  # run names come from test names
        run = "".join(c if c.isalnum() or c in "._-" else "-"
                      for c in run)[:128] or "run"
    client = FleetClient(
        cfg["addr"], cfg.get("tenant", "local"), run,
        model=cfg.get("model", "cas-register"),
        initial=cfg.get("initial"),
        weight=float(cfg.get("weight", 1.0)))
    streamer = FleetStreamer(inner, client,
                             chunk_ops=int(cfg.get("chunk_ops",
                                                   DEFAULT_CHUNK_OPS)))
    return streamer, streamer
