"""Per-node health: transport-failure circuit breakers + quarantine
(the port's copy of jepsen_tpu/control/health.py).

A node that dies mid-run used to make every op against it burn the full
reconnect-retry budget (seconds each), and a run whose DB teardown hit
the dead node aborted entirely. This layer gives the control plane the
standard remedy: a circuit breaker per node.

  - CLOSED:    commands flow; consecutive transport failures count up.
  - OPEN:      after `threshold` consecutive transport failures the
               node is quarantined — commands fail IMMEDIATELY with
               TransportError("quarantined"), so client ops crash to
               :info in microseconds instead of stalling workers, and
               the run continues :degraded instead of aborting
               (core.analyze stamps results["degraded"]).
  - HALF-OPEN: after `cooldown_s` one probe command is let through; a
               success closes the circuit (the node healed — maybe the
               nemesis restarted it), a failure re-opens it.

Opt in with test["quarantine?"] = True (core.run builds the registry
and control.remote_for wraps the test's remote). The breaker counts
ONLY TransportError — a command's own non-zero exit means the node is
alive and talking. See doc/robustness.md.
"""

from __future__ import annotations

import logging
import threading
import time as _time

from .. import telemetry
from .core import Action, Remote, Session, TransportError

logger = logging.getLogger(__name__)

DEFAULT_THRESHOLD = 3
DEFAULT_COOLDOWN_S = 10.0


class Quarantined(TransportError):
    """The node's circuit is open: the command was rejected without
    touching the transport. A TransportError subclass so every
    existing crash-to-:info / retry-classification path treats it as
    the node being unreachable (which it is, just cheaply)."""


class CircuitBreaker:
    """One node's breaker. Thread-safe: many workers share a node."""

    def __init__(self, node, threshold: int = DEFAULT_THRESHOLD,
                 cooldown_s: float = DEFAULT_COOLDOWN_S):
        self.node = node
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._failures = 0          # consecutive transport failures
        self._open_since: float | None = None
        self._probing = False
        self.opened_count = 0       # times the circuit opened (stats)

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._open_since is not None

    def state(self) -> str:
        """'closed', 'open', or 'half-open' (cooldown elapsed: the
        next command probes, or one already is) — what the node
        plane's breaker records surface (nodeprobe.py)."""
        with self._lock:
            if self._open_since is None:
                return "closed"
            if (self._probing
                    or _time.monotonic() - self._open_since
                    >= self.cooldown_s):
                return "half-open"
            return "open"

    def admit(self) -> bool:
        """May a command proceed? False = quarantined (fail fast).
        In the half-open window exactly one caller is admitted as the
        probe; the rest keep failing fast until it reports back."""
        with self._lock:
            if self._open_since is None:
                return True
            if (not self._probing
                    and _time.monotonic() - self._open_since
                    >= self.cooldown_s):
                self._probing = True  # this caller probes
                granted = True
            else:
                granted = False
        if granted:
            # the open -> half-open transition, next to the opened/
            # healed counters (state transitions as telemetry)
            telemetry.count("control.quarantine.half-open")
        return granted

    def success(self) -> None:
        with self._lock:
            was_open = self._open_since is not None
            self._failures = 0
            self._open_since = None
            self._probing = False
        if was_open:
            telemetry.count("control.quarantine.healed")
            logger.info("node %s healed; circuit closed", self.node)

    def abort_probe(self) -> None:
        """The admitted call died for a NON-transport reason (local
        OSError, a bug in the caller): no verdict on the node, but the
        probe slot must free or a half-open circuit wedges forever."""
        with self._lock:
            self._probing = False

    def failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            just_opened = (self._open_since is None
                           and self._failures >= self.threshold)
            if just_opened:
                self._open_since = _time.monotonic()
                self.opened_count += 1
            elif self._open_since is not None:
                self._open_since = _time.monotonic()  # re-arm cooldown
        if just_opened:
            telemetry.count("control.quarantine.opened")
            logger.warning(
                "node %s quarantined after %d consecutive transport "
                "failures; its ops will fail fast (run continues "
                ":degraded)", self.node, self._failures)


class HealthRegistry:
    """The per-test map node -> CircuitBreaker, shared by every session
    to that node (test["health"])."""

    def __init__(self, threshold: int = DEFAULT_THRESHOLD,
                 cooldown_s: float = DEFAULT_COOLDOWN_S):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._breakers: dict = {}
        self._advisories: dict = {}

    @classmethod
    def from_test(cls, test: dict) -> "HealthRegistry":
        q = test.get("quarantine?")
        opts = q if isinstance(q, dict) else {}
        return cls(threshold=int(opts.get("threshold",
                                          DEFAULT_THRESHOLD)),
                   cooldown_s=float(opts.get("cooldown_s",
                                             DEFAULT_COOLDOWN_S)))

    def breaker(self, node) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(node)
            if b is None:
                b = self._breakers[node] = CircuitBreaker(
                    node, self.threshold, self.cooldown_s)
            return b

    def states(self) -> dict:
        """{node: breaker state} for every node a breaker exists for —
        the view the node plane records as `breaker` transitions."""
        with self._lock:
            breakers = list(self._breakers.values())
        return {b.node: b.state() for b in breakers}

    def advise(self, node, reason: str, value=None) -> None:
        """An ADVISORY health signal from the node observability plane
        (nodeprobe.py: low memory, cpu saturation). Logged and
        counted, never a breaker verdict — a loaded node is not a dead
        node, and metrics must not trip circuits (transport failures
        alone do that)."""
        with self._lock:
            self._advisories.setdefault(node, {})[str(reason)] = value
        telemetry.count("control.health.advisories")
        telemetry.count(f"control.health.advisory.{reason}")
        logger.warning("node %s health advisory: %s (%r) — advisory "
                       "only, circuit unaffected", node, reason, value)

    def advisories(self) -> dict:
        """{node: {reason: last value}} of advisories received."""
        with self._lock:
            return {n: dict(v) for n, v in self._advisories.items()}

    def quarantined(self) -> list:
        """Nodes whose circuit is currently open."""
        with self._lock:
            breakers = list(self._breakers.values())
        return [b.node for b in breakers if b.is_open]

    def ever_quarantined(self) -> list:
        """Nodes that were quarantined at any point in the run — the
        :degraded marker wants the full story even if a node later
        healed."""
        with self._lock:
            breakers = list(self._breakers.values())
        return [b.node for b in breakers if b.opened_count > 0]


class GuardedSession(Session):
    """A session gated by its node's circuit breaker."""

    def __init__(self, inner: Session, breaker: CircuitBreaker):
        self.inner = inner
        self.breaker = breaker

    def _guarded(self, f):
        if not self.breaker.admit():
            telemetry.count("control.quarantine.rejected")
            raise Quarantined(
                "node is quarantined (circuit open)",
                node=self.breaker.node)
        try:
            res = f()
        except TransportError:
            self.breaker.failure()
            raise
        except BaseException:
            self.breaker.abort_probe()  # no verdict; free the slot
            raise
        self.breaker.success()
        return res

    def execute(self, action: Action):
        return self._guarded(lambda: self.inner.execute(action))

    def upload(self, local_paths, remote_path):
        return self._guarded(
            lambda: self.inner.upload(local_paths, remote_path))

    def download(self, remote_paths, local_path):
        return self._guarded(
            lambda: self.inner.download(remote_paths, local_path))

    def disconnect(self) -> None:
        self.inner.disconnect()


class GuardedRemote(Remote):
    """Wraps another Remote so every session shares the test's health
    registry. Sits OUTSIDE the retry wrapper in the default stack: a
    command first burns its (budgeted) retries, and only the final
    transport verdict feeds the breaker — transient one-retry blips
    don't open circuits."""

    def __init__(self, remote: Remote, registry: HealthRegistry):
        self.remote = remote
        self.registry = registry

    def connect(self, conn_spec: dict) -> Session:
        breaker = self.registry.breaker(conn_spec.get("host"))
        if not breaker.admit():
            telemetry.count("control.quarantine.rejected")
            raise Quarantined("node is quarantined (circuit open)",
                              node=breaker.node)
        try:
            inner = self.remote.connect(conn_spec)
        except TransportError:
            breaker.failure()
            raise
        except BaseException:
            breaker.abort_probe()  # no verdict; free the slot
            raise
        # a returned session is NOT a success verdict: the default
        # stack's RetryingRemote.connect just constructs lazily (no
        # network I/O), so crediting it would reset the failure count
        # before every command and the circuit would never open. The
        # first command's real transport outcome decides.
        breaker.abort_probe()
        return GuardedSession(inner, breaker)


class LazyConnectSession(Session):
    """Placeholder for a node whose session could not open (dead at
    run start, or died and was disconnected): every use retries the
    connect through the guarded stack, so a healed node springs back
    and a dead one fails fast once its circuit opens. This is what
    lets control.open_sessions keep a run alive when a node is down —
    the node's ops crash to :info instead of the whole run aborting."""

    def __init__(self, remote: Remote, conn_spec: dict):
        self.remote = remote
        self.conn_spec = conn_spec
        self._lock = threading.Lock()
        self._inner: Session | None = None

    def _sess(self) -> Session:
        with self._lock:
            if self._inner is None:
                self._inner = self.remote.connect(self.conn_spec)
            return self._inner

    def _drop(self) -> None:
        with self._lock:
            inner, self._inner = self._inner, None
        if inner is not None:
            try:
                inner.disconnect()
            except Exception:  # noqa: BLE001 — already failing
                pass

    def _via(self, f):
        try:
            return f(self._sess())
        except TransportError:
            self._drop()  # reconnect on the next use
            raise

    def execute(self, action: Action):
        return self._via(lambda s: s.execute(action))

    def upload(self, local_paths, remote_path):
        return self._via(lambda s: s.upload(local_paths, remote_path))

    def download(self, remote_paths, local_path):
        return self._via(lambda s: s.download(remote_paths, local_path))

    def disconnect(self) -> None:
        self._drop()


def probe(test: dict, node) -> bool:
    """One cheap liveness command against `node` through the guarded
    stack; True = the node answered (and the breaker saw a success).
    Used by explicit health sweeps and tests."""
    from . import with_session

    try:
        with with_session(test, node) as sess:
            sess.execute(Action(cmd="true", timeout=10.0))
        return True
    except TransportError:
        return False


def probe_all(test: dict) -> dict:
    """{node: alive?} across the test's nodes, in parallel."""
    from .. import util
    from . import on_nodes  # noqa: F401 — doc pointer

    nodes = list(test.get("nodes") or [])
    return dict(zip(nodes, util.real_pmap(
        lambda n: probe(test, n), nodes)))
