"""Auto-reconnecting, retrying wrapper around any Remote (the port's
copy of jepsen_tpu/control/retry.py).

Capability reference: jepsen/src/jepsen/control/retry.clj:35-72 — SSH
client stacks fail spuriously; their commands can almost always be
retried. The wrapper keeps the underlying session in a reconnect
wrapper (reconnect.py) and retries TRANSPORT failures (the
analog of the reference's ::ssh-failed — never a command's own
non-zero exit, which comes back as a Result) with decorrelated-jitter
backoff, cycling the session between attempts.

Two safeguards against retry storms:

  - *Decorrelated jitter* (the AWS architecture-blog algorithm): each
    sleep is uniform(BACKOFF_S, 3 * previous_sleep), capped. A fixed
    backoff synchronizes every worker's reconnect attempts against a
    recovering node into thundering-herd waves; decorrelation spreads
    them.
  - *Per-session retry budget*: a session may spend at most
    SESSION_RETRY_BUDGET retries between successes (a successful
    command refunds the budget — the node answered). A genuinely dead
    node otherwise costs every command its full per-command retry
    count forever; once the budget is gone, transport failures
    propagate immediately (and the quarantine breaker, when enabled,
    starts rejecting in microseconds).
"""

from __future__ import annotations

import random
import threading
import time

from .. import reconnect, telemetry, tracing
from .core import Action, Remote, Result, Session, TransportError

RETRIES = 5
BACKOFF_S = 0.1
BACKOFF_CAP_S = 3.0
SESSION_RETRY_BUDGET = 64


class RetryBudget:
    """Thread-safe retry allowance shared by all commands on one
    session."""

    def __init__(self, limit: int = SESSION_RETRY_BUDGET):
        self.limit = limit
        self._lock = threading.Lock()
        self._spent = 0

    def try_spend(self) -> bool:
        """Takes one retry from the budget; False = exhausted (the
        caller must give up instead of sleeping + retrying)."""
        with self._lock:
            if self._spent >= self.limit:
                return False
            self._spent += 1
            return True

    def refund(self) -> None:
        """A command SUCCEEDED: the node is alive, so spent retries
        replenish. Without this, routine nemesis partition windows in
        a multi-hour run drain the lifetime budget and late-run
        transient blips fail fast forever — the budget should only
        starve sessions to nodes that never answer."""
        with self._lock:
            self._spent = 0

    @property
    def spent(self) -> int:
        with self._lock:
            return self._spent

    @property
    def exhausted(self) -> bool:
        with self._lock:
            return self._spent >= self.limit


def decorrelated_jitter(prev_s: float, base_s: float | None = None,
                        cap_s: float | None = None,
                        rng=None) -> float:
    """The next backoff sleep: uniform(base, 3 * prev), capped.
    base/cap default to the module knobs at CALL time so tests (and
    operators) can tune them with a monkeypatch/assignment."""
    rng = rng or random
    if base_s is None:
        base_s = BACKOFF_S
    if cap_s is None:
        cap_s = BACKOFF_CAP_S
    return min(cap_s, base_s + rng.random() * max(3 * prev_s - base_s,
                                                  0.0))


class RetryingSession(Session):
    def __init__(self, remote: Remote, conn_spec: dict,
                 budget: RetryBudget | None = None):
        self.conn_spec = conn_spec
        self.budget = budget if budget is not None else RetryBudget()
        self.wrapper = reconnect.Wrapper(
            open=lambda: remote.connect(conn_spec),
            close=lambda s: s.disconnect(),
            name=("control", conn_spec.get("host")))
        self.wrapper.open()

    def _with_retry(self, f):
        tries = RETRIES
        sleep_s = BACKOFF_S
        while True:
            try:
                # cycle the session ONLY on transport failures: a
                # command's own error (nonzero exit, missing file on
                # scp) must not tear down the shared ControlMaster and
                # kill other threads' in-flight multiplexed commands
                with self.wrapper.with_conn(
                        cycle_on=TransportError) as sess:
                    res = f(sess)
                self.budget.refund()  # the node answered
                return res
            except TransportError as e:
                if tries <= 0:
                    raise
                if not self.budget.try_spend():
                    # budget exhausted: this session has retried enough
                    # for one lifetime — fail fast and let the caller
                    # (worker crash-to-:info, quarantine breaker)
                    # handle a node that is actually down
                    telemetry.count("control.retry.budget-exhausted")
                    tracing.event("remote-retry-budget-exhausted",
                                  node=self.conn_spec.get("host"))
                    raise
                tries -= 1
                # stamp the attempt count on the ambient 'remote'
                # trace span (control.traced_execute opened it around
                # this whole retry loop), so a command that limped
                # through on attempt 3 carries retries=3
                tracing.annotate(retries=RETRIES - tries)
                tracing.event("remote-retry",
                              node=self.conn_spec.get("host"),
                              attempt=RETRIES - tries,
                              error=str(e)[:160])
                sleep_s = decorrelated_jitter(sleep_s)
                time.sleep(sleep_s)

    def execute(self, action: Action) -> Result:
        return self._with_retry(lambda s: s.execute(action))

    def upload(self, local_paths, remote_path) -> None:
        return self._with_retry(
            lambda s: s.upload(local_paths, remote_path))

    def download(self, remote_paths, local_path) -> None:
        return self._with_retry(
            lambda s: s.download(remote_paths, local_path))

    def disconnect(self) -> None:
        self.wrapper.close()


class RetryingRemote(Remote):
    """Wraps another Remote so transport failures reconnect + retry
    (retry.clj `remote`, 67-72). budget_limit bounds retries per
    session (see SESSION_RETRY_BUDGET)."""

    def __init__(self, remote: Remote, budget_limit: int | None = None):
        self.remote = remote
        self.budget_limit = budget_limit

    def connect(self, conn_spec: dict) -> RetryingSession:
        budget = (RetryBudget(self.budget_limit)
                  if self.budget_limit is not None else RetryBudget())
        return RetryingSession(self.remote, conn_spec, budget=budget)
