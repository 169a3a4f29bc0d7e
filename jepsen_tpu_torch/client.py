"""Client protocol: applies operations to the database under test (the
port's copy of jepsen_tpu/client.py).

Capability reference: jepsen/src/jepsen/client.clj (Client protocol 9-27,
Reusable 29-44, Validate 64-114, timeout wrapper 116-148, noop client).
"""

from __future__ import annotations

from typing import Callable

from . import util
from .history import Op


class Client:
    """A client opens a connection to one node and applies ops.

    Lifecycle: open(test, node) -> setup(test) -> invoke(test, op)* ->
    teardown(test) -> close(test). open/close must not affect the logical
    state of the test."""

    def open(self, test, node) -> "Client":
        return self

    def setup(self, test) -> "Client":
        return self

    def invoke(self, test, op: Op) -> Op:
        raise NotImplementedError

    def teardown(self, test) -> None:
        pass

    def close(self, test) -> None:
        pass

    def reusable(self, test) -> bool:
        """If True, this client survives a crashed invocation and can be
        reused by the replacement process (Reusable protocol,
        client.clj:29-44)."""
        return False


def is_reusable(client, test) -> bool:
    try:
        return bool(client.reusable(test))
    except Exception:  # noqa: BLE001 - parity with is-reusable? fallback
        return False


class NoopClient(Client):
    """Completes every op :ok without talking to anything."""

    def invoke(self, test, op):
        return op.copy(type="ok")


noop = NoopClient()


class InvalidCompletion(Exception):
    def __init__(self, op, op2, problems):
        self.op = op
        self.op2 = op2
        self.problems = problems
        super().__init__(f"invalid completion for {op!r}: {op2!r} ({problems})")


class Validate(Client):
    """Asserts invoke returns a completion with legal type and unchanged
    process/f (client.clj:64-114)."""

    def __init__(self, client: Client):
        self.client = client

    def open(self, test, node):
        res = self.client.open(test, node)
        if not isinstance(res, Client):
            raise TypeError(f"open should return a Client, got {res!r}")
        return Validate(res)

    def setup(self, test):
        return Validate(self.client.setup(test))

    def invoke(self, test, op):
        op2 = self.client.invoke(test, op)
        problems = []
        if not isinstance(op2, Op):
            problems.append("should be an Op")
        else:
            if op2.type not in ("ok", "info", "fail"):
                problems.append("type should be ok, info, or fail")
            if op2.process != op.process:
                problems.append("process should be the same")
            if op2.f != op.f:
                problems.append("f should be the same")
        if problems:
            raise InvalidCompletion(op, op2, problems)
        return op2

    def teardown(self, test):
        self.client.teardown(test)

    def close(self, test):
        self.client.close(test)

    def reusable(self, test):
        return is_reusable(self.client, test)


def validate(client: Client) -> Validate:
    return Validate(client)


class Timeout(Client):
    """Times out invocations after timeout_ms (or (f op) -> ms), completing
    them :info with error 'timeout' (client.clj:116-148)."""

    def __init__(self, timeout_fn: Callable[[Op], float], client: Client):
        self.timeout_fn = timeout_fn
        self.client = client

    def open(self, test, node):
        return Timeout(self.timeout_fn, self.client.open(test, node))

    def setup(self, test):
        return Timeout(self.timeout_fn, self.client.setup(test))

    def invoke(self, test, op):
        ms = self.timeout_fn(op)
        return util.timeout(ms / 1000.0,
                            lambda: self.client.invoke(test, op),
                            default=op.copy(type="info", error="timeout"))

    def teardown(self, test):
        self.client.teardown(test)

    def close(self, test):
        self.client.close(test)

    def reusable(self, test):
        return is_reusable(self.client, test)


def timeout(timeout_or_fn, client: Client) -> Timeout:
    if callable(timeout_or_fn):
        return Timeout(timeout_or_fn, client)
    return Timeout(lambda _op: timeout_or_fn, client)


class Traced(Client):
    """Per-call client tracing (the dgraph/src/jepsen/dgraph/trace.clj
    analog): wraps invoke — and reopen-during-invoke — in a 'client'
    child span of the ambient op trace, so the client round-trip is
    visible as its own slice under the op's lifetime. A no-op when
    tracing is disabled (the tracing module gates every record on one
    enabled check)."""

    def __init__(self, client: Client):
        self.client = client

    def open(self, test, node):
        from . import tracing

        with tracing.span("client", "client.open",
                          node=util.name_str(node)
                          if node is not None else None):
            return Traced(self.client.open(test, node))

    def setup(self, test):
        return Traced(self.client.setup(test))

    def invoke(self, test, op):
        from . import tracing

        with tracing.span("client", f"client.{op.f}") as rec:
            op2 = self.client.invoke(test, op)
            if rec is not None:
                rec.setdefault("attrs", {})["type"] = op2.type
            return op2

    def teardown(self, test):
        self.client.teardown(test)

    def close(self, test):
        from . import tracing

        with tracing.span("client", "client.close"):
            self.client.close(test)

    def reusable(self, test):
        return is_reusable(self.client, test)


def traced(client: Client) -> Traced:
    return Traced(client)


def should_trace(test) -> bool:
    """Whether the interpreter should wrap this test's client in
    Traced: tracing must be on for the run (test['trace?'], wired by
    core.run), and suites opt out of per-call client spans with
    test['trace_clients?'] = False (or force the wrapper on a client
    they build themselves via traced())."""
    from . import tracing

    return (tracing.get().enabled
            and test.get("trace_clients?", True) is not False)


def definite_http_failure(e: Exception) -> bool:
    """True when an HTTP request certainly never executed — a refused
    connection — so the op is a safe definite :fail. Timeouts, resets
    and 5xx are indeterminate (:info): the server may have applied the
    write before the reply was lost. Shared by the HTTP-driven suites
    (the reference's suites each carry a with-errors macro making the
    same split, e.g. consul/client.clj with-errors)."""
    import urllib.error

    if isinstance(e, urllib.error.URLError):
        reason = getattr(e, "reason", None)
        return isinstance(reason, ConnectionRefusedError)
    return isinstance(e, ConnectionRefusedError)
