"""Clusterless test fixtures: the noop test and in-memory clients (the
port's copy of the part of jepsen_tpu/testing.py that core.run and the
register, bank, list-append, rw-register and lock workloads run
against).

Capability reference: jepsen/src/jepsen/tests.clj (noop-test 11-24,
atom-db 26-32, atom-client 34-66). These power the reference's own
end-to-end tests (core_test.clj:69-120).
"""

from __future__ import annotations

import threading
import time

from . import client as jclient
from . import db as jdb
from . import nemesis as jnemesis
from . import net as jnet
from . import os_setup


def noop_test() -> dict:
    """A boring test stub, basis for writing real tests
    (tests.clj:11-24)."""
    return {
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "name": None,  # no store dir by default in unit tests
        "os": os_setup.noop,
        "db": jdb.noop,
        "net": jnet.iptables,
        "ssh": {"dummy": True},
        "client": jclient.noop,
        "nemesis": jnemesis.noop,
        "generator": None,
    }


class AtomState:
    """A lock-guarded in-memory register (the reference's atom)."""

    def __init__(self, value=None):
        self.lock = threading.Lock()
        self.value = value


class AtomDB(jdb.DB):
    def __init__(self, state: AtomState):
        self.state = state

    def setup(self, test, node):
        with self.state.lock:
            self.state.value = 0

    def teardown(self, test, node):
        with self.state.lock:
            self.state.value = "done"


class AtomClient(jclient.Client):
    """A CAS register client over shared in-memory state
    (tests.clj:34-66)."""

    def __init__(self, state: AtomState, meta_log: list | None = None,
                 latency_s: float = 0.001):
        self.state = state
        self.meta_log = meta_log if meta_log is not None else []
        self.latency_s = latency_s

    def open(self, test, node):
        self.meta_log.append("open")
        return self

    def setup(self, test):
        self.meta_log.append("setup")
        return self

    def teardown(self, test):
        self.meta_log.append("teardown")

    def close(self, test):
        self.meta_log.append("close")

    def invoke(self, test, op):
        # Sleep to create actual concurrency, like the reference's
        # (Thread/sleep 1).
        if self.latency_s:
            time.sleep(self.latency_s)
        if op.f == "write":
            with self.state.lock:
                self.state.value = op.value
            return op.copy(type="ok")
        if op.f == "cas":
            cur, new = op.value
            with self.state.lock:
                if self.state.value == cur:
                    self.state.value = new
                    return op.copy(type="ok")
            return op.copy(type="fail")
        if op.f == "read":
            with self.state.lock:
                v = self.state.value
            return op.copy(type="ok", value=v)
        raise ValueError(f"unknown f {op.f!r}")


class ListAppendState:
    """In-memory strict-serializable list-append store for elle-style
    workloads (mirrors core_test.clj's atom database for txns)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.data: dict = {}

    def apply_txn(self, txn):
        out = []
        with self.lock:
            for f, k, v in txn:
                if f == "r":
                    out.append([f, k, list(self.data.get(k, []))])
                elif f == "append":
                    self.data.setdefault(k, []).append(v)
                    out.append([f, k, v])
                else:
                    raise ValueError(f"unknown mop {f!r}")
        return out


class ListAppendClient(jclient.Client):
    def __init__(self, state: ListAppendState, latency_s: float = 0.0005):
        self.state = state
        self.latency_s = latency_s

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        if self.latency_s:
            time.sleep(self.latency_s)
        return op.copy(type="ok", value=self.state.apply_txn(op.value))


class KVState:
    """Lock-guarded keyed CAS registers for independent-key workloads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.data: dict = {}


class KVClient(jclient.Client):
    """Register client over keyed state; op values are (key, v) tuples
    (the independent.clj tuple convention)."""

    def __init__(self, state: KVState, latency_s: float = 0.0005):
        self.state = state
        self.latency_s = latency_s

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        if self.latency_s:
            time.sleep(self.latency_s)
        k, v = op.value
        with self.state.lock:
            if op.f == "write":
                self.state.data[k] = v
                return op.copy(type="ok")
            if op.f == "cas":
                cur, new = v
                if self.state.data.get(k) == cur:
                    self.state.data[k] = new
                    return op.copy(type="ok")
                return op.copy(type="fail")
            if op.f == "read":
                return op.copy(type="ok",
                               value=(k, self.state.data.get(k)))
        raise ValueError(f"unknown f {op.f!r}")


class BankState:
    def __init__(self, accounts, initial=10):
        self.lock = threading.Lock()
        self.balances = {a: initial for a in accounts}


class BankClient(jclient.Client):
    """Serializable in-memory bank (tests/bank.clj semantics)."""

    def __init__(self, state: BankState, latency_s: float = 0.0005):
        self.state = state
        self.latency_s = latency_s

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        if self.latency_s:
            time.sleep(self.latency_s)
        with self.state.lock:
            if op.f == "read":
                return op.copy(type="ok", value=dict(self.state.balances))
            v = op.value
            frm, to, amt = v["from"], v["to"], v["amount"]
            if self.state.balances.get(frm, 0) < amt:
                return op.copy(type="fail")
            self.state.balances[frm] -= amt
            self.state.balances[to] = self.state.balances.get(to, 0) + amt
            return op.copy(type="ok")


class TxnClient(jclient.Client):
    """Strict-serializable txn client over keyed lists/registers: handles
    append/r (list-append) and w/r (rw-register) micro-ops."""

    def __init__(self, state: "ListAppendState" = None,
                 latency_s: float = 0.0003):
        self.state = state if state is not None else ListAppendState()
        self.latency_s = latency_s

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        if self.latency_s:
            time.sleep(self.latency_s)
        out = []
        with self.state.lock:
            for f, k, v in op.value:
                if f == "r":
                    cur = self.state.data.get(k)
                    out.append([f, k, list(cur) if isinstance(cur, list)
                                else cur])
                elif f == "append":
                    self.state.data.setdefault(k, []).append(v)
                    out.append([f, k, v])
                elif f == "w":
                    self.state.data[k] = v
                    out.append([f, k, v])
                else:
                    raise ValueError(f"unknown mop {f!r}")
        return op.copy(type="ok", value=out)


class LockState:
    """Shared in-memory lock service: owner, reentrancy count, and a
    monotonic fencing-token counter."""

    def __init__(self, permits: int = 1):
        self.lock = threading.Lock()
        self.owner = None
        self.count = 0
        self.fence = 0
        self.permits = permits
        self.held: dict = {}  # process -> permits held (semaphore mode)


class LockClient(jclient.Client):
    """In-memory fenced lock / semaphore client (the hazelcast.clj
    client families). `reentrant_limit` > 1 allows nested acquires;
    `semaphore=True` switches to permit semantics; `steal_every`
    grants every Nth busy acquire anyway WITHOUT a fresh fence — a
    mutual-exclusion violation with a stale token, the classic
    fencing failure."""

    def __init__(self, state=None, reentrant_limit: int = 1,
                 semaphore: bool = False, steal_every: int = 0,
                 fences: bool = True):
        self.state = state if state is not None else LockState()
        self.reentrant_limit = reentrant_limit
        self.semaphore = semaphore
        self.steal_every = steal_every
        self.fences = fences
        self._attempts = 0

    def open(self, test, node):
        c = LockClient(self.state, self.reentrant_limit,
                       self.semaphore, self.steal_every, self.fences)
        return c

    def _sem_invoke(self, s: LockState, op):
        total = sum(s.held.values())
        mine = s.held.get(op.process, 0)
        if op.f == "acquire":
            if total < s.permits:
                s.held[op.process] = mine + 1
                return op.copy(type="ok")
            return op.copy(type="fail", error="no permits")
        if mine > 0:
            s.held[op.process] = mine - 1
            return op.copy(type="ok")
        return op.copy(type="fail", error="not-permit-owner")

    def invoke(self, test, op):
        s = self.state
        with s.lock:
            if self.semaphore:
                return self._sem_invoke(s, op)
            if op.f == "acquire":
                self._attempts += 1
                if s.owner is None or (s.owner == op.process
                                       and s.count
                                       < self.reentrant_limit):
                    first = s.owner is None
                    s.owner = op.process
                    s.count += 1
                    if first and self.fences:
                        s.fence += 1
                    val = {"fence": s.fence} if self.fences else None
                    return op.copy(type="ok", value=val)
                if self.steal_every and \
                        self._attempts % self.steal_every == 0:
                    # grants despite a holder, reusing a stale fence
                    s.owner = op.process
                    s.count = 1
                    val = {"fence": s.fence} if self.fences else None
                    return op.copy(type="ok", value=val)
                return op.copy(type="fail", error="busy")
            if op.f == "release":
                if s.owner != op.process:
                    return op.copy(type="fail",
                                   error="not-lock-owner")
                s.count -= 1
                if s.count == 0:
                    s.owner = None
                return op.copy(type="ok")
        raise ValueError(f"unknown f {op.f!r}")
