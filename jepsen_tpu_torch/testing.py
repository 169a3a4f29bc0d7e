"""Clusterless test fixtures: the noop test, an in-memory DB and the
in-memory clients every workload family runs against (the port's copy of
jepsen_tpu/testing.py). Each faulty client keeps the reference's knob
under the same name (drop_every, dup_every, lose_write, hide_first,
broken, lose_offset, skew_every, hide_first_every, dirty_every,
lose_every, steal_every, race_every, miss_every/late_every, tear_every,
stale_every, diverge_every).

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


class SetClient(jclient.Client):
    """In-memory grow-only set; drop_every simulates lost adds."""

    def __init__(self, state=None, drop_every: int = 0,
                 latency_s: float = 0.0003):
        self.state = state if state is not None else {"set": set(),
                                                      "n": 0}
        self.lock = threading.Lock()
        self.drop_every = drop_every
        self.latency_s = latency_s

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        if self.latency_s:
            time.sleep(self.latency_s)
        with self.lock:
            if op.f == "add":
                self.state["n"] += 1
                if self.drop_every and \
                        self.state["n"] % self.drop_every == 0:
                    return op.copy(type="ok")  # ack but drop: lost add
                self.state["set"].add(op.value)
                return op.copy(type="ok")
            if op.f == "read":
                return op.copy(type="ok",
                               value=sorted(self.state["set"]))
        raise ValueError(f"unknown f {op.f!r}")


class QueueClient(jclient.Client):
    """In-memory queue with optional message loss."""

    def __init__(self, state=None, drop_every: int = 0,
                 latency_s: float = 0.0003):
        self.state = state if state is not None else {"q": [], "n": 0}
        self.lock = threading.Lock()
        self.drop_every = drop_every
        self.latency_s = latency_s

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        if self.latency_s:
            time.sleep(self.latency_s)
        with self.lock:
            if op.f == "enqueue":
                self.state["n"] += 1
                if self.drop_every and \
                        self.state["n"] % self.drop_every == 0:
                    return op.copy(type="ok")
                self.state["q"].append(op.value)
                return op.copy(type="ok")
            if op.f == "dequeue":
                if self.state["q"]:
                    return op.copy(type="ok",
                                   value=self.state["q"].pop(0))
                return op.copy(type="fail")
            if op.f == "drain":
                got, self.state["q"] = self.state["q"], []
                return op.copy(type="ok", value=got)
        raise ValueError(f"unknown f {op.f!r}")


class CounterClient(jclient.Client):
    def __init__(self, state=None, latency_s: float = 0.0003):
        self.state = state if state is not None else {"v": 0}
        self.lock = threading.Lock()
        self.latency_s = latency_s

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        if self.latency_s:
            time.sleep(self.latency_s)
        with self.lock:
            if op.f == "add":
                self.state["v"] += op.value
                return op.copy(type="ok")
            if op.f == "read":
                return op.copy(type="ok", value=self.state["v"])
        raise ValueError(f"unknown f {op.f!r}")


class UniqueIdsClient(jclient.Client):
    def __init__(self, state=None, dup_every: int = 0,
                 latency_s: float = 0.0003):
        self.state = state if state is not None else {"n": 0}
        self.lock = threading.Lock()
        self.dup_every = dup_every
        self.latency_s = latency_s

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        if self.latency_s:
            time.sleep(self.latency_s)
        with self.lock:
            self.state["n"] += 1
            n = self.state["n"]
            if self.dup_every and n % self.dup_every == 0:
                n = 1  # duplicate id
            return op.copy(type="ok", value=n)


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


class CausalClient(jclient.Client):
    """Single-site causal register per key: positions increase
    monotonically, links chain per key; lose_write makes later reads
    stale (the anomaly the causal checker catches). Mirrors the
    reference's in-memory fixtures in jepsen.tests (tests.clj:26-66
    pattern, applied to tests/causal.clj semantics)."""

    def __init__(self, state=None, lose_write=False):
        self.state = state if state is not None else {
            "lock": threading.Lock(), "regs": {}, "pos": 0}
        self.lose_write = lose_write

    def open(self, test, node):
        return CausalClient(self.state, self.lose_write)

    def invoke(self, test, o):
        from . import independent

        k = independent.key_(o.value)
        v = independent.value_(o.value)
        with self.state["lock"]:
            reg = self.state["regs"].setdefault(
                k, {"value": 0, "counter": 0, "last": "init"})
            self.state["pos"] += 1
            pos = self.state["pos"]
            link = reg["last"]
            reg["last"] = pos
            if o.f == "write":
                if not (self.lose_write and v == 1):
                    reg["value"] = v
                reg["counter"] += 1
                out = v
            else:
                out = reg["value"]
            return o.copy(type="ok",
                          value=independent.ktuple(k, out),
                          position=pos,
                          link="init" if o.f == "read-init" else link)


class PerKeySetClient(jclient.Client):
    """Blind writes into a per-key list; reads return it (the
    causal-reverse workload's client shape). hide_first drops the
    oldest acked write from later reads — the T2-without-T1 anomaly."""

    def __init__(self, state=None, hide_first=False):
        self.state = state if state is not None else {
            "lock": threading.Lock(), "sets": {}}
        self.hide_first = hide_first

    def open(self, test, node):
        return PerKeySetClient(self.state, self.hide_first)

    def invoke(self, test, o):
        from . import independent

        k = independent.key_(o.value)
        v = independent.value_(o.value)
        with self.state["lock"]:
            s = self.state["sets"].setdefault(k, [])
            if o.f == "write":
                s.append(v)
                return o.copy(type="ok")
            vals = list(s)
            if self.hide_first and len(vals) > 2:
                vals = vals[1:]
            return o.copy(type="ok",
                          value=independent.ktuple(k, vals))


class G2Client(jclient.Client):
    """Predicate-read-then-insert: under the lock at most one insert
    per key commits (serializable); broken=True lets both commit — the
    adya G2 anomaly."""

    def __init__(self, state=None, broken=False):
        self.state = state if state is not None else {
            "lock": threading.Lock(), "rows": {}}
        self.broken = broken

    def open(self, test, node):
        return G2Client(self.state, self.broken)

    def invoke(self, test, o):
        from . import independent

        k = independent.key_(o.value)
        with self.state["lock"]:
            if self.state["rows"].get(k) and not self.broken:
                return o.copy(type="fail")
            self.state["rows"].setdefault(k, []).append(
                independent.value_(o.value))
            return o.copy(type="ok")


class KafkaState:
    """Shared in-memory partitioned log with per-(client, key)
    consumer positions."""

    def __init__(self):
        self.lock = threading.Lock()
        self.logs: dict = {}

    def append(self, k, v) -> int:
        with self.lock:
            self.logs.setdefault(k, []).append(v)
            return len(self.logs[k]) - 1


class KafkaClient(jclient.Client):
    """Drives the kafka workload's send/poll/txn + subscribe/assign op
    encoding against KafkaState; lose_offset makes one committed send
    invisible to every consumer (a lost write)."""

    def __init__(self, state=None, lose_offset=None):
        self.state = state if state is not None else KafkaState()
        self.lose_offset = lose_offset  # (key, offset) to hide
        self.positions: dict = {}

    def open(self, test, node):
        c = KafkaClient(self.state, self.lose_offset)
        return c

    def invoke(self, test, o):
        if o.f in ("subscribe", "assign"):
            for k in o.value or []:
                self.positions.setdefault(k, 0)
            return o.copy(type="ok")
        done = []
        for m in o.value:
            if m[0] == "send":
                _f, k, v = m
                off = self.state.append(k, v)
                done.append(["send", k, [off, v]])
            else:
                reads: dict = {}
                with self.state.lock:
                    logs = {k: list(vs)
                            for k, vs in self.state.logs.items()}
                for k, log in logs.items():
                    pos = self.positions.get(k, 0)
                    pairs = []
                    for i in range(pos, len(log)):
                        if self.lose_offset == (k, i):
                            continue
                        pairs.append([i, log[i]])
                    if pairs:
                        reads[k] = pairs
                    self.positions[k] = len(log)
                done.append(["poll", reads])
        return o.copy(type="ok", value=done)


class MonotonicState:
    """Rows for the monotonic workload, with a perfect (or skewed)
    logical clock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.rows: list = []
        self.clock = 0


class MonotonicClient(jclient.Client):
    """In-memory monotonic-inserts client (mirrors cockroach
    monotonic.clj semantics): add reads the max, inserts max+1 with a
    db timestamp; read returns rows sorted by timestamp.
    `skew_every` makes every Nth timestamp run backwards (an ordering
    violation); `dup_every` re-inserts an existing value."""

    def __init__(self, state=None, skew_every: int = 0,
                 dup_every: int = 0, node_index: int = 0):
        self.state = state if state is not None else MonotonicState()
        self.skew_every = skew_every
        self.dup_every = dup_every
        self.node_index = node_index

    def open(self, test, node):
        idx = list(test.get("nodes", ())).index(node) \
            if node in test.get("nodes", ()) else 0
        return MonotonicClient(self.state, self.skew_every,
                               self.dup_every, idx)

    def invoke(self, test, op):
        s = self.state
        with s.lock:
            if op.f == "add":
                cur_max = max((r["val"] for r in s.rows), default=0)
                val = cur_max + 1
                if self.dup_every and len(s.rows) and \
                        len(s.rows) % self.dup_every == 0:
                    val = s.rows[-1]["val"]  # duplicate insert
                s.clock += 1
                sts = s.clock
                if self.skew_every and \
                        len(s.rows) % self.skew_every == (
                            self.skew_every - 1):
                    sts = max(s.clock - 3, 0)  # clock ran backwards
                row = {"val": val, "sts": sts,
                       "node": self.node_index,
                       "process": op.process,
                       "tb": len(s.rows) % 2}
                s.rows.append(row)
                return op.copy(type="ok", value=row)
            if op.f == "read":
                rows = sorted(s.rows, key=lambda r: r["sts"])
                return op.copy(type="ok", value=rows)
        raise ValueError(f"unknown f {op.f!r}")


class SequentialState:
    def __init__(self):
        self.lock = threading.Lock()
        self.present: set = set()


class SequentialClient(jclient.Client):
    """In-memory sequential-consistency client: writes insert a key's
    subkeys in order (each its own 'txn'); reads probe them reversed.
    `hide_first_every` makes every Nth write skip its FIRST subkey (a
    later subkey visible without the earlier one -> violation)."""

    def __init__(self, state=None, key_count: int = 5,
                 hide_first_every: int = 0):
        self.state = state if state is not None else SequentialState()
        self.key_count = key_count
        self.hide_first_every = hide_first_every
        self._writes = 0

    def open(self, test, node):
        c = SequentialClient(self.state,
                             test.get("key_count", self.key_count),
                             self.hide_first_every)
        return c

    def invoke(self, test, op):
        from .workloads import sequential as seq

        s = self.state
        ks = seq.subkeys(self.key_count, op.value)
        if op.f == "write":
            self._writes += 1
            skip_first = (self.hide_first_every
                          and self._writes % self.hide_first_every
                          == 0)
            for i, k in enumerate(ks):
                if skip_first and i == 0:
                    continue
                with s.lock:
                    s.present.add(k)
            return op.copy(type="ok")
        if op.f == "read":
            obs = []
            for k in reversed(ks):
                with s.lock:
                    obs.append(k if k in s.present else None)
            return op.copy(type="ok", value=(op.value, obs))
        raise ValueError(f"unknown f {op.f!r}")


class DirtyReadState:
    """Visible vs committed value sets, for the dirty-read workload.
    Healthy behavior keeps them identical."""

    def __init__(self):
        self.lock = threading.Lock()
        self.visible: set = set()
        self.committed: set = set()


class DirtyReadClient(jclient.Client):
    """In-memory dirty-read client. `dirty_every` makes every Nth
    write visible-but-never-committed (its ack crashes): readers can
    observe it, strong reads won't — a dirty read. `lose_every` acks
    every Nth write but drops it from the committed set — a lost
    write."""

    def __init__(self, state=None, dirty_every: int = 0,
                 lose_every: int = 0):
        self.state = state if state is not None else DirtyReadState()
        self.dirty_every = dirty_every
        self.lose_every = lose_every
        self._writes = 0

    def open(self, test, node):
        c = DirtyReadClient(self.state, self.dirty_every,
                            self.lose_every)
        return c

    def invoke(self, test, op):
        s = self.state
        if op.f == "write":
            self._writes += 1
            with s.lock:
                s.visible.add(op.value)
                if self.dirty_every and \
                        self._writes % self.dirty_every == 0:
                    # crashes un-acked; never commits, stays visible
                    # for a while so a racing read can catch it
                    return op.copy(type="info", error="conn lost")
                if self.lose_every and \
                        self._writes % self.lose_every == 0:
                    s.visible.discard(op.value)  # acked yet gone
                    return op.copy(type="ok")
                s.committed.add(op.value)
            return op.copy(type="ok")
        if op.f == "read":
            with s.lock:
                found = op.value in s.visible
            return op.copy(type="ok" if found else "fail")
        if op.f == "refresh":
            with s.lock:
                # convergence: uncommitted in-flight values vanish
                s.visible = set(s.committed)
            return op.copy(type="ok")
        if op.f == "strong-read":
            with s.lock:
                return op.copy(type="ok", value=sorted(s.visible))
        raise ValueError(f"unknown f {op.f!r}")


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


class UpsertClient(jclient.Client):
    """Per-key insert-unless-exists returning a fresh uid on creation
    (dgraph upsert.clj client). race_every lets every Nth contended
    upsert create a SECOND record for the key — the uniqueness
    violation the checker must catch."""

    def __init__(self, state=None, race_every: int = 0):
        self.state = state if state is not None else {
            "lock": threading.Lock(), "rows": {}, "next_uid": 1,
            "attempts": 0}
        self.race_every = race_every

    def open(self, test, node):
        return UpsertClient(self.state, self.race_every)

    def invoke(self, test, op):
        from . import independent

        s = self.state
        k = independent.key_(op.value)
        with s["lock"]:
            rows = s["rows"].setdefault(k, [])
            if op.f == "upsert":
                s["attempts"] += 1
                racing = self.race_every and \
                    s["attempts"] % self.race_every == 0
                if rows and not racing:
                    return op.copy(type="fail", error="exists")
                uid = s["next_uid"]
                s["next_uid"] += 1
                rows.append(uid)
                return op.copy(
                    type="ok", value=independent.ktuple(k, uid))
            if op.f == "read":
                return op.copy(
                    type="ok",
                    value=independent.ktuple(k, sorted(rows)))
        raise ValueError(f"unknown f {op.f!r}")


class SchedulerClient(jclient.Client):
    """In-memory job scheduler (chronos.clj shape): add-job records
    the spec; the final read synthesizes the runs a faithful scheduler
    would have produced for every due target (start jittered within
    epsilon, completed after `duration`). miss_every drops every Nth
    target's run — the lost-invocation bug run-coverage must flag."""

    def __init__(self, state=None, miss_every: int = 0,
                 late_every: int = 0):
        self.state = state if state is not None else {
            "lock": threading.Lock(), "jobs": []}
        self.miss_every = miss_every
        self.late_every = late_every

    def open(self, test, node):
        return SchedulerClient(self.state, self.miss_every,
                               self.late_every)

    def invoke(self, test, op):
        from .workloads import scheduler as sched

        s = self.state
        with s["lock"]:
            if op.f == "add-job":
                s["jobs"].append(dict(op.value))
                return op.copy(type="ok")
            if op.f == "read":
                read_time = max(
                    [j["start"] + j["interval"] * j["count"]
                     for j in s["jobs"]] + [0.0]) + 60.0
                runs, n = [], 0
                for job in s["jobs"]:
                    for (t0, _dl) in sched.job_targets(
                            read_time, job):
                        n += 1
                        if self.miss_every and \
                                n % self.miss_every == 0:
                            continue
                        start = t0 + (job["epsilon"] + 30.0
                                      if self.late_every
                                      and n % self.late_every == 0
                                      else 0.5)
                        runs.append({"name": job["name"],
                                     "start": start,
                                     "end": start + job["duration"]})
                return op.copy(type="ok", value={"time": read_time,
                                                 "runs": runs})
        raise ValueError(f"unknown f {op.f!r}")


class PagesClient(jclient.Client):
    """Per-key element store with atomic group inserts (faunadb
    pages.clj client). tear_every serves every Nth read while a group
    is half-applied — the pagination-isolation anomaly."""

    def __init__(self, state=None, tear_every: int = 0):
        self.state = state if state is not None else {
            "lock": threading.Lock(), "rows": {}, "reads": 0}
        self.tear_every = tear_every

    def open(self, test, node):
        return PagesClient(self.state, self.tear_every)

    def invoke(self, test, op):
        from . import independent

        s = self.state
        k = independent.key_(op.value)
        v = independent.value_(op.value)
        with s["lock"]:
            rows = s["rows"].setdefault(k, [])
            if op.f == "add":
                rows.extend(v)
                return op.copy(type="ok")
            if op.f == "read":
                s["reads"] += 1
                vals = list(rows)
                if self.tear_every and \
                        s["reads"] % self.tear_every == 0 and \
                        len(vals) > 2:
                    vals = vals[:-2]  # half of the last group missing
                return op.copy(
                    type="ok", value=independent.ktuple(k, vals))
        raise ValueError(f"unknown f {op.f!r}")


class MultiRegClient(jclient.Client):
    """Increment-only multi-register store with a logical read
    timestamp (faunadb multimonotonic.clj client). stale_every serves
    every Nth read from an old snapshot with a CURRENT timestamp —
    the ts-order violation."""

    def __init__(self, state=None, stale_every: int = 0):
        self.state = state if state is not None else {
            "lock": threading.Lock(), "regs": {}, "ts": 0,
            "reads": 0, "snapshots": []}
        self.stale_every = stale_every

    def open(self, test, node):
        return MultiRegClient(self.state, self.stale_every)

    def invoke(self, test, op):
        s = self.state
        with s["lock"]:
            if op.f == "write":
                for k, v in (op.value or {}).items():
                    s["regs"][k] = v
                s["ts"] += 1
                return op.copy(type="ok")
            if op.f == "read":
                s["reads"] += 1
                s["ts"] += 1
                regs = dict(s["regs"])
                stale = (self.stale_every
                         and s["reads"] % self.stale_every == 0
                         and s["snapshots"])
                if stale:
                    # a lagging replica: values from several reads
                    # ago served under a CURRENT timestamp
                    regs = dict(s["snapshots"][0])
                else:
                    s["snapshots"].append(dict(regs))
                    if len(s["snapshots"]) > 8:
                        s["snapshots"].pop(0)
                return op.copy(type="ok", value={"ts": s["ts"],
                                                 "registers": regs})
        raise ValueError(f"unknown f {op.f!r}")


class VersionedSetClient(jclient.Client):
    """Per-key element list guarded by a row version (crate
    lost_updates.clj client shape): add re-reads and writes back iff
    the version is unchanged. lose_every makes every Nth guarded
    update ack WITHOUT applying — a lost update."""

    def __init__(self, state=None, lose_every: int = 0):
        self.state = state if state is not None else {
            "lock": threading.Lock(), "rows": {}, "adds": 0}
        self.lose_every = lose_every

    def open(self, test, node):
        return VersionedSetClient(self.state, self.lose_every)

    def invoke(self, test, op):
        from . import independent

        s = self.state
        k = independent.key_(op.value)
        v = independent.value_(op.value)
        with s["lock"]:
            row = s["rows"].setdefault(k, {"els": [], "version": 0})
            if op.f == "add":
                s["adds"] += 1
                if self.lose_every and \
                        s["adds"] % self.lose_every == 0:
                    return op.copy(type="ok")  # acked, never applied
                row["els"].append(v)
                row["version"] += 1
                return op.copy(type="ok")
            if op.f == "read":
                return op.copy(type="ok", value=independent.ktuple(
                    k, sorted(row["els"])))
        raise ValueError(f"unknown f {op.f!r}")


class VersionRegClient(jclient.Client):
    """Versioned register (crate version_divergence.clj client):
    writes bump _version; reads return {value, version}.
    diverge_every makes every Nth read report a DIFFERENT value under
    the same version — replica divergence."""

    def __init__(self, state=None, diverge_every: int = 0):
        self.state = state if state is not None else {
            "lock": threading.Lock(), "rows": {}, "reads": 0}
        self.diverge_every = diverge_every

    def open(self, test, node):
        return VersionRegClient(self.state, self.diverge_every)

    def invoke(self, test, op):
        from . import independent

        s = self.state
        k = independent.key_(op.value)
        v = independent.value_(op.value)
        with s["lock"]:
            row = s["rows"].get(k)
            if op.f == "write":
                if row is None:
                    s["rows"][k] = {"value": v, "version": 1}
                else:
                    row["value"] = v
                    row["version"] += 1
                return op.copy(type="ok")
            if op.f == "read":
                s["reads"] += 1
                if row is None:
                    return op.copy(
                        type="ok", value=independent.ktuple(k, None))
                out = {"value": row["value"],
                       "version": row["version"]}
                if self.diverge_every and \
                        s["reads"] % self.diverge_every == 0:
                    out = {"value": (row["value"] or 0) + 100000,
                           "version": row["version"]}
                return op.copy(
                    type="ok", value=independent.ktuple(k, out))
        raise ValueError(f"unknown f {op.f!r}")
