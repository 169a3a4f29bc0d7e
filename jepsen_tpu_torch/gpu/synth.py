"""Synthetic histories for benchmarks and compile checks: the CAS
register, list-append, bank and rw-register generators of
jepsen_tpu/tpu/synth.py, copied so the port's seeded inputs match the JAX
package's op for op.

Valid-by-construction concurrent register histories: each op's effect is
applied to the true register at a random instant inside its
invoke/complete window, so the resulting history is linearizable by
construction (the application order is a witness). This mirrors how the
reference generates its perf-regression history fixture
(jepsen/test/jepsen/perf_test.clj) but at arbitrary scale.
"""

from __future__ import annotations

import random

from ..history import History, op


def register_history(n_ops: int, n_procs: int = 5, seed: int = 0,
                     crash_p: float = 0.0, n_values: int = 5,
                     cas_p: float = 0.25, read_p: float = 0.4) -> History:
    """A valid CAS-register history with `n_ops` invocations (history
    length is ~2*n_ops events). Initial register value is None."""
    rng = random.Random(seed)
    value = None
    events: list = []
    # process -> [f, v, applied?, result]
    open_ops: dict[int, list] = {}
    budget = n_ops
    append = events.append
    while budget > 0 or open_ops:
        idle = n_procs - len(open_ops)
        unapplied = [p for p, o in open_ops.items() if not o[2]]
        applied = [p for p, o in open_ops.items() if o[2]]
        r = rng.random()
        # Prefer invoking while idle processes remain, then applying,
        # then completing — weights keep several ops in flight.
        if budget > 0 and idle and (r < 0.45 or not open_ops):
            p = rng.choice([q for q in range(n_procs)
                            if q not in open_ops])
            r2 = rng.random()
            if r2 < read_p:
                f, v = "read", None
            elif r2 < read_p + cas_p:
                f = "cas"
                v = [rng.randrange(n_values), rng.randrange(n_values)]
            else:
                f, v = "write", rng.randrange(n_values)
            open_ops[p] = [f, v, False, None]
            append(("invoke", p, f, v))
            budget -= 1
        elif unapplied and (r < 0.75 or not applied):
            p = rng.choice(unapplied)
            o = open_ops[p]
            f, v = o[0], o[1]
            if f == "read":
                o[3] = value
            elif f == "write":
                value = v
            else:
                cur, new = v
                if cur == value:
                    value = new
                    o[3] = "ok"
                else:
                    o[3] = "fail"
            o[2] = True
        elif applied:
            p = rng.choice(applied)
            f, v, _, result = open_ops.pop(p)
            if crash_p and rng.random() < crash_p:
                append(("info", p, f, v))
            elif f == "read":
                append(("ok", p, f, result))
            elif f == "write":
                append(("ok", p, f, v))
            else:
                append(("ok" if result == "ok" else "fail", p, f, v))
    ops = [op(index=i, time=i, type=t, process=p, f=f, value=v)
           for i, (t, p, f, v) in enumerate(events)]
    return History(ops, assign_indices=False)


def corrupt_register_history(hist: History, at_frac: float = 0.85,
                             bogus: int | None = None) -> tuple[History, int]:
    """Seeds ONE linearizability anomaly into a valid register history:
    the first ok read at/after `at_frac` of the history starts returning
    `bogus` (default: one past the largest int value seen anywhere in
    the history, so it is provably outside the write domain), making the
    read impossible to linearize. Returns (corrupted history, event
    index of the bad read).

    Drives the time-to-first-anomaly benchmark (BASELINE.md names the
    metric; the reference's knossos surfaces its counterexample through
    the same invalid-read shape, knossos.model/cas-register)."""
    events = list(hist)
    if bogus is None:
        seen = [e.value for e in events if isinstance(e.value, int)]
        seen += [v for e in events if isinstance(e.value, (list, tuple))
                 for v in e.value if isinstance(v, int)]
        bogus = max(seen, default=98) + 1
    start = int(len(events) * at_frac)
    for i in range(start, len(events)):
        e = events[i]
        if e.type == "ok" and e.f == "read":
            events[i] = e.copy(value=bogus)
            return History(events, assign_indices=False), i
    raise ValueError("no ok read at/after at_frac to corrupt")


def list_append_history(n_txns: int, n_procs: int = 5, n_keys: int = 6,
                        max_len: int = 4, rotate: int = 40,
                        seed: int = 0) -> History:
    """A valid concurrent list-append history: appends apply to a true
    store at completion, reads return its current state; keys rotate
    every `rotate` txns so read lists stay bounded (as elle's generator
    does). BASELINE config 3 fodder."""
    rng = random.Random(seed)
    store: dict = {}
    epoch = 0
    events: list = []
    open_t: dict[int, list] = {}
    t_count = 0
    nv = 1
    while t_count < n_txns or open_t:
        idle = n_procs - len(open_t)
        if t_count < n_txns and idle and (rng.random() < 0.6
                                          or not open_t):
            p = rng.choice([q for q in range(n_procs)
                            if q not in open_t])
            txn = []
            for _ in range(rng.randint(1, max_len)):
                k = f"k{rng.randrange(n_keys)}e{epoch}"
                if rng.random() < 0.5:
                    txn.append(["append", k, nv])
                    nv += 1
                else:
                    txn.append(["r", k, None])
            events.append(("invoke", p, txn))
            open_t[p] = txn
            t_count += 1
            if t_count % rotate == 0:
                epoch += 1
        else:
            p = rng.choice(list(open_t))
            txn = open_t.pop(p)
            res = []
            for f, k, v in txn:
                if f == "append":
                    store.setdefault(k, []).append(v)
                    res.append(["append", k, v])
                else:
                    res.append(["r", k, list(store.get(k, []))])
            events.append(("ok", p, res))
    ops = [op(index=i, time=i, type=t, process=p, f="txn", value=m)
           for i, (t, p, m) in enumerate(events)]
    return History(ops, assign_indices=False)


def bank_history(n_txns: int, n_procs: int = 5, n_accounts: int = 8,
                 initial: int = 10, max_transfer: int = 5,
                 read_p: float = 0.5, seed: int = 0) -> History:
    """A valid concurrent bank history: transfers apply atomically to
    true balances at completion, reads snapshot them. Total balance is
    conserved by construction. BASELINE config 4 fodder."""
    rng = random.Random(seed)
    balances = {a: initial for a in range(n_accounts)}
    events: list = []
    open_t: dict[int, tuple] = {}
    t_count = 0
    while t_count < n_txns or open_t:
        idle = n_procs - len(open_t)
        if t_count < n_txns and idle and (rng.random() < 0.6
                                          or not open_t):
            p = rng.choice([q for q in range(n_procs)
                            if q not in open_t])
            if rng.random() < read_p:
                o = ("read", None)
            else:
                frm, to = rng.sample(range(n_accounts), 2)
                o = ("transfer", {"from": frm, "to": to,
                                  "amount": rng.randint(1, max_transfer)})
            events.append(("invoke", p, o[0], o[1]))
            open_t[p] = o
            t_count += 1
        else:
            p = rng.choice(list(open_t))
            f, v = open_t.pop(p)
            if f == "transfer":
                amt = v["amount"]
                if balances[v["from"]] >= amt:
                    balances[v["from"]] -= amt
                    balances[v["to"]] += amt
                    events.append(("ok", p, f, v))
                else:
                    events.append(("fail", p, f, v))
            else:
                events.append(("ok", p, f, dict(balances)))
    ops = [op(index=i, time=i, type=t, process=p, f=f, value=v)
           for i, (t, p, f, v) in enumerate(events)]
    return History(ops, assign_indices=False)


def rw_register_history(n_txns: int, n_procs: int = 5,
                        n_keys: int = 32, max_len: int = 4,
                        seed: int = 0) -> History:
    """A valid concurrent rw-register txn history: writes apply to true
    registers at completion, reads snapshot them, every written value
    unique (elle's rw-register generator guarantee). BASELINE config 3
    fodder alongside list_append_history."""
    rng = random.Random(seed)
    regs: dict = {}
    events: list = []
    open_t: dict[int, list] = {}
    nv = 1
    t_count = 0
    while t_count < n_txns or open_t:
        idle = n_procs - len(open_t)
        if t_count < n_txns and idle and (rng.random() < 0.6
                                          or not open_t):
            p = rng.choice([q for q in range(n_procs)
                            if q not in open_t])
            txn = []
            for _ in range(rng.randint(1, max_len)):
                k = f"k{rng.randrange(n_keys)}"
                if rng.random() < 0.5:
                    txn.append(["w", k, nv])
                    nv += 1
                else:
                    txn.append(["r", k, None])
            events.append(("invoke", p, txn))
            open_t[p] = txn
            t_count += 1
        else:
            p = rng.choice(list(open_t))
            txn = open_t.pop(p)
            res = []
            for f, k, v in txn:
                if f == "w":
                    regs[k] = v
                    res.append(["w", k, v])
                else:
                    res.append(["r", k, regs.get(k)])
            events.append(("ok", p, res))
    ops = [op(index=i, time=i, type=t, process=p, f="txn", value=m)
           for i, (t, p, m) in enumerate(events)]
    return History(ops, assign_indices=False)


def corrupt_list_append_history(hist: History, at_frac: float = 0.85
                                ) -> tuple[History, int]:
    """A copy of a list-append history with one committed read damaged:
    the first ok txn at or after `at_frac` of the events that holds a
    read of two or more elements has the last two elements of that read
    swapped. The read then contradicts the version order, which the elle
    checkers report as incompatible-order and as a cycle. Returns (the
    history, the index of the damaged op)."""
    events = list(hist)
    for i in range(int(len(events) * at_frac), len(events)):
        e = events[i]
        if e.type != "ok" or e.f != "txn":
            continue
        mops = [list(m) for m in e.value]
        for m in mops:
            if m[0] == "r" and m[2] is not None and len(m[2]) >= 2:
                m[2] = list(m[2])
                m[2][-2], m[2][-1] = m[2][-1], m[2][-2]
                events[i] = e.copy(value=mops)
                return History(events, assign_indices=False), i
    raise ValueError("no ok read of two or more elements at/after "
                     "at_frac to corrupt")


def corrupt_rw_register_history(hist: History, at_frac: float = 0.85
                                ) -> tuple[History, int]:
    """A copy of an rw-register history with one committed read damaged:
    the first ok txn at or after `at_frac` of the events with a read of
    a key that some later op writes has that read replaced by the later
    write's value. The txn then observes the future, which the elle
    checkers report as a dependency cycle. Returns (the history, the
    index of the damaged op)."""
    events = list(hist)
    for i in range(int(len(events) * at_frac), len(events)):
        e = events[i]
        if e.type != "ok" or e.f != "txn":
            continue
        for j, m in enumerate(e.value):
            if m[0] != "r" or m[2] is None:
                continue
            future = next((w[2] for later in events[i + 1:]
                           if later.type == "ok" and later.f == "txn"
                           for w in later.value
                           if w[0] == "w" and w[1] == m[1]), None)
            if future is not None:
                mops = [list(x) for x in e.value]
                mops[j][2] = future
                events[i] = e.copy(value=mops)
                return History(events, assign_indices=False), i
    raise ValueError("no ok read at/after at_frac with a later write of "
                     "its key")
