"""Synthetic histories for benchmarks and compile checks: the CAS
register generators of jepsen_tpu/tpu/synth.py, copied so the port's
seeded inputs match the JAX package's op for op.

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
