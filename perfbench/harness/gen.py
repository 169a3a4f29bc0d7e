"""The benchmark's history generator: a frozen copy of the port's CAS
register generator and its corruption (jepsen_tpu_torch/gpu/synth.py,
`register_history` and `corrupt_register_history`), kept here so that a
later change to the program cannot change the benchmark's inputs.

Histories are plain lists of event tuples `(type, process, f, value)`;
an event's index and time are its position. The harness turns them into
the port's `History` for the timed side and hands the same tuples to the
reference. Beside the events the generator returns its witness: the
positions of the invocations in the order the generator applied them to
the true register, which is a linearization of the history by
construction.

A test (tests/test_perfbench_gen.py) holds the copy against the port's
generator op for op at small sizes.
"""

from __future__ import annotations

import random


def register_history(n_ops: int, n_procs: int = 5, seed: int = 0,
                     crash_p: float = 0.0, n_values: int = 5,
                     cas_p: float = 0.25, read_p: float = 0.4
                     ) -> tuple[list, list]:
    """(events, witness) of a valid CAS-register history with `n_ops`
    invocations, about 2 * n_ops events. The initial value is None.
    Each op takes effect at a random instant inside its window; with
    `crash_p` a completion is recorded as `info` (the op did take
    effect)."""
    rng = random.Random(seed)
    value = None
    events: list = []
    witness: list = []
    # process -> [f, v, applied?, result, invocation position]
    open_ops: dict[int, list] = {}
    budget = n_ops
    append = events.append
    while budget > 0 or open_ops:
        idle = n_procs - len(open_ops)
        unapplied = [p for p, o in open_ops.items() if not o[2]]
        applied = [p for p, o in open_ops.items() if o[2]]
        r = rng.random()
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
            open_ops[p] = [f, v, False, None, len(events)]
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
            if not (f == "cas" and o[3] == "fail"):
                witness.append(o[4])
        elif applied:
            p = rng.choice(applied)
            f, v, _, result, _inv = open_ops.pop(p)
            if crash_p and rng.random() < crash_p:
                append(("info", p, f, v))
            elif f == "read":
                append(("ok", p, f, result))
            elif f == "write":
                append(("ok", p, f, v))
            else:
                append(("ok" if result == "ok" else "fail", p, f, v))
    return events, witness


def corrupt_register_history(events: list, at_frac: float = 0.85,
                             bogus: int | None = None) -> tuple[list, int]:
    """A copy of `events` with one linearizability anomaly: the first ok
    read at or after `at_frac` of the history returns `bogus` (default:
    one past the largest int value anywhere in the history, so no op
    ever writes it). Returns (events, position of the bad read)."""
    events = list(events)
    if bogus is None:
        seen = [e[3] for e in events if isinstance(e[3], int)]
        seen += [v for e in events if isinstance(e[3], (list, tuple))
                 for v in e[3] if isinstance(v, int)]
        bogus = max(seen, default=98) + 1
    for i in range(int(len(events) * at_frac), len(events)):
        t, p, f, _v = events[i]
        if t == "ok" and f == "read":
            events[i] = (t, p, f, bogus)
            return events, i
    raise ValueError("no ok read at/after at_frac to corrupt")


def fold_keys(hists: list[list]) -> tuple[list, list]:
    """One multi-key history out of single-key ones, as a Jepsen run of
    independent keys records them: key k's events get values (k, v) and
    process ids k * 1000 + p, and the events merge by (position in their
    own history, key). Returns (events, positions), where positions[k][i]
    is the folded position of key k's event i."""
    order = sorted((i, k) for k, h in enumerate(hists)
                   for i in range(len(h)))
    events = []
    positions = [[0] * len(h) for h in hists]
    for pos, (i, k) in enumerate(order):
        t, p, f, v = hists[k][i]
        events.append((t, k * 1000 + p, f, (k, v)))
        positions[k][i] = pos
    return events, positions


def relabelings(seed: int, n_values: int, n_procs: int):
    """(value permutation, process map) pairs drawn from `seed`, one
    after another: each maps the n_procs process numbers to distinct
    numbers under 1,000 (as Jepsen's process ids grow when a client is
    replaced), and no two maps are the same, so no two histories of a
    run have the same process ids."""
    rng = random.Random(f"pool:{seed}")
    seen: set = set()
    while True:
        pp = rng.sample(range(1000), n_procs)
        if tuple(pp) in seen:
            continue
        seen.add(tuple(pp))
        yield rng.sample(range(n_values), n_values), pp


def relabel_value(v, perm):
    """`v` with every register value in range of `perm` mapped through
    it: None, and values outside the permutation (a corruption's bogus
    value), stay as they are."""
    if isinstance(v, list):
        return [relabel_value(x, perm) for x in v]
    if isinstance(v, int) and 0 <= v < len(perm):
        return perm[v]
    return v


def relabel(events: list, vperm: list, pperm: list) -> list:
    """`events` with the register values permuted by `vperm` and each
    process id's own process number (its value mod 1000) mapped through
    `pperm` (distinct numbers under 1,000), the key of an independent
    (key, value) pair kept. The relabelled history has the same
    structure, verdict and anomaly as the original."""
    out = []
    for t, p, f, v in events:
        if isinstance(v, tuple):
            v = (v[0], relabel_value(v[1], vperm))
        else:
            v = relabel_value(v, vperm)
        out.append((t, p - p % 1000 + pperm[p % 1000], f, v))
    return out
