"""Multi-register monotonicity workload: increment-only registers,
each written by a single dedicated worker (blind writes — no OCC read
locks), read in random subsets with a database timestamp. Two
checkers: timestamp-order (replay reads in ts order, values must never
run backwards) and read-skew (the per-key value orders must be
mutually compatible — no cycles).

Capability reference: faunadb/src/jepsen/faunadb/multimonotonic.clj —
client (76-107: write = blind upserts of {k: v}, read = subset query
returning {ts, registers}), nonmonotonic-states (180-241: fold reads
in ts order tracking max-seen per key; any key running backwards is an
error with both observations), ts-order-checker (253-270),
read-skew-checker (272-316: the reference documents the SCC
formulation but left its body a stub returning valid? true — here it
is actually implemented, via the elle engine's host SCC), generator
(318-340: per-thread keys from process ids, reads over random
non-empty subsets of active keys).

Client contract:
  {"f": "write", "value": {k: v}} -> ok (blind upsert of each k to v)
  {"f": "read", "value": [k...]} -> ok with value
      {"ts": <comparable>, "registers": {k: v, ...}}  (absent keys
      omitted)

The port's copy of jepsen_tpu/workloads/multimonotonic.py; read skew
takes the scipy SCC of the port's gpu/elle.py. No kernel runs.
"""

from __future__ import annotations

from .. import checker as chk
from .. import generator as gen


def _observation(op, k):
    v = op.value
    return {"read-ts": v.get("ts"),
            "value": v["registers"].get(k),
            "op-index": op.index}


def nonmonotonic_states(reads: list) -> list:
    """multimonotonic.clj nonmonotonic-states (180-241): fold reads
    (already ordered) keeping the highest observation per key; flag
    any read whose value for a key is lower than the inferred floor."""
    inferred: dict = {}
    errors = []
    for op in reads:
        state = op.value.get("registers", {})
        bad = {}
        for k, v in state.items():
            prev = inferred.get(k)
            if prev is not None and v < prev["value"]:
                bad[k] = [prev, _observation(op, k)]
        if bad:
            errors.append({
                "inferred": {k: inferred[k]["value"]
                             for k in state if k in inferred},
                "observed": dict(state),
                "op-index": op.index,
                "errors": bad,
            })
        for k, v in state.items():
            prev = inferred.get(k)
            if prev is None or v > prev["value"]:
                inferred[k] = _observation(op, k)
    return errors


def _ok_ts_reads(hist) -> list:
    reads = [o for o in hist
             if o.type == "ok" and o.f == "read"
             and isinstance(o.value, dict)
             and o.value.get("ts") is not None]
    reads.sort(key=lambda o: o.value["ts"])
    return reads


def check_ts_order(hist) -> dict:
    """ts-order-checker (253-270): in timestamp order, increment-only
    registers must never run backwards."""
    errs = nonmonotonic_states(_ok_ts_reads(hist))
    return {"valid?": not errs, "errors": errs[:8],
            "error-count": len(errs)}


def check_read_skew(hist) -> dict:
    """read-skew-checker (272-316), actually implemented: each key's
    increment-only order gives edges between read-states (state with
    k=v points at the next-higher observed v); a cycle in the union
    graph is a read skew — two reads that each saw the other's
    'past'."""
    from ..gpu.elle import _find_cycle, _sccs

    reads = [o for o in hist
             if o.type == "ok" and o.f == "read"
             and isinstance(o.value, dict)]
    by_key: dict = {}  # k -> {v: [read index]}
    for i, op in enumerate(reads):
        for k, v in op.value.get("registers", {}).items():
            by_key.setdefault(k, {}).setdefault(v, []).append(i)
    edges = []
    for k, versions in by_key.items():
        ordered = sorted(versions)
        for a, b in zip(ordered, ordered[1:]):
            for i in versions[a]:
                for j in versions[b]:
                    if i != j:
                        edges.append((i, j, k))
    cycles = []
    for scc in _sccs(len(reads), edges):
        if len(scc) > 1:
            cyc = _find_cycle(scc, edges)
            cycles.append([{"op-index": reads[i].index,
                            "key": key,
                            "registers": reads[i].value["registers"]}
                           for i, _, key in cyc])
    return {"valid?": not cycles, "cycles": cycles[:4],
            "cycle-count": len(cycles)}


def ts_order_checker() -> chk.Checker:
    return chk.checker(lambda test, hist, opts: check_ts_order(hist))


def read_skew_checker() -> chk.Checker:
    return chk.checker(lambda test, hist, opts: check_read_skew(hist))


class _WriteGen(gen.Generator):
    """Each thread owns the key named after its thread index and
    blind-writes 0,1,2,...: single-writer increment-only registers
    with no shared state (multimonotonic.clj generator, 318-340).
    Functional: the per-thread counters ride in the successor. Keys
    are strings so histories survive the JSON store round trip."""

    def __init__(self, counts=()):
        self.counts = tuple(counts)  # (key, next_v) pairs

    def op(self, test, ctx):
        m = gen.fill_in_op({"f": "write", "value": None}, ctx)
        if m is gen.PENDING:
            return gen.PENDING, self
        # the key belongs to whichever thread the op landed on
        k = str(ctx.process_to_thread_name(m.process))
        d = dict(self.counts)
        v = d.get(k, 0)
        d[k] = v + 1
        return m.copy(value={k: v}), _WriteGen(tuple(sorted(d.items())))

    def update(self, test, ctx, event):
        return self


def workload(opts: dict | None = None) -> dict:
    o = dict(opts or {})
    n = o.get("ops", 400)

    def read():
        return {"f": "read", "value": None}

    # reads carry value None; the CLIENT chooses a random non-empty
    # subset of keys it has seen (reference: random-nonempty-subset of
    # active keys) — keeping the generator pure.
    half = max(o.get("writers", 2), 1)
    g = gen.reserve(half, _WriteGen(), gen.repeat(read))
    return {
        "generator": gen.limit(n, gen.stagger(
            o.get("stagger", 0.001), g)),
        "checker": chk.compose({
            "ts-order": ts_order_checker(),
            "read-skew": read_skew_checker(),
        }),
    }
