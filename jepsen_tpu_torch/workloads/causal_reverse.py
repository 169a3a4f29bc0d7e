"""Strict-serializability anomaly probe: T1 < T2 but T2 is visible
without T1.

Capability reference: jepsen/src/jepsen/tests/causal_reverse.clj —
concurrent blind writes per key plus transactional reads; `graph`
replays the history collecting, for each write w, the set of writes
acknowledged before w's invocation (22-48); `errors` flags reads that
see w but miss an acknowledged predecessor (50-78); checker (80-89)
and the independent-keyed workload (91-120).

The port's copy of jepsen_tpu/workloads/causal_reverse.py; a host
checker. No kernel runs.
"""

from __future__ import annotations

from .. import checker as chk
from .. import independent
from ..checker import _Fn


def graph(hist) -> dict:
    """value -> frozenset of writes acknowledged before its invocation
    (first-order write precedence, causal_reverse.clj:22-48)."""
    completed: set = set()
    expected: dict = {}
    for op in hist:
        if op.f != "write":
            continue
        if op.type == "invoke":
            expected[op.value] = frozenset(completed)
        elif op.type == "ok":
            completed.add(op.value)
    return expected


def errors(hist, expected: dict) -> list:
    """Reads that observe a write but miss one of its acknowledged
    predecessors (causal_reverse.clj:50-78)."""
    errs = []
    for op in hist:
        if op.f != "read" or op.type != "ok":
            continue
        seen = set(op.value or [])
        our_expected: set = set()
        for v in seen:
            our_expected |= expected.get(v, frozenset())
        missing = our_expected - seen
        if missing:
            errs.append({"op": op, "missing": sorted(missing, key=str),
                         "expected-count": len(our_expected)})
    return errs


def checker() -> chk.Checker:
    def run(test, hist, opts):
        expected = graph(hist)
        errs = errors(hist, expected)
        return {"valid?": not errs, "errors": errs[:8],
                "error-count": len(errs)}

    return _Fn(run)


def workload(opts: dict | None = None) -> dict:
    """Concurrent writes + reads per key (causal_reverse.clj:91-120)."""
    from .. import generator as gen

    o = dict(opts or {})
    keys = o.get("keys", list(range(o.get("key-count", 4))))
    per_key = o.get("per-key-limit", 100)

    def key_gen(k):
        writes = ({"f": "write", "value": x} for x in range(10 ** 6))
        return gen.limit(per_key, gen.stagger(
            0.01, gen.mix([gen.repeat({"f": "read", "value": None}),
                           writes])))

    return {
        "generator": independent.concurrent_generator(
            o.get("group-size", 2), keys, key_gen),
        "checker": chk.compose(
            {"sequential": independent.checker(checker()),
             "stats": chk.stats()}),
    }
