"""Adya anomaly probes: G2 (anti-dependency cycles through predicate
reads).

Capability reference: jepsen/src/jepsen/tests/adya.clj — g2-gen emits,
per concurrent unique key, exactly two :insert ops [key [a-id b-id]]
(one with a-id, one with b-id); clients run predicate reads over two
tables and insert only if both come back empty, so under
serializability at most one insert per key can commit (11-57);
g2-checker counts successful inserts per key and flags keys with more
than one (59-86).

The port's copy of jepsen_tpu/workloads/adya.py; a host checker. No
kernel runs.
"""

from __future__ import annotations

import itertools

from .. import checker as chk
from .. import independent
from ..checker import _Fn


def g2_gen(keys=None):
    """Two racing inserts per key: [k [None b]] and [k [a None]]
    (adya.clj g2-gen, 11-57). keys must be finite (the reference's
    infinite (range) relies on an outer time-limit; our concurrent
    generator materializes the key sequence)."""
    ids = itertools.count(1)
    keys = list(keys) if keys is not None else list(range(1, 65))

    def per_key(k):
        return [{"type": "invoke", "f": "insert",
                 "value": [None, next(ids)]},
                {"type": "invoke", "f": "insert",
                 "value": [next(ids), None]}]

    return independent.concurrent_generator(2, keys, per_key)


def g2_checker() -> chk.Checker:
    """At most one successful insert per key (adya.clj g2-checker,
    59-86)."""

    def run(test, hist, opts):
        keys: dict = {}
        for op in hist:
            if op.f != "insert" or op.type == "invoke":
                continue
            k = independent.key_(op.value)
            keys.setdefault(k, 0)
            if op.type == "ok":
                keys[k] += 1
        illegal = {k: n for k, n in sorted(keys.items(), key=str)
                   if n > 1}
        insert_count = sum(1 for n in keys.values() if n > 0)
        return {
            "valid?": not illegal,
            "key-count": len(keys),
            "legal-count": insert_count - len(illegal),
            "illegal-count": len(illegal),
            "illegal": illegal,
        }

    return _Fn(run)


def workload(opts: dict | None = None) -> dict:
    o = dict(opts or {})
    keys = o.get("keys", list(range(1, o.get("key-count", 16) + 1)))
    return {
        "generator": g2_gen(keys),
        "checker": g2_checker(),
    }
