"""Lost-updates probe: per-key sets grown by version-guarded
read-modify-write; after quiescence a final read per key must contain
every acknowledged add.

Capability reference: crate/src/jepsen/crate/lost_updates.clj — client
(33-100: add = select elements+_version, write back the extended list
guarded by _version, 0 rows -> fail / 1 -> ok / else info; read =
final set), test (109-146: independent keys, adds under a partition
nemesis, quiescence sleep, then per-thread final reads, checked by
independent set checkers).

The checker IS the set checker — what this workload contributes is the
op contract exercising optimistic-concurrency version guards:
  {"f": "add", "value": (k, v)} -> ok iff the guarded update applied
  {"f": "read", "value": (k, None)} -> ok with value (k, [elements])

The port's copy of jepsen_tpu/workloads/lost_updates.py; independent set
checkers on the host. No kernel runs.
"""

from __future__ import annotations

import itertools

from .. import checker as chk
from .. import generator as gen
from .. import independent


def workload(opts: dict | None = None) -> dict:
    o = dict(opts or {})
    keys = o.get("keys", list(range(o.get("key_count", 4))))
    n_group = o.get("group-size", o.get("group_size", 5))
    ops_per_key = o.get("ops_per_key", 100)

    def key_gen(k):
        counter = itertools.count()
        adds = gen.limit(ops_per_key,
                         lambda: {"f": "add", "value": next(counter)})
        final = gen.each_thread(gen.once(
            lambda: {"f": "read", "value": None}))
        return gen.phases(gen.stagger(o.get("stagger", 0.001), adds),
                          final)

    return {
        "generator": independent.concurrent_generator(
            n_group, keys, key_gen),
        "checker": independent.checker(chk.set_checker()),
    }
