"""Read-write register transactional workload (elle rw-register), the port's
copy of jepsen_tpu/workloads/txn_wr.py. opts reach the checker whole:
opts["device"] picks the card (None, the default) or "cpu".

Capability reference: jepsen/src/jepsen/tests/cycle/wr.clj.
"""

from __future__ import annotations

from .. import generator as gen
from ..checker import cycle


def workload(opts: dict | None = None) -> dict:
    o = dict(opts or {})
    g = cycle.wr_gen(
        key_count=o.get("key-count", 3),
        min_txn_length=o.get("min-txn-length", 1),
        max_txn_length=o.get("max-txn-length", 4),
        max_writes_per_key=o.get("max-writes-per-key", 32),
        seed=o.get("seed"))
    out = {"generator": (lambda: next(g)),
           "checker": cycle.wr_checker(o)}
    if o.get("ops"):
        out["generator"] = gen.limit(o["ops"], out["generator"])
    return out
