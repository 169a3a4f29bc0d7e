"""Counter workload: concurrent increments + reads; every read must lie
between acknowledged and attempted sums.

Capability reference: jepsen/src/jepsen/checker.clj counter (749-819);
generator shape from suite counter tests (aerospike/cockroach).

The port's copy of jepsen_tpu/workloads/counter.py; checked by the
port's checker.counter on the host. No kernel runs.
"""

from __future__ import annotations

import random

from .. import checker as chk
from .. import generator as gen


def workload(opts: dict | None = None) -> dict:
    o = dict(opts or {})
    n = o.get("ops", 300)
    rng = random.Random(o.get("seed"))

    def add():
        return {"f": "add", "value": rng.randint(1, 5)}

    def read():
        return {"f": "read", "value": None}

    return {
        "generator": gen.limit(n, gen.mix([add, add, read])),
        "checker": chk.counter(),
    }
