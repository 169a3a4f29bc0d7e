"""Unique-ID workload: every acknowledged generate must return a
globally unique id.

Capability reference: jepsen/src/jepsen/checker.clj unique-ids
(710-747).

The port's copy of jepsen_tpu/workloads/unique_ids.py; checked by the
port's checker.unique_ids on the host. No kernel runs.
"""

from __future__ import annotations

from .. import checker as chk
from .. import generator as gen


def workload(opts: dict | None = None) -> dict:
    o = dict(opts or {})
    n = o.get("ops", 300)
    return {
        "generator": gen.limit(n, lambda: {"f": "generate",
                                           "value": None}),
        "checker": chk.unique_ids(),
    }
