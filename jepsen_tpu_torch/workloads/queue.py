"""Queue workload: enqueues/dequeues with a final drain, checked for
conservation (what goes in must come out).

Capability reference: jepsen/src/jepsen/checker.clj total-queue
(648-708) + queue (235-255); drain expansion (614-646).

The port's copy of jepsen_tpu/workloads/queue.py; the port's total_queue
and queue checkers on the host. No kernel runs.
"""

from __future__ import annotations

import itertools

from .. import checker as chk
from .. import generator as gen
from ..checker import models


def workload(opts: dict | None = None) -> dict:
    o = dict(opts or {})
    n = o.get("ops", 200)
    counter = itertools.count()

    def enq():
        return {"f": "enqueue", "value": next(counter)}

    def deq():
        return {"f": "dequeue", "value": None}

    return {
        "generator": gen.phases(
            gen.limit(n, gen.mix([enq, deq])),
            gen.each_thread(gen.once(lambda: {"f": "drain",
                                              "value": None}))),
        "checker": chk.compose({
            "total-queue": chk.total_queue(),
            "stats": chk.stats()}),
    }


def fifo_workload(opts: dict | None = None) -> dict:
    o = dict(opts or {})
    n = o.get("ops", 200)
    counter = itertools.count()
    return {
        "generator": gen.limit(n, gen.mix(
            [lambda: {"f": "enqueue", "value": next(counter)},
             lambda: {"f": "dequeue", "value": None}])),
        "checker": chk.queue(models.unordered_queue()),
    }
