"""Set workloads: unique adds followed by reads.

Capability reference: jepsen/src/jepsen/checker.clj set (257-317) and
set-full (320-612); generator shape from doc/tutorial/08 (adds of
monotonically increasing elements, final read).

The port's copy of jepsen_tpu/workloads/sets.py; the port's set and set-
full checkers on the host. No kernel runs.
"""

from __future__ import annotations

import itertools

from .. import checker as chk
from .. import generator as gen


def adds():
    """add ops with unique ascending elements."""
    counter = itertools.count()
    return lambda: {"f": "add", "value": next(counter)}


def reads():
    return lambda: {"f": "read", "value": None}


def workload(opts: dict | None = None) -> dict:
    """Adds throughout; one final read checked by the basic set checker."""
    o = dict(opts or {})
    n = o.get("ops", 200)
    return {
        "generator": gen.phases(gen.limit(n, adds()),
                                gen.once(reads())),
        "checker": chk.set_checker(),
    }


def full_workload(opts: dict | None = None) -> dict:
    """Continuous adds + reads checked by the rigorous per-element
    lifecycle analysis (set-full)."""
    o = dict(opts or {})
    n = o.get("ops", 300)
    a = adds()
    rd = reads()
    return {
        "generator": gen.limit(
            n, gen.mix([a, rd])),
        "checker": chk.set_full({"linearizable?":
                                 o.get("linearizable?", False)}),
    }
