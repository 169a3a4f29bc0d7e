"""Causal consistency workload: a per-key causal order of reads and
writes that every site must observe in issue order.

Capability reference: jepsen/src/jepsen/tests/causal.clj — its own tiny
Model protocol with a CausalRegister (value, counter, last-pos) whose
step enforces position links and counter-sequenced writes (10-81), a
checker folding :ok ops through the model (87-108), the ri/cw1/r/cw2
generators (111-115), and the independent-keyed test bundle (117-131).

The port's copy of jepsen_tpu/workloads/causal.py; its CausalRegister
steps into the port's checker/models Inconsistent. No kernel runs.
"""

from __future__ import annotations

from .. import checker as chk
from .. import independent
from ..checker import _Fn
# one Inconsistent type across model layers, so is_inconsistent checks
# agree wherever a causal model flows (round-3 review finding)
from ..checker.models import (Inconsistent, inconsistent,  # noqa: F401
                              is_inconsistent)


class CausalRegister:
    """Register whose writes are counter-sequenced and whose ops carry
    position/link causality tokens (causal.clj CausalRegister,
    32-81)."""

    __slots__ = ("value", "counter", "last_pos")

    def __init__(self, value=0, counter=0, last_pos=None):
        self.value = value
        self.counter = counter
        self.last_pos = last_pos

    def step(self, op):
        c = self.counter + 1
        v = op.value
        pos = op.get("position")
        link = op.get("link")
        if not (link == "init" or link == self.last_pos):
            return inconsistent(
                f"Cannot link {link!r} to last-seen position "
                f"{self.last_pos!r}")
        if op.f == "write":
            if v == c:
                return CausalRegister(v, c, pos)
            return inconsistent(
                f"expected value {c} attempting to write {v} instead")
        if op.f == "read-init":
            if self.counter == 0 and v not in (None, 0):
                return inconsistent(f"expected init value 0, read {v}")
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return inconsistent(
                f"can't read {v} from register {self.value}")
        if op.f == "read":
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return inconsistent(
                f"can't read {v} from register {self.value}")
        return inconsistent(f"unknown f {op.f!r}")


def causal_register() -> CausalRegister:
    return CausalRegister(0, 0, None)


def check(model=None) -> chk.Checker:
    """Folds :ok ops through the causal model (causal.clj check,
    87-108)."""
    model = model if model is not None else causal_register()

    def run(test, hist, opts):
        s = model
        for op in hist:
            if op.type != "ok":
                continue
            s = s.step(op)
            if is_inconsistent(s):
                return {"valid?": False, "error": s.msg}
        return {"valid?": True, "model": s}

    return _Fn(run)


def ri(*_):
    return {"type": "invoke", "f": "read-init"}


def r(*_):
    return {"type": "invoke", "f": "read"}


def cw1(*_):
    return {"type": "invoke", "f": "write", "value": 1}


def cw2(*_):
    return {"type": "invoke", "f": "write", "value": 2}


def workload(opts: dict | None = None) -> dict:
    """One causal order (ri w1 r w2 r) per key, checked per key
    (causal.clj test, 117-131)."""
    from .. import generator as gen

    o = dict(opts or {})
    keys = o.get("keys", list(range(o.get("key-count", 8))))
    # one-shot dict elements: the reference's [ri cw1 r cw2 r] fn
    # vector relies on an outer time-limit to stop its infinite fn
    # generators; the five-op causal order itself is the point
    g = independent.sequential_generator(
        keys, lambda k: [ri(), cw1(), r(), cw2(), r()])
    return {
        "generator": gen.stagger(o.get("stagger", 0.01), g),
        "checker": independent.checker(check(causal_register())),
    }
