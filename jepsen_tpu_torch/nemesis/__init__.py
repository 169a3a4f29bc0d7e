"""Nemesis protocol: the half of jepsen_tpu/nemesis/core.py that the
interpreter's nemesis worker needs (the port's own copy).

Capability reference: jepsen/src/jepsen/nemesis.clj (Nemesis protocol
12-22, Validate 50-91). The fault nemeses (partitions, process and file
faults, clocks, the combined packages), composition and the coverage
taxonomy of fault activations come with the test lifecycle and are not
ported yet: `fault_kinds` declares no kind here.
"""

from __future__ import annotations

from .. import telemetry
from ..history import Op


class Nemesis:
    """Fault injector driven by generator ops on the :nemesis thread."""

    def setup(self, test) -> "Nemesis":
        return self

    def invoke(self, test, op: Op) -> Op:
        raise NotImplementedError

    def teardown(self, test) -> None:
        pass

    def fs(self) -> set:
        """The set of op :f values this nemesis handles (Reflection
        protocol, nemesis.clj:17-22)."""
        return set()

    def fault_kinds(self) -> dict:
        """{f: (fault-kind, phase)}: the coverage taxonomy tag of each op
        :f this nemesis speaks. Empty: the coverage registry is not
        ported."""
        return {}


class NoopNemesis(Nemesis):
    """Does nothing."""

    def invoke(self, test, op):
        return op


noop = NoopNemesis()


class InvalidNemesisCompletion(Exception):
    pass


class Validate(Nemesis):
    """Asserts nemesis protocol invariants (nemesis.clj:50-91), and gives
    each fault activation its telemetry span."""

    def __init__(self, nemesis: Nemesis):
        self.nemesis = nemesis

    def setup(self, test):
        with telemetry.span("nemesis:setup"):
            res = self.nemesis.setup(test)
        if not isinstance(res, Nemesis):
            raise InvalidNemesisCompletion(
                f"setup should return a Nemesis, got {res!r}")
        return Validate(res)

    def invoke(self, test, op):
        with telemetry.span(f"nemesis:{op.f}"):
            op2 = self.nemesis.invoke(test, op)
        if not isinstance(op2, Op):
            raise InvalidNemesisCompletion(
                f"invoke should return an Op, got {op2!r}")
        if op2.process != op.process:
            raise InvalidNemesisCompletion(
                f"process changed: {op!r} -> {op2!r}")
        return op2

    def teardown(self, test):
        with telemetry.span("nemesis:teardown"):
            self.nemesis.teardown(test)

    def fs(self):
        return self.nemesis.fs()

    def fault_kinds(self):
        return self.nemesis.fault_kinds()


def validate(nemesis: Nemesis) -> Validate:
    return Validate(nemesis)


# Functional façade
def setup(nemesis, test):
    return nemesis.setup(test)


def invoke(nemesis, test, op):
    return nemesis.invoke(test, op)


def teardown(nemesis, test):
    return nemesis.teardown(test)
