"""Sequential data-type models for linearizability checking (the
port's copy of jepsen_tpu/checker/models.py).

Capability reference: the knossos.model namespace as consumed by the
reference's checkers and suites (checker.clj:202-233 passes models into
knossos; suite usage e.g. cockroachdb/src/jepsen/cockroach/register.clj;
an in-repo mirror of the protocol shape is tests/causal.clj:10-29).

A model is an immutable value with step(op) -> next model, or an
Inconsistent value if the op can't be applied. Models also compile to
dense transition tables for the device checker (gpu/encode.py).
"""

from __future__ import annotations

from ..history import Op


class Inconsistent:
    __slots__ = ("msg",)

    def __init__(self, msg):
        self.msg = msg

    def __repr__(self):
        return f"Inconsistent<{self.msg}>"


def inconsistent(msg) -> Inconsistent:
    return Inconsistent(msg)


def is_inconsistent(m) -> bool:
    return isinstance(m, Inconsistent)


def _hfreeze(v):
    """Hashable view of a model state value: ops may carry lists/dicts
    (e.g. a list written into a Register), and model states built from
    them must still hash for search-state dedup."""
    if isinstance(v, (list, tuple)):
        return tuple(_hfreeze(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return frozenset(_hfreeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted(((k, _hfreeze(x)) for k, x in v.items()),
                            key=repr))
    return v


class Model:
    """A sequential datatype: step(op) -> next model | Inconsistent.

    Contract for the device checker: step() must depend ONLY on op.f and
    op.value — the transition tables (gpu/encode.py) key distinct
    ops by (f, value). A model that consults op.process/op.ext must set
    `tabulable = False`, which routes checking to the object-model host
    search instead of the device kernels."""

    tabulable = True

    def step(self, op: Op):
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(
            (k, _hfreeze(v))
            for k, v in sorted(self.__dict__.items()))))


class NoOp(Model):
    """Every op succeeds and does nothing."""

    def step(self, op):
        return self


class Register(Model):
    """A read/write register."""

    def __init__(self, value=None):
        self.value = value

    def step(self, op):
        if op.f == "write":
            return Register(op.value)
        if op.f == "read":
            if op.value is None or op.value == self.value:
                return self
            return inconsistent(
                f"read {op.value!r} but expected {self.value!r}")
        return inconsistent(f"unknown f {op.f!r}")

    def __repr__(self):
        return f"Register<{self.value!r}>"


class CASRegister(Model):
    """A register supporting read/write/cas, the canonical Jepsen
    linearizable-register model."""

    def __init__(self, value=None):
        self.value = value

    def step(self, op):
        f = op.f
        if f == "write":
            return CASRegister(op.value)
        if f == "cas":
            if op.value is None:
                return inconsistent("nil cas value")
            cur, new = op.value
            if cur == self.value:
                return CASRegister(new)
            return inconsistent(f"can't CAS {self.value!r} from {cur!r}")
        if f == "read":
            if op.value is None or op.value == self.value:
                return self
            return inconsistent(
                f"can't read {op.value!r} from register {self.value!r}")
        return inconsistent(f"unknown f {f!r}")

    def __repr__(self):
        return f"CASRegister<{self.value!r}>"


class Mutex(Model):
    """A lock: acquire/release."""

    def __init__(self, locked=False):
        self.locked = locked

    def step(self, op):
        if op.f == "acquire":
            if self.locked:
                return inconsistent("already held")
            return Mutex(True)
        if op.f == "release":
            if not self.locked:
                return inconsistent("not held")
            return Mutex(False)
        return inconsistent(f"unknown f {op.f!r}")


class UnorderedQueue(Model):
    """A queue where dequeue may return any enqueued element."""

    def __init__(self, pending: frozenset = frozenset()):
        self.pending = pending

    def step(self, op):
        if op.f == "enqueue":
            return UnorderedQueue(self.pending | {op.value})
        if op.f == "dequeue":
            if op.value in self.pending:
                return UnorderedQueue(self.pending - {op.value})
            return inconsistent(
                f"can't dequeue {op.value!r}: not in queue")
        return inconsistent(f"unknown f {op.f!r}")


class FIFOQueue(Model):
    """A strictly-ordered queue."""

    def __init__(self, pending: tuple = ()):
        self.pending = pending

    def step(self, op):
        if op.f == "enqueue":
            return FIFOQueue(self.pending + (op.value,))
        if op.f == "dequeue":
            if not self.pending:
                return inconsistent("can't dequeue from empty queue")
            if self.pending[0] != op.value:
                return inconsistent(
                    f"dequeued {op.value!r} but head was "
                    f"{self.pending[0]!r}")
            return FIFOQueue(self.pending[1:])
        return inconsistent(f"unknown f {op.f!r}")


class GSet(Model):
    """A grow-only set with add/read."""

    def __init__(self, elements: frozenset = frozenset()):
        self.elements = elements

    def step(self, op):
        if op.f == "add":
            return GSet(self.elements | {op.value})
        if op.f == "read":
            if op.value is None or set(op.value) == set(self.elements):
                return self
            return inconsistent(
                f"read {op.value!r} but expected {sorted(self.elements)!r}")
        return inconsistent(f"unknown f {op.f!r}")


def register(value=None) -> Register:
    return Register(value)


def cas_register(value=None) -> CASRegister:
    return CASRegister(value)


def mutex() -> Mutex:
    return Mutex(False)


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue()


def fifo_queue() -> FIFOQueue:
    return FIFOQueue()


def step(model, op):
    """Steps a model, passing Inconsistent through unchanged."""
    if is_inconsistent(model):
        return model
    return model.step(op)
