"""Nemesis protocol, validation, composition, and partition grudge math
(the port's copy of jepsen_tpu/nemesis/core.py).

Capability reference: jepsen/src/jepsen/nemesis.clj (Nemesis protocol
12-22, Validate 50-91, grudges 121-277, compose/f-map 286-430). Network
application of grudges lives in the net module; this module computes
*which* links to cut, as pure functions over node lists.
"""

from __future__ import annotations

import random
import threading
from typing import Callable

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
        """{f: (fault-kind, phase)} — the structured coverage taxonomy
        tag for each op :f this nemesis speaks. phase is 'begin'/'end'
        (window-bounding ops like start-partition/stop-partition) or
        'pulse' (point faults like bitflip). The default derives from
        fs() via the shared registry (coverage.F_KINDS), so
        nemeses speaking the standard fs are covered automatically;
        override to declare custom kinds."""
        from .. import coverage

        return coverage.default_kinds(self.fs())


class NoopNemesis(Nemesis):
    """Does nothing."""

    def invoke(self, test, op):
        return op


noop = NoopNemesis()


class InvalidNemesisCompletion(Exception):
    pass


class Validate(Nemesis):
    """Asserts nemesis protocol invariants (nemesis.clj:50-91). Every
    nemesis call passes through here (core.run_case wraps the test's
    nemesis in validate()), so this is also where fault activations
    get their telemetry spans."""

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
        with telemetry.span(f"nemesis:{op.f}") as span_rec:
            op2 = self.nemesis.invoke(test, op)
        if not isinstance(op2, Op):
            raise InvalidNemesisCompletion(
                f"invoke should return an Op, got {op2!r}")
        if op2.process != op.process:
            raise InvalidNemesisCompletion(
                f"process changed: {op!r} -> {op2!r}")
        # coverage taxonomy: every fault activation that completed is
        # recorded with its nemesis-declared kind + the span's window
        # (coverage.py; fs without a kind — observational ops
        # like check-offsets — are not faults and stay unrecorded)
        try:
            got = self.nemesis.fault_kinds().get(op.f)
            if got is not None and span_rec is not None:
                from .. import coverage

                kind, phase = got
                coverage.record_fault(kind, op.f, phase,
                                      span_rec["t0"], span_rec["t1"])
        except Exception:  # noqa: BLE001 — coverage is best-effort
            import logging

            logging.getLogger(__name__).exception(
                "recording fault coverage failed")
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


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

class Compose(Nemesis):
    """Routes ops to sub-nemeses by :f (nemesis.clj:286-430).

    Holds (fspec, nemesis) pairs where fspec is either a set of fs
    (forwarded unchanged) or a dict {outer-f: inner-f} (the op's :f is
    rewritten to the inner name on the way in and restored on the way
    out)."""

    def __init__(self, pairs: list):
        self.pairs = list(pairs)

    def _route(self, f):
        for fspec, nem in self.pairs:
            if isinstance(fspec, dict):
                if f in fspec:
                    return fspec[f], nem
            elif f in fspec:
                return f, nem
        return None, None

    def setup(self, test):
        return Compose([(spec, nem.setup(test))
                        for spec, nem in self.pairs])

    def invoke(self, test, op):
        inner_f, nem = self._route(op.f)
        if nem is None:
            raise ValueError(f"no nemesis handles f={op.f!r}")
        op2 = nem.invoke(test, op.copy(f=inner_f))
        return op2.copy(f=op.f)

    def teardown(self, test):
        for _spec, nem in self.pairs:
            nem.teardown(test)

    def fs(self):
        out = set()
        for fspec, nem in self.pairs:
            if isinstance(fspec, dict):
                out |= set(fspec.keys())
            else:
                out |= set(fspec)
        return out

    def fault_kinds(self):
        out = {}
        for fspec, nem in self.pairs:
            inner = nem.fault_kinds()
            if isinstance(fspec, dict):
                for outer_f, inner_f in fspec.items():
                    if inner_f in inner:
                        out[outer_f] = inner[inner_f]
            else:
                for f in fspec:
                    if f in inner:
                        out[f] = inner[f]
        return out


def compose(nemeses) -> Nemesis:
    """Takes (fspec, nemesis) pairs — fspec a set of fs or a dict
    {outer-f: inner-f} — or a plain list of nemeses routed by their
    declared fs()."""
    pairs = []
    for item in nemeses:
        if isinstance(item, (tuple, list)) and len(item) == 2 and (
                isinstance(item[0], (set, frozenset, dict))):
            pairs.append((item[0], item[1]))
        else:
            fs = frozenset(item.fs())
            if not fs:
                raise ValueError(
                    f"{item!r} declares no fs; pass (fspec, nemesis) pairs")
            pairs.append((fs, item))
    return Compose(pairs)


class FMap(Nemesis):
    """Renames the fs a nemesis speaks: outer f -> inner f via `fmap`
    (nemesis.clj f-map)."""

    def __init__(self, fmap: dict, nemesis: Nemesis):
        self.fmap = fmap
        self.inv = {v: k for k, v in fmap.items()}
        self.nemesis = nemesis

    def setup(self, test):
        return FMap(self.fmap, self.nemesis.setup(test))

    def invoke(self, test, op):
        op2 = self.nemesis.invoke(test, op.copy(f=self.fmap.get(op.f, op.f)))
        return op2.copy(f=self.inv.get(op2.f, op2.f))

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        inv = self.inv
        return {inv.get(f, f) for f in self.nemesis.fs()}

    def fault_kinds(self):
        inv = self.inv
        return {inv.get(f, f): kind
                for f, kind in self.nemesis.fault_kinds().items()}


def f_map(fmap: dict, nemesis: Nemesis) -> FMap:
    return FMap(fmap, nemesis)


# ---------------------------------------------------------------------------
# Grudges: who can't talk to whom. A grudge maps node -> set of nodes whose
# packets it drops (nemesis.clj:121-277).
# ---------------------------------------------------------------------------

def bisect(nodes: list) -> list:
    """Splits a list in half: [[smaller-half], [larger-half]]."""
    mid = len(nodes) // 2
    return [list(nodes[:mid]), list(nodes[mid:])]


def split_one(node, nodes: list) -> list:
    """[[node], [everyone else]]."""
    return [[node], [n for n in nodes if n != node]]


def complete_grudge(components: list) -> dict:
    """Given components (lists of nodes), each node drops every node
    outside its component (nemesis.clj:121-133)."""
    grudge = {}
    all_nodes = [n for comp in components for n in comp]
    for comp in components:
        outside = set(all_nodes) - set(comp)
        for n in comp:
            grudge[n] = set(outside)
    return grudge


def bridge(nodes: list) -> dict:
    """Bisects the cluster but leaves one 'bridge' node connected to both
    halves (nemesis.clj:145-156)."""
    nodes = list(nodes)
    mid = len(nodes) // 2
    bridge_node = nodes[mid]
    a = nodes[:mid]
    b = nodes[mid + 1:]
    grudge = {}
    for n in a:
        grudge[n] = set(b)
    for n in b:
        grudge[n] = set(a)
    grudge[bridge_node] = set()
    return grudge


def majorities_ring(nodes: list, rng: random.Random | None = None) -> dict:
    """Every node sees a bare majority, but no two nodes see the same
    majority: arranges nodes in a (shuffled) ring, each node talking only
    to the nodes nearest it until a majority is visible
    (nemesis.clj:203-277)."""
    rng = rng or random
    nodes = list(nodes)
    n = len(nodes)
    if n < 3:
        return {node: set() for node in nodes}
    shuffled = list(nodes)
    rng.shuffle(shuffled)
    m = n // 2 + 1            # bare majority, including the node itself
    left = (m - 1) // 2       # neighbors on each side (asymmetric if even)
    right = (m - 1) - left
    grudge = {}
    for i, node in enumerate(shuffled):
        visible = {shuffled[(i + d) % n] for d in range(-left, right + 1)}
        grudge[node] = set(shuffled) - visible
    return grudge


# ---------------------------------------------------------------------------
# Partitioner nemesis
# ---------------------------------------------------------------------------

class Partitioner(Nemesis):
    """start/stop nemesis cutting links per a grudge function
    (nemesis.clj:158-184). grudge_fn: nodes -> grudge dict."""

    def __init__(self, grudge_fn: Callable[[list], dict]):
        self.grudge_fn = grudge_fn

    def setup(self, test):
        net = test.get("net")
        if net is not None:
            net.heal(test)
        return self

    def invoke(self, test, op):
        if op.f == "start":
            nodes = list(test["nodes"])
            grudge = (op.value if isinstance(op.value, dict)
                      else self.grudge_fn(nodes))
            test["net"].drop_all(test, grudge)
            pretty = {k: sorted(v) for k, v in grudge.items()}
            return op.copy(value=["isolated", pretty])
        if op.f == "stop":
            test["net"].heal(test)
            return op.copy(value="network healed")
        raise ValueError(f"partitioner doesn't understand f={op.f!r}")

    def teardown(self, test):
        net = test.get("net")
        if net is not None:
            net.heal(test)

    def fs(self):
        return {"start", "stop"}

    def fault_kinds(self):
        return {"start": ("partition", "begin"),
                "stop": ("partition", "end")}


def partitioner(grudge_fn) -> Partitioner:
    return Partitioner(grudge_fn)


# ---------------------------------------------------------------------------
# Process and file nemeses (nemesis.clj:430-599)
# ---------------------------------------------------------------------------

class NodeStartStopper(Nemesis):
    """Responds to start/stop by running start_fn/stop_fn on targeted
    nodes with an ambient control session (nemesis.clj:453-496).
    targeter: (test, nodes) -> node(s) or None to skip. `kind` names
    the coverage fault kind the start/stop window injects (default
    'process-pause', the hammer_time use)."""

    def __init__(self, targeter, start_fn, stop_fn,
                 kind: str = "process-pause"):
        self.targeter = targeter
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self.kind = kind
        self._nodes = None
        self._lock = threading.Lock()

    def invoke(self, test, op):
        from .. import control

        with self._lock:
            if op.f == "start":
                ns = self.targeter(test, list(test["nodes"]))
                if ns is None:
                    return op.copy(value="no-target")
                if not isinstance(ns, (list, tuple, set)):
                    ns = [ns]
                ns = list(ns)
                if self._nodes is not None:
                    return op.copy(
                        value=f"nemesis already disrupting {self._nodes}")
                self._nodes = ns
                res = control.on_nodes(
                    test, lambda t, n: self.start_fn(t, n), ns)
                return op.copy(value=res)
            if op.f == "stop":
                if self._nodes is None:
                    return op.copy(value="not-started")
                res = control.on_nodes(
                    test, lambda t, n: self.stop_fn(t, n), self._nodes)
                self._nodes = None
                return op.copy(value=res)
            raise ValueError(f"unknown f {op.f!r}")

    def fs(self):
        return {"start", "stop"}

    def fault_kinds(self):
        return {"start": (self.kind, "begin"),
                "stop": (self.kind, "end")}


def node_start_stopper(targeter, start_fn, stop_fn,
                       kind: str = "process-pause") -> NodeStartStopper:
    return NodeStartStopper(targeter, start_fn, stop_fn, kind=kind)


def _rand_node_targeter(test, nodes):
    return random.choice(nodes)


def hammer_time(process: str, targeter=None) -> NodeStartStopper:
    """Pauses a named process with SIGSTOP on start, resumes with
    SIGCONT on stop (nemesis.clj:498-513)."""
    from .. import control

    def start(test, node):
        with control.su():
            control.exec_("killall", "-s", "STOP", process)
        return ["paused", process]

    def stop(test, node):
        with control.su():
            control.exec_("killall", "-s", "CONT", process)
        return ["resumed", process]

    return NodeStartStopper(targeter or _rand_node_targeter, start, stop)


def _resolve_target_file(file: str) -> str:
    """file itself if it's a regular file, else a random entry of the
    directory (nemesis.clj truncate/bitflip target selection). Probes as
    root — DB data dirs are typically unreadable to the login user."""
    from .. import control
    from ..control import util as cu

    with control.su():
        if cu.file_p(file):
            return file
        return random.choice(cu.ls_full(file))


class TruncateFile(Nemesis):
    """Drops trailing bytes from files: op value is
    {node: {'file': path-or-dir, 'drop': n-bytes}}
    (nemesis.clj:514-548)."""

    def invoke(self, test, op):
        from .. import control

        assert op.f == "truncate"
        plan = op.value

        def body(t, node):
            spec = plan[node]
            file, drop = spec["file"], spec["drop"]
            assert isinstance(file, str) and isinstance(drop, int)
            file = _resolve_target_file(file)
            with control.su():
                control.exec_("truncate", "-c", "-s", f"-{drop}", file)
            return {"file": file, "drop": drop}

        res = control.on_nodes(test, body, list(plan.keys()))
        return op.copy(value=res)

    def fs(self):
        return {"truncate"}

    def fault_kinds(self):
        return {"truncate": ("file-truncate", "pulse")}


def truncate_file() -> TruncateFile:
    return TruncateFile()


class Bitflip(Nemesis):
    """Flips random bits in files: op value is
    {node: {'file': path-or-dir, 'probability': p}}. The reference
    downloads a Go release binary (nemesis.clj:550-599); we compile our
    own C tool (resources/bitflip.c) on each node instead."""

    def setup(self, test):
        import os as _os

        from .. import control
        from .time import compile_c

        src = _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), "resources", "bitflip.c")
        control.on_nodes(test, lambda t, n: compile_c(src, "bitflip"))
        return self

    def invoke(self, test, op):
        from .. import control

        plan = op.value

        def flip(t, node):
            spec = plan[node]
            file = spec.get("file")
            if not file:
                raise ValueError("bitflip op needs a :file")
            file = _resolve_target_file(file)
            probability = spec.get("probability", 0.01)
            percent = 100 * probability
            from .time import DIR
            with control.su():
                control.exec_(f"{DIR}/bitflip", "spray",
                              f"{percent:.32f}", file)
            return {"file": file, "probability": probability}

        res = control.on_nodes(test, flip, list(plan.keys()))
        return op.copy(value=res)

    def fs(self):
        return {"bitflip"}

    def fault_kinds(self):
        return {"bitflip": ("file-bitflip", "pulse")}


def bitflip() -> Bitflip:
    return Bitflip()


def partition_halves() -> Partitioner:
    """Cuts the network into two halves (first half vs rest)."""
    return Partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves() -> Partitioner:
    """Cuts into two randomly chosen halves."""

    def grudge(nodes):
        nodes = list(nodes)
        random.shuffle(nodes)
        return complete_grudge(bisect(nodes))

    return Partitioner(grudge)


def partition_random_node() -> Partitioner:
    """Isolates a single random node."""

    def grudge(nodes):
        return complete_grudge(split_one(random.choice(list(nodes)), nodes))

    return Partitioner(grudge)


def partition_majorities_ring() -> Partitioner:
    """Overlapping-majorities ring partition."""
    return Partitioner(majorities_ring)


def start_stop_cycle(period: float = 5.0):
    """The canonical nemesis schedule: sleep, start fault, sleep, stop,
    repeat (the gen/cycle in every tutorial-grade suite,
    zookeeper.clj:129-133)."""
    from .. import generator as gen

    return gen.cycle(gen.phases(gen.sleep(period),
                                {"type": "info", "f": "start"},
                                gen.sleep(period),
                                {"type": "info", "f": "stop"}))
