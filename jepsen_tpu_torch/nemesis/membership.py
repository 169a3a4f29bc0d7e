"""Membership nemesis: a state machine for adding/removing cluster
nodes, with per-node view polling (the port's copy of
jepsen_tpu/nemesis/membership.py).

Capability reference: jepsen/src/jepsen/nemesis/membership.clj:109-247
and membership/state.clj — a State protocol (node_view, merge_views,
op, invoke, resolve, resolve_op), background per-node view updaters
feeding a merged authoritative view, an invoke path that records
[op, op'] pairs as pending until resolved, and a generator that asks
the state machine which operations are currently legal.

The state object carries three bookkeeping fields the nemesis manages
for it (state.clj:6-17): `node_views` (node -> that node's view of the
cluster), `view` (merged authoritative view) and `pending` (applied
[op, op'] pairs not yet confirmed)."""

from __future__ import annotations

import threading
from typing import Any

from .. import generator as gen
from . import core as n

NODE_VIEW_INTERVAL = 5.0  # seconds between node view polls


class MembershipState:
    """Subclass and implement the cluster-specific parts. Instances are
    mutated only under the nemesis lock."""

    def __init__(self):
        self.node_views: dict = {}
        self.view: Any = None
        self.pending: set = set()

    # -- cluster-specific hooks -------------------------------------------

    def setup(self, test) -> None:
        """One-time initialization (open connections etc.)."""

    def node_view(self, test, node):
        """This node's view of the cluster, or None if unknown."""
        raise NotImplementedError

    def merge_views(self, test):
        """Derive the authoritative view from self.node_views."""
        raise NotImplementedError

    def fs(self) -> set:
        """All op :f values this state machine can generate."""
        raise NotImplementedError

    def op(self, test):
        """A legal op to perform now, gen.PENDING when none is."""
        raise NotImplementedError

    def invoke(self, test, op: dict) -> dict:
        """Applies a generated op; returns the completed op."""
        raise NotImplementedError

    def resolve(self, test) -> bool:
        """One evolution step toward a stable state; True if changed."""
        return False

    def resolve_op(self, test, pair) -> bool:
        """True iff the [op, op'] pair is now resolved (it is then
        dropped from pending)."""
        return False

    def teardown(self, test) -> None:
        """Dispose of resources."""


def _resolve(state: MembershipState, test) -> None:
    """Fixed point of resolve + resolve_op (membership.clj:80-106)."""
    for _ in range(100):  # fixed-point iteration guard
        changed = bool(state.resolve(test))
        for pair in list(state.pending):
            if state.resolve_op(test, pair):
                state.pending.discard(pair)
                changed = True
        if not changed:
            return


class MembershipNemesis(n.Nemesis):
    """Runs the state machine: background view updaters + locked
    invoke/resolve (membership.clj Nemesis record, 159-221)."""

    def __init__(self, state: MembershipState,
                 interval: float = NODE_VIEW_INTERVAL):
        self.state = state
        self.interval = interval
        self.lock = threading.RLock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def _update_node_view(self, test, node):
        nv = self.state.node_view(test, node)
        if nv is None:
            return
        with self.lock:
            self.state.node_views[node] = nv
            self.state.view = self.state.merge_views(test)
            _resolve(self.state, test)

    def _view_loop(self, test, node):
        while not self._stop.is_set():
            try:
                self._update_node_view(test, node)
            except Exception:  # noqa: BLE001 — keep polling (clj warn+retry)
                pass
            self._stop.wait(self.interval)

    def setup(self, test):
        with self.lock:
            self.state.setup(test)
        for node in test.get("nodes", []):
            t = threading.Thread(target=self._view_loop,
                                 args=(test, node), daemon=True,
                                 name=f"membership-view-{node}")
            t.start()
            self._threads.append(t)
        return self

    def invoke(self, test, op):
        with self.lock:
            done = self.state.invoke(test, op)
            self.state.pending.add(
                (_freeze_op(getattr(op, "to_dict", lambda: op)()),
                 _freeze_op(getattr(done, "to_dict", lambda: done)())))
            _resolve(self.state, test)
            return done

    def teardown(self, test):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
        self.state.teardown(test)

    def fs(self):
        return set(self.state.fs())

    def fault_kinds(self):
        # every membership transition is a pulse of the one kind: the
        # coverage cell asks "was membership churned", not which verb
        return {f: ("membership", "pulse") for f in self.state.fs()}


def _freeze_op(op) -> tuple:
    if isinstance(op, dict):
        return tuple(sorted((k, _freeze_op(v)) for k, v in op.items()))
    if isinstance(op, (list, tuple)):
        return tuple(_freeze_op(x) for x in op)
    if isinstance(op, set):
        return frozenset(_freeze_op(x) for x in op)
    return op


class MembershipGenerator(gen.Generator):
    """Asks the state machine for a legal op (membership.clj Generator,
    226-237)."""

    __slots__ = ("nemesis",)

    def __init__(self, nemesis: MembershipNemesis):
        self.nemesis = nemesis

    def op(self, test, ctx):
        with self.nemesis.lock:
            o = self.nemesis.state.op(test)
        if o is None:
            return None
        if o is gen.PENDING or o == "pending":
            return gen.PENDING, self
        o = dict(o)
        o.setdefault("type", "info")
        filled = gen.fill_in_op(o, ctx)
        if filled is gen.PENDING:
            return gen.PENDING, self
        return filled, self

    def update(self, test, ctx, event):
        return self


def package(opts: dict) -> dict:
    """{nemesis, generator, state} package, active when 'membership'
    is in opts['faults'] (membership.clj package, 242-270). Membership
    opts: {'state': a MembershipState, 'interval': view poll seconds}."""
    if "membership" not in set(opts.get("faults", ())):
        return None
    mopts = dict(opts.get("membership") or {})
    state = mopts.get("state")
    if state is None:
        raise ValueError(
            "the 'membership' fault needs a cluster-specific state "
            "machine: pass opts['membership']['state'] (a "
            "MembershipState, e.g. suites.etcd.EtcdMembership)")
    nem = MembershipNemesis(
        state, interval=mopts.get("view-interval", NODE_VIEW_INTERVAL))
    g = gen.stagger(opts.get("interval", 10), MembershipGenerator(nem))
    return {
        "state": state,
        "nemesis": nem,
        "generator": g,
        "final_generator": None,
        "perf": {("membership", frozenset(state.fs()),
                  frozenset(), "#A197F9")},
    }
