"""The port's membership nemesis (nemesis/membership.py) against the JAX
package's.

- Every test of tests/test_membership.py has a counterpart here, run on
  each package (`[port]` and `[jax]`) with the same assertions. The JAX
  tests drive the etcd suite's state machine over a fake member API; the
  port has no suites (ROADMAP A10), so one state machine,
  chip_smoke.MemberMachine over the in-memory chip_smoke.MemberList, is
  subclassed from each package's MembershipState (chip_smoke's phase 25
  runs the port's subclass in whole tests on the card).
- On one seed both packages' nemeses and generators give the same ops,
  the same completions and the same member lists.
- Every view thread ends at teardown; the waits are bounded.
"""

from __future__ import annotations

import importlib
import threading
import time

import pytest

import chip_smoke

ROOTS = {"port": "jepsen_tpu_torch", "jax": "jepsen_tpu"}
NODES = ["n1", "n2", "n3", "n4", "n5"]


class Pkg:
    def __init__(self, root: str):
        self.root = root

    def m(self, name: str):
        return importlib.import_module(f"{self.root}.{name}")

    @property
    def membership(self):
        return self.m("nemesis.membership")

    @property
    def gen(self):
        return self.m("generator")


@pytest.fixture(params=list(ROOTS))
def pkg(request):
    return Pkg(ROOTS[request.param])


def state_class(pkg):
    """chip_smoke's state machine on this package's MembershipState."""

    class State(chip_smoke.MemberMachine, pkg.membership.MembershipState):
        control = pkg.m("control")

    return State


def make_test(pkg):
    t = pkg.m("testing").noop_test()
    t.update(nodes=list(NODES))
    return t


def make_nemesis(pkg, members, **kw):
    state = state_class(pkg)(members, **kw)
    return pkg.membership.MembershipNemesis(state, interval=0.02), state


def membership_package(pkg, opts):
    """The suites' membership_package over the fixture state machine:
    without an explicit db the test's db restarts re-added members."""
    o = dict(opts)
    mopts = dict(o.get("membership") or {})
    mopts.setdefault("state", state_class(pkg)(
        mopts.pop("members"), db=mopts.pop("db", o.get("db")),
        seed=mopts.pop("seed", None)))
    o["membership"] = mopts
    return pkg.membership.package(o)


def await_(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def view_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("membership-view-")]


@pytest.fixture(autouse=True)
def no_view_thread_left():
    yield
    assert await_(lambda: not view_threads(), timeout=5.0), view_threads()


def next_op(pkg, g, test, ctx):
    res = g.op(test, ctx)
    deadline = time.time() + 10.0
    while res[0] is pkg.gen.PENDING and time.time() < deadline:
        time.sleep(0.02)
        res = g.op(test, ctx)
    assert res[0] is not pkg.gen.PENDING, "no legal op within 10 s"
    return res[0]


class TestStateMachine:
    def test_view_converges_from_polling(self, pkg):
        members = chip_smoke.MemberList(NODES)
        nem, state = make_nemesis(pkg, members)
        test = make_test(pkg)
        nem.setup(test)
        try:
            assert await_(lambda: state.view == frozenset(NODES))
        finally:
            nem.teardown(test)

    def test_remove_then_add_cycle(self, pkg):
        members = chip_smoke.MemberList(NODES)
        nem, state = make_nemesis(pkg, members)
        test = make_test(pkg)
        nem.setup(test)
        try:
            assert await_(lambda: state.view is not None)
            g = pkg.membership.MembershipGenerator(nem)
            ctx = pkg.m("generator.context").Context.for_test(
                {"concurrency": 2})
            # policy: shrink to the quorum floor, then grow back
            op1 = next_op(pkg, g, test, ctx)
            assert op1.f == "remove-member"
            done = nem.invoke(test, op1)
            assert done.value[1] == "removed"
            assert done.value[0] not in members.members
            # pending until the pollers see the new view
            assert await_(lambda: not state.pending)
            op2 = next_op(pkg, g, test, ctx)
            assert op2.f == "remove-member"
            nem.invoke(test, op2)
            assert await_(lambda: not state.pending)
            assert len(members.members) == 3
            # at the floor: the only legal op is adding one back
            op3 = next_op(pkg, g, test, ctx)
            assert op3.f == "add-member"
            done3 = nem.invoke(test, op3)
            assert done3.value[1] == "added"
            assert await_(lambda: not state.pending)
            assert len(members.members) == 4
        finally:
            nem.teardown(test)

    def test_never_removes_below_quorum(self, pkg):
        members = chip_smoke.MemberList(NODES)
        nem, state = make_nemesis(pkg, members)
        test = make_test(pkg)
        Context = pkg.m("generator.context").Context
        nem.setup(test)
        try:
            assert await_(lambda: state.view is not None)
            removed = 0
            for _ in range(6):
                o = None

                def ready():
                    nonlocal o
                    with nem.lock:
                        o = state.op(test)
                    return o is not pkg.gen.PENDING

                if not await_(ready, timeout=5.0):
                    break
                if o["f"] != "remove-member":
                    break
                nem.invoke(test, pkg.gen.fill_in_op(
                    dict(o), Context.for_test({"concurrency": 2})))
                removed += 1
                await_(lambda: not state.pending)
            # 5 nodes: majority quorum floor is 3 -> at most 2 removals
            assert removed == 2, removed
            assert len(members.members) == 3
        finally:
            nem.teardown(test)

    def test_down_node_view_ignored(self, pkg):
        members = chip_smoke.MemberList(NODES)
        state = state_class(pkg)(members)
        # n9 isn't a member: its view poll raises and must be ignored
        assert state.node_view(make_test(pkg), "n9") is None

    def test_fs(self, pkg):
        _nem, state = make_nemesis(pkg, chip_smoke.MemberList(NODES))
        assert state.fs() == {"add-member", "remove-member"}


class TestPackage:
    def test_package_gated_on_fault(self, pkg):
        assert pkg.membership.package({"faults": set()}) is None
        p = membership_package(pkg, {
            "faults": {"membership"},
            "membership": {"members": chip_smoke.MemberList(NODES),
                           "view-interval": 0.02}})
        assert p is not None
        assert isinstance(p["nemesis"], pkg.membership.MembershipNemesis)
        assert p["nemesis"].interval == 0.02
        assert p["generator"] is not None
        assert p["perf"] == {("membership", frozenset(
            {"add-member", "remove-member"}), frozenset(), "#A197F9")}

    def test_combined_packages_include_membership(self, pkg):
        state = state_class(pkg)(chip_smoke.MemberList(NODES))
        pkgs = pkg.m("nemesis.combined").nemesis_packages({
            "db": None, "faults": {"membership"},
            "membership": {"state": state}})
        assert any(isinstance(p.get("nemesis"),
                              pkg.membership.MembershipNemesis)
                   for p in pkgs if p)


class TestReviewRegressions:
    def test_missing_state_raises_helpful_error(self, pkg):
        with pytest.raises(ValueError, match="MembershipState"):
            pkg.membership.package({"faults": {"membership"}})

    def test_add_member_wipes_stale_data_dir(self, pkg):
        """Rejoining with a stale data dir would restart the old removed
        identity; the add path cleans it and starts the DB, on the
        rejoining node's session."""
        Action = pkg.m("control.core").Action
        db = fixture_db(pkg)
        members = chip_smoke.MemberList(NODES[:4])
        state = state_class(pkg)(members, db=db)
        state.view = frozenset(NODES[:4])
        remote = pkg.m("control.dummy").DummyRemote()
        test = make_test(pkg)
        test["remote"] = remote
        test["sessions"] = {n: remote.connect({"host": n})
                            for n in NODES}
        done = state.invoke(test, pkg.m("history").op(
            type="info", f="add-member", value="n5"))
        assert done.value == ["n5", "added"]
        assert "n5" in members.members
        got = [a.cmd for a in test["sessions"]["n5"].log
               if isinstance(a, Action)]
        joined = " ; ".join(got)
        assert f"rm -rf {chip_smoke.LAZYFS_DIR}/n5" in joined, got
        assert "start-db n5" in joined, got
        assert not any(test["sessions"][n].log for n in NODES[:4])

    def test_package_uses_test_db_by_default(self, pkg):
        db = fixture_db(pkg)
        p = membership_package(pkg, {
            "faults": {"membership"}, "db": db,
            "membership": {"members": chip_smoke.MemberList(NODES)}})
        assert p["state"].db is db


def fixture_db(pkg):
    class DB(pkg.m("db").DB):
        def start(self, test, node):
            pkg.m("control").exec_("start-db", node)
            return "started"

    return DB()


# ---------------------------------------------------------------------------
# The two packages on one seed
# ---------------------------------------------------------------------------

def churn(pkg, steps: int):
    """The generator and nemesis over a fresh member list with seed 25:
    each step waits for a legal op, invokes it and waits for the pollers
    to resolve it. Returns the ops, their completions, the member lists
    after each step and whether every view thread ended."""
    members = chip_smoke.MemberList(NODES)
    nem, state = make_nemesis(pkg, members, seed=25)
    test = make_test(pkg)
    g = pkg.membership.MembershipGenerator(nem)
    ctx = pkg.m("generator.context").Context.for_test({"concurrency": 2})
    out = []
    nem.setup(test)
    try:
        assert await_(lambda: state.view == frozenset(NODES))
        for _ in range(steps):
            o = next_op(pkg, g, test, ctx)
            done = nem.invoke(test, o)
            assert await_(lambda: not state.pending)
            out.append(((o.type, o.f, o.value), (done.f, done.value),
                        sorted(members.members)))
    finally:
        nem.teardown(test)
    return out, all(not t.is_alive() for t in nem._threads)


def test_same_ops_on_the_same_seed():
    j = churn(Pkg("jepsen_tpu"), 8)
    p = churn(Pkg("jepsen_tpu_torch"), 8)
    assert p == j
    ops, ended = p
    assert ended
    # two removals to the quorum floor, then add and remove in turn
    assert [f for (_t, f, _v), _d, _m in ops] == \
        ["remove-member"] * 2 + ["add-member", "remove-member"] * 3
    assert [len(m) for _o, _d, m in ops] == [4, 3] + [4, 3] * 3


def test_teardown_joins_every_view_thread(pkg):
    nem, state = make_nemesis(pkg, chip_smoke.MemberList(NODES))
    test = make_test(pkg)
    before = len(view_threads())
    nem.setup(test)
    assert len(view_threads()) == before + len(NODES)
    assert {t.name for t in nem._threads} == {
        f"membership-view-{n}" for n in NODES}
    nem.teardown(test)
    assert not any(t.is_alive() for t in nem._threads)


def test_a_failing_poll_keeps_the_thread_polling(pkg):
    """A node_view that raises is retried on the next tick (the
    reference warns and retries): the view still converges."""
    members = chip_smoke.MemberList(NODES)
    nem, state = make_nemesis(pkg, members)
    calls = {"n": 0}
    orig = state.node_view

    def flaky(test, node):
        calls["n"] += 1
        if calls["n"] <= 5:
            raise RuntimeError("poll failed")
        return orig(test, node)

    state.node_view = flaky
    test = make_test(pkg)
    nem.setup(test)
    try:
        assert await_(lambda: state.view == frozenset(NODES))
    finally:
        nem.teardown(test)
    assert calls["n"] > 5


def test_resolve_and_freeze_alike():
    def scen(pkg):
        mem = pkg.membership
        state = state_class(pkg)(chip_smoke.MemberList(NODES))
        state.view = frozenset(NODES[:4])
        frozen = [mem._freeze_op(x) for x in (
            {"f": "add-member", "value": ["n5", "added"]},
            {"b": {1, 2}, "a": [1, {"c": None}]})]
        state.pending = {(frozen[0], frozen[0]),
                         (mem._freeze_op({"f": "remove-member"}),
                          mem._freeze_op({"f": "remove-member",
                                          "value": ["n1", "removed"]}))}
        mem._resolve(state, {})
        left = sorted(map(repr, state.pending))
        state.view = frozenset(NODES[1:])  # n5 in, n1 out: both resolve
        mem._resolve(state, {})
        return frozen, left, state.pending

    j, p = (scen(Pkg(r)) for r in ("jepsen_tpu", "jepsen_tpu_torch"))
    assert p == j
    assert len(p[1]) == 2 and p[2] == set()


def test_fault_kinds_and_generator_pending(pkg):
    nem, state = make_nemesis(pkg, chip_smoke.MemberList(NODES))
    assert nem.fault_kinds() == {"add-member": ("membership", "pulse"),
                                 "remove-member": ("membership", "pulse")}
    assert nem.fs() == {"add-member", "remove-member"}
    g = pkg.membership.MembershipGenerator(nem)
    ctx = pkg.m("generator.context").Context.for_test({"concurrency": 2})
    # no view yet: the state machine answers pending
    assert g.op(make_test(pkg), ctx) == (pkg.gen.PENDING, g)
    assert g.update({}, ctx, None) is g
