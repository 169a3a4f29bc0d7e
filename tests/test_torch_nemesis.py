"""The port's fault nemeses against the JAX package's: nemesis/core.py
(grudges, composition, the partitioner, process and file nemeses),
nemesis/time.py and nemesis/combined.py (tests/test_nemesis.py and
tests/test_nemesis_combined.py).

Pure functions (grudges, node specs) are compared on the same inputs
with the global random module seeded the same way before each package's
call. Nemesis invocations run on each package's dummy sessions and must
leave equal command logs on every node (the C sources that the clock and
bitflip nemeses upload through write_file included: the port's
resources/ are byte-equal copies). The combined packages' generators
must give the same ops, op for op, under each package's simulator. All
comparisons are exact.
"""

from __future__ import annotations

import importlib
import random
from pathlib import Path

import pytest

ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")
NODES = ["n1", "n2", "n3", "n4", "n5"]


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def clear_ip_caches():
    """Both packages' net modules memoize node addresses at module
    level: leave neither cache behind."""
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()
    yield
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()


def both(scenario, seed=1234):
    out = []
    for root in ROOTS:
        random.seed(seed)
        out.append(scenario(root))
    assert out[0] == out[1]
    return out[1]


def responder_for(root, fail_stat=False):
    core = mod(root, "control.core")

    def responder(node, action):
        cmd = action.cmd
        if cmd.startswith("getent ahostsv4"):
            host = cmd.split()[-1]
            return f"10.0.0.{host[1:]}   STREAM {host}"
        if cmd == "ip -o link show":
            return "1: lo: <LOOPBACK>\n2: eth0: <BROADCAST>"
        if cmd.startswith("date +%s.%N"):
            return "1000.5"
        if cmd.startswith("/opt/jepsen/bump-time"):
            return "1000.25"
        if cmd == "cat /run/db.pid":
            return "1234"
        if cmd.startswith("ls -A"):
            return "wal.1\nwal.2"
        if fail_stat and cmd.startswith(("stat", "test -f")):
            return core.Result(exit=1, out="", err="", cmd=cmd)
        return None

    return responder


def fake_db(root):
    control = mod(root, "control")

    class FakeDB(mod(root, "db").DB):
        supports_kill = True
        supports_pause = True

        def kill(self, test, node):
            control.exec_("killall", "-9", "-w", "db")
            return "killed"

        def start(self, test, node):
            control.exec_("start-db")
            return "started"

        def pause(self, test, node):
            control.exec_("killall", "-s", "STOP", "db")
            return "paused"

        def resume(self, test, node):
            control.exec_("killall", "-s", "CONT", "db")
            return "resumed"

    return FakeDB()


def base_map(root, fail_stat=False):
    remote = mod(root, "control.dummy").DummyRemote(
        responder_for(root, fail_stat))
    return {"nodes": list(NODES), "remote": remote,
            "net": mod(root, "net").iptables, "db": fake_db(root),
            "sessions": {x: remote.connect({"host": x}) for x in NODES}}


def logs(test) -> dict:
    out = {}
    for n, s in test["sessions"].items():
        out[n] = [tuple(map(repr, a)) if isinstance(a, tuple)
                  else (a.cmd, a.sudo, a.dir, a.stdin) for a in s.log]
    return out


def info(root, f, value=None):
    return mod(root, "history").op(type="info", process="nemesis", f=f,
                                   value=value)


def plain(x):
    """Op values and nested results as comparable data."""
    if hasattr(x, "to_dict") and not isinstance(x, dict):
        return plain(x.to_dict())
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    return x


# ---------------------------------------------------------------------------
# Grudges and node specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 8))
def test_grudges_equal(n):
    nodes = [f"n{i}" for i in range(1, n + 1)]

    def scen(root):
        nem = mod(root, "nemesis")
        return plain([nem.bisect(nodes), nem.split_one(nodes[0], nodes),
                      nem.complete_grudge(nem.bisect(nodes)),
                      nem.bridge(nodes) if n > 1 else None,
                      nem.majorities_ring(nodes, rng=random.Random(7)),
                      nem.majorities_ring(nodes)])

    both(scen)


def test_grudge_math_as_the_reference():
    from jepsen_tpu_torch import nemesis as nem

    assert nem.bisect([1, 2, 3, 4, 5]) == [[1, 2], [3, 4, 5]]
    assert nem.complete_grudge([[1, 2], [3, 4, 5]])[3] == {1, 2}
    g = nem.bridge([1, 2, 3, 4, 5])
    assert g[3] == set() and g[1] == {4, 5}
    g = nem.majorities_ring(NODES, rng=random.Random(7))
    assert all(len(set(NODES) - g[x]) == 3 for x in NODES)
    assert len({frozenset(set(NODES) - g[x]) for x in NODES}) == 5


@pytest.mark.parametrize("spec", ["one", "majority", "majorities-ring",
                                  "minority-third",
                                  {"n1": {"n2"}, "n2": {"n1"}}])
def test_combined_grudge_specs(spec):
    def scen(root):
        t = base_map(root)
        return plain(mod(root, "nemesis.combined").grudge(t, t["db"], spec))

    got = both(scen)
    if spec == "minority-third":
        assert sorted(len(v) for v in got.values()) == [1, 1, 1, 1, 4]


@pytest.mark.parametrize("spec", [None, "one", "minority", "majority",
                                  "minority-third", "all", ["n2"]])
def test_db_nodes_specs(spec):
    def scen(root):
        t = base_map(root)
        c = mod(root, "nemesis.combined")
        return [c.db_nodes(t, t["db"], spec) for _ in range(5)], \
            c.node_specs(t["db"]), c.partition_specs(t["db"])

    both(scen)


# ---------------------------------------------------------------------------
# Nemesis invocations on dummy sessions: equal command logs per node
# ---------------------------------------------------------------------------

def run_ops(root, build, ops, fail_stat=False, teardown=False):
    t = base_map(root, fail_stat)
    nem = build(root, t).setup(t)
    done = [plain(nem.invoke(t, info(root, f, v))) for f, v in ops]
    for d in done:
        # an offset is the node's reading minus the control machine's
        # clock at the call: only the nodes read compare across calls
        if "clock-offsets" in d:
            d["clock-offsets"] = sorted(d["clock-offsets"])
    if teardown:
        nem.teardown(t)
    return done, logs(t), sorted(nem.fs()), nem.fault_kinds()


SCENARIOS = {
    "db-kill-start": (
        lambda root, t: mod(root, "nemesis.combined").DbNemesis(t["db"]),
        [("kill", "all"), ("start", "all"), ("pause", ["n2"]),
         ("resume", "all"), ("kill", "one"), ("pause", "majority")]),
    "partition": (
        lambda root, t: mod(root, "nemesis.combined").PartitionNemesis(
            t["db"]),
        [("start-partition", "majority"), ("stop-partition", None),
         ("start-partition", "one"), ("stop-partition", None),
         ("start-partition", "majorities-ring"),
         ("start-partition", "minority-third")]),
    "packet": (
        lambda root, t: mod(root, "nemesis.combined").PacketNemesis(
            t["db"]),
        [("start-packet", ["all", {"delay": {}}]), ("stop-packet", None),
         ("start-packet", ["one", {"loss": {}, "corrupt": {}}])]),
    "clock": (
        lambda root, t: mod(root, "nemesis.time").clock_nemesis(),
        [("bump", {"n1": 4000, "n3": -8000}), ("check-offsets", None),
         ("strobe", {"n2": {"delta": 100, "period": 10, "duration": 2}}),
         ("reset", ["n4"])]),
    "truncate": (
        lambda root, t: mod(root, "nemesis").truncate_file(),
        [("truncate", {"n1": {"file": "/data/wal", "drop": 64}}),
         ("truncate", {"n2": {"file": "/data", "drop": 8}})]),
    "bitflip": (
        lambda root, t: mod(root, "nemesis").bitflip(),
        [("bitflip", {"n2": {"file": "/data/wal", "probability": 0.001}}),
         ("bitflip", {"n3": {"file": "/data"}})]),
    "file-corruption": (
        lambda root, t: mod(root, "nemesis.combined").FileCorruptionNemesis(
            t["db"]),
        [("truncate", [["n1", "n2"], {"file": "/data/wal", "drop": 8}]),
         ("bitflip", ["one", {"file": "/data/wal", "probability": 0.5}])]),
    "hammer": (
        lambda root, t: mod(root, "nemesis").hammer_time("db"),
        [("start", None), ("start", None), ("stop", None),
         ("stop", None)]),
    "partition-halves": (
        lambda root, t: mod(root, "nemesis").partition_halves(),
        [("start", None), ("stop", None)]),
    "partition-random-halves": (
        lambda root, t: mod(root, "nemesis").partition_random_halves(),
        [("start", None), ("stop", None), ("start", None)]),
    "partition-random-node": (
        lambda root, t: mod(root, "nemesis").partition_random_node(),
        [("start", None), ("stop", None)]),
    "partition-ring": (
        lambda root, t: mod(root, "nemesis").partition_majorities_ring(),
        [("start", None), ("stop", None)]),
}


@pytest.mark.parametrize("fail_stat", [False, True])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_nemesis_ops_leave_equal_command_logs(name, fail_stat):
    build, ops = SCENARIOS[name]
    done, got, fs, kinds = both(lambda root: run_ops(
        root, build, ops, fail_stat, teardown=True))
    cmds = {n: [c[0] for c in v if len(c) == 4] for n, v in got.items()}
    if name == "db-kill-start":
        assert done[0]["value"] == {x: "killed" for x in NODES}
        assert "killall -s STOP db" in cmds["n2"]
    if name == "partition":
        assert done[0]["value"][0] == "isolated"
        assert all(any("-j DROP" in c for c in cmds[x]) for x in NODES)
    if name == "clock":
        assert "/opt/jepsen/bump-time 4000" in cmds["n1"]
        assert done[1]["clock-offsets"] == NODES
    if name == "hammer":
        assert "already disrupting" in done[1]["value"]
    if name == "truncate" and not fail_stat:
        assert "truncate -c -s -64 /data/wal" in cmds["n1"]
    if name in ("clock", "bitflip") and fail_stat:
        # the tool's source went up through write_file, as text
        uploads = [c for v in got.values() for c in v
                   if len(c) == 4 and c[0].startswith("cat > /opt/jepsen/")]
        assert uploads and all(c[3] for c in uploads)


@pytest.mark.parametrize("name", ["bitflip.c", "bump_time.c",
                                  "strobe_time.c"])
def test_resources_are_byte_equal_copies(name):
    import jepsen_tpu
    import jepsen_tpu_torch

    j = Path(jepsen_tpu.__file__).parent / "resources" / name
    p = Path(jepsen_tpu_torch.__file__).parent / "resources" / name
    assert p.read_bytes() == j.read_bytes()


def test_compose_and_f_map_route_by_fs():
    def scen(root):
        nem = mod(root, "nemesis")

        class Recorder(nem.Nemesis):
            def __init__(self):
                self.seen = []

            def invoke(self, test, o):
                self.seen.append(o.f)
                return o

            def fs(self):
                return {"go"}

        a, b = Recorder(), Recorder()
        c = nem.compose([({"a-go"}, nem.f_map({"a-go": "go"}, a)),
                         ({"b-go"}, nem.f_map({"b-go": "go"}, b))])
        c = c.setup({})
        out = c.invoke({}, info(root, "a-go"))
        d = nem.compose([({"kill-primary": "go"}, a)])
        d.invoke({}, info(root, "kill-primary"))
        with pytest.raises(ValueError):
            c.invoke({}, info(root, "nope"))
        return (out.f, a.seen, b.seen, sorted(c.fs()), sorted(d.fs()),
                c.fault_kinds())

    got = both(scen)
    assert got[:4] == ("a-go", ["go", "go"], [], ["a-go", "b-go"])


def test_validate_records_fault_activations():
    """Validate records each completed fault activation with the
    nemesis's declared kind (coverage.py's recorder); an observational
    op (check-offsets) records none."""
    def scen(root):
        cov = mod(root, "coverage")
        util = mod(root, "util")
        nem = mod(root, "nemesis")
        t = base_map(root)
        pkg = mod(root, "nemesis.combined").nemesis_package(
            {"db": t["db"], "faults": ["partition", "kill", "pause",
                                       "clock"]})
        cov.reset()
        with util.with_relative_time():
            v = nem.validate(pkg["nemesis"]).setup(t)
            for f, val in [("start-partition", "one"), ("kill", "all"),
                           ("start", "all"), ("pause", "one"),
                           ("resume", "all"), ("bump-clock", {"n1": 10}),
                           ("check-clock-offsets", None),
                           ("reset-clock", ["n2"]),
                           ("stop-partition", None)]:
                v.invoke(t, info(root, f, val))
        acts = [(a["kind"], a["f"], a["phase"])
                for a in cov.get().activations()]
        folded = [(f["kind"], f["count"], len(f["windows"]))
                  for f in cov.fold_faults(cov.get().activations())]
        cov.reset()
        return acts, folded, v.fault_kinds()

    acts, folded, kinds = both(scen)
    assert ("partition", "start-partition", "begin") in acts
    assert ("db-kill", "start", "end") in acts
    assert not any(f == "check-clock-offsets" for _k, f, _p in acts)
    assert ("partition", 1, 1) in folded


# ---------------------------------------------------------------------------
# Packages: generators op for op under each package's simulator
# ---------------------------------------------------------------------------

FAULT_SETS = [["partition"], ["kill"], ["pause"], ["clock"], ["packet"],
              ["partition", "kill", "pause", "clock"],
              ["partition", "packet", "kill", "pause", "clock",
               "file-corruption"]]
# completions of the simulator's modes (generator/test_support.py), run
# through simulate() itself so that the test map (the clock package's
# targets read its nodes) reaches the generators
SIMULATORS = {
    "quick": lambda c, inv: inv.copy(type="ok"),
    "perfect": lambda c, inv: inv.copy(type="ok", time=inv.time + 10),
    "perfect_info": lambda c, inv: inv.copy(type="info",
                                            time=inv.time + 10),
}


@pytest.mark.parametrize("sim", SIMULATORS)
@pytest.mark.parametrize("faults", FAULT_SETS,
                         ids=["+".join(f) for f in FAULT_SETS])
def test_package_generators_op_for_op(faults, sim):
    def scen(root):
        c = mod(root, "nemesis.combined")
        gen = mod(root, "generator")
        simm = mod(root, "generator.test_support")
        t = base_map(root)
        pkg = c.nemesis_package({
            "db": t["db"], "faults": faults, "interval": 1,
            "file_corruption": {"corruptions": [
                {"type": "bitflip", "file": "/d",
                 "probability": {"distribution": "one-of",
                                 "values": [0.1, 0.2]}},
                {"type": "truncate", "file": "/d",
                 "drop": {"distribution": "uniform", "min": 1,
                          "max": 64}}]}})
        g = gen.nemesis(gen.phases(gen.limit(24, pkg["generator"]),
                                   pkg["final_generator"]))
        ops = simm.simulate(g, SIMULATORS[sim], test={
            "nodes": NODES, "concurrency": 2})
        return ([(o.type, o.f, plain(o.value), o.process, o.time)
                 for o in ops], plain(pkg["final_generator"]),
                plain(sorted(pkg["perf"], key=repr)),
                sorted(pkg["nemesis"].fs()), pkg["nemesis"].fault_kinds())

    got = both(scen)
    assert got[0]


def test_db_generators_flip_flop():
    def scen(root):
        c = mod(root, "nemesis.combined")
        gen = mod(root, "generator")
        t = base_map(root)
        gens = c.db_generators({"db": t["db"], "faults": {"kill"},
                                "interval": 0})
        ctx = gen.context({"concurrency": 2, "nodes": NODES})
        o, g2 = gen.op(gens["generator"], t, ctx)
        o2, _ = gen.op(g2, t, ctx)
        return o.f, o2.f, o2.value, gens["final_generator"]

    assert both(scen) == ("kill", "start", "all", [
        {"type": "info", "f": "start", "value": "all"}])


def test_start_stop_cycle_op_for_op():
    def scen(root):
        g = mod(root, "generator")
        simm = mod(root, "generator.test_support")
        ops = simm.quick_ops(g.nemesis(g.limit(
            6, mod(root, "nemesis").start_stop_cycle(2.0))))
        return [(o.type, o.f, o.process, o.time) for o in ops]

    got = both(scen)
    assert [(t, f) for t, f, _p, _tm in got if t == "info"][:2] == [
        ("info", "start"), ("info", "stop")]


# ---------------------------------------------------------------------------
# What the port does not have raises
# ---------------------------------------------------------------------------

def test_the_membership_fault_raises():
    """The membership fault is ported (ROADMAP A3c; it raised
    NotImplementedError before): asked for without a cluster's state
    machine, both packages raise the same ValueError."""
    for root in ("jepsen_tpu", "jepsen_tpu_torch"):
        combined = mod(root, "nemesis.combined")
        with pytest.raises(ValueError, match="MembershipState"):
            combined.nemesis_package({"db": fake_db(root), "faults": [
                "partition", "membership"]})
        with pytest.raises(ValueError, match="MembershipState"):
            combined.nemesis_packages({"db": None,
                                       "faults": ["membership"]})


def test_lazyfs_raises():
    """lazyfs is ported (ROADMAP A3c; a lazyfs map raised
    NotImplementedError before): the file-corruption nemesis over a
    lazyfs map takes lose-unfsynced-writes and raises the JAX package's
    ValueError on an f it does not know, and the package without a
    lazyfs map raises the reference's own ValueError."""
    from jepsen_tpu_torch.history import op as mkop
    from jepsen_tpu_torch.nemesis import combined

    db = fake_db("jepsen_tpu_torch")
    nem = combined.FileCorruptionNemesis(db, lazyfs_map={"dir": "/d"})
    assert "lose-unfsynced-writes" in nem.fs()
    assert nem.lazyfs_map["fifo"] == "/d.lazyfs/fifo"
    with pytest.raises(ValueError, match="unknown f"):
        nem.invoke({"nodes": ["n1"]}, mkop(type="info", f="scramble",
                                           value=["all", None]))
    pkg = combined.file_corruption_package({
        "db": db, "faults": ["file-corruption"],
        "file_corruption": {"lazyfs": "/d", "corruptions": [
            {"type": "lose-unfsynced-writes"}]}})
    assert pkg["nemesis"].fault_kinds()["lose-unfsynced-writes"] == \
        ("file-lost-writes", "pulse")
    # without a lazyfs map the reference's own ValueError stands
    with pytest.raises(ValueError, match="lazyfs map"):
        combined.file_corruption_package({
            "db": db, "faults": ["file-corruption"],
            "file_corruption": {"corruptions": [
                {"type": "lose-unfsynced-writes"}]}})


def test_package_lifecycle_end_to_end():
    """A package-driven nemesis schedule runs through the port's
    core.run clusterless (tests/test_nemesis_combined.py:264-301)."""
    from jepsen_tpu_torch import checker, core, os_setup, testing
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.nemesis import combined

    root = "jepsen_tpu_torch"
    t = base_map(root)
    pkg = combined.nemesis_package({"db": t["db"], "interval": 0.001,
                                    "faults": ["partition"]})
    state = testing.AtomState()
    test = dict(t)
    test.update(
        name=None, os=os_setup.noop, ssh={}, concurrency=2,
        client=testing.AtomClient(state), db=testing.AtomDB(state),
        checker=checker.stats(), nemesis=pkg["nemesis"],
        generator=gen.nemesis(
            gen.phases(gen.limit(4, pkg["generator"]),
                       pkg["final_generator"]),
            gen.time_limit(0.5, gen.stagger(
                0.01, lambda: {"f": "read"}))))
    test = core.run(test)
    fs = {o.f for o in test["history"]
          if o.process == "nemesis" and o.type == "info"}
    assert {"start-partition", "stop-partition"} <= fs
    cmds = [a.cmd for x in NODES for a in test["sessions"][x].log
            if not isinstance(a, tuple)]
    assert any("-j DROP" in c for c in cmds)
    assert "iptables -F -w" in cmds
    assert test["results"]["valid?"] is True
