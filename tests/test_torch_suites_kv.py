"""The port's key-value suites (zookeeper, raftis, redis_sentinel,
aerospike, crate, rethinkdb; jepsen_tpu_torch/suites/) against the JAX
package's, on the CPU.

For each suite: the DB's command streams on the dummy remote, per node,
equal in both packages; its transport's commands and replies; its client
against the JAX test's in-memory fake (a fresh one per package), with
equal completions and equal fake state after; its error classification;
whole clusterless runs, healthy and with the seeded bug of the JAX test
(or a phantom read where the JAX test has none), recorded on each
package's interpreter and checked by both packages with equal results;
the builder's shape and its command line's options (the port's plus
--device); phase 27's runs stored by each package and analysed by both;
and phase 27 itself at a small size.
"""

from __future__ import annotations

import random
import re

import pytest

import test_aerospike as tae
import test_crate as tcr
import test_raftis as trf
import test_redis_sentinel as trs
import test_rethinkdb as trd
import test_zookeeper as tzk
from test_torch_suites_registry import (  # noqa: F401 (fixture)
    JAX, PORT, ROOTS, Raising, both_streams, clear_ip_caches, device_opts,
    drive, held_by_both, help_options, log_stream, make_test, mod, op,
    outcome,
    parsed, phase_27, remote_error, run_checked_by_both, shape,
    small_specs, stored_across, stream, suite)

SUITES = ("zookeeper", "raftis", "redis_sentinel", "aerospike", "crate",
          "rethinkdb")

# ---------------------------------------------------------------------------
# DB command streams
# ---------------------------------------------------------------------------

DBS = {
    "zookeeper": (lambda s, r: s.ZkDB("3.4.13-2"), None),
    "raftis": (lambda s, r: s.RaftisDB("v1.0"), trf.responder),
    "redis_sentinel": (lambda s, r: s.RedisSentinelDB(), None),
    "aerospike": (lambda s, r: s.AerospikeDB("3.5.4"), tae.responder),
    "crate": (lambda s, r: s.CrateDB("5.7.2"), tcr._sql_responder),
    "rethinkdb": (lambda s, r: s.RethinkDB(write_acks="single",
                                           read_mode="single"), None),
}
METHODS = ("teardown", "kill", "start", "setup_primary")


def _db_cases():
    from jepsen_tpu.suites import (aerospike, crate, raftis,
                                   redis_sentinel, rethinkdb, zookeeper)

    mods = {"zookeeper": zookeeper, "raftis": raftis,
            "redis_sentinel": redis_sentinel, "aerospike": aerospike,
            "crate": crate, "rethinkdb": rethinkdb}
    out = []
    for name in SUITES:
        cls = type(DBS[name][0](mods[name], JAX))
        out.append((name, "setup"))
        out += [(name, m) for m in METHODS if m in vars(cls)]
    return out


@pytest.mark.parametrize("name,method", _db_cases())
def test_db_command_stream(name, method):
    make_db, responder = DBS[name]
    calls = ([("setup", None)] if method == "setup"
             else [(method, "n2")])
    both_streams(name, make_db, calls, responder)


def test_rethinkdb_primaries_and_conf_equal():
    for node in ("n1", "n2", "n3"):
        t = {"nodes": ["n1", "n2", "n3"]}
        assert suite(PORT, "rethinkdb").conf_body(t, node) == \
            suite(JAX, "rethinkdb").conf_body(t, node)
    got = {}
    for root in ROOTS:
        db = DBS["rethinkdb"][0](suite(root, "rethinkdb"), root)
        got[root] = db.primaries(make_test(root))
    assert got[PORT] == got[JAX]


def test_node_side_helpers_byte_equal():
    """The text uploaded to the nodes is the JAX package's, byte for
    byte: rethinkdb's ReQL helper, aerospike's UDF, zoo.cfg's head."""
    for name, attr in (("rethinkdb", "QUERY_SCRIPT"),
                       ("aerospike", "UDF_BODY"),
                       ("redis_sentinel", "CAS_LUA"),
                       ("zookeeper", "ZOO_CFG")):
        assert getattr(suite(PORT, name), attr) == \
            getattr(suite(JAX, name), attr)


def test_aerospike_conf_equal():
    t = {"nodes": ["n1", "n2", "n3"]}
    for node in t["nodes"]:
        assert suite(PORT, "aerospike").conf_body(t, node) == \
            suite(JAX, "aerospike").conf_body(t, node)


# ---------------------------------------------------------------------------
# transports: the commands each sends and how it reads the reply
# ---------------------------------------------------------------------------

def _transport(root, name):
    s = suite(root, name)

    def reply(node, action):
        if "SENTINEL" in action.cmd:
            return "n1\n6379"
        if action.cmd.startswith("curl"):
            return '{"rows": [[3]], "rowcount": 1}'
        return "OK"

    test = make_test(root, reply, ("n1",))
    if name == "raftis":
        t = s.RedisCli(test, "n1")
        out = [t.run("SET", "r", "3"), t.run("GET", "r")]
    elif name == "redis_sentinel":
        t = s.SentinelCli(test, "n1")
        out = [t.run("GET", "r"), t.master, t.forget_master(),
               t.run("SET", "r", "1")]
    elif name == "aerospike":
        t = s.AqlCli(test, "n1")
        out = [t.run("SELECT v FROM test.jepsen WHERE PK='r'")]
    elif name == "crate":
        t = s.CrateSql(test, "n1")
        out = [t.stmt("SELECT val FROM jepsen_r WHERE id = ?", [0])]
    else:
        t = s.RethinkCli(test, "n1")
        out = [t.run("write", "majority", "majority", "4")]
    sess = t.sess
    t.close()
    return out, log_stream(root, {"n1": sess})


@pytest.mark.parametrize("name", ["raftis", "redis_sentinel", "aerospike",
                                  "crate", "rethinkdb"])
def test_transport_commands_equal(name):
    port, jax = _transport(PORT, name), _transport(JAX, name)
    assert port == jax
    assert port[1]["n1"]


def test_crate_non_json_reply_raises_each_package_remote_error():
    for root in ROOTS:
        test = make_test(root, lambda node, a: "<html>502</html>",
                         ("n1",))
        control = mod(root, "control")
        with control.with_session(test, "n1"):
            sql = suite(root, "crate").CrateSql(test, "n1")
            with pytest.raises(mod(root, "control.core").RemoteError):
                sql.stmt("SELECT 1")


# ---------------------------------------------------------------------------
# clients against the JAX tests' fakes
# ---------------------------------------------------------------------------

REGISTER_SCRIPT = [("read", None), ("write", 3), ("read", None),
                   ("cas", [3, 4]), ("cas", [9, 1]), ("read", None),
                   ("write", 0), ("cas", [0, 2]), ("read", None)]


def _zk_client(root):
    fake = tzk.FakeZk()
    test = make_test(root, fake.responder, ("n1",))
    c = suite(root, "zookeeper").ZkCasClient().open(test, "n1")
    got = drive(root, c, REGISTER_SCRIPT, test)
    return got, (fake.value, fake.version), stream(root, test)


def test_zookeeper_client_equal():
    port, jax = _zk_client(PORT), _zk_client(JAX)
    assert port == jax
    assert [g[0] for g in port[0]] == ["ok", "ok", "ok", "ok", "fail",
                                      "ok", "ok", "ok", "ok"]
    assert port[0][0][2] == 0  # created as 0 on first touch


CLIENTS = {
    # suite: (client class, transport attr, JAX fake factory, state attr)
    "raftis": ("RaftisRegisterClient", "cli_factory", trf.FakeCliFactory,
               "kv"),
    "redis_sentinel": ("SentinelRegisterClient", "cli_factory",
                       trs.FakeCliFactory, "value"),
    "aerospike": ("AerospikeCasClient", "cli_factory", tae.FakeCliFactory,
                  "value"),
    "crate": ("CrateRegisterClient", "sql_factory", tcr.FakeSqlFactory,
              "value"),
    "rethinkdb": ("RethinkCasClient", "cli_factory", trd.FakeCliFactory,
                  "val"),
}


def _client(root, name, script, factory=None):
    cls, _attr, make_factory, state = CLIENTS[name]
    f = factory or make_factory()
    c = getattr(suite(root, name), cls)(f).open({"nodes": ["n1"]}, "n1")
    got = drive(root, c, script)
    return got, getattr(getattr(f, "state", None), state, None)


@pytest.mark.parametrize("name", ["redis_sentinel", "aerospike", "crate",
                                  "rethinkdb"])
def test_register_client_equal(name):
    port, jax = _client(PORT, name, REGISTER_SCRIPT), \
        _client(JAX, name, REGISTER_SCRIPT)
    assert port == jax
    assert ("ok", "cas", [3, 4], None) in [g[:3] + (None,) for g in port[0]]


def test_raftis_clients_equal():
    script = [("read", None), ("write", 3), ("read", None), ("write", 1)]
    assert _client(PORT, "raftis", script) == \
        _client(JAX, "raftis", script)
    got = {}
    for root in ROOTS:
        f = trf.FakeCliFactory()
        c = suite(root, "raftis").RaftisCounterClient(f).open({}, "n1")
        got[root] = (drive(root, c, [("add", 2), ("add", -1),
                                     ("read", None), ("add", 0),
                                     ("read", None)]), dict(f.state.kv))
    assert got[PORT] == got[JAX]
    assert got[PORT][1] == {"c": 1}


def test_sentinel_readonly_bounce_and_refusal_equal():
    got = {}
    for root in ROOTS:
        out = []
        for bounces in (1, 99):
            state = trs.FakeRedis()
            state.readonly_bounces = bounces
            c = suite(root, "redis_sentinel").SentinelRegisterClient(
                trs.FakeCliFactory(state)).open({}, "n1")
            out.append((outcome(c.invoke({}, op(root, "write", 4))),
                        state.value))
        got[root] = out
    assert got[PORT] == got[JAX]
    assert [o[0][0] for o in got[PORT]] == ["ok", "fail"]


# (suite, f, the error each package's transport raises, want)
ERRORS = [
    ("raftis", "write", lambda r: remote_error(
        r, "redis failed", err="ERR write InComplete: no leader node!"),
     "fail"),
    ("raftis", "write", lambda r: remote_error(r, "broken pipe"), "info"),
    ("raftis", "read", lambda r: remote_error(r, "timed out"), "fail"),
    ("redis_sentinel", "write", lambda r: remote_error(r, "broken pipe"),
     "info"),
    ("redis_sentinel", "cas", lambda r: remote_error(
        r, "refused", err="Could not connect to Redis"), "fail"),
    ("redis_sentinel", "read", lambda r: remote_error(r, "timeout"),
     "fail"),
    ("aerospike", "write", lambda r: remote_error(
        r, "timed out", exit=-1, err="timeout"), "info"),
    ("aerospike", "read", lambda r: remote_error(
        r, "timed out", exit=-1, err="timeout"), "fail"),
    ("crate", "write", lambda r: suite(r, "crate").CrateSqlError(
        "blocked by: [FORBIDDEN/12/index read-only]"), "fail"),
    ("crate", "write", lambda r: suite(r, "crate").CrateSqlError(
        "SQLActionException: shard failure, primary unavailable"), "info"),
    ("crate", "cas", lambda r: remote_error(
        r, "timed out", exit=28, err="timed out"), "info"),
    ("crate", "read", lambda r: suite(r, "crate").CrateSqlError(
        "shard failure"), "fail"),
    ("rethinkdb", "write", lambda r: remote_error(r, "broken pipe"),
     "info"),
    ("rethinkdb", "read", lambda r: remote_error(r, "timed out"), "fail"),
]


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_client_error_classified_alike(case):
    name, f, make, want = ERRORS[case]
    value = {"read": None, "write": 1, "cas": [1, 2]}[f]
    got = {}
    for root in ROOTS:
        cls, _attr, _mf, _s = CLIENTS[name]
        c = getattr(suite(root, name), cls)(Raising(root, make)).open(
            {"nodes": ["n1"]}, "n1")
        got[root] = outcome(c.invoke({}, op(root, f, value)))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == want


# replies that are errors in the reply text itself
REPLIES = [
    ("raftis", "write", "(error) ERR not ready", "fail"),
    ("raftis", "read", "ERR not ready", "fail"),
    ("rethinkdb", "cas", "ERR Write acks not satisfied: 1 of 2 acks "
     "received", "info"),
    ("rethinkdb", "write", "ERR Cannot perform write: lost contact with "
     "primary replica", "fail"),
    ("rethinkdb", "cas", "CAS 0", "fail"),
    ("aerospike", "write", "Error: (11) AEROSPIKE_ERR_CLUSTER "
     "unavailable\n", "fail"),
]


@pytest.mark.parametrize("case", range(len(REPLIES)))
def test_reply_classified_alike(case):
    name, f, reply, want = REPLIES[case]
    value = {"read": None, "write": 1, "cas": [1, 2]}[f]

    class Replying:
        def __call__(self, *_a, **_kw):
            class _T:
                def run(self, *_a):
                    return reply

                def close(self):
                    pass

            return _T()

    got = {}
    for root in ROOTS:
        cls = CLIENTS[name][0]
        c = getattr(suite(root, name), cls)(Replying()).open({}, "n1")
        got[root] = outcome(c.invoke({}, op(root, f, value)))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == want


@pytest.mark.parametrize("text", [
    "+---+\n| v |\n+---+\n| 5 |\n+---+\n1 row in set (0.000 secs)\n",
    "0 rows in set (0.000 secs)\n", "Error: (11) AEROSPIKE_ERR_CLUSTER\n"])
def test_aerospike_parse_cells_alike(text):
    got = {}
    for root in ROOTS:
        try:
            got[root] = suite(root, "aerospike").parse_cells(text)
        except Exception as e:  # noqa: BLE001
            got[root] = type(e).__name__
    assert got[PORT] == got[JAX]


# ---------------------------------------------------------------------------
# whole clusterless runs, checked by both packages
# ---------------------------------------------------------------------------

class RaftisStale(trf.FakeRedis):
    def __init__(self):
        super().__init__()
        self.reads = 0

    def run(self, *args):
        if args[0] == "GET":
            self.reads += 1
            if self.reads >= 20:
                return "99"
        return super().run(*args)


class RaftisDropping(trf.FakeRedis):
    def __init__(self):
        super().__init__()
        self.n = 0

    def run(self, *args):
        if args[0] == "INCRBY":
            self.n += 1
            if self.n % 3 == 0:
                with self.lock:
                    return str(self.kv.get(args[1], 0))
        return super().run(*args)


class SentinelSplitBrain(trs.FakeRedis):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def cli(self, host, port, *args):
        with self.lock:
            self.calls += 1
            diverged = self.calls > 120
        if diverged and args[0].upper() == "GET":
            return "99"
        return super().cli(host, port, *args)


class AerospikePhantom(tae.FakeAerospike):
    def __init__(self):
        super().__init__()
        self.reads = 0

    def run(self, statement):
        if statement.startswith("SELECT"):
            self.reads += 1
            if self.reads >= 20:
                return self._table(99)
        return super().run(statement)


class CrateLostUpdates(tcr.FakeCrate):
    def __init__(self):
        super().__init__()
        self.writes = 0

    def stmt(self, sql, args=None):
        out = super().stmt(sql, args)
        if sql.strip().upper().startswith("INSERT"):
            self.writes += 1
            if self.writes % 4 == 0:
                with self.lock:
                    self.value = 97
        return out


class RethinkStale(trd.FakeRethink):
    def __init__(self):
        super().__init__()
        self.reads = 0

    def run(self, *args):
        if args[0] == "read":
            self.reads += 1
            if self.reads >= 20:
                return "VAL 99"
        return super().run(*args)


# name: (suite, workload, opts, transport attr, factory(root), valid?)
RUNS = {
    "raftis-register": ("raftis", "register_workload",
                        {"ops": 150, "seed": 3}, "cli_factory",
                        lambda r: trf.FakeCliFactory(), True),
    "raftis-register-stale": ("raftis", "register_workload",
                              {"ops": 200, "seed": 5}, "cli_factory",
                              lambda r: trf.FakeCliFactory(RaftisStale()),
                              False),
    "raftis-counter": ("raftis", "counter_workload",
                       {"ops": 200, "seed": 7}, "cli_factory",
                       lambda r: trf.FakeCliFactory(), True),
    "raftis-counter-dropped": ("raftis", "counter_workload",
                               {"ops": 300, "seed": 9}, "cli_factory",
                               lambda r: trf.FakeCliFactory(
                                   RaftisDropping()), False),
    "redis_sentinel-register": ("redis_sentinel", "register_workload",
                                {"ops": 150, "seed": 5}, "cli_factory",
                                lambda r: trs.FakeCliFactory(), True),
    "redis_sentinel-register-split-brain": (
        "redis_sentinel", "register_workload", {"ops": 200, "seed": 7},
        "cli_factory", lambda r: trs.FakeCliFactory(SentinelSplitBrain()),
        False),
    "aerospike-register": ("aerospike", "register_workload",
                           {"ops": 160, "seed": 7}, "cli_factory",
                           lambda r: tae.FakeCliFactory(), True),
    "aerospike-register-phantom": ("aerospike", "register_workload",
                                   {"ops": 160, "seed": 7}, "cli_factory",
                                   lambda r: tae.FakeCliFactory(
                                       AerospikePhantom()), False),
    "crate-register": ("crate", "register_workload",
                       {"ops": 150, "seed": 9}, "sql_factory",
                       lambda r: tcr.FakeSqlFactory(), True),
    "crate-register-lost-updates": ("crate", "register_workload",
                                    {"ops": 200, "seed": 11},
                                    "sql_factory",
                                    lambda r: tcr.FakeSqlFactory(
                                        CrateLostUpdates()), False),
    "rethinkdb-register": ("rethinkdb", "register_workload",
                           {"ops": 150, "seed": 3}, "cli_factory",
                           lambda r: trd.FakeCliFactory(), True),
    "rethinkdb-register-stale": ("rethinkdb", "register_workload",
                                 {"ops": 150, "seed": 3}, "cli_factory",
                                 lambda r: trd.FakeCliFactory(
                                     RethinkStale()), False),
}


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_checked_by_both(run, root):
    name, workload, opts, attr, factory, valid = RUNS[run]
    res = run_checked_by_both(root, name, workload, opts, attr, factory,
                              valid)
    if not valid and workload == "register_workload":
        assert res["anomaly-classes"]["nonlinearizable"] == "witnessed"


class ZkPhantom(tzk.FakeZk):
    def __init__(self):
        super().__init__()
        self.gets = 0

    def responder(self, node, action):
        r = super().responder(node, action)
        if r is not None and re.search(r"zkCli\.sh -server \S+ '?get ",
                                       action.cmd) and r.exit == 0:
            self.gets += 1
            if self.gets >= 20:
                r.out = r.out.replace(f"{self.value}\n", "99\n", 1)
        return r


def _zk_run(root, fake, seed=4):
    s = suite(root, "zookeeper")
    gen = mod(root, "generator")
    models = mod(root, "checker.models")
    cas_op_mix = mod(root, "workloads.register").cas_op_mix
    rng = random.Random(seed)
    test = make_test(root, fake.responder, ("n1", "n2"))
    test.update(concurrency=4, client=s.ZkCasClient(),
                checker=mod(root, "checker").linearizable(device_opts(
                    root, {"model": models.cas_register(0)})),
                generator=gen.clients(gen.limit(
                    120, lambda: cas_op_mix(rng, n_values=3))))
    return mod(root, "core").run(test)


def _zk_checker(root):
    models = mod(root, "checker.models")
    return mod(root, "checker").linearizable(device_opts(
        root, {"model": models.cas_register(0)}))


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("twin", [False, True])
def test_zookeeper_run_checked_by_both(root, twin):
    test = _zk_run(root, ZkPhantom() if twin else tzk.FakeZk())
    held_by_both(test, _zk_checker, not twin)


# ---------------------------------------------------------------------------
# builders, command lines, stored runs, phase 27
# ---------------------------------------------------------------------------

BUILDERS = {"zookeeper": "zk_test", "raftis": "raftis_test",
            "redis_sentinel": "redis_sentinel_test",
            "aerospike": "aerospike_test", "crate": "crate_test",
            "rethinkdb": "rethinkdb_test"}
OPTS = {"nodes": ["n1", "n2", "n3"], "concurrency": 6,
        "ssh": {"dummy": True}, "time_limit": 1, "seed": 2}


@pytest.mark.parametrize("name", SUITES)
def test_builder_shape_equal(name):
    got = {root: shape(getattr(suite(root, name), BUILDERS[name])(
        device_opts(root, OPTS))) for root in ROOTS}
    assert got[PORT] == got[JAX]
    if name != "zookeeper":
        assert list(suite(PORT, name).WORKLOADS) == \
            list(suite(JAX, name).WORKLOADS)


@pytest.mark.parametrize("name", SUITES)
def test_command_line_options(name):
    port, jax = help_options(PORT, name), help_options(JAX, name)
    assert sorted(set(port) - {"--device"}) == sorted(set(jax))
    assert "--device" in port
    argv = ["--nodes", "n1,n2", "--time-limit", "3", "--no-ssh"]
    got = parsed(PORT, name, argv + ["--device", "cpu"])
    want = parsed(JAX, name, argv)
    assert got.pop("device") == "cpu"
    assert got == want


@pytest.mark.parametrize("writer", ROOTS)
@pytest.mark.parametrize("run", sorted(small_specs(SUITES)))
def test_stored_run_analysed_by_both(run, writer, tmp_path):
    stored_across(writer, small_specs(SUITES)[run], tmp_path)


def test_phase_27_kv_runs_at_a_small_size(monkeypatch):
    launches = phase_27(SUITES, monkeypatch)
    # the plain wgl_search on the CPU, once a run
    assert sorted(launches["wgl_search"]) == sorted(
        f"suite-{s}" for s in small_specs(SUITES))
    assert not launches["scc"] and not launches["bank_reduce"]
