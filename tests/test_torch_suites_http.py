"""The port's consul, mongodb and voltdb suites against the JAX package's,
on the CPU: the independent-key registers (consul's KV over HTTP,
mongodb's documents through the mongo shell, voltdb's partitioned table
through sqlcmd) and voltdb's dirty-read workload.

For each suite: the DB's command streams per node on the dummy remote;
the transport against the JAX test's in-memory fake (consul's KV driver
on the fake's HTTP replies, each package's own ConsulHttp around the one
fake); the client's completions and the fake's state; the error
classification; whole clusterless runs, healthy and with the JAX test's
seeded bug (phantom reads, stale reads, leaked dirty rows), recorded on
each package and checked by both with equal results and the same failing
keys; the builder, the command line, stored runs across packages, and
phase 27 at a small size. Every test clears both packages' net address
cache first (the JAX tests' order dependence, ROADMAP C2, stays out of
these).
"""

from __future__ import annotations

import base64
import json

import pytest

import test_consul as tcn
import test_mongodb as tmg
import test_voltdb as tvd
from test_torch_suites_registry import (  # noqa: F401 (fixture)
    JAX, PORT, ROOTS, Raising, both_streams, clear_ip_caches, device_opts,
    failing_keys, help_options, make_test, mod, op, outcome, parsed,
    phase_27, remote_error, run_checked_by_both, shape, small_specs,
    stored_across, suite)

SUITES = ("consul", "mongodb", "voltdb")


def consul_factory(state=None):
    """tests/test_consul.py's FakeHttpFactory per package: root's own
    ConsulHttp, its request answered by the one fake."""
    state = state or tcn.FakeConsulState()

    def for_root(root):
        def make(node, consistency=None, timeout=5.0):
            http = suite(root, "consul").ConsulHttp(
                node, consistency=consistency, timeout=timeout)
            http.request = state.request
            return http

        make.state = state
        return make

    return for_root


def kop(root, f, k, v=None):
    return op(root, f, mod(root, "independent").ktuple(k, v))


# ---------------------------------------------------------------------------
# DB command streams
# ---------------------------------------------------------------------------

DBS = {
    "consul": (lambda s, r: s.ConsulDB("1.6.1", http_factory=None),
               tcn.getent_responder),
    "mongodb": (lambda s, r: s.MongoDB("7.0.14", shell_factory=None),
                tmg.responder),
    "voltdb": (lambda s, r: s.VoltdbDB(), tvd.responder),
    "voltdb-k2": (lambda s, r: s.VoltdbDB(kfactor=2), tvd.responder),
}


@pytest.mark.parametrize("db", sorted(DBS))
@pytest.mark.parametrize("method", ["setup", "teardown", "kill", "start"])
def test_db_command_stream(db, method):
    make_db, responder = DBS[db]
    calls = ([("setup", None)] if method == "setup"
             else [(method, "n2")])
    both_streams(db.split("-")[0], make_db, calls, responder,
                 prepare=True)


def test_mongodb_initiates_on_the_primary_alike():
    got = {}
    for root in ROOTS:
        calls = []

        class Shell:
            def __init__(self, test, node, direct=False, timeout=10.0):
                self.node = node

            def run_command(self, command, admin=False):
                calls.append((self.node, next(iter(command)), admin))
                if "replSetInitiate" in command:
                    return {"ok": 1}
                return {"ok": 1, "isWritablePrimary": True}

            def close(self):
                pass

        test = make_test(root, tmg.responder, prepare=True)
        db = suite(root, "mongodb").MongoDB(shell_factory=Shell)
        mod(root, "control").on_nodes(test, lambda t, n: db.setup(t, n))
        got[root] = sorted(calls)
    assert got[PORT] == got[JAX]
    assert ("n1", "replSetInitiate", True) in got[PORT]


def test_consul_db_awaits_its_cluster_alike():
    """The primary's setup polls the catalog through the DB's own
    http_factory until every node has joined."""
    got = {}
    for root in ROOTS:
        f = consul_factory()(root)
        test = make_test(root, tcn.getent_responder)
        db = suite(root, "consul").ConsulDB("1.6.1", http_factory=f)
        with mod(root, "control").with_session(test, "n1"):
            db.setup(test, "n1")
        got[root] = f.state.requests
    assert got[PORT] == got[JAX]
    assert ("GET", "/v1/catalog/nodes", {}) in got[PORT]


# ---------------------------------------------------------------------------
# consul's KV driver on the fake's HTTP replies
# ---------------------------------------------------------------------------

def _driver(root, steps):
    f = consul_factory()(root)
    http = f("n1")
    out = [step(http) for step in steps]
    return out, dict(f.state.kv), f.state.requests


DRIVER = {
    "missing": [lambda h: h.get("register/0")],
    "roundtrip": [lambda h: h.put("register/0", "3"),
                  lambda h: h.get("register/0")],
    "cas": [lambda h: h.put("k", "1"), lambda h: h.cas("k", "1", "2"),
            lambda h: h.get("k"), lambda h: h.cas("k", "1", "9"),
            lambda h: h.get("k")],
    "cas-missing": [lambda h: h.cas("nope", "1", "2")],
}


@pytest.mark.parametrize("case", sorted(DRIVER))
def test_consul_kv_driver_alike(case):
    assert _driver(PORT, DRIVER[case]) == _driver(JAX, DRIVER[case])


def test_consul_cas_index_race_loses_alike():
    got = {}
    for root in ROOTS:
        f = consul_factory()(root)
        http = f("n1")
        http.put("k", "1")
        real = http.request
        raced = {"done": False}

        def racing(method, path, params=None, body=None):
            if method == "PUT" and "cas" in (params or {}) and \
                    not raced["done"]:
                raced["done"] = True
                real("PUT", path, {}, "1")
            return real(method, path, params, body)

        http.request = racing
        got[root] = (http.cas("k", "1", "2"), f.state.kv["k"])
    assert got[PORT] == got[JAX]
    assert got[PORT][0] is False and got[PORT][1][0] == "1"


def test_consul_consistency_threads_through_alike():
    got = {}
    for root in ROOTS:
        f = consul_factory()(root)
        http = f("n1", consistency="stale")
        http.put("k", "1")
        http.get("k")
        got[root] = f.state.requests
    assert got[PORT] == got[JAX]
    assert all("stale" in p for m, _path, p in got[PORT] if m == "GET")


def test_consul_await_cluster_ready_alike():
    for root in ROOTS:
        s = suite(root, "consul")
        f = consul_factory(tcn.FakeConsulState(nodes=["n1", "n2"]))(root)
        s.await_cluster_ready(f("n1"), 2, timeout_secs=1)
        f = consul_factory(tcn.FakeConsulState(nodes=["n1"]))(root)
        with pytest.raises(mod(root, "util").Timeout):
            s.await_cluster_ready(f("n1"), 3, timeout_secs=0.1)


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------

SCRIPT = [("read", 0, None), ("write", 0, 3), ("read", 0, None),
          ("cas", 0, [3, 4]), ("cas", 0, [3, 9]), ("read", 0, None),
          ("write", 1, 2), ("cas", 1, [2, 0]), ("read", 1, None)]


def _client(root, name):
    if name == "consul":
        f = consul_factory()(root)
        c = suite(root, "consul").ConsulRegisterClient(http_factory=f)
        state = lambda: dict(f.state.kv)  # noqa: E731
    elif name == "mongodb":
        f = tmg.FakeShellFactory()
        c = suite(root, "mongodb").MongoCasClient(shell_factory=f)
        state = lambda: (dict(f.state.docs), f.state.commands)  # noqa
    else:
        f = tvd.FakeSqlFactory()
        c = suite(root, "voltdb").VoltRegisterClient(sql_factory=f)
        state = lambda: dict(f.state.registers)  # noqa: E731
    c = c.open({"nodes": ["n1"]}, "n1")
    out = [outcome(c.invoke({}, kop(root, fn, k, v)))
           for fn, k, v in SCRIPT]
    return out, state()


@pytest.mark.parametrize("name", SUITES)
def test_register_client_alike(name):
    port, jax = _client(PORT, name), _client(JAX, name)
    assert port == jax
    assert [o[0] for o in port[0]] == ["ok", "ok", "ok", "ok", "fail",
                                      "ok", "ok", "ok", "ok"]


def test_mongodb_concerns_alike():
    got = {}
    for root in ROOTS:
        out = []
        for wc, rc in (("majority", "linearizable"), ("1", "majority")):
            f = tmg.FakeShellFactory()
            c = suite(root, "mongodb").MongoCasClient(
                shell_factory=f, write_concern=wc,
                read_concern=rc).open({"nodes": ["n1"]}, "n1")
            c.invoke({}, kop(root, "write", 0, 1))
            c.invoke({}, kop(root, "read", 0))
            out.append(f.state.commands)
        got[root] = out
    assert got[PORT] == got[JAX]


class Racy(tmg.FakeMongo):
    def run_command(self, command, admin=False):
        if "update" in command:
            return {"ok": 1, "n": 0, "writeErrors": [
                {"index": 0, "code": 11000,
                 "errmsg": "E11000 duplicate key"}]}
        return super().run_command(command, admin)


class Undurable(tmg.FakeMongo):
    def run_command(self, command, admin=False):
        res = super().run_command(command, admin)
        if "update" in command:
            res["writeConcernError"] = {"code": 64,
                                        "errmsg": "waiting for replication"}
        return res


class Noop(tmg.FakeMongo):
    def run_command(self, command, admin=False):
        if "update" in command and "value" not in command["updates"][0]["q"]:
            return {"ok": 1, "n": 0, "nModified": 0}
        return super().run_command(command, admin)


@pytest.mark.parametrize("fake,want", [(Racy, ["fail", "fail"]),
                                       (Undurable, ["info", "info"]),
                                       (Noop, ["fail", "fail"])])
def test_mongodb_update_replies_alike(fake, want):
    got = {}
    for root in ROOTS:
        c = suite(root, "mongodb").MongoCasClient(
            shell_factory=tmg.FakeShellFactory(fake())).open(
            {"nodes": ["n1"]}, "n1")
        got[root] = [outcome(c.invoke({}, kop(root, "write", 0, 3))),
                     outcome(c.invoke({}, kop(root, "cas", 0, [3, 4])))]
    assert got[PORT] == got[JAX]
    assert [o[0] for o in got[PORT]] == want


ERRORS = [
    ("mongodb", "write", lambda r: remote_error(
        r, "mongosh failed", err="NotWritablePrimary"), "fail"),
    ("mongodb", "write", lambda r: mod(r, "control.core").RemoteError(
        "mongosh timed out", cmd="mongosh", node="n1"), "info"),
    ("mongodb", "read", lambda r: mod(r, "control.core").RemoteError(
        "mongosh timed out", cmd="mongosh", node="n1"), "fail"),
    ("voltdb", "write", lambda r: remote_error(
        r, "sqlcmd failed", err="Connection refused"), "fail"),
    ("voltdb", "cas", lambda r: remote_error(r, "timed out"), "info"),
    ("voltdb", "read", lambda r: remote_error(r, "timed out"), "fail"),
]


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_client_error_classified_alike(case):
    name, f, make, want = ERRORS[case]
    value = {"read": None, "write": 1, "cas": [1, 2]}[f]
    got = {}
    for root in ROOTS:
        s = suite(root, name)
        c = (s.MongoCasClient(shell_factory=Raising(root, make))
             if name == "mongodb"
             else s.VoltRegisterClient(sql_factory=Raising(root, make)))
        c = c.open({"nodes": ["n1"]}, "n1")
        got[root] = outcome(c.invoke({}, kop(root, f, 0, value)))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == want


class CorruptConsul(tcn.FakeConsulState):
    def request(self, method, path, params=None, body=None):
        if method == "GET" and path.startswith("/v1/kv/"):
            return 200, json.dumps([{
                "Key": path[len("/v1/kv/"):], "ModifyIndex": 1,
                "Value": base64.b64encode(b"not-a-number").decode()}])
        return super().request(method, path, params, body)


def test_consul_corrupt_value_raises_alike():
    """A non-integer KV value crashes the op (info in a run), never a
    clean fail, in both packages."""
    for root in ROOTS:
        c = suite(root, "consul").ConsulRegisterClient(
            http_factory=consul_factory(CorruptConsul())(root)).open(
            {}, "n1")
        with pytest.raises(ValueError):
            c.invoke({}, kop(root, "read", 0))


@pytest.mark.parametrize("text,want", [("1\n", 1),
                                       ("(Returned 1 rows)\n0\n", 0),
                                       ("v=3\n", 0)])
def test_voltdb_count_alike(text, want):
    assert suite(PORT, "voltdb")._count(text) == \
        suite(JAX, "voltdb")._count(text) == want


# ---------------------------------------------------------------------------
# whole clusterless runs
# ---------------------------------------------------------------------------

class ConsulPhantom(tcn.FakeConsulState):
    def __init__(self):
        super().__init__()
        self.reads = 0

    def request(self, method, path, params=None, body=None):
        if method == "GET" and path.startswith("/v1/kv/"):
            self.reads += 1
            if self.reads >= 20:
                return 200, json.dumps([{
                    "Key": path[len("/v1/kv/"):], "ModifyIndex": 1,
                    "Value": base64.b64encode(b"99").decode()}])
        return super().request(method, path, params, body)


class MongoStale(tmg.FakeMongo):
    def __init__(self):
        super().__init__()
        self.reads = 0

    def run_command(self, command, admin=False):
        if "find" in command:
            self.reads += 1
            if self.reads > 10:
                k = command["filter"]["_id"]
                return {"ok": 1, "cursor": {"firstBatch": [
                    {"_id": k, "value": -7}]}}
        return super().run_command(command, admin)


class VoltPhantom(tvd.FakeVolt):
    def __init__(self):
        super().__init__()
        self.reads = 0

    def _stmt(self, s):
        if s.startswith("SELECT 'v='") and "registers" in s:
            self.reads += 1
            if self.reads >= 20:
                return "v=99"
        return super()._stmt(s)


class VoltLeaky(tvd.FakeVolt):
    def _stmt(self, s):
        import re

        m = re.match(r"INSERT INTO dirty_reads \(id\) VALUES \((\d+)\)", s)
        if m:
            self.dirty.add(int(m.group(1)))
            return "0"
        if s.startswith("SELECT 'i='"):
            return None
        return super()._stmt(s)


N3 = {"nodes": ("n1", "n2", "n3")}
RUNS = {
    "consul-register": ("consul", "register_workload",
                        {"concurrency": 6, "keys": 2, "ops_per_key": 60,
                         "seed": 7}, "http_factory",
                        lambda r: consul_factory()(r), True,
                        dict(N3, concurrency=6, stagger=0.0005)),
    "consul-register-phantom": ("consul", "register_workload",
                                {"concurrency": 4, "keys": 1,
                                 "ops_per_key": 80, "seed": 3},
                                "http_factory",
                                lambda r: consul_factory(ConsulPhantom())(r),
                                False,
                                dict(nodes=("n1",), concurrency=4,
                                     stagger=0.0005)),
    "consul-register-one-thread": ("consul", "register_workload",
                                   {"concurrency": 1, "keys": 1,
                                    "ops_per_key": 40, "seed": 5},
                                   "http_factory",
                                   lambda r: consul_factory()(r), True,
                                   dict(nodes=("n1",), concurrency=1,
                                        stagger=0.0005)),
    "mongodb-cas": ("mongodb", "cas_workload",
                    {"concurrency": 6, "keys": 2, "ops_per_key": 60,
                     "seed": 7}, "shell_factory",
                    lambda r: tmg.FakeShellFactory(), True,
                    dict(N3, concurrency=6, stagger=0.0005)),
    "mongodb-cas-stale": ("mongodb", "cas_workload",
                          {"concurrency": 6, "keys": 1, "ops_per_key": 80,
                           "seed": 3}, "shell_factory",
                          lambda r: tmg.FakeShellFactory(MongoStale()),
                          False, dict(N3, concurrency=6, stagger=0.0005)),
    "voltdb-register": ("voltdb", "register_workload",
                        {"concurrency": 6, "keys": 2, "ops_per_key": 60,
                         "seed": 7}, "sql_factory",
                        lambda r: tvd.FakeSqlFactory(), True,
                        dict(concurrency=6)),
    "voltdb-register-phantom": ("voltdb", "register_workload",
                                {"concurrency": 4, "keys": 1,
                                 "ops_per_key": 160, "seed": 3},
                                "sql_factory",
                                lambda r: tvd.FakeSqlFactory(
                                    VoltPhantom()), False,
                                dict(concurrency=4)),
    "voltdb-dirty-read": ("voltdb", "dirty_read_workload",
                          {"concurrency": 6, "ops": 120, "seed": 5},
                          "sql_factory", lambda r: tvd.FakeSqlFactory(),
                          True, dict(concurrency=6, final=True)),
    "voltdb-dirty-read-leaky": ("voltdb", "dirty_read_workload",
                                {"concurrency": 6, "ops": 120, "seed": 5},
                                "sql_factory",
                                lambda r: tvd.FakeSqlFactory(VoltLeaky()),
                                False, dict(concurrency=6, final=True)),
}


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_checked_by_both(run, root):
    name, workload, opts, attr, factory, valid, kw = RUNS[run]
    res = run_checked_by_both(root, name, workload, opts, attr, factory,
                              valid, **kw)
    if not valid and workload != "dirty_read_workload":
        # the one key of a twin fails
        assert failing_keys(res) == [0]
    if workload == "dirty_read_workload":
        assert res["strong-read-count"] > 0 if valid else \
            res["dirty-count"] > 0


# ---------------------------------------------------------------------------
# builders, command lines, stored runs, phase 27
# ---------------------------------------------------------------------------

BUILDERS = {"consul": "consul_test", "mongodb": "mongodb_test",
            "voltdb": "voltdb_test"}
OPTS = {"nodes": ["n1", "n2", "n3"], "concurrency": 6,
        "ssh": {"dummy": True}, "time_limit": 1, "seed": 1}


@pytest.mark.parametrize("name,extra", [
    ("consul", {"workload": "register"}),
    ("consul", {"workload": "register", "consistency": "stale"}),
    ("mongodb", {}), ("mongodb", {"write_concern": "1",
                                  "read_concern": "majority"}),
    ("voltdb", {"workload": "register"}),
    ("voltdb", {"workload": "dirty-read"})])
def test_builder_shape_equal(name, extra):
    tests = {root: getattr(suite(root, name), BUILDERS[name])(
        device_opts(root, dict(OPTS, **extra))) for root in ROOTS}
    assert shape(tests[PORT]) == shape(tests[JAX])
    for attr in ("consistency", "write_concern", "read_concern"):
        assert getattr(tests[PORT]["client"], attr, None) == \
            getattr(tests[JAX]["client"], attr, None)
    assert list(suite(PORT, name).WORKLOADS) == \
        list(suite(JAX, name).WORKLOADS)


@pytest.mark.parametrize("name", SUITES)
def test_command_line_options(name):
    port, jax = help_options(PORT, name), help_options(JAX, name)
    assert sorted(set(port) - {"--device"}) == sorted(set(jax))
    argv = ["--nodes", "n1,n2", "--time-limit", "3", "--no-ssh"]
    got = parsed(PORT, name, argv + ["--device", "cpu"])
    want = parsed(JAX, name, argv)
    assert got.pop("device") == "cpu"
    assert got == want


@pytest.mark.parametrize("writer", ROOTS)
@pytest.mark.parametrize("run", sorted(small_specs(SUITES)))
def test_stored_run_analysed_by_both(run, writer, tmp_path):
    stored_across(writer, small_specs(SUITES)[run], tmp_path)


def test_phase_27_http_runs_at_a_small_size(monkeypatch):
    launches = phase_27(SUITES, monkeypatch)
    # one plain wgl_search for all keys of each run, twin included
    assert sorted(launches["wgl_search"]) == sorted(
        f"suite-{s}" for s in small_specs(SUITES))
    assert not launches["scc"] and not launches["bank_reduce"]
