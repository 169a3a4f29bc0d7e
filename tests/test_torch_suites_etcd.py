"""The port's etcd suite against the JAX package's, on the CPU: the
register (independent keys, one wgl_search launch) and list-append (Elle)
workloads over the v3 JSON gateway, the membership state machine over
the port's nemesis/membership.py, the nemesis menu and test-all's sweep.

The DB's command streams per node (setup, teardown, kill, start, pause,
resume, a member's daemon alone); the gateway's requests and how its
replies are read; the clients against the JAX test's FakeEtcd; the
membership view, the ops it picks on one seed, its join and leave
commands and member API calls; whole clusterless runs, healthy and with
lost writes, recorded on each package and checked by both; the builder,
the command line, `all_tests`' sequence, stored runs across packages and
phase 27 at a small size.
"""

from __future__ import annotations

import base64
import urllib.error

import pytest

import test_etcd as ted
from test_torch_suites_registry import (  # noqa: F401 (fixture)
    JAX, PORT, ROOTS, both_streams, clear_ip_caches, device_opts,
    held_by_both, help_options, make_test, mod, op, outcome, parsed,
    phase_27, shape, small_specs, stored_across, stream, suite)

NODES = ["n1", "n2", "n3"]


def etcd(root):
    return suite(root, "etcd")


def test_cluster_urls_alike():
    t = {"nodes": NODES}
    for fn in ("initial_cluster",):
        assert getattr(etcd(PORT), fn)(t) == getattr(etcd(JAX), fn)(t)
    for n in NODES:
        for fn in ("peer_url", "client_url"):
            assert getattr(etcd(PORT), fn)(n) == getattr(etcd(JAX), fn)(n)


# ---------------------------------------------------------------------------
# DB command streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["setup", "teardown", "kill", "start",
                                    "pause", "resume",
                                    "setup_daemon_only"])
def test_db_command_stream(method):
    calls = ([("setup", None)] if method == "setup"
             else [(method, "n2"), (method, "n3")])
    both_streams("etcd", lambda s, r: s.EtcdDB("v3.5.15"), calls,
                 ted.fresh_node_responder, prepare=True)


# ---------------------------------------------------------------------------
# the gateway
# ---------------------------------------------------------------------------

def _b64(s):
    return base64.b64encode(s.encode()).decode()


class Gateway:
    """The v3 JSON gateway over tests/test_etcd.py's FakeEtcd: records
    every (path, body) posted and answers range, put, txn (VALUE, CREATE
    and MOD compares) and the member API."""

    def __init__(self):
        self.state = ted.FakeEtcd()
        self.posts: list = []
        self.members = [{"ID": 11, "name": "n1"}, {"ID": 12, "name": "n2"},
                        {"ID": 13, "name": "n3"}]

    def post(self, path, body):
        self.posts.append((path, body))
        s = self.state
        un = lambda v: base64.b64decode(v).decode()  # noqa: E731
        if path == "/v3/kv/range":
            k = un(body["key"])
            if k not in s.kv:
                return {}
            return {"kvs": [{"value": _b64(s.kv[k]),
                             "mod_revision": str(s.rev[k])}]}
        if path == "/v3/kv/put":
            s._write(un(body["key"]), un(body["value"]))
            return {}
        if path == "/v3/kv/txn":
            ok = True
            for c in body["compare"]:
                k = un(c["key"])
                if c["target"] == "VALUE":
                    ok &= s.kv.get(k) == un(c["value"])
                elif c["target"] == "CREATE":
                    ok &= k not in s.kv
                else:
                    ok &= str(s.rev.get(k) or 0) == c["mod_revision"]
            if ok:
                for p in body["success"]:
                    put = p["requestPut"]
                    s._write(un(put["key"]), un(put["value"]))
            return {"succeeded": ok} if ok else {}
        if path == "/v3/cluster/member/list":
            return {"members": list(self.members)}
        if path == "/v3/cluster/member/add":
            self.members.append({"ID": 20 + len(self.members),
                                 "peerURLs": body["peerURLs"]})
            return {"member": self.members[-1]}
        if path == "/v3/cluster/member/remove":
            self.members = [m for m in self.members if m["ID"] != body["ID"]]
            return {}
        raise AssertionError(path)


def _gateway(root):
    g = Gateway()
    http = etcd(root).EtcdHttp("n1")
    http.post = g.post
    out = [http.get("k"), http.put("k", "1"), http.get("k"),
           http.cas("k", "1", "2"), http.cas("k", "1", "3"),
           http.cas_create("k", "4"), http.cas_create("j", "5"),
           http.txn_rw([("k", 2), ("x", None)], [("k", "6"), ("x", "7")]),
           http.txn_rw([("k", 3)], [("k", "8")]), http.get("k"),
           http.get("x"), http.members(), http.member_add("http://n4:2380"),
           http.member_remove(12), http.members()]
    return out, g.posts, http.base


def test_gateway_requests_and_replies_alike():
    port, jax = _gateway(PORT), _gateway(JAX)
    assert port == jax
    assert port[0][9] == ("6", 4)


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------

def _register(root, factory_of):
    state = ted.FakeEtcd()
    c = etcd(root).EtcdRegisterClient(factory_of(state)).open({}, "n1")
    t = mod(root, "independent").ktuple
    script = [("read", t(1, None)), ("write", t(1, 3)), ("read", t(1, None)),
              ("cas", t(1, [3, 4])), ("cas", t(1, [9, 5])),
              ("read", t(1, None)), ("cas", t(2, [0, 1])),
              ("write", t(2, 0)), ("cas", t(2, [0, 1]))]
    return [outcome(c.invoke({}, op(root, f, v))) for f, v in script], \
        dict(state.kv)


def test_register_client_alike():
    port = _register(PORT, lambda s: s.factory)
    assert port == _register(JAX, lambda s: s.factory)
    assert [o[0] for o in port[0]] == ["ok", "ok", "ok", "ok", "fail",
                                      "ok", "fail", "ok", "ok"]


def test_register_client_on_the_gateway_alike():
    """The same ops through each package's EtcdHttp on the gateway."""
    got = {}
    for root in ROOTS:
        g = Gateway()
        c = etcd(root).EtcdRegisterClient(
            lambda node, r=root: _with_post(etcd(r).EtcdHttp(node), g)).open(
            {}, "n1")
        t = mod(root, "independent").ktuple
        got[root] = ([outcome(c.invoke({}, op(root, f, v))) for f, v in (
            ("write", t(0, 2)), ("cas", t(0, [2, 3])), ("read", t(0, None)))],
            g.posts)
    assert got[PORT] == got[JAX]


def _with_post(http, g):
    http.post = g.post
    return http


APPEND = [[["append", "x", 1], ["r", "x", None]], [["append", "x", 2]],
          [["r", "x", None], ["append", "y", 9], ["r", "y", None]],
          [["r", "z", None]]]


def test_append_client_alike():
    got = {}
    for root in ROOTS:
        state = ted.FakeEtcd()
        c = etcd(root).EtcdAppendClient(state.factory).open({}, "n1")
        got[root] = ([outcome(c.invoke({}, op(root, "txn", m)))
                      for m in APPEND], dict(state.kv))
    assert got[PORT] == got[JAX]
    assert got[PORT][0][2][2] == [["r", "x", [1, 2]], ["append", "y", 9],
                                  ["r", "y", [9]]]


class Boom:
    def __init__(self, exc):
        self.exc = exc

    def _raise(self, *_a):
        raise self.exc

    get = put = cas = cas_create = txn_rw = _raise


@pytest.mark.parametrize("exc,want", [
    (urllib.error.URLError(ConnectionRefusedError(111)), "fail"),
    (urllib.error.URLError(TimeoutError()), "info"),
    (TimeoutError(), "info"),
    (ConnectionRefusedError(111), "fail")])
@pytest.mark.parametrize("f", ["read", "write", "cas", "txn"])
def test_error_mapping_alike(exc, want, f):
    got = {}
    for root in ROOTS:
        t = mod(root, "independent").ktuple
        value = {"read": t(1, None), "write": t(1, 2),
                 "cas": t(1, [1, 2]), "txn": [["append", "x", 1]]}[f]
        cls = etcd(root).EtcdAppendClient if f == "txn" \
            else etcd(root).EtcdRegisterClient
        c = cls(lambda n: Boom(exc)).open({}, "n1")
        got[root] = outcome(c.invoke({}, op(root, f, value)))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == want


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------

def _membership(root, seed=3):
    g = Gateway()
    s = etcd(root)
    # five nodes, three of them members: the view sits at the majority
    # floor, so the machine grows it back
    test = make_test(root, ted.fresh_node_responder, NODES + ["n4", "n5"])
    db = s.EtcdDB("v3.5.15")
    m = s.EtcdMembership(http_factory=lambda n: _with_post(s.EtcdHttp(n), g),
                         db=db, seed=seed)
    out = [sorted(m.node_view(test, n)) for n in NODES]
    m.node_views = {n: m.node_view(test, n) for n in NODES}
    m.view = m.merge_views(test)
    out.append(sorted(m.view))
    out.append(sorted(m.fs()))
    Op = mod(root, "history").Op
    picked = m.op(test)
    out.append(picked)
    for f, target in (("remove-member", "n2"), ("add-member", "n4"),
                      ("remove-member", "n9")):
        done = m.invoke(test, Op(type="info", process="nemesis", f=f,
                                 value=target))
        out.append((done.f, done.value))
        out.append(m.resolve_op(test, (None, done.to_dict() | {
            "value": tuple(done.value)})))
    out.append(g.posts)
    return out, stream(root, test)


def test_membership_view_ops_and_commands_alike():
    port, jax = _membership(PORT), _membership(JAX)
    assert port == jax
    assert port[0][3] == ["n1", "n2", "n3"]
    assert ("add-member", ["n4", "added"]) in port[0]
    # the joining member starts clean, as an existing cluster's member
    assert any("rm -rf /opt/etcd/n4.etcd" in a[1]
               for a in port[1]["n4"] if a[0] == "exec")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_membership_package_alike(seed):
    pkgs = {}
    for root in ROOTS:
        p = etcd(root).membership_package({
            "nodes": NODES, "faults": ["membership"],
            "membership": {"seed": seed,
                           "http_factory": lambda n: Gateway()}})
        pkgs[root] = (sorted(p["nemesis"].fs()),
                      type(p["nemesis"]).__name__,
                      sorted(k for k in p if p[k] is not None))
    assert pkgs[PORT] == pkgs[JAX]


# ---------------------------------------------------------------------------
# whole clusterless runs (the JAX test's run_suite_workload)
# ---------------------------------------------------------------------------

def suite_run(root, name, client_of, ops_per_key=60):
    opts = device_opts(root, {
        "workload": name, "nodes": NODES, "concurrency": 3,
        "ssh": {"dummy": True}, "time_limit": 5, "rate": 500,
        "ops_per_key": ops_per_key, "ops": 120, "seed": 7})
    s = etcd(root)
    test = s.etcd_test(opts)
    w = s.WORKLOADS[name](opts)
    test.update(os=mod(root, "os_setup").noop, db=mod(root, "db").noop,
                client=client_of(s), nemesis=None, name=None,
                generator=mod(root, "generator").clients(w["generator"]))
    return mod(root, "core").run(test), opts


# name: (workload, client(suite, FakeEtcd), ops a key, valid?). The
# lost writes are the JAX test's BrokenHttp (every third put acked and
# dropped), at 200 ops a key: at the JAX test's 60 a run can pass (its
# intermittent failure, ROADMAP C2); at 200 each of ten runs failed
# three or four of its four keys.
RUNS = {
    "register": ("register",
                 lambda s, st: s.EtcdRegisterClient(st.factory), 60, True),
    "register-lost-writes": ("register",
                             lambda s, st: s.EtcdRegisterClient(
                                 lambda n: ted.BrokenHttp(st)), 200,
                             False),
    "append": ("append", lambda s, st: s.EtcdAppendClient(st.factory), 60,
               True),
}


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_checked_by_both(run, root):
    name, client, ops_per_key, valid = RUNS[run]
    state = ted.FakeEtcd()
    test, opts = suite_run(root, name, lambda s: client(s, state),
                           ops_per_key)
    res = held_by_both(test, lambda r: mod(r, "checker").compose({
        "workload": etcd(r).WORKLOADS[name](device_opts(r, opts))[
            "checker"]}), valid)
    if not valid:
        assert res["workload"]["failures"]


# ---------------------------------------------------------------------------
# builders, the nemesis menu, test-all, the command line, stored runs
# ---------------------------------------------------------------------------

BASE = {"nodes": NODES, "concurrency": 3, "ssh": {"dummy": True}}


@pytest.mark.parametrize("faults", [None, ["partition"], ["kill"],
                                    ["pause"], ["clock"],
                                    ["partition", "kill"], ["membership"]])
@pytest.mark.parametrize("workload", [None, "register", "append"])
def test_builder_and_nemesis_menu_alike(faults, workload):
    got = {}
    for root in ROOTS:
        opts = device_opts(root, dict(BASE, workload=workload,
                                      faults=faults,
                                      membership={"seed": 3}))
        t = etcd(root).etcd_test(opts)
        got[root] = (shape(t), sorted(t["nemesis"].fs())
                     if hasattr(t["nemesis"], "fs") else None)
    assert got[PORT] == got[JAX]


def test_all_tests_sequence_alike():
    for opts in ({"time_limit": 1, "seed": 1},
                 {"time_limit": 1, "workload": "append", "faults": ["kill"],
                  "test_count": 3, "seed": 1}):
        seqs = {}
        for root in ROOTS:
            tests = list(etcd(root).all_tests(device_opts(
                root, dict(BASE, **opts))))
            seqs[root] = [(t["name"], type(t["nemesis"]).__name__,
                           sorted(t["nemesis"].fs())
                           if hasattr(t["nemesis"], "fs") else None)
                          for t in tests]
            assert len({id(t["nemesis"]) for t in tests}) == len(tests)
        assert seqs[PORT] == seqs[JAX]
    assert etcd(PORT).FAULT_OPTIONS == etcd(JAX).FAULT_OPTIONS


def test_command_line_options():
    port, jax = help_options(PORT, "etcd"), help_options(JAX, "etcd")
    assert sorted(set(port) - {"--device"}) == sorted(set(jax))
    argv = ["--nodes", "n1,n2", "--time-limit", "3", "--no-ssh",
            "--nemesis", "partition,kill"]
    got = parsed(PORT, "etcd", argv + ["--device", "cpu"])
    want = parsed(JAX, "etcd", argv)
    assert got.pop("device") == "cpu"
    assert got == want
    assert got["faults"] == ["partition", "kill"]


def test_test_all_command_parses_alike():
    cmds = {}
    for root in ROOTS:
        cli = mod(root, "cli")
        seen = {}
        real = cli.run_cli

        def capture(subcommands, argv=None):
            seen.update(subcommands)

        cli.run_cli = capture
        try:
            etcd(root).main([])
        finally:
            cli.run_cli = real
        cmds[root] = sorted(seen)
    assert cmds[PORT] == cmds[JAX]
    assert "test-all" in cmds[PORT]


@pytest.mark.parametrize("writer", ROOTS)
@pytest.mark.parametrize("run", sorted(small_specs(("etcd",))))
def test_stored_run_analysed_by_both(run, writer, tmp_path):
    stored_across(writer, small_specs(("etcd",))[run], tmp_path)


def test_phase_27_etcd_runs_at_a_small_size(monkeypatch):
    launches = phase_27(("etcd",), monkeypatch)
    assert sorted(launches["wgl_search"]) == ["suite-etcd-register"]
    assert not launches["scc"] and not launches["bank_reduce"]
