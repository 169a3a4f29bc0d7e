"""The port's dgraph suite against the JAX package's, on the CPU: upsert
uniqueness, indexed deletes, the linearizable register, set, sequential,
bank, long-fork and Elle's rw-register (wr) over the alpha's HTTP API,
and the per-op trace spans.

The DB's command streams per node on the dummy remote; the HTTP
transport's curl commands and its answers to the alpha's JSON (errors,
conflicts, uids, the startTs protocol); each client's completions and
the records of the JAX test's in-memory FakeDgraph (its commit conflicts
raised as each package's own TxnConflict); the error classification; the
trace client's spans; whole clusterless runs of every workload, healthy
and with the JAX test's seeded bugs (a double upsert, a dirty index),
recorded on each package and checked by both with equal results; the
builder, the command line, stored runs across packages, and phase 28 at
a small size. Equality is exact: the results are verdicts and counts.
The upsert, delete and register workloads group their threads by 4 by
default: a thread count that 4 does not divide is refused by the
generator in both packages (ROADMAP C13).
"""

from __future__ import annotations

import json

import pytest

import test_dgraph as tdg
from test_torch_suites_registry import (  # noqa: F401 (fixture)
    JAX, PORT, ROOTS, Raising, both_streams, clear_ip_caches, device_opts,
    help_options, make_test, mod, op, outcome, parsed, phase_28,
    remote_error, run_checked_by_both, shape, small_specs, stored_across,
    suite)

NAME = "dgraph"


def http_factory(state=None):
    """tests/test_dgraph.py's FakeHTTPFactory per package: the one
    FakeDgraph, its commit conflicts raised as root's TxnConflict."""
    state = state or tdg.FakeDgraph()

    def for_root(root):
        conflict = suite(root, NAME).TxnConflict

        class _Http:
            def __getattr__(self, name):
                fn = getattr(state, name)

                def call(*a, **kw):
                    try:
                        return fn(*a, **kw)
                    except suite(JAX, NAME).TxnConflict as e:
                        raise conflict(str(e)) from None

                return call

        http = _Http()

        def make(test, node, timeout=10.0):
            return http

        make.state = state
        return make

    return for_root


def kop(root, f, k, v=None, process=0):
    return op(root, f, mod(root, "independent").ktuple(k, v), process)


# ---------------------------------------------------------------------------
# the DB and the HTTP transport
# ---------------------------------------------------------------------------

def _archive(node, action):
    if action.cmd.startswith("stat "):
        return mod(JAX, "control.core").Result(exit=1, out="",
                                               err="no such file",
                                               cmd=action.cmd)
    if action.cmd.startswith("dirname "):
        return action.cmd.split()[-1].rsplit("/", 1)[0]
    if action.cmd.startswith("ls -A"):
        return "dgraph"
    return None


@pytest.mark.parametrize("method", ["teardown", "kill", "start",
                                    "_start_zero", "_start_alpha"])
def test_db_command_stream(method):
    both_streams(NAME, lambda s, r: s.DgraphDB(replicas=3),
                 [(method, "n2"), (method, "n1")], _archive)


def test_db_setup_stream(monkeypatch):
    """setup (install, zero, alpha, the port wait) with its 2 s pause
    between the daemons taken out."""
    for root in ROOTS:
        monkeypatch.setattr(suite(root, NAME).time, "sleep",
                            lambda s: None)
    both_streams(NAME, lambda s, r: s.DgraphDB(replicas=3),
                 [("setup", None)], _archive)


@pytest.mark.parametrize("nodes", [["n1"], ["n1", "n2", "n3"]])
def test_node_idx_alike(nodes):
    t = {"nodes": nodes}
    assert [suite(PORT, NAME).node_idx(t, n) for n in nodes] == \
        [suite(JAX, NAME).node_idx(t, n) for n in nodes]


def _replies(node, action):
    """The alpha's JSON, by the path curl posts to."""
    cmd = action.cmd
    if "/commit" in cmd:
        return json.dumps({"data": {"code": "Success"}})
    if "/mutate" in cmd:
        return json.dumps({"data": {"uids": {"u": "0x7"}},
                           "extensions": {"txn": {
                               "start_ts": 12, "keys": ["k1"],
                               "preds": ["1-tval"]}}})
    if "/query" in cmd:
        return json.dumps({"data": {"q": [{"uid": "0x7", "val": 3}]},
                           "extensions": {"txn": {"start_ts": 12}}})
    return json.dumps({"data": {"code": "Success"}})


CALLS = {
    "alter": lambda h: h.alter_schema("key: int @index(int) ."),
    "upsert": lambda h: h.upsert_unless_exists("email", "a@b",
                                               {"name": "x"}),
    "delete": lambda h: h.delete_where("key", 3),
    "query": lambda h: h.query_eq("key", 3, want=("uid", "val")),
    "write": lambda h: h.write_value("key", 3, "val", 9),
    "txn": lambda h: (lambda t: (h.txn_query(t, "tkey", 1,
                                             want=("uid", "tval")),
                                 h.txn_set(t, '<0x7> <tval> "2" .'),
                                 h.txn_commit(t), t))(h.txn_begin()),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_http_transport_alike(call):
    got = {}
    for root in ROOTS:
        test = make_test(root, _replies, ("n1", "n2"))
        h = suite(root, NAME).DgraphHTTP(test, "n2", timeout=4)
        with mod(root, "control").with_session(test, "n2"):
            out = CALLS[call](h)
        got[root] = (out, [(a.cmd, a.stdin) for a in
                           test["sessions"]["n2"].log])
    assert got[PORT] == got[JAX]


@pytest.mark.parametrize("errors,want", [
    ([{"message": "Transaction has been aborted. Please retry"}],
     "TxnConflict"),
    ([{"message": "conflict on key"}], "TxnConflict"),
    ([{"message": "predicate not indexed"}], "RemoteError")])
def test_http_errors_alike(errors, want):
    got = {}
    for root in ROOTS:
        test = make_test(root, lambda node, a: json.dumps(
            {"errors": errors}), ("n1",))
        h = suite(root, NAME).DgraphHTTP(test, "n1")
        with mod(root, "control").with_session(test, "n1"):
            with pytest.raises(Exception) as e:
                h.query_eq("key", 1)
        got[root] = (type(e.value).__name__, str(e.value).split(
            " (node=")[0])
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == want


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------

def _upsert(root, c):
    return [outcome(c.invoke({}, kop(root, f, k)))
            for f, k in (("upsert", 0), ("upsert", 0), ("read", 0),
                         ("read", 1))]


def _delete(root, c):
    return [outcome(c.invoke({}, kop(root, f, k)))
            for f, k in (("upsert", 0), ("read", 0), ("delete", 0),
                         ("delete", 0), ("read", 0))]


def _register(root, c):
    return [outcome(c.invoke({}, kop(root, f, k, v)))
            for f, k, v in (("read", 0, None), ("write", 0, 3),
                            ("read", 0, None), ("write", 0, 4),
                            ("read", 0, None))]


def _set(root, c):
    out = [outcome(c.invoke({}, op(root, "add", v))) for v in (4, 9, 4)]
    return out + [outcome(c.invoke({}, op(root, "read")))]


def _sequential(root, c):
    return [outcome(c.invoke({}, op(root, f, k)))
            for f, k in (("write", 0), ("read", 0), ("read", 1))]


def _bank(root, c):
    out = [outcome(c.invoke({}, op(root, "transfer", v))) for v in (
        {"from": 0, "to": 1, "amount": 4},
        {"from": 2, "to": 1, "amount": 11},
        {"from": 2, "to": 9, "amount": 1})]
    return out + [outcome(c.invoke({}, op(root, "read")))]


def _txn(root, c):
    return [outcome(c.invoke({}, op(root, "txn", mops)))
            for mops in ([["w", 1, 1]], [["r", 1, None], ["r", 2, None]],
                         [["w", 1, 2], ["r", 1, None]])]


CLIENTS = {
    "upsert": ("UpsertClient", {}, _upsert),
    "delete": ("DeleteClient", {}, _delete),
    "register": ("RegisterClient", {}, _register),
    "set": ("SetClient", {}, _set),
    "sequential": ("SequentialClient", {"key_count": 3}, _sequential),
    "bank": ("BankClient", {}, _bank),
    "txn": ("TxnClient", {}, _txn),
}


def _records(fake) -> dict:
    return {k: v for k, v in vars(fake).items()
            if k not in ("lock", "uids")}


@pytest.mark.parametrize("case", sorted(CLIENTS))
def test_client_alike(case):
    cls, kw, script = CLIENTS[case]
    got = {}
    for root in ROOTS:
        f = http_factory()(root)
        c = getattr(suite(root, NAME), cls)(http_factory=f, **kw).open(
            {"nodes": ["n1", "n2"]}, "n2")
        c.setup({})
        got[root] = (script(root, c), _records(f.state))
    assert got[PORT] == got[JAX]
    assert any(o[0] == "ok" for o in got[PORT][0])


class Conflicting(tdg.FakeDgraph):
    """Every commit conflicts."""

    def txn_commit(self, txn):
        raise suite(JAX, NAME).TxnConflict("uid 0x1 written since ts 0")


def test_commit_conflict_fails_the_txn_alike():
    got = {}
    for root in ROOTS:
        f = http_factory(Conflicting())(root)
        txn = suite(root, NAME).TxnClient(http_factory=f).open({}, "n1")
        bank = suite(root, NAME).BankClient(http_factory=f).open({}, "n1")
        bank.setup({})
        got[root] = [outcome(txn.invoke({}, op(root, "txn",
                                               [["w", 1, 1]]))),
                     outcome(bank.invoke({}, op(root, "transfer", {
                         "from": 0, "to": 1, "amount": 1})))]
    assert got[PORT] == got[JAX]
    assert [o[0] for o in got[PORT]] == ["fail", "fail"]
    assert all("conflict" in o[3] for o in got[PORT])


ERRORS = [
    ("UpsertClient", "upsert", "info"),
    ("UpsertClient", "read", "fail"),
    ("DeleteClient", "delete", "info"),
    ("RegisterClient", "write", "info"),
    ("RegisterClient", "read", "fail"),
    ("SetClient", "add", "info"),
    ("SetClient", "read", "fail"),
    ("SequentialClient", "write", "info"),
    ("BankClient", "transfer", "info"),
    ("TxnClient", "txn", "info"),
]
VALUES = {"add": 3, "read": None, "write": 0,
          "transfer": {"from": 0, "to": 1, "amount": 1},
          "txn": [["r", 1, None]]}


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_client_error_classified_alike(case):
    cls, f, want = ERRORS[case]
    got = {}
    for root in ROOTS:
        make = Raising(root, lambda r: remote_error(r, "dgraph error",
                                                    err="unreachable"))
        c = getattr(suite(root, NAME), cls)(http_factory=make).open({}, "n1")
        value = VALUES.get(f)
        if cls in ("UpsertClient", "DeleteClient", "RegisterClient"):
            value = mod(root, "independent").ktuple(0, value)
        got[root] = outcome(c.invoke({}, op(root, f, value)))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == want


def test_trace_client_spans_alike(tmp_path):
    got = {}
    for root in ROOTS:
        inner = suite(root, NAME).UpsertClient(http_factory=http_factory()(
            root))
        path = tmp_path / f"{root}.jsonl"
        c = suite(root, NAME).TraceClient(inner, path=str(path)).open(
            {"nodes": ["n1"]}, "n1")
        c.setup({})
        outs = [outcome(c.invoke({}, kop(root, f, 0, process=p)))
                for f, p in (("upsert", 0), ("upsert", 1), ("read", 2))]
        spans = [json.loads(x) for x in path.read_text().splitlines()]
        assert all(s.pop("end") >= s.pop("start") for s in spans)
        got[root] = (outs, spans)
    assert got[PORT] == got[JAX]
    assert [s["type"] for s in got[PORT][1]] == ["ok", "fail", "ok"]


def test_trace_client_writes_into_the_store_dir_alike(tmp_path):
    for root in ROOTS:
        d = tmp_path / root
        d.mkdir()
        inner = suite(root, NAME).SetClient(http_factory=http_factory()(root))
        c = suite(root, NAME).TraceClient(inner).open(
            {"nodes": ["n1"], "store_dir": str(d)}, "n1")
        c.invoke({}, op(root, "add", 1))
        assert json.loads((d / "trace.jsonl").read_text())["f"] == "add"


# ---------------------------------------------------------------------------
# whole clusterless runs
# ---------------------------------------------------------------------------

N3 = {"nodes": ("n1", "n2", "n3"), "concurrency": 6, "stagger": 0.0003}
RUNS = {
    "upsert": ("upsert", {"key_count": 4, "group_size": 3},
               tdg.FakeDgraph, True, N3),
    "upsert-double": ("upsert", {"key_count": 4, "group_size": 3},
                      lambda: tdg.FakeDgraph("double-upsert"), False, N3),
    "delete": ("delete", {"key_count": 4, "seed": 5}, tdg.FakeDgraph,
               True, N3),
    "delete-dirty-index": ("delete", {"key_count": 3, "seed": 5,
                                      "ops_per_key": 40},
                           lambda: tdg.FakeDgraph("dirty-index"), False,
                           N3),
    "linearizable-register": ("linearizable_register",
                              {"keys": [0, 1, 2], "ops_per_key": 40,
                               "group_size": 3, "seed": 3},
                              tdg.FakeDgraph, True, N3),
    "set": ("set_workload", {"ops": 60}, tdg.FakeDgraph, True,
            dict(N3, final=True)),
    "bank": ("bank", {"ops": 80}, tdg.FakeDgraph, True,
             dict(N3, extra=("total-amount", "accounts"))),
    "long-fork": ("long_fork", {"ops": 80}, tdg.FakeDgraph, True, N3),
    "wr": ("wr", {"ops": 80}, tdg.FakeDgraph, True, N3),
}


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_checked_by_both(run, root):
    workload, opts, fake, valid, kw = RUNS[run]
    run_checked_by_both(root, NAME, workload, opts, "http_factory",
                        http_factory(fake()), valid, **kw)


def test_sequential_run_checked_alike():
    """sequential's verdict is valid or unknown as the run goes (as in
    the JAX test); both packages' checkers agree on the recorded
    history."""
    from test_torch_suites_registry import (check_both, norm, run_workload,
                                            workload_checker)

    for root in ROOTS:
        test = run_workload(root, NAME, "sequential", {"ops": 60},
                            "http_factory", http_factory(), **N3)
        port, jax = check_both(workload_checker(NAME, "sequential",
                                                {"ops": 60}), test)
        assert norm(port) == norm(jax)
        assert port["valid?"] in (True, "unknown")


@pytest.mark.parametrize("concurrency", [6, 3, 5])
def test_default_groups_refuse_a_thread_count_four_does_not_divide(
        concurrency):
    """ROADMAP C13: dgraph's upsert, delete and register workloads spread
    their keys over groups of 4 threads; the CLI's default concurrency
    ("1n": 3 or 5 nodes) and 6 are refused by the generator, with the
    same error in both packages."""
    msgs = {}
    for root in ROOTS:
        ts = mod(root, "generator.test_support")
        out = []
        for w in ("upsert", "linearizable_register"):
            g = getattr(suite(root, NAME), w)(device_opts(root, {}))
            with pytest.raises(Exception) as e:
                ts.simulate(g["generator"], lambda _c, inv: inv.copy(
                    type="ok", time=inv.time + 10),
                    ctx=ts.n_plus_nemesis_context(concurrency))
            out.append(str(e.value.__cause__ or e.value))
        msgs[root] = out
    assert msgs[PORT] == msgs[JAX]
    assert all(f"concurrency ({concurrency}) must be divisible by group "
               f"size (4)" in m for m in msgs[PORT])


# ---------------------------------------------------------------------------
# builders, command lines, stored runs, phase 28
# ---------------------------------------------------------------------------

OPTS = {"nodes": ["n1", "n2", "n3"], "concurrency": 8,
        "ssh": {"dummy": True}, "time_limit": 1, "seed": 1}


@pytest.mark.parametrize("workload", [None] + list(
    suite(JAX, NAME).WORKLOADS))
@pytest.mark.parametrize("trace", [False, True])
def test_builder_shape_equal(workload, trace):
    opts = dict(OPTS, trace=trace,
                **({"workload": workload} if workload else {}))
    tests = {root: suite(root, NAME).dgraph_test(device_opts(root, opts))
             for root in ROOTS}
    assert shape(tests[PORT]) == shape(tests[JAX])
    for k in ("total-amount", "accounts"):
        assert tests[PORT].get(k) == tests[JAX].get(k)


def test_command_line_options():
    port, jax = help_options(PORT, NAME), help_options(JAX, NAME)
    assert sorted(set(port) - {"--device"}) == sorted(set(jax))
    argv = ["--nodes", "n1,n2", "--time-limit", "3", "--no-ssh",
            "--workload", "wr", "--trace", "--replicas", "2"]
    got = parsed(PORT, NAME, argv + ["--device", "cpu"])
    want = parsed(JAX, NAME, argv)
    assert got.pop("device") == "cpu"
    assert got == want


@pytest.mark.parametrize("writer", ROOTS)
@pytest.mark.parametrize("run", sorted(small_specs((NAME,))))
def test_stored_run_analysed_by_both(run, writer, tmp_path):
    stored_across(writer, small_specs((NAME,))[run], tmp_path)


def test_phase_28_dgraph_runs_at_a_small_size(monkeypatch):
    launches = phase_28((NAME,), monkeypatch)
    # the register's keys in one plain wgl_search; upsert on the host
    assert launches == {
        "wgl_search": {"suite-dgraph-linearizable-register": 1},
        "scc": {}, "bank_reduce": {}}
