"""The port's tidb suite against the JAX package's, on the CPU: the
list-append (Elle), bank (one table and multitable), long-fork,
monotonic, txn-cycle (Elle rw-register), register, set, set-cas,
sequential and table workloads over the mysql CLI, and the test-all
sweep of workloads by faults.

The DB's command streams per node on the dummy remote (pd, tikv and
tidb daemons, the primary's schema); the transport's command line; each
client's statements and completions against the JAX test's in-memory
FakeTidbFull (its errors raised as each package's own RemoteError); the
error classification; the table generator and checker; whole clusterless
runs of every workload, healthy and with a seeded bug (reversed list
reads, backwards commit timestamps, a ghost table), recorded on each
package and checked by both with equal results; the test-all sweep (the
same tests in both packages); the builder, the command line, stored runs
across packages, and phase 28 at a small size. Equality is exact: the
results are verdicts and anomaly sets.
"""

from __future__ import annotations

import re

import pytest

import test_tidb as ttd
from test_torch_suites_registry import (  # noqa: F401 (fixture)
    JAX, PORT, ROOTS, Raising, both_streams, clear_ip_caches, device_opts,
    failing_keys, help_options, make_test, mod, op, outcome, parsed,
    phase_28, remote_error, run_checked_by_both, shape, small_specs,
    stored_across, suite)

NAME = "tidb"


class BankFake(ttd.FakeTidbFull):
    """tests/test_tidb.py's TestBank fake: the accounts transfer under
    the @b1 guard."""

    def __init__(self, lose_every=0):
        super().__init__()
        self.applied = False
        self.b1 = 0
        self.lose_every = lose_every
        self.debits = 0

    def _stmt(self, s):
        if s.startswith("SELECT balance INTO @b1 FROM accounts"):
            self.b1 = self.accounts[int(re.search(r"id = (\d+)",
                                                  s).group(1))]
            return None
        m = re.match(r"UPDATE accounts SET balance = balance ([-+]) (\d+) "
                     r"WHERE id = (\d+)", s)
        if m:
            sign, a, acct = m.group(1), int(m.group(2)), int(m.group(3))
            self.applied = self.b1 >= a
            if self.applied and sign == "-" and self.lose_every:
                self.debits += 1
                if self.debits % self.lose_every == 0:
                    return None
            if self.applied:
                self.accounts[acct] += a if sign == "+" else -a
            return None
        if s.startswith("SELECT CONCAT('applied='"):
            return "applied=1" if self.applied else "applied=0"
        return super()._stmt(s)


class Reversed(ttd.FakeTidbFull):
    """tests/test_tidb.py's Corrupt: every second list read of two or
    more elements comes back reversed."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def _stmt(self, s):
        out = super()._stmt(s)
        if out and out.startswith("m") and "," in out:
            self.n += 1
            if self.n % 2:
                tag, raw = out.split("=", 1)
                out = tag + "=" + ",".join(reversed(raw.split(",")))
        return out


def sql_factory(state=None):
    """tests/test_tidb.py's FakeFullFactory per package: the one fake
    database, its errors raised as root's RemoteError."""
    state = state or ttd.FakeTidbFull()

    def for_root(root):
        def make(test, node, timeout=10.0):
            class _Sql:
                def run(self, sql):
                    try:
                        return state.run(sql)
                    except ttd._FakeSqlError as e:
                        raise remote_error(root, "mysql failed",
                                           err=str(e), cmd="mysql",
                                           node=node)

                def close(self):
                    pass

            return _Sql()

        make.state = state
        return make

    return for_root


# ---------------------------------------------------------------------------
# the DB and the transport
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["setup", "teardown", "kill", "start"])
def test_db_command_stream(method):
    calls = ([("setup", None)] if method == "setup"
             else [(method, "n2"), (method, "n1")])
    both_streams(NAME, lambda s, r: s.TidbDB(), calls, ttd.responder,
                 prepare=True)


@pytest.mark.parametrize("nodes", [["n1"], ["n1", "n2", "n3"]])
def test_pd_urls_alike(nodes):
    for fn in ("pd_initial_cluster", "pd_endpoints"):
        assert getattr(suite(PORT, NAME), fn)({"nodes": nodes}) == \
            getattr(suite(JAX, NAME), fn)({"nodes": nodes})
    assert [suite(PORT, NAME).table_for(k) for k in range(7)] == \
        [suite(JAX, NAME).table_for(k) for k in range(7)]


def test_transport_command_line_alike():
    got = {}
    for root in ROOTS:
        test = make_test(root, lambda node, a: "m0=1", ("n1", "n2"))
        s = suite(root, NAME).TidbSql(test, "n2", timeout=4)
        out = s.run("SELECT 1")
        got[root] = (out, [(a.cmd, a.stdin) for a in s.sess.log])
        s.close()
    assert got[PORT] == got[JAX]


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------

def _txns(root, c, test=None):
    return [outcome(c.invoke(test or {}, op(root, "txn", mops)))
            for mops in ([["append", 1, 10]], [["r", 1, None]],
                         [["append", 4, 2], ["r", 4, None],
                          ["append", 4, 3], ["r", 4, None]],
                         [["r", 9, None]])]


def _long_fork(root, c):
    test = {"lf-table": True}
    return [outcome(c.invoke(test, op(root, "txn", mops)))
            for mops in ([["w", 1, 1]], [["r", 1, None], ["r", 2, None]],
                         [["w", 2, 1]], [["r", 2, None]])]


def _register(root, c):
    return [outcome(c.invoke({}, op(root, f, [k, v])))
            for f, k, v in (("read", 0, None), ("write", 0, 3),
                            ("read", 0, None), ("cas", 0, [3, 4]),
                            ("cas", 0, [3, 9]), ("read", 0, None))]


def _sets(root, c):
    out = [outcome(c.invoke({}, op(root, "add", v))) for v in (4, 9, 1)]
    return out + [outcome(c.invoke({}, op(root, "read")))]


def _sequential(root, c):
    return [outcome(c.invoke({}, op(root, f, k)))
            for f, k in (("write", 0), ("read", 0), ("read", 1))]


def _monotonic(root, c):
    out = [outcome(c.invoke({}, op(root, "add", None, process=p)))
           for p in (0, 2)]
    return out + [outcome(c.invoke({}, op(root, "read")))]


def _table(root, c):
    return [outcome(c.invoke({}, op(root, f, v)))
            for f, v in (("create-table", 1), ("insert", [1, 0]),
                         ("insert", [2, 1]), ("create-table", 2),
                         ("insert", [2, 2]))]


def _bank(root, c):
    out = [outcome(c.invoke({}, op(root, "transfer", v))) for v in (
        {"from": 0, "to": 1, "amount": 4},
        {"from": 2, "to": 1, "amount": 11})]
    return out + [outcome(c.invoke({}, op(root, "read")))]


CLIENTS = {
    "append": ("TidbTxnClient", {}, _txns, ttd.FakeTidbFull),
    "long-fork": ("TidbTxnClient", {}, _long_fork, ttd.FakeTidbFull),
    "register": ("TidbRegisterClient", {}, _register, ttd.FakeTidbFull),
    "set": ("TidbSetClient", {}, _sets, ttd.FakeTidbFull),
    "set-cas": ("TidbSetClient", {"cas": True}, _sets, ttd.FakeTidbFull),
    "sequential": ("TidbSequentialClient", {"key_count": 3}, _sequential,
                   ttd.FakeTidbFull),
    "monotonic": ("TidbMonotonicClient", {}, _monotonic, ttd.FakeTidbFull),
    "table": ("TidbTableClient", {}, _table, ttd.FakeTidbFull),
    "bank": ("TidbBankClient", {}, _bank, BankFake),
    "bank-multitable": ("TidbMultiBankClient", {}, _bank,
                        ttd.FakeTidbFull),
}


def _fake_state(fake) -> dict:
    return {k: v for k, v in vars(fake).items() if k != "lock"}


@pytest.mark.parametrize("case", sorted(CLIENTS))
def test_client_alike(case):
    cls, kw, script, fake = CLIENTS[case]
    got = {}
    for root in ROOTS:
        f = sql_factory(fake())(root)
        c = getattr(suite(root, NAME), cls)(sql_factory=f, **kw).open(
            {"nodes": ["n1", "n2"]}, "n2")
        got[root] = (script(root, c), _fake_state(f.state))
    assert got[PORT] == got[JAX]
    assert any(o[0] == "ok" for o in got[PORT][0])


def test_table_insert_into_a_missing_table_alike():
    got = {}
    for root in ROOTS:
        c = suite(root, NAME).TidbTableClient(
            sql_factory=sql_factory()(root)).open({}, "n1")
        got[root] = _table(root, c)
    assert got[PORT] == got[JAX]
    assert [o[0] for o in got[PORT]] == ["ok", "ok", "fail", "ok", "ok"]
    assert got[PORT][2][3] == "doesn't-exist"


ERRORS = [
    ("TidbTxnClient", "txn", "Write conflict, txnStartTS=1", "fail"),
    ("TidbTxnClient", "txn", "Lost connection to MySQL server", "info"),
    ("TidbBankClient", "read", "Lost connection", "fail"),
    ("TidbBankClient", "transfer", "Deadlock found", "fail"),
    ("TidbRegisterClient", "cas", "Region is unavailable", "fail"),
    ("TidbRegisterClient", "write", "i/o timeout", "info"),
    ("TidbSetClient", "add", "try again later", "fail"),
    ("TidbTableClient", "insert", "Duplicate entry '1'", "fail"),
    ("TidbTableClient", "create-table", "i/o timeout", "info"),
]
VALUES = {"txn": [["append", 1, 1]], "read": None, "add": 3,
          "transfer": {"from": 0, "to": 1, "amount": 1},
          "cas": [0, [1, 2]], "write": [0, 1], "insert": [1, 0],
          "create-table": 1}


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_client_error_classified_alike(case):
    cls, f, err, want = ERRORS[case]
    got = {}
    for root in ROOTS:
        make = Raising(root, lambda r: remote_error(r, "mysql failed",
                                                    err=err))
        c = getattr(suite(root, NAME), cls)(sql_factory=make).open({}, "n1")
        got[root] = outcome(c.invoke({}, op(root, f, VALUES[f])))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == want


# ---------------------------------------------------------------------------
# the table workload's generator and checker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [None, 2, 9])
def test_table_generator_simulates_alike(seed):
    """_TableGen through each package's simulator: creates that complete
    ok steer the inserts that follow."""
    got = {}
    for root in ROOTS:
        ts = mod(root, "generator.test_support")
        g = mod(root, "generator").limit(60, suite(root, NAME)._TableGen(
            rng_seed=seed))
        got[root] = [(o.type, o.process, o.f, repr(o.value))
                     for o in ts.perfect(g)]
    assert got[PORT] == got[JAX]
    assert {o[2] for o in got[PORT]} == {"create-table", "insert"}


def test_check_tables_alike():
    got = {}
    for root in ROOTS:
        Op = mod(root, "history").Op
        hist = [Op(index=i, type=t, process=0, f=f, value=v).copy(
                    **({"error": e} if e else {}))
                for i, (t, f, v, e) in enumerate([
                    ("ok", "create-table", 1, None),
                    ("ok", "insert", [1, 0], None),
                    ("fail", "insert", [2, 1], "doesn't-exist"),
                    ("fail", "insert", [1, 0], "duplicate-key")])]
        got[root] = (suite(root, NAME).check_tables(hist),
                     suite(root, NAME).check_tables(hist[:2]))
    assert got[PORT] == got[JAX]
    assert got[PORT][0]["valid?"] is False and got[PORT][1]["valid?"]


# ---------------------------------------------------------------------------
# whole clusterless runs
# ---------------------------------------------------------------------------

N3 = {"nodes": ("n1", "n2", "n3"), "concurrency": 6, "stagger": 0.0003}
RUNS = {
    "append": ("append_workload", {"ops": 250, "keys": 5, "seed": 3},
               ttd.FakeTidbFull, True, dict(N3, limit=250)),
    "append-reversed": ("append_workload",
                        {"ops": 300, "keys": 2, "seed": 13}, Reversed,
                        False, dict(N3, limit=300)),
    "bank": ("bank_workload", {"seed": 5}, BankFake, True,
             dict(N3, limit=200)),
    "bank-lost-debit": ("bank_workload", {"seed": 7},
                        lambda: BankFake(lose_every=5), False,
                        dict(N3, limit=200)),
    "bank-multitable": ("bank_multitable_workload", {"seed": 3},
                        ttd.FakeTidbFull, True, dict(N3, limit=100)),
    "long-fork": ("long_fork_workload", {"ops": 300}, ttd.FakeTidbFull,
                  True, dict(N3, limit=300, extra=("lf-table",))),
    "txn-cycle": ("txn_cycle_workload", {"ops": 150, "seed": 5},
                  ttd.FakeTidbFull, True,
                  dict(N3, limit=200, extra=("lf-table",))),
    "register": ("register_workload", {"keys": [0, 1], "ops_per_key": 40,
                                       "group_size": 3, "seed": 7},
                 ttd.FakeTidbFull, True, dict(N3, limit=200)),
    "set": ("set_workload", {"ops": 120}, ttd.FakeTidbFull, True,
            dict(N3, limit=150)),
    "set-cas": ("set_cas_workload", {"ops": 120}, ttd.FakeTidbFull, True,
                dict(N3, limit=150)),
    "sequential": ("sequential_workload", {"ops": 80}, ttd.FakeTidbFull,
                   True, dict(N3, limit=120)),
    "monotonic": ("monotonic_workload", {"ops": 60}, ttd.FakeTidbFull,
                  True, dict(N3, limit=80, final=True)),
    "monotonic-reordered": ("monotonic_workload", {"ops": 60},
                            lambda: ttd.FakeTidbFull("mono-reorder"), False,
                            dict(N3, limit=80, final=True)),
    "table": ("table_workload", {"ops": 80, "seed": 2}, ttd.FakeTidbFull,
              True, dict(N3, limit=100)),
    "table-ghost": ("table_workload", {"ops": 120, "seed": 2},
                    lambda: ttd.FakeTidbFull("ghost-table"), False,
                    dict(N3, limit=150)),
}


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_checked_by_both(run, root):
    workload, opts, fake, valid, kw = RUNS[run]
    res = run_checked_by_both(root, NAME, workload, opts, "sql_factory",
                              sql_factory(fake()), valid, **kw)
    if run == "append-reversed":
        assert "incompatible-order" in failing_keys(res)


# ---------------------------------------------------------------------------
# the test-all sweep, builders, command lines, stored runs, phase 28
# ---------------------------------------------------------------------------

OPTS = {"nodes": ["n1", "n2", "n3"], "concurrency": 6,
        "ssh": {"dummy": True}, "time_limit": 1, "seed": 1}


def _nemesis(test) -> tuple:
    return (type(test["nemesis"]).__name__, sorted(test["nemesis"].fs()))


@pytest.mark.parametrize("extra", [
    {}, {"workload": "bank"}, {"faults": ["kill"]},
    {"workload": "register", "faults": ["partition", "kill"]},
    {"test_count": 2, "workload": "append"}])
def test_all_tests_sweep_alike(extra):
    """tidb/core.clj's workload x fault sweep yields the same tests, in
    the same order, in both packages."""
    got = {}
    for root in ROOTS:
        tests = list(suite(root, NAME).all_tests(
            device_opts(root, dict(OPTS, **extra))))
        got[root] = [(shape(t), _nemesis(t), t.get("lf-table"))
                     for t in tests]
    assert got[PORT] == got[JAX]
    n = ((1 if "workload" in extra else len(suite(JAX, NAME).WORKLOADS))
         * (1 if "faults" in extra else 3) * extra.get("test_count", 1))
    assert len(got[PORT]) == n


def test_all_command_sweeps_alike(monkeypatch):
    """`test-all` through each package's command line hands the same
    tests to the runner."""
    got = {}
    for root in ROOTS:
        cli = mod(root, "cli")
        seen = []
        monkeypatch.setattr(cli, "test_all_run_tests",
                            lambda tests, seen=seen: seen.extend(tests)
                            or [])
        argv = ["test-all", "--nodes", "n1,n2", "--time-limit", "3",
                "--no-ssh", "--nemesis", "kill,partition"]
        if root == PORT:
            argv += ["--device", "cpu"]
        with pytest.raises(SystemExit):
            suite(root, NAME).main(argv)
        got[root] = [(shape(t), _nemesis(t)) for t in seen]
    assert got[PORT] == got[JAX]
    assert len(got[PORT]) == len(suite(JAX, NAME).WORKLOADS)


@pytest.mark.parametrize("faults", [None, [], ["kill"],
                                    ["partition", "kill", "clock"]])
def test_nemesis_for_alike(faults):
    got = {}
    for root in ROOTS:
        s = suite(root, NAME)
        pkg = s.nemesis_for(dict(OPTS, faults=faults), s.TidbDB())
        got[root] = (type(pkg["nemesis"]).__name__,
                     sorted(pkg["nemesis"].fs()),
                     pkg.get("final_generator") is None)
    assert got[PORT] == got[JAX]


@pytest.mark.parametrize("workload", [None] + list(
    suite(JAX, NAME).WORKLOADS))
def test_builder_shape_equal(workload):
    opts = dict(OPTS, **({"workload": workload} if workload else {}))
    tests = {root: suite(root, NAME).tidb_test(device_opts(root, opts))
             for root in ROOTS}
    assert shape(tests[PORT]) == shape(tests[JAX])
    assert tests[PORT].get("lf-table") == tests[JAX].get("lf-table")


def test_command_line_options():
    port, jax = help_options(PORT, NAME), help_options(JAX, NAME)
    assert sorted(set(port) - {"--device"}) == sorted(set(jax))
    argv = ["--nodes", "n1,n2", "--time-limit", "3", "--no-ssh",
            "--nemesis", "kill, partition", "--workload", "set-cas"]
    got = parsed(PORT, NAME, argv + ["--device", "cpu"])
    want = parsed(JAX, NAME, argv)
    assert got.pop("device") == "cpu"
    assert got == want
    assert got["faults"] == ["kill", "partition"]


@pytest.mark.parametrize("writer", ROOTS)
@pytest.mark.parametrize("run", sorted(small_specs((NAME,))))
def test_stored_run_analysed_by_both(run, writer, tmp_path):
    stored_across(writer, small_specs((NAME,))[run], tmp_path)


def test_phase_28_tidb_runs_at_a_small_size(monkeypatch):
    launches = phase_28((NAME,), monkeypatch)
    # 150 txns stay under Elle's device dispatch
    assert launches == {"wgl_search": {}, "scc": {}, "bank_reduce": {}}
