"""The port's SQL suites (galera, postgres, stolon) against the JAX
package's, on the CPU: galera's bank and set over mysql, postgres'
list-append (Elle) and bank over psql, and stolon's append through its
proxy and its ledger with the ledger checker.

For each suite: the DB's command streams per node on the dummy remote;
the client's statements and completions against the JAX test's in-memory
database (postgres' and stolon's psql fakes rebuilt per package, so each
raises its own package's RemoteError); the error classification; whole
clusterless runs, healthy and with the JAX test's seeded bug (a lost
credit or debit, a dropped insert, reversed list reads, a double spend),
recorded on each package and checked by both with equal results; the
builder, the command line, stored runs across packages, and phase 27 at
a small size (its 10,000-txn postgres run, which reaches scc, runs on
the card only).
"""

from __future__ import annotations

import re
from types import SimpleNamespace

import pytest

import test_galera as tga
import test_postgres as tpg
import test_stolon as tst
from test_torch_suites_registry import (  # noqa: F401 (fixture)
    JAX, PORT, ROOTS, Raising, both_streams, clear_ip_caches, device_opts,
    help_options, make_test, mod, op, outcome, parsed, phase_27,
    remote_error, run_checked_by_both, shape, small_specs, stored_across,
    suite)

SUITES = ("galera", "postgres", "stolon")


def psql_factory(state=None, cls=None):
    """tests/test_postgres.py's FakePsqlFactory per package: the one fake
    database, its errors raised as root's own RemoteError."""
    state = state or (cls or tpg.FakePostgres)()

    def for_root(root):
        def make(test, node, host=None, timeout=10.0, port=None):
            class _Psql:
                def run(self, sql):
                    try:
                        return state.execute(sql)
                    except (tpg._PgError, tst._PgError) as e:
                        raise remote_error(root, "psql failed",
                                           err=f"ERROR: {e}", cmd="psql",
                                           node=node)

                def close(self):
                    pass

            return _Psql()

        make.state = state
        return make

    return for_root


# ---------------------------------------------------------------------------
# DB command streams
# ---------------------------------------------------------------------------

def _hba(node, action):
    if action.cmd.startswith("psql") and "SHOW hba_file" in action.cmd:
        return "/etc/postgresql/15/main/pg_hba.conf"
    return None


def _archive(node, action):
    """install_archive's probes: nothing cached, one top-level
    directory."""
    if action.cmd.startswith("stat "):
        return SimpleNamespace(exit=1, out="", err="no such file",
                               cmd=action.cmd)
    if action.cmd.startswith("dirname "):
        return action.cmd.split()[-1].rsplit("/", 1)[0]
    if action.cmd.startswith("ls -A"):
        return "stolon-v0.17.0-linux-amd64"
    return None


DBS = {
    "galera": (lambda s, r: s.GaleraDB(), None),
    "postgres": (lambda s, r: s.PostgresDB(), _hba),
    "stolon": (lambda s, r: s.StolonDB(), _archive),
}
CALLS = {
    "galera": ("setup", "teardown"),
    "postgres": ("setup", "teardown"),
    "stolon": ("setup", "teardown", "kill", "start", "_start_sentinel",
               "_start_keeper", "_start_proxy"),
}


@pytest.mark.parametrize("name,method", [(n, m) for n in SUITES
                                         for m in CALLS[n]])
def test_db_command_stream(name, method):
    make_db, responder = DBS[name]
    calls = ([("setup", None)] if method == "setup"
             else [(method, "n2"), (method, "n1")])
    both_streams(name, make_db, calls, responder, prepare=True)


def test_stolon_cluster_spec_and_ids_alike():
    for nodes in (["n1", "n2", "n3"], ["n1", "n2", "n3", "n4", "n5"]):
        t = {"nodes": nodes}
        assert suite(PORT, "stolon").cluster_spec(t) == \
            suite(JAX, "stolon").cluster_spec(t)
        assert [suite(PORT, "stolon").pg_id(t, n) for n in nodes] == \
            [suite(JAX, "stolon").pg_id(t, n) for n in nodes]


def test_postgres_transport_stream_alike():
    got = {}
    for root in ROOTS:
        test = make_test(root, lambda node, a: "m0=1\n", ("n1",))
        p = suite(root, "postgres").Psql(test, "n1", "n1")
        got[root] = (p.run("SELECT 1"), [
            (a.cmd, a.stdin) for a in p.sess.log])
        p.close()
    assert got[PORT] == got[JAX]


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------

APPEND_SCRIPTS = {
    "append-then-read": [[["append", 1, 10]], [["r", 1, None]]],
    "missing-key": [[["r", 9, None]]],
    "own-writes": [[["append", 2, 7], ["r", 2, None], ["append", 2, 8],
                    ["r", 2, None]]],
    "tables": [[["append", 0, 1]], [["append", 1, 1]], [["append", 5, 1]],
               [["r", 5, None], ["r", 0, None]]],
}


@pytest.mark.parametrize("case", sorted(APPEND_SCRIPTS))
@pytest.mark.parametrize("isolation", ["SERIALIZABLE", "REPEATABLE READ"])
def test_postgres_append_client_alike(case, isolation):
    got = {}
    for root in ROOTS:
        f = psql_factory()(root)
        c = suite(root, "postgres").PgAppendClient(
            psql_factory=f, isolation=isolation).open({"nodes": ["n1"]},
                                                      "n1")
        out = [outcome(c.invoke({}, op(root, "txn", mops)))
               for mops in APPEND_SCRIPTS[case]]
        got[root] = (out, f.state.statements, f.state.tables)
    assert got[PORT] == got[JAX]
    assert all(o[0] == "ok" for o in got[PORT][0])


def test_postgres_serialization_failure_alike():
    got = {}
    for root in ROOTS:
        f = psql_factory()(root)
        state = f.state

        def failing(sql):
            raise tpg._PgError("could not serialize access due to "
                               "concurrent update")

        state.execute = failing
        c = suite(root, "postgres").PgAppendClient(psql_factory=f).open(
            {"nodes": ["n1"]}, "n1")
        got[root] = outcome(c.invoke({}, op(root, "txn", [
            ["append", 1, 1], ["r", 1, None]])))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == "fail" and "serialize" in got[PORT][3]


def test_postgres_bank_client_alike():
    got = {}
    for root in ROOTS:
        f = psql_factory(tpg.FakePostgres(accounts=2, balance=3))(root)
        c = suite(root, "postgres").PgBankClient(psql_factory=f).open(
            {"nodes": ["n1"]}, "n1")
        out = [outcome(c.invoke({}, op(root, "transfer", v))) for v in (
            {"from": 0, "to": 1, "amount": 99},
            {"from": 0, "to": 1, "amount": 2})]
        out.append(outcome(c.invoke({}, op(root, "read"))))
        got[root] = (out, f.state.accounts)
    assert got[PORT] == got[JAX]
    assert [o[0] for o in got[PORT][0]] == ["fail", "ok", "ok"]
    assert got[PORT][1] == {0: 1, 1: 5}


def test_galera_clients_alike():
    got = {}
    for root in ROOTS:
        f = tga.FakeMysqlFactory()
        s = suite(root, "galera")
        bank = s.GaleraBankClient(mysql_factory=f).open({"nodes": ["n1"]},
                                                         "n1")
        sets = s.GaleraSetClient(mysql_factory=f).open({"nodes": ["n1"]},
                                                       "n1")
        out = [outcome(bank.invoke({}, op(root, "transfer", v))) for v in (
            {"from": 0, "to": 1, "amount": 3},
            {"from": 2, "to": 1, "amount": 11})]
        out.append(outcome(bank.invoke({}, op(root, "read"))))
        out += [outcome(sets.invoke({}, op(root, "add", v)))
                for v in (4, 7)]
        out.append(outcome(sets.invoke({}, op(root, "read"))))
        got[root] = (out, f.state.accounts, f.state.sets)
    assert got[PORT] == got[JAX]
    assert [o[0] for o in got[PORT][0]] == ["ok", "fail", "ok", "ok",
                                           "ok", "ok"]


def test_stolon_ledger_client_alike():
    got = {}
    for root in ROOTS:
        f = psql_factory(tst.FakeLedgerPg())(root)
        c = suite(root, "stolon").LedgerClient(psql_factory=f).open(
            {"nodes": ["n1"]}, "n1")
        out = [outcome(c.invoke({}, op(root, "transfer", v, process=p)))
               for v, p in (([0, 10], 1), ([0, -9], 2), ([0, -9], 1),
                            ([1, 5], 3))]
        out.append(outcome(c.invoke({}, op(root, "read"))))
        got[root] = (out, f.state.rows)
    assert got[PORT] == got[JAX]
    assert [o[0] for o in got[PORT][0]] == ["ok", "ok", "fail", "ok", "ok"]
    assert got[PORT][0][-1][2] == {0: 1, 1: 5}


ERRORS = [
    ("galera", "transfer", "ERROR 1213 (40001): Deadlock found", "fail"),
    ("galera", "transfer", "Lost connection to MySQL server", "info"),
    ("galera", "read", "Lost connection to MySQL server", "fail"),
    ("postgres", "txn", "ERROR: could not serialize access", "fail"),
    ("postgres", "txn", "server closed the connection unexpectedly",
     "info"),
    ("postgres", "transfer", "violates check constraint", "fail"),
]


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_client_error_classified_alike(case):
    name, f, err, want = ERRORS[case]
    value = {"transfer": {"from": 0, "to": 1, "amount": 3},
             "read": None, "txn": [["append", 1, 1]]}[f]
    got = {}
    for root in ROOTS:
        s = suite(root, name)
        make = Raising(root, lambda r: remote_error(r, "failed", err=err))
        if name == "galera":
            c = s.GaleraBankClient(mysql_factory=make)
        elif f == "txn":
            c = s.PgAppendClient(psql_factory=make)
        else:
            c = s.PgBankClient(psql_factory=make)
        c = c.open({"nodes": ["n1"]}, "n1")
        got[root] = outcome(c.invoke({}, op(root, f, value)))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == want


LEDGERS = {
    "charitable": [("ok", 0, [0, 10]), ("info", 1, [0, -9]),
                   ("ok", 2, [0, -9])],
    "double-spend": [("ok", 0, [0, 10]), ("info", 1, [0, -9]),
                     ("ok", 2, [0, -9]), ("ok", 3, [0, -9])],
    "info-deposit": [("info", 0, [0, 10]), ("ok", 1, [0, -9])],
    "two-accounts": [("ok", 0, [0, 5]), ("ok", 1, [1, -1]),
                     ("ok", 2, [0, -5])],
}


@pytest.mark.parametrize("case", sorted(LEDGERS))
def test_check_ledger_alike(case):
    got = {}
    for root in ROOTS:
        Op = mod(root, "history").Op
        hist = [Op(type=t, process=p, f="transfer", value=v)
                for t, p, v in LEDGERS[case]]
        got[root] = suite(root, "stolon").check_ledger(hist)
    assert got[PORT] == got[JAX]


# ---------------------------------------------------------------------------
# whole clusterless runs
# ---------------------------------------------------------------------------

class GaleraLossy(tga.FakeMysql):
    def __init__(self):
        super().__init__()
        self.n = 0

    def run(self, sql):
        if "START TRANSACTION" in sql:
            self.n += 1
            if self.n % 5 == 0:
                m = re.search(r"balance - (\d+) WHERE id = (\d+)", sql)
                a, f = int(m.group(1)), int(m.group(2))
                with self.lock:
                    if self.accounts[f] >= a:
                        self.accounts[f] -= a
                        return "applied=1"
                    return "applied=0"
        return super().run(sql)


class GaleraDropping(tga.FakeMysql):
    def __init__(self):
        super().__init__()
        self.n = 0

    def run(self, sql):
        if "INSERT INTO sets" in sql:
            self.n += 1
            if self.n == 3:
                return ""
        return super().run(sql)


class PgCorrupt(tpg.FakePostgres):
    def __init__(self):
        super().__init__()
        self.n = 0

    def _read_mop(self, m):
        t, k = m.group(2), int(m.group(3))
        val = self.tables[t].get(k)
        self.n += 1
        if val is not None and "," in val and self.n % 2:
            val = ",".join(reversed(val.split(",")))
        return f"m{m.group(1)}=" + ("~" if val is None else val)


class PgLossy(tpg.FakePostgres):
    def _transfer(self, m):
        if "- " in m.group(0):
            return
        super()._transfer(m)


RUNS = {
    "galera-bank": ("galera", "bank_workload", {"seed": 5, "ops": 200},
                    "mysql_factory", lambda r: tga.FakeMysqlFactory(),
                    True, dict(limit=200, stagger=0.0005)),
    "galera-bank-lost-credit": ("galera", "bank_workload",
                                {"seed": 7, "ops": 200}, "mysql_factory",
                                lambda r: tga.FakeMysqlFactory(
                                    GaleraLossy()), False,
                                dict(limit=200, stagger=0.0005)),
    "galera-set": ("galera", "set_workload", {"ops": 100,
                                              "concurrency": 4},
                   "mysql_factory", lambda r: tga.FakeMysqlFactory(), True,
                   dict(nodes=("n1",), stagger=0.0003, final=True)),
    "galera-set-dropped": ("galera", "set_workload", {"ops": 60},
                           "mysql_factory",
                           lambda r: tga.FakeMysqlFactory(
                               GaleraDropping()), False,
                           dict(nodes=("n1",), concurrency=2,
                                stagger=0.0003, final=True)),
    "postgres-append": ("postgres", "append_workload",
                        {"ops": 300, "keys": 5, "seed": 11,
                         "concurrency": 6}, "psql_factory",
                        lambda r: psql_factory()(r), True,
                        dict(nodes=("n1", "n2", "n3"), concurrency=6,
                             limit=300, stagger=0.0005)),
    "postgres-append-reversed": ("postgres", "append_workload",
                                 {"ops": 400, "keys": 2, "seed": 13,
                                  "concurrency": 6}, "psql_factory",
                                 lambda r: psql_factory(cls=PgCorrupt)(r),
                                 False,
                                 dict(nodes=("n1", "n2", "n3"),
                                      concurrency=6, limit=400,
                                      stagger=0.0005)),
    "postgres-bank": ("postgres", "bank_workload",
                      {"ops": 300, "seed": 17, "concurrency": 6},
                      "psql_factory", lambda r: psql_factory()(r), True,
                      dict(nodes=("n1", "n2", "n3"), concurrency=6,
                           limit=300, stagger=0.0005)),
    "postgres-bank-lost-debit": ("postgres", "bank_workload",
                                 {"ops": 200, "seed": 19,
                                  "concurrency": 4}, "psql_factory",
                                 lambda r: psql_factory(cls=PgLossy)(r),
                                 False,
                                 dict(nodes=("n1", "n2", "n3"),
                                      concurrency=4, limit=200,
                                      stagger=0.0005)),
    "stolon-append": ("stolon", "append_workload",
                      {"ops": 300, "keys": 5, "seed": 11}, "psql_factory",
                      lambda r: psql_factory()(r), True,
                      dict(nodes=("n1", "n2", "n3"), concurrency=6,
                           limit=300, stagger=0.0005)),
    "stolon-append-reversed": ("stolon", "append_workload",
                               {"ops": 400, "keys": 2, "seed": 13},
                               "psql_factory",
                               lambda r: psql_factory(cls=PgCorrupt)(r),
                               False, dict(nodes=("n1", "n2", "n3"),
                                           concurrency=6, limit=400,
                                           stagger=0.0005)),
    "stolon-ledger": ("stolon", "ledger_workload", {"ops": 200, "seed": 7},
                      "psql_factory",
                      lambda r: psql_factory(tst.FakeLedgerPg())(r), True,
                      dict(stagger=0.0003)),
    "stolon-ledger-double-spend": ("stolon", "ledger_workload",
                                   {"ops": 300, "seed": 7}, "psql_factory",
                                   lambda r: psql_factory(tst.FakeLedgerPg(
                                       broken=True))(r), False,
                                   dict(concurrency=6, stagger=0.0003)),
}


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_checked_by_both(run, root):
    name, workload, opts, attr, factory, valid, kw = RUNS[run]
    res = run_checked_by_both(root, name, workload, opts, attr, factory,
                              valid, **kw)
    if not valid and workload == "append_workload":
        assert "incompatible-order" in res["anomaly-types"]


# ---------------------------------------------------------------------------
# builders, command lines, stored runs, phase 27
# ---------------------------------------------------------------------------

BUILDERS = {"galera": "galera_test", "postgres": "postgres_test",
            "stolon": "stolon_test"}
OPTS = {"nodes": ["n1", "n2", "n3"], "concurrency": 6,
        "ssh": {"dummy": True}, "time_limit": 1}


@pytest.mark.parametrize("name,workload", [
    ("galera", None), ("galera", "set"), ("postgres", "append"),
    ("postgres", "bank"), ("stolon", None), ("stolon", "ledger")])
def test_builder_shape_equal(name, workload):
    opts = dict(OPTS, isolation="REPEATABLE READ")
    if workload:
        opts["workload"] = workload
    tests = {root: getattr(suite(root, name), BUILDERS[name])(
        device_opts(root, opts)) for root in ROOTS}
    assert shape(tests[PORT]) == shape(tests[JAX])
    assert getattr(tests[PORT]["client"], "isolation", None) == \
        getattr(tests[JAX]["client"], "isolation", None)
    assert list(suite(PORT, name).WORKLOADS) == \
        list(suite(JAX, name).WORKLOADS)


def test_stolon_nemesis_packages_alike():
    for faults in (None, ["partition"], ["kill"], ["partition", "kill"]):
        fs = {}
        for root in ROOTS:
            opts = device_opts(root, dict(OPTS, faults=faults))
            t = suite(root, "stolon").stolon_test(opts)
            fs[root] = sorted(t["nemesis"].fs())
        assert fs[PORT] == fs[JAX]


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


def test_phase_27_sql_runs_at_a_small_size(monkeypatch):
    launches = phase_27(SUITES, monkeypatch)
    # no linearizable register, no 12-account bank, no append past
    # Elle's dispatch at this size: no kernel
    assert launches == {"wgl_search": {}, "scc": {}, "bank_reduce": {}}
