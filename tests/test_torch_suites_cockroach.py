"""The port's cockroach suite against the JAX package's, on the CPU: the
register, bank (one table and multitable), monotonic, sequential, sets,
comments and G2 workloads over `cockroach sql --format tsv`.

The DB's command streams per node on the dummy remote (install, start,
the primary's one-time init and schema); the transport's command line;
each client's statements and completions against the JAX test's
in-memory FakeCrdbFull (its errors raised as each package's own
RemoteError); the error classification; whole clusterless runs of every
workload, healthy and with a seeded bug (phantom register reads, a lost
debit, a backwards timestamp, a hidden subkey, causal reversal, a G2
race), recorded on each package and checked by both with equal results;
the builder, the command line, stored runs across packages, and phase 28
at a small size. Equality is exact: the results are verdicts, failing
keys and counts.
"""

from __future__ import annotations

import random
import re
from decimal import Decimal

import pytest

import test_cockroach as tcr
from test_torch_suites_registry import (  # noqa: F401 (fixture)
    JAX, PORT, ROOTS, Raising, both_streams, clear_ip_caches, device_opts,
    failing_keys, help_options, make_test, mod, op, outcome, parsed,
    phase_28, remote_error, run_checked_by_both, shape, small_specs,
    stored_across, suite)

NAME = "cockroach"


def sql_factory(state=None):
    """tests/test_cockroach.py's FakeFullFactory per package: the one
    fake database, its errors (the fake's own, or a JAX RemoteError)
    raised as root's RemoteError."""
    state = state or tcr.FakeCrdbFull()

    def for_root(root):
        def make(test, node, timeout=10.0):
            class _Sql:
                def run(self, sql):
                    try:
                        return state.run(sql)
                    except tcr._CrdbError as e:
                        raise remote_error(root, "sql failed", err=str(e),
                                           cmd="sql", node=node)
                    except mod(JAX, "control.core").RemoteError as e:
                        raise remote_error(root, "cockroach sql failed",
                                           err=e.err, cmd=e.cmd,
                                           node=e.node)

                def close(self):
                    pass

            return _Sql()

        make.state = state
        return make

    return for_root


def kop(root, f, k, v=None, process=0):
    return op(root, f, mod(root, "independent").ktuple(k, v), process)


# ---------------------------------------------------------------------------
# the DB and the transport
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["setup", "teardown", "kill", "start"])
def test_db_command_stream(method):
    calls = ([("setup", None)] if method == "setup"
             else [(method, "n2"), (method, "n1")])
    stream = both_streams(NAME, lambda s, r: s.CockroachDB(), calls,
                          tcr.responder, prepare=True)
    if method == "setup":
        # init and schema once, on the primary
        cmds = {n: " ; ".join(a[1] for a in acts if a[0] == "exec")
                for n, acts in stream.items()}
        assert "init --insecure" in cmds["n1"]
        assert "init --insecure" not in cmds["n2"]


def test_transport_command_line_alike():
    got = {}
    for root in ROOTS:
        test = make_test(root, lambda node, a: "v\n3", ("n1", "n2"))
        s = suite(root, NAME).CrdbSql(test, "n2", timeout=4)
        out = s.run("SELECT v FROM kv WHERE k = 1;")
        got[root] = (out, [(a.cmd, a.stdin) for a in s.sess.log])
        s.close()
    assert got[PORT] == got[JAX]


@pytest.mark.parametrize("out,want", [("v\n3", ["3"]), ("v", []),
                                      ("NOTICE: x\nid\tb\n1\t2\n", ["1\t2"]),
                                      ("", [])])
def test_data_lines_alike(out, want):
    assert suite(PORT, NAME)._data_lines(out) == \
        suite(JAX, NAME)._data_lines(out) == want


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------

def _register(root, c):
    return [outcome(c.invoke({}, kop(root, f, k, v)))
            for f, k, v in [("read", 0, None), ("write", 0, 3),
                            ("read", 0, None), ("cas", 0, [3, 4]),
                            ("cas", 0, [3, 9]), ("read", 0, None),
                            ("write", 1, 2), ("read", 1, None)]]


def _bank(root, c):
    out = [outcome(c.invoke({}, op(root, "transfer", v))) for v in (
        {"from": 0, "to": 1, "amount": 4},
        {"from": 2, "to": 1, "amount": 11},
        {"from": 1, "to": 3, "amount": 14})]
    return out + [outcome(c.invoke({}, op(root, "read")))]


def _monotonic(root, c):
    random.seed(11)  # the client draws its tb from the global random
    out = [outcome(c.invoke({}, op(root, "add", None, process=p)))
           for p in (0, 3, 1)]
    return out + [outcome(c.invoke({}, op(root, "read")))]


def _sequential(root, c):
    return [outcome(c.invoke({}, op(root, f, k)))
            for f, k in (("write", 0), ("read", 0), ("read", 1),
                         ("write", 1), ("read", 1))]


def _sets(root, c):
    out = [outcome(c.invoke({}, op(root, "add", v))) for v in (4, 9, 1)]
    return out + [outcome(c.invoke({}, op(root, "read")))]


def _comments(root, c):
    return [outcome(c.invoke({}, op(root, f, [k, v])))
            for f, k, v in (("write", 0, 1), ("write", 0, 2),
                            ("write", 1, 3), ("read", 0, None),
                            ("read", 1, None), ("read", 2, None))]


def _g2(root, c):
    return [outcome(c.invoke({}, op(root, "insert", [k, pair])))
            for k, pair in ((1, [10, None]), (1, [None, 11]),
                            (2, [None, 12]), (2, [13, None]))]


CLIENTS = {
    "register": ("CrdbRegisterClient", {}, _register),
    "bank": ("CrdbBankClient", {}, _bank),
    "bank-multitable": ("CrdbMultiBankClient", {}, _bank),
    "monotonic": ("CrdbMonotonicClient", {}, _monotonic),
    "sequential": ("CrdbSequentialClient", {"key_count": 3}, _sequential),
    "sets": ("CrdbSetClient", {}, _sets),
    "comments": ("CrdbCommentsClient", {}, _comments),
    "g2": ("CrdbG2Client", {}, _g2),
}


def _fake_state(fake) -> dict:
    return {k: v for k, v in vars(fake).items() if k != "lock"}


@pytest.mark.parametrize("case", sorted(CLIENTS))
def test_client_alike(case):
    cls, kw, script = CLIENTS[case]
    got = {}
    for root in ROOTS:
        f = sql_factory()(root)
        c = getattr(suite(root, NAME), cls)(sql_factory=f, **kw).open(
            {"nodes": ["n1", "n2"]}, "n2")
        got[root] = (script(root, c), _fake_state(f.state))
    assert got[PORT] == got[JAX]
    assert any(o[0] == "ok" for o in got[PORT][0])


def test_bank_overdraft_is_a_definite_fail_alike():
    got = {}
    for root in ROOTS:
        c = suite(root, NAME).CrdbBankClient(
            sql_factory=sql_factory()(root)).open({}, "n1")
        got[root] = _bank(root, c)
    assert got[PORT] == got[JAX]
    assert [o[0] for o in got[PORT]] == ["ok", "fail", "ok", "ok"]
    assert "check constraint" in got[PORT][1][3]


ERRORS = [
    ("CrdbRegisterClient", "read", "connection reset", "fail"),
    ("CrdbRegisterClient", "write", "connection reset", "info"),
    ("CrdbRegisterClient", "cas", "restart transaction: retry", "fail"),
    ("CrdbRegisterClient", "write", "TransactionRetryError", "fail"),
    ("CrdbBankClient", "transfer", "node is not ready", "fail"),
    ("CrdbBankClient", "transfer", "i/o timeout", "info"),
    ("CrdbSetClient", "add", "failed to connect to n1", "fail"),
    ("CrdbG2Client", "insert", "i/o timeout", "info"),
]
VALUES = {"read": None, "write": 1, "cas": [1, 2], "add": 3,
          "transfer": {"from": 0, "to": 1, "amount": 1},
          "insert": [1, [5, None]]}


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_client_error_classified_alike(case):
    cls, f, err, want = ERRORS[case]
    got = {}
    for root in ROOTS:
        make = Raising(root, lambda r: remote_error(r, "sql failed",
                                                    err=err))
        c = getattr(suite(root, NAME), cls)(sql_factory=make).open({}, "n1")
        value = VALUES[f]
        if cls == "CrdbRegisterClient":
            value = mod(root, "independent").ktuple(0, value)
        got[root] = outcome(c.invoke({}, op(root, f, value)))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == want


# ---------------------------------------------------------------------------
# whole clusterless runs
# ---------------------------------------------------------------------------

class CrdbPhantom(tcr.FakeCrdbFull):
    """From the 20th read of key 0 on, it answers 99, a value nobody
    wrote."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def run(self, sql):
        if sql.startswith("SELECT v FROM kv WHERE k = 0;"):
            self.reads += 1
            if self.reads >= 20:
                return "v\n99"
        return super().run(sql)


class CrdbLostDebit(tcr.FakeCrdbFull):
    """Every fifth transfer credits without debiting."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def run(self, sql):
        if "UPDATE accounts" in sql:
            self.n += 1
            if self.n % 5 == 0:
                m = re.search(r"balance \+ (\d+) WHERE id = (\d+)", sql)
                with self.lock:
                    self.accounts[int(m.group(2))] += int(m.group(1))
                return ""
        return super().run(sql)


class CrdbSkewed(tcr.FakeCrdbFull):
    """tests/test_cockroach.py's Skewed: every seventh row's stored
    timestamp runs backwards."""

    def run(self, sql):
        out = super().run(sql)
        if sql.startswith("INSERT INTO mono") and len(self.mono) % 7 == 0:
            with self.lock:
                self.mono[-1]["sts"] = Decimal(max(self.clock - 5, 0))
        return out


class CrdbDropping(tcr.FakeCrdbFull):
    """tests/test_cockroach.py's Dropping: _0 subkeys hidden from
    reads."""

    def run(self, sql):
        if sql.startswith("SELECT key FROM seq") and "_0'" in sql:
            return "key"
        return super().run(sql)


N3 = {"nodes": ("n1", "n2", "n3"), "concurrency": 6, "stagger": 0.0003}
RUNS = {
    "register": ("register_workload", {"concurrency": 6, "keys": 2,
                                       "ops_per_key": 50, "seed": 3},
                 tcr.FakeCrdbFull, True, dict(N3)),
    "register-phantom": ("register_workload",
                         {"concurrency": 4, "keys": 1, "ops_per_key": 100,
                          "seed": 5}, CrdbPhantom, False,
                         dict(N3, concurrency=4)),
    "bank": ("bank_workload", {"seed": 5}, tcr.FakeCrdbFull, True,
             dict(N3, limit=150)),
    "bank-lost-debit": ("bank_workload", {"seed": 7}, CrdbLostDebit, False,
                        dict(N3, limit=200)),
    "bank-multitable": ("bank_multitable_workload", {"seed": 5},
                        tcr.FakeCrdbFull, True, dict(N3, limit=100)),
    "monotonic": ("monotonic_workload", {"concurrency": 4, "ops": 120},
                  tcr.FakeCrdbFull, True,
                  dict(N3, concurrency=4, final=True)),
    "monotonic-skewed": ("monotonic_workload",
                         {"concurrency": 4, "ops": 150}, CrdbSkewed, False,
                         dict(N3, concurrency=4, final=True)),
    "sequential": ("sequential_workload",
                   {"concurrency": 6, "ops": 200, "seed": 9},
                   tcr.FakeCrdbFull, True, dict(N3, extra=("key_count",))),
    "sequential-dropped": ("sequential_workload",
                           {"concurrency": 6, "ops": 200, "seed": 9},
                           CrdbDropping, False,
                           dict(N3, extra=("key_count",))),
    "sets": ("sets_workload", {"ops": 100}, tcr.FakeCrdbFull, True,
             dict(N3, limit=130)),
    "comments": ("comments_workload", {"keys": [0, 1],
                                       "per-key-limit": 40},
                 tcr.FakeCrdbFull, True, dict(N3, limit=100)),
    "comments-causal-reverse": ("comments_workload",
                                {"keys": [0], "per-key-limit": 80,
                                 "group-size": 3},
                                lambda: tcr.FakeCrdbFull("causal-reverse"),
                                False, dict(N3, limit=120)),
    "g2": ("g2_workload", {"keys": list(range(1, 13))}, tcr.FakeCrdbFull,
           True, dict(N3, limit=60)),
    "g2-race": ("g2_workload", {"keys": list(range(1, 13))},
                lambda: tcr.FakeCrdbFull("g2-race"), False,
                dict(N3, limit=60)),
}


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_checked_by_both(run, root):
    workload, opts, fake, valid, kw = RUNS[run]
    res = run_checked_by_both(root, NAME, workload, opts, "sql_factory",
                              sql_factory(fake()), valid, **kw)
    if run == "register-phantom":
        assert failing_keys(res) == [0]


# ---------------------------------------------------------------------------
# builders, command lines, stored runs, phase 28
# ---------------------------------------------------------------------------

OPTS = {"nodes": ["n1", "n2", "n3"], "concurrency": 6,
        "ssh": {"dummy": True}, "time_limit": 1, "seed": 1}


@pytest.mark.parametrize("workload", [None] + list(
    suite(JAX, NAME).WORKLOADS))
def test_builder_shape_equal(workload):
    opts = dict(OPTS, **({"workload": workload} if workload else {}))
    tests = {root: suite(root, NAME).cockroach_test(device_opts(root, opts))
             for root in ROOTS}
    assert shape(tests[PORT]) == shape(tests[JAX])
    assert tests[PORT]["key_count"] == tests[JAX]["key_count"]
    assert list(suite(PORT, NAME).WORKLOADS) == \
        list(suite(JAX, NAME).WORKLOADS)


def test_command_line_options():
    port, jax = help_options(PORT, NAME), help_options(JAX, NAME)
    assert sorted(set(port) - {"--device"}) == sorted(set(jax))
    argv = ["--nodes", "n1,n2", "--time-limit", "3", "--no-ssh",
            "--workload", "bank", "--version", "v23.1.9"]
    got = parsed(PORT, NAME, argv + ["--device", "cpu"])
    want = parsed(JAX, NAME, argv)
    assert got.pop("device") == "cpu"
    assert got == want


@pytest.mark.parametrize("writer", ROOTS)
@pytest.mark.parametrize("run", sorted(small_specs((NAME,))))
def test_stored_run_analysed_by_both(run, writer, tmp_path):
    stored_across(writer, small_specs((NAME,))[run], tmp_path)


def test_phase_28_cockroach_runs_at_a_small_size(monkeypatch):
    launches = phase_28((NAME,), monkeypatch)
    # the register's keys in one plain wgl_search, its twin's too
    assert launches == {"wgl_search": {"suite-cockroach-register": 1,
                                       "suite-cockroach-register-twin": 1},
                        "scc": {}, "bank_reduce": {}}
