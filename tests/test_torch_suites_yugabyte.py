"""The port's yugabyte suite against the JAX package's, on the CPU: the
API-parameterised workload matrix (counter, set, set-index, bank, bank
multitable, long-fork, single- and multi-key ACID registers, Elle's
list-append and its per-table variant, the default-value DDL race) over
ysqlsh and ycqlsh.

The DB's command streams per node on the dummy remote; each runner's
command line; each client's statements and completions against the JAX
test's in-memory FakeYb (YSQL; its errors raised as each package's own
RemoteError) and FakeYcql (YCQL); the error classification; the
multi-register model and the default-value checker; whole clusterless
runs of every workload of the matrix, healthy and with a seeded bug
(lost updates, a NULL default, reversed list reads), recorded on each
package and checked by both with equal results; the builder for every
matrix entry, the command line, stored runs across packages, and phase
28 at a small size. Equality is exact: the results are verdicts, models
and anomaly sets.
"""

from __future__ import annotations

import random

import pytest

import test_yugabyte as tyb
from test_torch_suites_registry import (  # noqa: F401 (fixture)
    JAX, PORT, ROOTS, Raising, both_streams, clear_ip_caches, device_opts,
    failing_keys, help_options, make_test, mod, op, outcome, parsed,
    phase_28, remote_error, run_checked_by_both, shape, small_specs,
    stored_across, suite)

NAME = "yugabyte"


def ysql_factory(state=None):
    """tests/test_yugabyte.py's FakeRunnerFactory per package: the one
    FakeYb, its errors raised as root's RemoteError."""
    state = state or tyb.FakeYb()

    def for_root(root):
        def make(test, node, timeout=10.0):
            class _Runner:
                dialect = "ysql"

                def run(self, stmt):
                    try:
                        return state.run(stmt)
                    except tyb._SqlError as e:
                        raise remote_error(root, "sql failed", err=str(e),
                                           cmd="sql", node=node)

                def close(self):
                    pass

            return _Runner()

        make.state = state
        return make

    return for_root


def ycql_factory(state=None):
    """tests/test_yugabyte.py's FakeYcqlFactory: the CQL fake answers
    with strings alone, so both packages share it."""
    state = state or tyb.FakeYcql()

    def for_root(root):
        f = tyb.FakeYcqlFactory(state)
        f.state = state
        return f

    return for_root


def matrix(entry):
    """A run_workload workload: the matrix entry through the suite's own
    workload_for (its runner pinned to the entry's API)."""
    def build(s, opts):
        return s.workload_for(entry, opts)[0]

    build.__name__ = entry
    return build


# ---------------------------------------------------------------------------
# the DB and the runners
# ---------------------------------------------------------------------------

def _archive(node, action):
    if action.cmd.startswith("stat "):
        return mod(JAX, "control.core").Result(exit=1, out="",
                                               err="no such file",
                                               cmd=action.cmd)
    if action.cmd.startswith("dirname "):
        return action.cmd.split()[-1].rsplit("/", 1)[0]
    if action.cmd.startswith("ls -A"):
        return "yugabyte-2.20.1.3"
    return None


@pytest.mark.parametrize("method", ["setup", "teardown", "kill", "start",
                                    "_start_master", "_start_tserver"])
def test_db_command_stream(method):
    calls = ([("setup", None)] if method == "setup"
             else [(method, "n2"), (method, "n1")])
    both_streams(NAME, lambda s, r: s.YbDB(replicas=3), calls, _archive)


def test_master_addresses_alike():
    for nodes in (["n1"], ["n1", "n2", "n3"]):
        assert suite(PORT, NAME).master_addresses({"nodes": nodes}) == \
            suite(JAX, NAME).master_addresses({"nodes": nodes})


@pytest.mark.parametrize("runner", ["YsqlRunner", "YcqlRunner"])
def test_runner_command_line_alike(runner):
    got = {}
    for root in ROOTS:
        test = make_test(root, lambda node, a: "m0=1", ("n1", "n2"))
        r = getattr(suite(root, NAME), runner)(test, "n2", timeout=4)
        with mod(root, "control").with_session(test, "n2"):
            out = r.run("SELECT 1")
        r.close()
        got[root] = (out, r.dialect, [(a.cmd, a.stdin) for a in
                                      test["sessions"]["n2"].log])
    assert got[PORT] == got[JAX]


@pytest.mark.parametrize("out", ["1\n2\n", " v\n---\n3\n\n(1 rows)", "",
                                 "-4\nx\n 5 \n"])
def test_int_lines_alike(out):
    assert suite(PORT, NAME)._int_lines(out) == \
        suite(JAX, NAME)._int_lines(out)


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------

def _counter(root, c):
    out = [outcome(c.invoke({}, op(root, "add", v))) for v in (2, 3)]
    return out + [outcome(c.invoke({}, op(root, "read")))]


def _set(root, c):
    out = [outcome(c.invoke({}, op(root, "add", v))) for v in (4, 9, 1)]
    return out + [outcome(c.invoke({}, op(root, "read")))]


def _bank(root, c):
    out = [outcome(c.invoke({}, op(root, "transfer", v))) for v in (
        {"from": 0, "to": 1, "amount": 4},
        {"from": 2, "to": 1, "amount": 11})]
    return out + [outcome(c.invoke({}, op(root, "read")))]


def _single(root, c):
    return [outcome(c.invoke({}, op(root, f, [k, v])))
            for f, k, v in (("read", 0, None), ("write", 0, 3),
                            ("read", 0, None), ("cas", 0, [3, 4]),
                            ("cas", 0, [3, 9]), ("read", 0, None))]


def _multi(root, c):
    return [outcome(c.invoke({}, op(root, f, [k, v])))
            for f, k, v in (("read", 0, [[0, None], [1, None]]),
                            ("write", 0, [[0, 2], [1, 102]]),
                            ("read", 0, [[0, None], [1, None]]),
                            ("read", 1, [[0, None], [1, None]]))]


def _append(root, c):
    return [outcome(c.invoke({}, op(root, "txn", mops)))
            for mops in ([["append", 1, 10]], [["r", 1, None]],
                         [["append", 4, 2], ["r", 4, None],
                          ["append", 4, 3], ["r", 4, None]],
                         [["r", 9, None]])]


def _long_fork(root, c):
    return [outcome(c.invoke({}, op(root, "txn", mops)))
            for mops in ([["w", 1, 1]], [["r", 1, None], ["r", 2, None]],
                         [["w", 2, 1], ["w", 3, 1]], [["r", 2, None]])]


def _default_value(root, c):
    return [outcome(c.invoke({}, op(root, f, v)))
            for f, v in (("insert", None), ("add-column", 0),
                         ("insert", None), ("read", None))]


YSQL = {
    "counter": ("CounterClient", _counter),
    "set": ("SetClient", _set),
    "set-index": ("SetIndexClient", _set),
    "bank": ("BankClient", _bank),
    "bank-multitable": ("MultiBankClient", _bank),
    "single-key-acid": ("SingleKeyAcidClient", _single),
    "multi-key-acid": ("MultiKeyAcidClient", _multi),
    "append": ("AppendClient", _append),
    "append-table": ("AppendTableClient", _append),
    "long-fork": ("TxnWClient", _long_fork),
    "default-value": ("DefaultValueClient", _default_value),
}
YCQL = ("counter", "set", "bank", "single-key-acid", "long-fork")


def _tables(fake) -> dict:
    return {k: v for k, v in vars(fake).items() if k != "lock"}


@pytest.mark.parametrize("api,case", [("ysql", c) for c in sorted(YSQL)]
                         + [("ycql", c) for c in YCQL])
def test_client_alike(api, case):
    cls, script = YSQL[case]
    got = {}
    for root in ROOTS:
        f = (ysql_factory if api == "ysql" else ycql_factory)()(root)
        c = getattr(suite(root, NAME), cls)(runner_factory=f).open(
            {"nodes": ["n1", "n2"]}, "n2")
        c.setup({})
        got[root] = (script(root, c), _tables(f.state))
    assert got[PORT] == got[JAX]
    assert any(o[0] == "ok" for o in got[PORT][0])


ERRORS = [
    ("SetClient", "add", 3, "could not serialize access", "fail"),
    ("SetClient", "add", 3, "connection closed", "info"),
    ("SetClient", "read", None, "connection closed", "fail"),
    ("BankClient", "transfer", {"from": 0, "to": 1, "amount": 1},
     "Restart read required", "fail"),
    ("SingleKeyAcidClient", "cas", [0, [1, 2]], "timed out", "info"),
    ("MultiKeyAcidClient", "write", [0, [[0, 1], [1, 101]]],
     "Conflicts with higher priority transaction", "fail"),
    ("AppendClient", "txn", [["r", 1, None]], "timed out", "info"),
    ("DefaultValueClient", "read", None, "timed out", "fail"),
]


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_client_error_classified_alike(case):
    cls, f, value, err, want = ERRORS[case]
    got = {}
    for root in ROOTS:
        make = Raising(root, lambda r: remote_error(r, "ysqlsh failed",
                                                    err=err))
        c = getattr(suite(root, NAME), cls)(runner_factory=make).open(
            {}, "n1")
        got[root] = outcome(c.invoke({}, op(root, f, value)))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == want


def test_multi_register_model_steps_alike():
    got = {}
    for root in ROOTS:
        m = suite(root, NAME).MultiRegister()
        Op = mod(root, "history").Op
        out = []
        for f, v in (("read", [[0, None], [1, None]]),
                     ("write", [[0, 1], [1, 101]]),
                     ("read", [[0, 1], [1, 101]]),
                     ("read", None),
                     ("read", [[0, 1], [1, None]])):
            m = m.step(Op(type="ok", process=0, f=f, value=v))
            out.append(repr(m))
            if "Inconsistent" in type(m).__name__:
                break
        got[root] = out
    assert got[PORT] == got[JAX]
    assert len(got[PORT]) == 5


def test_default_value_checker_alike():
    got = {}
    for root in ROOTS:
        Op = mod(root, "history").Op
        hist = [Op(index=0, type="ok", process=0, f="read", value=[1, 0]),
                Op(index=1, type="ok", process=1, f="read",
                   value=[2, None]),
                Op(index=2, type="fail", process=1, f="read", value=None)]
        got[root] = (suite(root, NAME).check_default_values(hist),
                     suite(root, NAME).check_default_values(hist[:1]))
    assert got[PORT] == got[JAX]
    assert got[PORT][0]["valid?"] is False and got[PORT][1]["valid?"]


def test_default_value_generator_alike():
    """default_value_workload draws from the global random module: the
    same seed gives the same ops in both packages."""
    got = {}
    for root in ROOTS:
        random.seed(21)
        g = suite(root, NAME).default_value_workload({"ops": 40})
        ts = mod(root, "generator.test_support")
        got[root] = [(o.type, o.f, o.value)
                     for o in ts.perfect(g["generator"])]
    assert got[PORT] == got[JAX]


# ---------------------------------------------------------------------------
# whole clusterless runs
# ---------------------------------------------------------------------------

class Reversed(tyb.FakeYb):
    """Every second list read of two or more elements comes back
    reversed."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def _select(self, s):
        out = super()._select(s)
        if out.startswith("m") and "," in out:
            self.n += 1
            if self.n % 2:
                tag, raw = out.split("=", 1)
                out = tag + "=" + ",".join(reversed(raw.split(",")))
        return out


class YcqlIndexed(tyb.FakeYcql):
    """The CQL fake with the covering index of ycql/set-index (reads go
    to the table as before)."""

    def _one(self, s):
        if s.upper().startswith("CREATE INDEX"):
            return ""
        return super()._one(s)


N3 = {"nodes": ("n1", "n2", "n3"), "concurrency": 6, "stagger": 0.0003}
BANK = dict(N3, extra=("total-amount", "accounts"))
REGISTERS = {"keys": [0, 1], "ops_per_key": 40, "group_size": 3, "seed": 7}
# run -> (matrix entry, opts, factory, fake, valid, run_workload kwargs)
RUNS = {
    "ysql/counter": ("ysql/counter", {"ops": 60}, ysql_factory,
                     tyb.FakeYb, True, N3),
    "ysql/set": ("ysql/set", {"ops": 60}, ysql_factory, tyb.FakeYb, True,
                 N3),
    "ysql/bank": ("ysql/bank", {"ops": 80}, ysql_factory, tyb.FakeYb, True,
                  BANK),
    "ysql/bank-lost-update": ("ysql/bank", {"ops": 80}, ysql_factory,
                              lambda: tyb.FakeYb(broken="lost-update"),
                              False, BANK),
    "ysql/bank-multitable": ("ysql/bank-multitable", {"ops": 80},
                             ysql_factory, tyb.FakeYb, True, BANK),
    "ysql/long-fork": ("ysql/long-fork", {"ops": 100}, ysql_factory,
                       tyb.FakeYb, True, N3),
    "ysql/single-key-acid": ("ysql/single-key-acid", REGISTERS,
                             ysql_factory, tyb.FakeYb, True, N3),
    "ysql/multi-key-acid": ("ysql/multi-key-acid",
                            dict(REGISTERS, ops_per_key=30), ysql_factory,
                            tyb.FakeYb, True, N3),
    "ysql/append": ("ysql/append", {"ops": 150, "seed": 3}, ysql_factory,
                    tyb.FakeYb, True, N3),
    "ysql/append-reversed": ("ysql/append",
                             {"ops": 300, "seed": 13, "key-count": 2},
                             ysql_factory, Reversed, False, N3),
    "ysql/append-table": ("ysql/append-table", {"ops": 150, "seed": 3},
                          ysql_factory, tyb.FakeYb, True, N3),
    "ysql/default-value": ("ysql/default-value", {"ops": 80}, ysql_factory,
                           tyb.FakeYb, True, N3),
    "ysql/default-value-null": ("ysql/default-value", {"ops": 120},
                                ysql_factory,
                                lambda: tyb.FakeYb(broken="null-default"),
                                False, N3),
    "ycql/counter": ("ycql/counter", {"ops": 60}, ycql_factory,
                     tyb.FakeYcql, True, N3),
    "ycql/set": ("ycql/set", {"ops": 60}, ycql_factory, tyb.FakeYcql, True,
                 N3),
    "ycql/set-index": ("ycql/set-index", {"ops": 60}, ycql_factory,
                       YcqlIndexed, True, N3),
    "ycql/bank": ("ycql/bank", {"ops": 60}, ycql_factory, tyb.FakeYcql,
                  True, BANK),
    "ycql/single-key-acid": ("ycql/single-key-acid", REGISTERS,
                             ycql_factory, tyb.FakeYcql, True, N3),
    "ycql/long-fork": ("ycql/long-fork", {"ops": 100}, ycql_factory,
                       tyb.FakeYcql, True, N3),
}


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_checked_by_both(run, root):
    entry, opts, factory, fake, valid, kw = RUNS[run]
    res = run_checked_by_both(root, NAME, matrix(entry), opts,
                              "runner_factory", factory(fake()), valid,
                              **kw)
    if run == "ysql/append-reversed":
        assert "incompatible-order" in failing_keys(res)


def test_runs_cover_the_matrix():
    """Every matrix entry runs above but ycql/multi-key-acid, whose
    client runs above over YSQL (the JAX test's CQL fake has no multireg
    table)."""
    run = {v[0] for v in RUNS.values()}
    assert set(suite(JAX, NAME).WORKLOADS) - run == {"ycql/multi-key-acid"}


# ---------------------------------------------------------------------------
# builders, command lines, stored runs, phase 28
# ---------------------------------------------------------------------------

OPTS = {"nodes": ["n1", "n2", "n3"], "concurrency": 6,
        "ssh": {"dummy": True}, "time_limit": 1, "seed": 1}


# the default, each entry, and bare names resolved through --api
BUILT = ([(None, "ysql")] + [(w, "ysql") for w in suite(JAX, NAME).WORKLOADS]
         + [("set", "ycql"), ("bank", "ycql"), ("append", "ysql")])


@pytest.mark.parametrize("workload,api", BUILT)
def test_builder_shape_equal(workload, api):
    opts = dict(OPTS, api=api,
                **({"workload": workload} if workload else {}))
    tests = {root: suite(root, NAME).yugabyte_test(device_opts(root, opts))
             for root in ROOTS}
    assert shape(tests[PORT]) == shape(tests[JAX])
    assert tests[PORT]["client"].runner_factory.__name__ == \
        tests[JAX]["client"].runner_factory.__name__
    for k in ("total-amount", "accounts"):
        assert tests[PORT].get(k) == tests[JAX].get(k)


def test_command_line_options():
    port, jax = help_options(PORT, NAME), help_options(JAX, NAME)
    assert sorted(set(port) - {"--device"}) == sorted(set(jax))
    argv = ["--nodes", "n1,n2", "--time-limit", "3", "--no-ssh",
            "--workload", "bank", "--api", "ycql", "--replicas", "2"]
    got = parsed(PORT, NAME, argv + ["--device", "cpu"])
    want = parsed(JAX, NAME, argv)
    assert got.pop("device") == "cpu"
    assert got == want


@pytest.mark.parametrize("writer", ROOTS)
@pytest.mark.parametrize("run", sorted(small_specs((NAME,))))
def test_stored_run_analysed_by_both(run, writer, tmp_path):
    stored_across(writer, small_specs((NAME,))[run], tmp_path)


def test_phase_28_yugabyte_runs_at_a_small_size(monkeypatch):
    launches = phase_28((NAME,), monkeypatch)
    # the multi-key ACID registers in one plain wgl_search; 200 txns
    # stay under Elle's device dispatch
    assert launches == {
        "wgl_search": {"suite-yugabyte-ysql-multi-key-acid": 1},
        "scc": {}, "bank_reduce": {}}
