"""The port's hazelcast suite against the JAX package's, on the CPU: the
CP locks, semaphore, atomic long and reference, id generator and queue
over the client jar's line protocol.

The DB's command streams per node on the dummy remote; the console's
command line; each client's completions and the structures of the JAX
test's in-memory FakeHz on the same script; the error classification
(each package's own RemoteError); whole clusterless runs of every
workload, healthy and with the JAX test's seeded bugs (a stolen lock, an
overfilled semaphore), recorded on each package and checked by both with
equal results; the builder, the command line, stored runs across
packages, and phase 28 at a small size. Equality is exact: the results
are verdicts, models and counts.
"""

from __future__ import annotations

import pytest

import test_hazelcast as thz
from test_torch_suites_registry import (  # noqa: F401 (fixture)
    JAX, PORT, ROOTS, Raising, both_streams, clear_ip_caches, device_opts,
    help_options, make_test, mod, op, outcome, parsed, phase_28,
    remote_error, run_checked_by_both, shape, small_specs, stored_across,
    suite)

NAME = "hazelcast"


def console_factory(state=None):
    """tests/test_hazelcast.py's FakeConsoleFactory, one per package run:
    the line protocol answers with strings, so both packages share it."""
    state = state or thz.FakeHz()
    return lambda root: thz.FakeConsoleFactory(state)


def _archive(node, action):
    """install_archive's probes: nothing cached, one top-level
    directory."""
    if action.cmd.startswith("stat "):
        return mod(JAX, "control.core").Result(exit=1, out="",
                                               err="no such file",
                                               cmd=action.cmd)
    if action.cmd.startswith("dirname "):
        return action.cmd.split()[-1].rsplit("/", 1)[0]
    if action.cmd.startswith("ls -A"):
        return "hazelcast-5.3.6"
    return None


# ---------------------------------------------------------------------------
# the DB and the console
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nodes", [["n1"], ["n1", "n2", "n3"],
                                   ["n1", "n2", "n3", "n4", "n5"]])
def test_member_config_alike(nodes):
    t = {"nodes": nodes}
    assert suite(PORT, NAME).member_config(t) == \
        suite(JAX, NAME).member_config(t)


@pytest.mark.parametrize("method", ["setup", "teardown", "kill", "start"])
def test_db_command_stream(method):
    calls = ([("setup", None)] if method == "setup"
             else [(method, "n2"), (method, "n1")])
    both_streams(NAME, lambda s, r: s.HzDB(), calls, _archive)


def test_console_command_line_alike():
    got = {}
    for root in ROOTS:
        test = make_test(root, lambda node, a: "OK 1", ("n1", "n2"))
        c = suite(root, NAME).HzConsole(test, "n2", timeout=7)
        with mod(root, "control").with_session(test, "n2"):
            out = c.cmd("lock acquire jepsen.lock", session="jepsen-p3")
        got[root] = (out, [(a.cmd, a.stdin) for a in
                           test["sessions"]["n2"].log])
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == "OK 1"


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------

CLIENTS = {
    "lock": ("LockClient", {}, [
        ("acquire", None, 0), ("acquire", None, 1), ("release", None, 1),
        ("release", None, 0), ("acquire", None, 1), ("release", None, 1)]),
    "reentrant": ("LockClient", {"name": "jepsen.cpLock2"}, [
        ("acquire", None, 0), ("acquire", None, 0), ("release", None, 0),
        ("acquire", None, 2), ("release", None, 0), ("acquire", None, 2)]),
    "semaphore": ("SemaphoreClient", {}, [
        ("acquire", None, 0), ("acquire", None, 1), ("acquire", None, 2),
        ("release", None, 3), ("release", None, 0), ("acquire", None, 2)]),
    "cas-long": ("CasLongClient", {}, [
        ("read", None, 0), ("write", 3, 0), ("cas", [3, 4], 1),
        ("cas", [3, 9], 1), ("read", None, 2)]),
    "cas-reference": ("CasRefClient", {}, [
        ("read", None, 0), ("cas", [0, 3], 0), ("write", 2, 1),
        ("cas", [2, 5], 1), ("read", None, 2)]),
    "id-gen": ("IdGenClient", {}, [("generate", None, p)
                                   for p in range(4)]),
    "queue": ("QueueClient", {}, [
        ("dequeue", None, 0), ("enqueue", 4, 0), ("enqueue", 5, 1),
        ("dequeue", None, 2), ("enqueue", 6, 1), ("drain", None, 3)]),
}


def _state(fake) -> dict:
    return {k: v for k, v in vars(fake).items() if k != "lock"}


@pytest.mark.parametrize("case", sorted(CLIENTS))
def test_client_alike(case):
    cls, kw, script = CLIENTS[case]
    got = {}
    for root in ROOTS:
        fac = thz.FakeConsoleFactory(thz.FakeHz())
        c = getattr(suite(root, NAME), cls)(console_factory=fac, **kw)
        c = c.open({"nodes": ["n1", "n2"]}, "n1")
        out = [outcome(c.invoke({}, op(root, f, v, process=p)))
               for f, v, p in script]
        got[root] = (out, _state(fac.state))
    assert got[PORT] == got[JAX]
    assert {o[0] for o in got[PORT][0]} <= {"ok", "fail"}
    assert any(o[0] == "ok" for o in got[PORT][0])


def test_lock_fences_grow_across_holders_alike():
    got = {}
    for root in ROOTS:
        fac = thz.FakeConsoleFactory(thz.FakeHz())
        c = suite(root, NAME).LockClient(console_factory=fac).open(
            {"nodes": ["n1"]}, "n1")
        got[root] = [c.invoke({}, op(root, f, process=p)).value
                     for f, p in (("acquire", 0), ("release", 0),
                                  ("acquire", 1), ("release", 1),
                                  ("acquire", 0))]
    assert got[PORT] == got[JAX]
    assert [v["fence"] for v in got[PORT][0::2]] == [1, 2, 3]


ERRORS = [
    ("LockClient", "acquire", None, "info"),
    ("SemaphoreClient", "release", None, "info"),
    ("CasLongClient", "read", None, "fail"),
    ("CasLongClient", "write", 3, "info"),
    ("CasLongClient", "cas", [1, 2], "info"),
    ("CasRefClient", "read", None, "fail"),
    ("CasRefClient", "cas", [1, 2], "info"),
    ("IdGenClient", "generate", None, "info"),
    ("QueueClient", "enqueue", 1, "info"),
    ("QueueClient", "dequeue", None, "info"),
    ("QueueClient", "drain", None, "info"),
]


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_client_error_classified_alike(case):
    cls, f, value, want = ERRORS[case]
    got = {}
    for root in ROOTS:
        make = Raising(root, lambda r: remote_error(r, "jar failed",
                                                    err="timeout"))
        c = getattr(suite(root, NAME), cls)(console_factory=make).open(
            {"nodes": ["n1"]}, "n1")
        got[root] = outcome(c.invoke({}, op(root, f, value)))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == want


class PartialDrain(thz.FakeHz):
    """Polls answer two elements, then an error line."""

    def __init__(self):
        super().__init__()
        self.polls = 0

    def cmd(self, session, line):
        if line.startswith("q poll"):
            self.polls += 1
            return f"OK {self.polls}" if self.polls <= 2 else "ERR gone"
        return super().cmd(session, line)


def test_queue_drain_keeps_what_it_polled_alike():
    got = {}
    for root in ROOTS:
        fac = thz.FakeConsoleFactory(PartialDrain())
        c = suite(root, NAME).QueueClient(console_factory=fac).open(
            {"nodes": ["n1"]}, "n1")
        got[root] = outcome(c.invoke({}, op(root, "drain")))
    assert got[PORT] == got[JAX]
    assert got[PORT][:3] == ("info", "drain", [1, 2])


# ---------------------------------------------------------------------------
# whole clusterless runs
# ---------------------------------------------------------------------------

FAST = {"ops": 60, "stagger": 0}
RUNS = {
    "lock": ("lock", FAST, thz.FakeHz, True),
    "owner-lock": ("owner_lock", FAST, thz.FakeHz, True),
    "fenced-lock": ("fenced_lock", FAST, thz.FakeHz, True),
    "fenced-lock-steal": ("fenced_lock", FAST,
                          lambda: thz.FakeHz(broken="steal"), False),
    "reentrant-lock": ("reentrant_lock", FAST, thz.FakeHz, True),
    "semaphore": ("semaphore", FAST, thz.FakeHz, True),
    "semaphore-overfill": ("semaphore", FAST,
                           lambda: thz.FakeHz(broken="overfill"), False),
    "cas-long": ("cas_long", {"ops": 50, "seed": 3}, thz.FakeHz, True),
    "cas-reference": ("cas_reference", {"ops": 50, "seed": 3}, thz.FakeHz,
                      True),
    "id-gen": ("id_gen", {"ops": 50}, thz.FakeHz, True),
    "queue": ("queue", {"ops": 40}, thz.FakeHz, True),
}


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_checked_by_both(run, root):
    workload, opts, fake, valid = RUNS[run]
    run_checked_by_both(root, NAME, workload, opts, "console_factory",
                        console_factory(fake()), valid,
                        nodes=("n1", "n2", "n3"), concurrency=6,
                        stagger=0.0002)


# ---------------------------------------------------------------------------
# builders, command lines, stored runs, phase 28
# ---------------------------------------------------------------------------

OPTS = {"nodes": ["n1", "n2", "n3"], "concurrency": 6,
        "ssh": {"dummy": True}, "time_limit": 1, "seed": 1}


@pytest.mark.parametrize("workload", [None] + list(
    suite(JAX, NAME).WORKLOADS))
def test_builder_shape_equal(workload):
    opts = dict(OPTS, **({"workload": workload} if workload else {}))
    tests = {root: suite(root, NAME).hazelcast_test(device_opts(root, opts))
             for root in ROOTS}
    assert shape(tests[PORT]) == shape(tests[JAX])
    assert getattr(tests[PORT]["client"], "name") == \
        getattr(tests[JAX]["client"], "name")
    assert list(suite(PORT, NAME).WORKLOADS) == \
        list(suite(JAX, NAME).WORKLOADS)


@pytest.mark.parametrize("faults", [None, ["partition"], ["kill"],
                                    ["partition", "kill", "pause"]])
def test_nemesis_packages_alike(faults):
    fs = {}
    for root in ROOTS:
        s = suite(root, NAME)
        pkg = s.nemesis_for(dict(OPTS, faults=faults), s.HzDB())
        fs[root] = (sorted(pkg["nemesis"].fs()),
                    type(pkg["nemesis"]).__name__)
    assert fs[PORT] == fs[JAX]


def test_command_line_options():
    port, jax = help_options(PORT, NAME), help_options(JAX, NAME)
    assert sorted(set(port) - {"--device"}) == sorted(set(jax))
    argv = ["--nodes", "n1,n2", "--time-limit", "3", "--no-ssh",
            "--workload", "fenced-lock", "--rate", "50"]
    got = parsed(PORT, NAME, argv + ["--device", "cpu"])
    want = parsed(JAX, NAME, argv)
    assert got.pop("device") == "cpu"
    assert got == want


@pytest.mark.parametrize("writer", ROOTS)
@pytest.mark.parametrize("run", sorted(small_specs((NAME,))))
def test_stored_run_analysed_by_both(run, writer, tmp_path):
    stored_across(writer, small_specs((NAME,))[run], tmp_path)


def test_phase_28_hazelcast_runs_at_a_small_size(monkeypatch):
    launches = phase_28((NAME,), monkeypatch)
    # the lock's mutex model: one plain wgl_search
    assert launches == {"wgl_search": {"suite-hazelcast-lock": 1},
                        "scc": {}, "bank_reduce": {}}
