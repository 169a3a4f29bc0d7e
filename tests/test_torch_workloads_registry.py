"""The workload registry and the families that reach no kernel, across
packages. Each family runs clusterless on one package's interpreter with
that package's in-memory fixture client, valid and with the fixture's
fault knob set (its twin), and the history it recorded goes through both
packages' checkers (converted through dicts for the other package). The
whole result trees must be equal: ops by their dicts, sets sorted, a
model by its fields. The runs are chip_smoke.py's phase-24 runs at a small
size, so the CPU holds them to the verdicts phase 24 asks of them on the
card.

The pure functions of the families are held on fixed hand-built
histories, the registry to the JAX package's keys in order, and the
causal workload's interleaving (ROADMAP C9) on both packages.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

import chip_smoke as cs
from jepsen_tpu import generator as jgen
from jepsen_tpu import interpreter as jinterp
from jepsen_tpu import testing as jtesting
from jepsen_tpu import util as jutil
from jepsen_tpu import workloads as jworkloads
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.workloads import adya as jadya
from jepsen_tpu.workloads import causal as jcausal
from jepsen_tpu.workloads import causal_reverse as jcausal_reverse
from jepsen_tpu.workloads import dirty_read as jdirty_read
from jepsen_tpu.workloads import kafka as jkafka
from jepsen_tpu.workloads import long_fork as jlong_fork
from jepsen_tpu.workloads import monotonic as jmonotonic
from jepsen_tpu.workloads import multimonotonic as jmultimonotonic
from jepsen_tpu.workloads import pages as jpages
from jepsen_tpu.workloads import queue as jqueue
from jepsen_tpu.workloads import scheduler as jscheduler
from jepsen_tpu.workloads import sequential as jsequential
from jepsen_tpu.workloads import upsert as jupsert
from jepsen_tpu.workloads import version_divergence as jversion_divergence
from jepsen_tpu_torch import generator as pgen
from jepsen_tpu_torch import interpreter as pinterp
from jepsen_tpu_torch import testing as ptesting
from jepsen_tpu_torch import util as putil
from jepsen_tpu_torch import workloads as pworkloads
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.workloads import adya as padya
from jepsen_tpu_torch.workloads import causal as pcausal
from jepsen_tpu_torch.workloads import causal_reverse as pcausal_reverse
from jepsen_tpu_torch.workloads import dirty_read as pdirty_read
from jepsen_tpu_torch.workloads import kafka as pkafka
from jepsen_tpu_torch.workloads import long_fork as plong_fork
from jepsen_tpu_torch.workloads import monotonic as pmonotonic
from jepsen_tpu_torch.workloads import multimonotonic as pmultimonotonic
from jepsen_tpu_torch.workloads import pages as ppages
from jepsen_tpu_torch.workloads import queue as pqueue
from jepsen_tpu_torch.workloads import scheduler as pscheduler
from jepsen_tpu_torch.workloads import sequential as psequential
from jepsen_tpu_torch.workloads import upsert as pupsert
from jepsen_tpu_torch.workloads import version_divergence as \
    pversion_divergence

torch.set_num_threads(1)

JAX = {"gen": jgen, "interp": jinterp, "testing": jtesting, "util": jutil,
       "History": JHistory, "workloads": jworkloads, "queue": jqueue}
PORT = {"gen": pgen, "interp": pinterp, "testing": ptesting, "util": putil,
        "History": PHistory, "workloads": pworkloads, "queue": pqueue}

# the JAX package's modules and the port's, by family
FAMILIES = {
    "adya": (jadya, padya), "causal": (jcausal, pcausal),
    "causal_reverse": (jcausal_reverse, pcausal_reverse),
    "dirty_read": (jdirty_read, pdirty_read), "kafka": (jkafka, pkafka),
    "long_fork": (jlong_fork, plong_fork),
    "monotonic": (jmonotonic, pmonotonic),
    "multimonotonic": (jmultimonotonic, pmultimonotonic),
    "pages": (jpages, ppages), "scheduler": (jscheduler, pscheduler),
    "sequential": (jsequential, psequential),
    "upsert": (jupsert, pupsert),
    "version_divergence": (jversion_divergence, pversion_divergence),
}

# the registry entries this slice ports; the others are held by
# tests/test_torch_workloads.py
NEW_ENTRIES = ("adya-g2", "causal", "causal-reverse", "counter",
               "dirty-read", "kafka", "long-fork", "lost-updates",
               "monotonic", "multimonotonic", "pages", "queue",
               "run-coverage", "sequential", "set", "set-full", "upsert",
               "version-divergence", "unique-ids")
SIZES = {"ops": 60, "kafka_ops": 300}
FIFO = cs._run_spec("queue-fifo", "queue-fifo", {"ops": 60},
                    lambda t: t.QueueClient(), 6)
SPECS = {s["name"]: s for s in cs.registry_runs(SIZES) + [FIFO]
         if s["entry"] in NEW_ENTRIES + ("queue-fifo",)}
CASES = sorted(SPECS)


def workload(pkg, spec: dict) -> dict:
    if spec["entry"] == "queue-fifo":
        return pkg["queue"].fifo_workload(dict(spec["opts"]))
    return pkg["workloads"].REGISTRY[spec["entry"]](
        dict(spec["opts"], device="cpu"))


def run_on(pkg, spec: dict) -> dict:
    """The run on pkg's interpreter with worker threads, against pkg's
    fixture client."""
    w = workload(pkg, spec)
    test = cs.registry_test(spec, w, spec["client"](pkg["testing"]),
                            pkg["testing"], pkg["gen"])
    with pkg["util"].with_relative_time():
        return pkg["interp"].run(test)


def check_both(spec: dict, test: dict) -> tuple[dict, dict]:
    """The recorded history through both packages' checkers, each on its
    own package's ops rebuilt through dicts; the results in plain data."""
    dicts = [o.to_dict() for o in test["history"]]
    out = []
    for pkg in (PORT, JAX):
        hist = pkg["History"](dicts, assign_indices=False)
        t = {k: v for k, v in test.items() if k != "history"}
        out.append(workload(pkg, spec)["checker"].check(t, hist))
    return out[0], out[1]


@pytest.mark.parametrize("name", CASES)
def test_port_run_checked_by_both(name):
    spec = SPECS[name]
    test = run_on(PORT, spec)
    hist = test["history"]
    assert len(hist) == 2 * sum(1 for o in hist if o.type == "invoke")
    port, jax = check_both(spec, test)
    assert cs._norm(port) == cs._norm(jax)
    cs.registry_verdict(spec, port)


@pytest.mark.parametrize("name", CASES)
def test_jax_run_checked_by_both(name):
    spec = SPECS[name]
    test = run_on(JAX, spec)
    port, jax = check_both(spec, test)
    assert cs._norm(port) == cs._norm(jax)
    cs.registry_verdict(spec, jax)


def test_every_new_family_valid_and_twin():
    """Each family this slice ports runs valid, and each fixture with a
    fault knob a twin (counter and long-fork's fixtures have none)."""
    valid = {SPECS[n]["entry"] for n in CASES if not SPECS[n]["twin"]}
    twins = {SPECS[n]["entry"] for n in CASES if SPECS[n]["twin"]}
    assert valid == set(NEW_ENTRIES) | {"queue-fifo"}
    assert twins == set(NEW_ENTRIES) - {"counter", "long-fork"}


def test_registry_keys_in_order():
    """The port's REGISTRY has the JAX package's 28 keys in its order,
    each mapped to the port's constructor of the same name."""
    assert list(pworkloads.REGISTRY) == list(jworkloads.REGISTRY)
    assert len(pworkloads.REGISTRY) == 28
    for name, fn in pworkloads.REGISTRY.items():
        jfn = jworkloads.REGISTRY[name]
        assert fn.__module__.startswith("jepsen_tpu_torch.workloads.")
        assert fn.__module__.split(".")[-1] == jfn.__module__.split(".")[-1]
        assert fn.__name__ == jfn.__name__


def test_registry_entries_build_bundles():
    for name, fn in pworkloads.REGISTRY.items():
        w = fn({"ops": 10, "device": "cpu"})
        assert "generator" in w and "checker" in w, name


def test_phase_24_at_a_small_size():
    """chip_smoke's phase 24 on the CPU: every registry entry, its twins
    and the kafka run at depth, each checked twice; the register and the
    plain lock reach wgl_search once each (the plain kernel here), the
    others no kernel wrapper."""
    got = cs.registry_path(torch.device("cpu"), False,
                           {"ops": 40, "kafka_ops": 200})
    assert got == {"wgl_search": {"registry-register": 1,
                                  "registry-lock": 1},
                   "scc": {}, "bank_reduce": {}}


# ---------------------------------------------------------------------------
# The pure functions on fixed histories
# ---------------------------------------------------------------------------

def _ev(type_, process, f, value, **ext):
    return dict(type=type_, process=process, f=f, value=value, **ext)


def _both(events, fam: str, fn: str, *args, **kw):
    """fn of the family over the same events as each package's history;
    both results in plain data."""
    out = []
    for hist_cls, mod in ((PHistory, FAMILIES[fam][1]),
                          (JHistory, FAMILIES[fam][0])):
        hist = hist_cls([dict(e, time=1_000_000 * i)
                         for i, e in enumerate(events)])
        out.append(cs._norm(getattr(mod, fn)(hist, *args, **kw)))
    return out


def send_ok(p, k, off, val):
    return [_ev("invoke", p, "send", [["send", k, val]]),
            _ev("ok", p, "send", [["send", k, [off, val]]])]


def poll_ok(p, reads):
    return [_ev("invoke", p, "poll", [["poll"]]),
            _ev("ok", p, "poll", [["poll", reads]])]


def assign_ok(p, keys, f="assign", type_="ok"):
    return [_ev("invoke", p, f, keys), _ev(type_, p, f, keys)]


def txn(p, inv, ok, type_="ok"):
    return [_ev("invoke", p, "txn", inv), _ev(type_, p, "txn", ok)]


def _skip(mid=()):
    return (send_ok(0, 0, 0, 1) + send_ok(0, 0, 1, 2) + send_ok(0, 0, 2, 3)
            + assign_ok(1, [0]) + poll_ok(1, {0: [[0, 1]]}) + list(mid)
            + poll_ok(1, {0: [[2, 3]]}) + assign_ok(2, [0])
            + poll_ok(2, {0: [[0, 1], [1, 2], [2, 3]]}))


ASSIGN = {"sub-via": ("assign",)}

# the histories of tests/test_kafka.py, one per anomaly class and policy
KAFKA = {
    "clean": (send_ok(0, 0, 0, 1) + send_ok(0, 0, 1, 2)
              + poll_ok(1, {0: [[0, 1], [1, 2]]}), None),
    "offset-gaps": (send_ok(0, 0, 0, 1) + send_ok(0, 0, 5, 2)
                    + poll_ok(1, {0: [[0, 1], [5, 2]]}), None),
    "inconsistent-offsets": (send_ok(0, 0, 0, 1) + send_ok(1, 0, 0, 2)
                             + poll_ok(2, {0: [[0, 1]]}), None),
    "g1a": ([_ev("invoke", 0, "send", [["send", 0, 9]]),
             _ev("fail", 0, "send", [["send", 0, 9]])]
            + poll_ok(1, {0: [[0, 9]]}), None),
    "lost-write": (send_ok(0, 0, 0, 1) + send_ok(0, 0, 1, 2)
                   + poll_ok(1, {0: [[1, 2]]}), None),
    "unseen": (send_ok(0, 0, 0, 1) + send_ok(0, 0, 1, 2)
               + poll_ok(1, {0: [[0, 1]]}), None),
    "wr-all-reads": (send_ok(3, 0, 1, 30) + [
        _ev("invoke", 1, "txn", [["send", 0, 10], ["poll"]]),
        _ev("invoke", 2, "txn", [["send", 1, 20], ["poll"]]),
        _ev("ok", 1, "txn", [["send", 0, [0, 10]],
                             ["poll", {1: [[0, 20]]}]]),
        _ev("ok", 2, "txn", [["send", 1, [0, 20]],
                             ["poll", {0: [[0, 10], [1, 30]]}]])],
        {"ww-deps": False}),
    "duplicate-offsets": (send_ok(0, 0, 0, 7)
                          + poll_ok(1, {0: [[0, 7], [3, 7]]}), None),
    "duplicate-writes": (send_ok(0, 0, 0, 7) + send_ok(1, 0, 3, 7), None),
    "int-poll-skip": (send_ok(0, 0, 0, 1) + send_ok(0, 0, 1, 2)
                      + send_ok(0, 0, 2, 3)
                      + txn(1, [["poll"], ["poll"]],
                            [["poll", {0: [[0, 1]]}],
                             ["poll", {0: [[2, 3]]}]]), None),
    "int-nonmonotonic-poll": (send_ok(0, 0, 0, 1) + send_ok(0, 0, 1, 2)
                              + txn(1, [["poll"], ["poll"]],
                                    [["poll", {0: [[1, 2]]}],
                                     ["poll", {0: [[0, 1]]}]]), None),
    "nonmonotonic-poll-assign": (send_ok(0, 0, 0, 1) + send_ok(0, 0, 1, 2)
                                 + poll_ok(1, {0: [[1, 2]]})
                                 + poll_ok(1, {0: [[0, 1]]}), ASSIGN),
    "nonmonotonic-poll-subscribe": (
        send_ok(0, 0, 0, 1) + send_ok(0, 0, 1, 2)
        + poll_ok(1, {0: [[1, 2]]}) + poll_ok(1, {0: [[0, 1]]}),
        {"sub-via": ("subscribe",)}),
    "poll-skip-reset-by-subscribe": (
        send_ok(0, 0, 0, 1) + send_ok(0, 0, 1, 2) + send_ok(0, 0, 2, 3)
        + poll_ok(1, {0: [[0, 1]]}) + assign_ok(1, [0], "subscribe")
        + poll_ok(1, {0: [[2, 3]]}), ASSIGN),
    "nonmonotonic-send": (send_ok(0, 0, 5, 1) + send_ok(0, 0, 2, 2)
                          + poll_ok(1, {0: [[2, 2], [5, 1]]}), None),
    "int-send-skip": (
        [_ev("invoke", 0, "send", [["send", 0, 1], ["send", 0, 2]]),
         _ev("ok", 0, "send", [["send", 0, [0, 1]], ["send", 0, [4, 2]]])]
        + send_ok(1, 0, 2, 9) + poll_ok(2, {0: [[0, 1], [2, 9], [4, 2]]}),
        None),
    "wr-cycle-no-ww": ([
        _ev("invoke", 0, "txn", [["send", 0, 1], ["poll"]]),
        _ev("invoke", 1, "txn", [["send", 1, 2], ["poll"]]),
        _ev("ok", 0, "txn", [["send", 0, [0, 1]], ["poll", {1: [[0, 2]]}]]),
        _ev("ok", 1, "txn", [["send", 1, [0, 2]], ["poll", {0: [[0, 1]]}]])],
        {"ww-deps": False}),
    "wr-cycle-ww": ([
        _ev("invoke", 0, "txn", [["send", 0, 1], ["poll"]]),
        _ev("invoke", 1, "txn", [["send", 1, 2], ["poll"]]),
        _ev("ok", 0, "txn", [["send", 0, [0, 1]], ["poll", {1: [[0, 2]]}]]),
        _ev("ok", 1, "txn", [["send", 1, [0, 2]], ["poll", {0: [[0, 1]]}]])],
        {"ww-deps": True}),
    "poll-skip-subscribe": (_skip(), None),
    "poll-skip-assign": (_skip(), ASSIGN),
    "reassign-resets": (_skip(assign_ok(1, [0])), ASSIGN),
    "info-send-offsets": (
        [_ev("invoke", 0, "send", [["send", 0, 5]]),
         _ev("info", 0, "send", [["send", 0, [0, 5]]])]
        + send_ok(1, 0, 0, 9) + poll_ok(2, {0: [[0, 9]]}), None),
    "failed-subscribe": (
        send_ok(0, 0, 0, 1) + send_ok(0, 0, 1, 2) + send_ok(0, 0, 2, 3)
        + poll_ok(1, {0: [[0, 1]]})
        + assign_ok(1, [0], "subscribe", "fail")
        + poll_ok(1, {0: [[2, 3]]}), ASSIGN),
}


@pytest.mark.parametrize("case", sorted(KAFKA))
def test_kafka_check(case):
    events, opts = KAFKA[case]
    port, jax = _both(events, "kafka", "check", opts)
    assert port == jax
    assert port["valid?"] in (True, False)


@pytest.mark.parametrize("case", sorted(KAFKA))
def test_kafka_analysis(case):
    """The version orders, ranks, offsets, unseen messages, errors and
    realtime lag of kafka's Analysis."""
    events, opts = KAFKA[case]
    o = opts or {}
    out = []
    for hist_cls, mod in ((PHistory, pkafka), (JHistory, jkafka)):
        hist = hist_cls([dict(e, time=1_000_000 * i)
                         for i, e in enumerate(events)])
        a = mod.Analysis(hist, ww_deps=o.get("ww-deps", True),
                         sub_via=o.get("sub-via", ("subscribe",)))
        out.append(cs._norm({
            "orders": a.orders, "rank": sorted(a.rank.items()),
            "offset_of": sorted(a.offset_of.items()), "unseen": a.unseen,
            "errors": dict(a.errors), "lag": a.realtime_lag()}))
    assert out[0] == out[1]


class _Gauges:
    def __init__(self):
        self.seen = []

    def probe_gauge(self, name, value):
        self.seen.append((name, value))


@pytest.mark.parametrize("case", ("clean", "unseen", "int-send-skip",
                                  "poll-skip-assign", "info-send-offsets"))
def test_kafka_lag_probe(case):
    """The live lag probe over a history's completions gives the same
    gauges in both packages."""
    events, _opts = KAFKA[case]
    out = []
    for hist_cls, mod in ((PHistory, pkafka), (JHistory, jkafka)):
        hist = hist_cls([dict(e, time=1_000_000 * i)
                         for i, e in enumerate(events)])
        probe, mon = mod.lag_probe(), _Gauges()
        for o in hist:
            probe(o, mon)
        out.append(mon.seen)
    assert out[0] == out[1]
    assert out[0]


JOB = {"name": 0, "start": 100.0, "interval": 50.0, "count": 5,
       "epsilon": 10.0, "duration": 5.0}


@pytest.mark.parametrize("read_time", (50.0, 115.0, 300.0, 10_000.0))
def test_scheduler_job_targets(read_time):
    assert pscheduler.job_targets(read_time, JOB) == \
        jscheduler.job_targets(read_time, JOB)
    assert pscheduler.EPSILON_FORGIVENESS == jscheduler.EPSILON_FORGIVENESS


MATCHES = {
    "all": ([(0.0, 10.0), (20.0, 30.0), (40.0, 50.0)], [5.0, 22.0, 41.0]),
    "one-run-two-targets": ([(0.0, 10.0), (5.0, 15.0)], [7.0]),
    "deadline-order": ([(0.0, 100.0), (0.0, 10.0)], [8.0, 50.0]),
    "late-and-early": ([(10.0, 20.0), (30.0, 40.0)], [5.0, 25.0, 45.0]),
    "none": ([(0.0, 1.0)], []),
}


@pytest.mark.parametrize("case", sorted(MATCHES))
def test_scheduler_match_targets(case):
    targets, starts = MATCHES[case]
    assert pscheduler.match_targets(targets, starts) == \
        jscheduler.match_targets(targets, starts)


def test_scheduler_check_schedule():
    runs = [{"name": 0, "start": 100.5, "end": 105.5},
            {"name": 0, "start": 151.0, "end": None},
            {"name": 0, "start": 250.0, "end": 255.0},
            {"name": 1, "start": 30.0, "end": 31.0},
            {"name": 7, "start": 1.0, "end": 2.0}]
    jobs = [JOB, dict(JOB, name=1, start=30.0, count=2)]
    p = pscheduler.check_schedule(400.0, jobs, runs)
    j = jscheduler.check_schedule(400.0, jobs, runs)
    assert cs._norm(p) == cs._norm(j)
    assert p["valid?"] is False and p["unknown-job-runs"]


PAGES_IDX = {1: frozenset({1, 2}), 2: frozenset({1, 2}), 3: frozenset({3}),
             4: frozenset({4, 5, 6}), 5: frozenset({4, 5, 6}),
             6: frozenset({4, 5, 6})}


@pytest.mark.parametrize("read", ({1, 2, 3}, {1, 3}, {4, 5}, {2, 3, 4, 5, 6},
                                  set(), {9}))
def test_pages_read_errs(read):
    assert ppages.read_errs(PAGES_IDX, read) == \
        jpages.read_errs(PAGES_IDX, read)


def test_pages_check():
    events = [_ev("invoke", 0, "add", [1, 2]), _ev("ok", 0, "add", [1, 2]),
              _ev("invoke", 1, "add", [3, 4]), _ev("fail", 1, "add", [3, 4]),
              _ev("invoke", 2, "read", None), _ev("ok", 2, "read", [1]),
              _ev("invoke", 2, "read", None), _ev("ok", 2, "read", [1, 1]),
              _ev("invoke", 2, "read", None), _ev("ok", 2, "read", [2, 1])]
    port, jax = _both(events, "pages", "check_pages")
    assert port == jax and port["error-count"] == 2


def _row(val, sts, proc=0, node=0, tb=0):
    return {"val": val, "sts": sts, "node": node, "process": proc, "tb": tb}


def _mono(adds, read, fails=()):
    evs = []
    for r in adds:
        evs += [_ev("invoke", r["process"], "add", None),
                _ev("ok", r["process"], "add", r)]
    for r in fails:
        evs += [_ev("invoke", 9, "add", None), _ev("fail", 9, "add", r)]
    if read is not None:
        evs += [_ev("invoke", 5, "read", None), _ev("ok", 5, "read", read)]
    return evs


_R = [_row(1, 1), _row(2, 2, 1), _row(3, 3, 0, 1, 1), _row(4, 4, 1, 1)]
MONOTONIC = {
    "valid": _mono(_R, _R),
    "ts-tie": _mono(_R, [_row(1, 1), _row(2, 1, 1)] + _R[2:]),
    "value-reorder": _mono(_R, [_R[1], _R[0]] + _R[2:]),
    "duplicate": _mono(_R, _R + [_row(4, 5, 1)]),
    "lost": _mono(_R, _R[:3]),
    "revived": _mono(_R, _R + [_row(9, 9)], fails=[_row(9, 9)]),
    "sts-backwards": _mono(_R, [_R[0], _row(2, 0, 1)] + _R[2:]),
    "never-read": _mono(_R, None),
}


@pytest.mark.parametrize("global_", (True, False))
@pytest.mark.parametrize("case", sorted(MONOTONIC))
def test_monotonic_check(case, global_):
    port, jax = _both(MONOTONIC[case], "monotonic", "check_monotonic",
                      global_=global_)
    assert port == jax


def _read(i, ts, regs, proc=0):
    return [_ev("invoke", proc, "read", None),
            _ev("ok", proc, "read", {"ts": ts, "registers": regs})]


MULTIMONOTONIC = {
    "skew": _read(0, 1, {"x": 1, "y": 0}) + _read(1, 2, {"x": 0, "y": 1}),
    "compatible": _read(0, 1, {"x": 0, "y": 0})
    + _read(1, 2, {"x": 1, "y": 1}),
    "backwards": _read(0, 1, {"x": 2}) + _read(1, 2, {"x": 1, "y": 3})
    + _read(2, 3, {"y": 2}),
    "three-way": _read(0, 3, {"a": 1, "b": 0, "c": 0})
    + _read(1, 1, {"a": 0, "b": 1, "c": 0})
    + _read(2, 2, {"a": 0, "b": 0, "c": 1}),
}


@pytest.mark.parametrize("case", sorted(MULTIMONOTONIC))
@pytest.mark.parametrize("fn", ("check_ts_order", "check_read_skew"))
def test_multimonotonic_checks(fn, case):
    port, jax = _both(MULTIMONOTONIC[case], "multimonotonic", fn)
    assert port == jax


def _seq(*reads):
    evs = []
    for k, obs in reads:
        evs += [_ev("invoke", 0, "read", k), _ev("ok", 0, "read", (k, obs))]
    return evs


SEQUENTIAL = {
    "valid": _seq((1, ["1_2", "1_1", "1_0"]), (2, [None, None, None]),
                  (3, [None, "3_1", "3_0"])),
    "trailing-none": _seq((1, ["1_2", None, "1_0"]), (2, ["2_1", None])),
    "lists": [_ev("invoke", 0, "read", 4),
              _ev("ok", 0, "read", [4, ["4_1", None]])],
    "no-reads": [_ev("invoke", 0, "write", 1), _ev("ok", 0, "write", 1)],
}


@pytest.mark.parametrize("case", sorted(SEQUENTIAL))
def test_sequential_check(case):
    port, jax = _both(SEQUENTIAL[case], "sequential", "check_sequential")
    assert port == jax


def _dirty(writes, reads, strongs):
    evs = []
    for v in writes:
        evs += [_ev("invoke", 0, "write", v), _ev("ok", 0, "write", v)]
    for v in reads:
        evs += [_ev("invoke", 1, "read", v), _ev("ok", 1, "read", v)]
    for i, s in enumerate(strongs):
        evs += [_ev("invoke", 2 + i, "strong-read", None),
                _ev("ok", 2 + i, "strong-read", s)]
    return evs


DIRTY = {
    "valid": _dirty([1, 2, 3], [1, 2], [[1, 2, 3], [1, 2, 3]]),
    "dirty": _dirty([1, 2], [1, 7], [[1, 2], [1, 2]]),
    "lost": _dirty([1, 2, 3], [1], [[1, 2], [1, 2]]),
    "disagree": _dirty([1, 2], [], [[1, 2], [1]]),
    "no-strong-reads": _dirty([1], [1], []),
}


@pytest.mark.parametrize("case", sorted(DIRTY))
def test_dirty_read_check(case):
    port, jax = _both(DIRTY[case], "dirty_read", "check_dirty_read")
    assert port == jax


UPSERT = {
    "one": [_ev("ok", 0, "upsert", 7), _ev("ok", 1, "read", [7])],
    "two-upserts": [_ev("ok", 0, "upsert", 7), _ev("ok", 1, "upsert", 8),
                    _ev("ok", 2, "read", [7, 8])],
    "bad-read": [_ev("ok", 0, "upsert", 7), _ev("fail", 1, "upsert", None),
                 _ev("ok", 2, "read", [7, 9])],
    "none": [_ev("fail", 0, "upsert", None), _ev("ok", 1, "read", [])],
}


@pytest.mark.parametrize("case", sorted(UPSERT))
def test_upsert_check(case):
    port, jax = _both(UPSERT[case], "upsert", "check_upsert")
    assert port == jax


VERSIONS = {
    "divergent": [_ev("ok", 0, "read", {"value": 1, "version": 3}),
                  _ev("ok", 1, "read", {"value": 2, "version": 3})],
    "agree": [_ev("ok", 0, "read", {"value": 1, "version": 3}),
              _ev("ok", 1, "read", {"value": 1, "version": 3}),
              _ev("ok", 1, "read", {"value": 2, "version": 4}),
              _ev("ok", 1, "read", None)],
}


@pytest.mark.parametrize("case", sorted(VERSIONS))
def test_version_divergence_check(case):
    port, jax = _both(VERSIONS[case], "version_divergence",
                      "check_multiversion")
    assert port == jax


def _causal(*events):
    return [_ev(t, 0, f, v, position=p, link=lk) for t, f, v, p, lk in events]


CAUSAL = {
    "valid": _causal(("ok", "read-init", 0, 1, "init"),
                     ("ok", "write", 1, 2, 1), ("ok", "read", 1, 3, 2),
                     ("ok", "write", 2, 4, 3), ("ok", "read", 2, 5, 4)),
    "broken-link": _causal(("ok", "read-init", 0, 1, "init"),
                           ("ok", "write", 1, 2, 99)),
    "write-skips-counter": _causal(("ok", "read-init", 0, 1, "init"),
                                   ("ok", "write", 2, 2, 1)),
    "stale-read": _causal(("ok", "read-init", 0, 1, "init"),
                          ("ok", "write", 1, 2, 1), ("ok", "read", 0, 3, 2)),
    "read-init-nonzero": _causal(("ok", "read-init", 7, 1, "init")),
}


def _checker_case(events, fam: str, ctor: str):
    """The family's checker over the same events as each package's
    history; both results in plain data."""
    out = []
    for hist_cls, mod in ((PHistory, FAMILIES[fam][1]),
                          (JHistory, FAMILIES[fam][0])):
        res = getattr(mod, ctor)().check({}, hist_cls(events), {})
        out.append(cs._norm(res))
    return out


@pytest.mark.parametrize("case", sorted(CAUSAL))
def test_causal_check(case):
    port, jax = _checker_case(CAUSAL[case], "causal", "check")
    assert port == jax
    assert port["valid?"] is (case == "valid")


def _w(*events):
    return [_ev(t, p, f, v) for t, p, f, v in events]


CAUSAL_REVERSE = {
    "valid": _w(("invoke", 0, "write", 1), ("ok", 0, "write", 1),
                ("invoke", 1, "write", 2), ("ok", 1, "write", 2),
                ("invoke", 2, "read", None), ("ok", 2, "read", [1, 2])),
    "t2-without-t1": _w(("invoke", 0, "write", 1), ("ok", 0, "write", 1),
                        ("invoke", 1, "write", 2), ("ok", 1, "write", 2),
                        ("invoke", 2, "read", None), ("ok", 2, "read", [2])),
    "concurrent": _w(("invoke", 0, "write", 1), ("invoke", 1, "write", 2),
                     ("ok", 0, "write", 1), ("ok", 1, "write", 2),
                     ("invoke", 2, "read", None), ("ok", 2, "read", [2])),
}


@pytest.mark.parametrize("case", sorted(CAUSAL_REVERSE))
def test_causal_reverse_check(case):
    port, jax = _checker_case(CAUSAL_REVERSE[case], "causal_reverse",
                              "checker")
    assert port == jax


ADYA = {
    "two-inserts": _w(("invoke", 0, "insert", (1, [None, 1])),
                      ("ok", 0, "insert", (1, [None, 1])),
                      ("invoke", 1, "insert", (1, [2, None])),
                      ("ok", 1, "insert", (1, [2, None]))),
    "one-insert": _w(("invoke", 0, "insert", (1, [None, 1])),
                     ("ok", 0, "insert", (1, [None, 1])),
                     ("invoke", 1, "insert", (1, [2, None])),
                     ("fail", 1, "insert", (1, [2, None]))),
}


@pytest.mark.parametrize("case", sorted(ADYA))
def test_adya_g2_checker(case):
    port, jax = _checker_case(ADYA[case], "adya", "g2_checker")
    assert port == jax


LONG_FORK = {
    "fork": _w(("ok", 0, "txn", [["w", 0, 1]]), ("ok", 1, "txn", [["w", 1, 1]]),
               ("ok", 2, "txn", [["r", 0, 1], ["r", 1, None]]),
               ("ok", 3, "txn", [["r", 0, None], ["r", 1, 1]])),
    "ordered": _w(("ok", 0, "txn", [["w", 0, 1]]),
                  ("ok", 2, "txn", [["r", 0, 1], ["r", 1, None]]),
                  ("ok", 3, "txn", [["r", 0, 1], ["r", 1, 1]])),
}


@pytest.mark.parametrize("case", sorted(LONG_FORK))
def test_long_fork_checker(case):
    port, jax = _checker_case(LONG_FORK[case], "long_fork", "checker")
    assert port == jax
    assert port["valid?"] is (case == "ordered")


# ---------------------------------------------------------------------------
# The causal workload's interleaving (ROADMAP C9)
# ---------------------------------------------------------------------------

# key 1's chain as one run recorded it with the write of 1 stalled 0.1 s
# on its thread (process 0): the other thread read 0, wrote 2 and read 2
# before the write of 1 was applied
STALLED = [
    ("invoke", 0, "read-init", (1, None), None, None),
    ("ok", 0, "read-init", (1, 0), 6, "init"),
    ("invoke", 0, "write", (1, 1), None, None),
    ("invoke", 1, "read", (1, None), None, None),
    ("ok", 1, "read", (1, 0), 7, 6),
    ("invoke", 1, "write", (1, 2), None, None),
    ("ok", 1, "write", (1, 2), 8, 7),
    ("invoke", 1, "read", (1, None), None, None),
    ("ok", 1, "read", (1, 2), 9, 8),
    ("ok", 0, "write", (1, 1), 13, 9),
]
STALL_ERROR = {1: "expected value 1 attempting to write 2 instead"}


def test_causal_stalled_interleaving_checked_alike():
    """The recorded interleaving is invalid in both packages, with the
    same error: the checker folds the chain in completion order."""
    events = [_ev(t, p, f, v, position=pos, link=lk)
              for t, p, f, v, pos, lk in STALLED]
    out = []
    for hist_cls, mod in ((PHistory, pcausal), (JHistory, jcausal)):
        res = mod.workload({"keys": [1]})["checker"].check(
            {}, hist_cls(events), {})
        out.append(cs._norm(res))
        assert res["valid?"] is False
        assert {k: r["error"] for k, r in res["results"].items()} == \
            STALL_ERROR
    assert out[0] == out[1]


def _stalled_client(pkg, stall_s: float):
    """pkg's CausalClient whose first write of 1 to key 1 waits stall_s
    before it reaches the register."""
    done = threading.Event()

    class Stalled(pkg["testing"].CausalClient):
        def open(self, test, node):
            c = Stalled(self.state, self.lose_write)
            return c

        def invoke(self, test, o):
            if o.f == "write" and tuple(o.value) == (1, 1) \
                    and not done.is_set():
                done.set()
                time.sleep(stall_s)
            return super().invoke(test, o)

    return Stalled()


@pytest.mark.parametrize("pkg", ("port", "jax"))
def test_causal_valid_client_stalled_is_invalid(pkg):
    """A correct in-memory register, one thread stalled past two stagger
    intervals: both packages' workloads record a chain the checker
    rejects (the interleaving, not the client, decides the verdict)."""
    p = PORT if pkg == "port" else JAX
    spec = SPECS["causal-twin"]
    w = p["workloads"].REGISTRY["causal"]({"keys": [0, 1, 2]})
    test = cs.registry_test(dict(spec, stagger=None), w,
                            _stalled_client(p, 0.3), p["testing"], p["gen"])
    with p["util"].with_relative_time():
        test = p["interp"].run(test)
    port, jax = check_both(dict(spec, entry="causal", opts={}), test)
    assert cs._norm(port) == cs._norm(jax)
    assert port["valid?"] is False
    assert port["results"][1]["error"] == STALL_ERROR[1]
