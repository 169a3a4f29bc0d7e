"""The port's latency, rate, monitor and clock plots (reports/perf.py,
reports/clock.py, checker.perf and checker.clock_plot) against the JAX
package's on the CPU.

Counterparts of the plot and clock tests of tests/test_reports.py
(test_bucketing .. test_perf_checker_writes_artifacts,
test_bank_balance_plot_skips_without_reads .. test_perf_checker_skips_
without_store, test_clock_datasets .. test_clock_plot_empty_history_ok).
Each runs both packages on the same inputs: the data helpers' values, the
returned dicts and the file names must be equal (paths compared with
each run's store directory replaced), and every PNG must be drawn. The
PNG bytes are not compared: they are matplotlib's rendering, not the
packages'."""

from __future__ import annotations

import importlib
import json
import os
import random

import pytest

ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def sec(s):
    return int(s * 1e9)


def register_history(root):
    """tests/test_reports.py's history: 20 reads on 3 processes with ok,
    fail and info completions, and a nemesis interval."""
    h = mod(root, "history")
    events = []
    i = 0
    for t in range(20):
        events.append(h.op(index=i, time=sec(t) + 1, type="invoke",
                           process=t % 3, f="read", value=None))
        typ = ["ok", "ok", "ok", "fail", "info"][t % 5]
        events.append(h.op(index=i + 1, time=sec(t) + int(2e8), type=typ,
                           process=t % 3, f="read", value=1))
        i += 2
    events.append(h.op(index=i, time=sec(5), type="info",
                       process="nemesis", f="start", value=None))
    events.append(h.op(index=i + 1, time=sec(12), type="info",
                       process="nemesis", f="stop", value=None))
    events.sort(key=lambda o: o.time)
    return h.History(events, assign_indices=False)


def seeded_history(root, seed, n=300):
    """Reads and writes of four fs on six processes with seeded latencies
    and completion types, and two nemesis windows (the second open)."""
    h = mod(root, "history")
    rng = random.Random(seed)
    events = []
    t = 0
    for i in range(n):
        t += rng.randrange(1, 50_000_000)
        f = rng.choice(["read", "write", "cas", "append"])
        p = i % 6
        events.append(h.op(time=t, type="invoke", process=p, f=f,
                           value=None))
        typ = rng.choice(["ok", "ok", "ok", "fail", "info"])
        events.append(h.op(time=t + rng.randrange(1, 400_000_000),
                           type=typ, process=p, f=f, value=i))
    for a, b, f in ((sec(1), sec(3), "start"), (sec(6), None, "start")):
        events.append(h.op(time=a, type="info", process="nemesis", f=f,
                           value=None))
        if b is not None:
            events.append(h.op(time=b, type="info", process="nemesis",
                               f="stop", value=None))
    events.sort(key=lambda o: o.time)
    # client completions pair with the invocation of their process in
    # time order: keep one op in flight a process
    out, busy = [], {}
    for o in events:
        if o.process == "nemesis":
            out.append(o)
        elif o.type == "invoke":
            if busy.get(o.process):
                continue
            busy[o.process] = o
            out.append(o)
        elif busy.get(o.process) is not None and busy[
                o.process].f == o.f and o.time > busy[o.process].time:
            busy[o.process] = None
            out.append(o)
    return h.History(out)


def norm(x, d=None):
    """Ops as to_dict(), tuples as lists, and the store directory `d`
    in every path replaced by '<store>'."""
    if isinstance(x, dict):
        return {str(k): norm(v, d) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v, d) for v in x]
    if hasattr(x, "to_dict"):
        return norm(x.to_dict(), d)
    if isinstance(x, str) and d is not None:
        return x.replace(str(d), "<store>")
    return x


# ---------------------------------------------------------------------------
# the data helpers
# ---------------------------------------------------------------------------

def test_bucketing():
    for root in ROOTS:
        p = mod(root, "reports.perf")
        assert p.bucket_time(10, 3) == 5.0
        assert p.bucket_time(10, 17) == 15.0
        got = p.bucket_points(10, [[1, "a"], [2, "b"], [11, "c"]])
        assert got == {5.0: [[1, "a"], [2, "b"]], 15.0: [[11, "c"]]}
    rng = random.Random(3)
    pts = [[rng.uniform(0, 100), rng.random()] for _ in range(500)]
    want, got = (mod(r, "reports.perf") for r in ROOTS)
    for dt in (1.0, 2.5, 10.0):
        assert got.bucket_points(dt, pts) == want.bucket_points(dt, pts)
        for b in range(12):
            assert got.bucket_scale(dt, b) == want.bucket_scale(dt, b)


def test_quantiles():
    want, got = (mod(r, "reports.perf") for r in ROOTS)
    assert got.quantiles([0.5, 1.0], [5, 1, 3, 2, 4]) == {0.5: 3, 1.0: 5}
    assert got.quantiles([0.5], []) == {}
    rng = random.Random(5)
    for n in (1, 2, 7, 100, 1001):
        vals = [rng.random() for _ in range(n)]
        assert (got.quantiles(got.QUANTILES, vals)
                == want.quantiles(want.QUANTILES, vals))


def test_latencies_to_quantiles():
    want, got = (mod(r, "reports.perf") for r in ROOTS)
    pts = [[t, float(t)] for t in range(20)]
    q = got.latencies_to_quantiles(10, [1.0], pts)
    assert q[1.0] == [[5.0, 9.0], [15.0, 19.0]]
    rng = random.Random(9)
    pts = [[rng.uniform(0, 60), rng.uniform(0, 900)] for _ in range(700)]
    assert (got.latencies_to_quantiles(7.5, got.QUANTILES, pts)
            == want.latencies_to_quantiles(7.5, want.QUANTILES, pts))
    with pytest.raises(AssertionError):
        got.latencies_to_quantiles(10, [1.5], pts)


@pytest.mark.parametrize("seed", [None, 1, 2])
def test_invokes_by_f_type(seed):
    by = {}
    for root in ROOTS:
        h = (register_history(root) if seed is None
             else seeded_history(root, seed))
        p = mod(root, "reports.perf")
        by[root] = p.invokes_by_f_type(h)
        pairs = [pr for ts in by[root].values() for prs in ts.values()
                 for pr in prs]
        by[root + "-points"] = p._latency_points(pairs)
    assert norm(by["jepsen_tpu_torch"]) == norm(by["jepsen_tpu"])
    assert by["jepsen_tpu_torch-points"] == by["jepsen_tpu-points"]
    if seed is None:
        got = by["jepsen_tpu_torch"]
        assert set(got) == {"read"}
        assert sum(len(v) for v in got["read"].values()) == 20
        assert len(got["read"]["fail"]) == 4
        assert len(got["read"]["info"]) == 4


def test_nemesis_specs_read_tuples_dicts_and_stored_lists():
    specs = {"nemeses": [("kill", ["kill"], ["start"], "#E9A4A0"),
                         ("pause", ["pause"], ["resume"]),
                         {"name": "clock", "start": {"bump"},
                          "stop": {"reset"}, "fs": {"strobe"}}]}
    got = mod("jepsen_tpu_torch", "reports.perf")._nemesis_specs(
        {"plot": specs})
    want = mod("jepsen_tpu", "reports.perf")._nemesis_specs(
        {"plot": specs})
    assert got == want
    # a stored test.json gives the tuples back as lists (ROADMAP C7)
    stored = json.loads(json.dumps({"nemeses": [
        list(s) if isinstance(s, tuple) else s for s in specs["nemeses"][
            :2]]}))
    assert mod("jepsen_tpu_torch", "reports.perf")._nemesis_specs(
        {"plot": stored}) == want[:2]


# ---------------------------------------------------------------------------
# the graph checkers
# ---------------------------------------------------------------------------

def _perf_test(d, name="perf-test"):
    return {"name": name, "store_dir": str(d), "nodes": ["n1"],
            "plot": {"nemeses": [{"name": "nemesis",
                                  "start": {"start"}, "stop": {"stop"},
                                  "color": "#E9DCA0"}]}}


def _timeseries(d, seed=4):
    """A live-monitor series as monitor.py streams it."""
    rng = random.Random(seed)
    with open(os.path.join(d, "timeseries.jsonl"), "w") as f:
        for i in range(12):
            p = {"t": sec(i * 0.5), "ops_s": rng.uniform(50, 500),
                 "inflight": {str(j): 1 for j in range(rng.randrange(6))}}
            if i == 5:
                p.pop("ops_s")
            f.write(json.dumps(p) + "\n")


@pytest.mark.parametrize("seed", [None, 7])
def test_perf_checker_writes_artifacts(tmp_path, seed):
    res = {}
    for root in ROOTS:
        d = tmp_path / root
        d.mkdir()
        _timeseries(d)
        h = (register_history(root) if seed is None
             else seeded_history(root, seed))
        chk = mod(root, "checker")
        r = chk.check_safe(chk.perf(), _perf_test(d), h)
        assert r["valid?"] is True, r
        files = (r["latency-graph"]["files"] + r["rate-graph"]["files"]
                 + r["monitor-graph"]["files"])
        assert {f.split("/")[-1] for f in files} == {
            "latency-raw.png", "latency-quantiles.png", "rate.png",
            "monitor.png"}
        for f in files:
            assert os.path.getsize(f) > 1000
        res[root] = norm(r, d)
    assert res["jepsen_tpu_torch"] == res["jepsen_tpu"]


@pytest.mark.parametrize("fn", ["point_graph", "quantile_graph",
                                "rate_preview", "monitor_preview"])
def test_graph_functions_return_equal_dicts(tmp_path, fn):
    res = {}
    for root in ROOTS:
        d = tmp_path / root
        d.mkdir()
        _timeseries(d, seed=11)
        r = getattr(mod(root, "reports.perf"), fn)(
            _perf_test(d, "graphs"), seeded_history(root, 3),
            {"dt": 2.0, "subdirectory": "plots"})
        assert os.path.getsize(r["file"]) > 1000
        assert os.path.dirname(r["file"]).endswith("plots")
        res[root] = norm(r, d)
    assert res["jepsen_tpu_torch"] == res["jepsen_tpu"]


def test_bank_balance_plot_skips_without_reads(tmp_path):
    for root in ROOTS:
        chk = mod(root, "checker")
        test = {"name": "bank-plot-empty", "store_dir": str(tmp_path)}
        res = chk.check_safe(mod(root, "reports.perf").balance_graph(),
                             test, mod(root, "history").History([]))
        assert res["valid?"] is True and res["files"] == []


def test_perf_checker_skips_without_store():
    res = {}
    for root in ROOTS:
        chk = mod(root, "checker")
        res[root] = chk.check_safe(chk.perf(), {"nodes": []},
                                   register_history(root))
        assert res[root]["valid?"] is True
        assert res[root]["latency-graph"]["skipped"]
    assert res["jepsen_tpu_torch"] == res["jepsen_tpu"]


def test_perf_checker_without_matplotlib_is_unknown(tmp_path, monkeypatch):
    """On a machine without matplotlib (the card machine) each graph
    raises ImportError and check_safe reports it as "unknown", in both
    packages alike."""
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    res = {}
    for root in ROOTS:
        d = tmp_path / root
        d.mkdir()
        chk = mod(root, "checker")
        res[root] = chk.check_safe(chk.perf(), _perf_test(d),
                                   register_history(root))
        assert res[root]["valid?"] == "unknown"
        for k in ("latency-graph", "rate-graph"):
            assert res[root][k]["valid?"] == "unknown"
            assert "ImportError" in res[root][k]["error"]
        assert not list(d.iterdir())
        # the error is a traceback: its last line names the ImportError
        for k in ("latency-graph", "rate-graph"):
            res[root][k]["error"] = res[root][k]["error"].strip(
            ).splitlines()[-1]
    assert norm(res["jepsen_tpu_torch"]) == norm(res["jepsen_tpu"])


# ---------------------------------------------------------------------------
# the clock plot
# ---------------------------------------------------------------------------

def clock_history(root):
    h = mod(root, "history")
    return h.History([
        h.op(index=0, time=sec(1), type="info", process="nemesis",
             f="check-offsets", value=None,
             **{"clock-offsets": {"n1": 0.5, "n2": -0.25}}),
        h.op(index=1, time=sec(3), type="info", process="nemesis",
             f="bump", value=None, **{"clock-offsets": {"n1": 2.0}}),
        h.op(index=2, time=sec(4), type="ok", process=0, f="read",
             value=1),
    ], assign_indices=False)


def test_clock_datasets():
    got = {r: mod(r, "reports.clock").history_to_datasets(clock_history(r))
           for r in ROOTS}
    assert got["jepsen_tpu_torch"] == got["jepsen_tpu"]
    ds = got["jepsen_tpu_torch"]
    assert ds["n1"] == [[1.0, 0.5], [3.0, 2.0], [4.0, 2.0]]
    assert ds["n2"] == [[1.0, -0.25], [4.0, -0.25]]
    empty = mod("jepsen_tpu_torch", "history").History([])
    assert mod("jepsen_tpu_torch", "reports.clock").history_to_datasets(
        empty) == {}


@pytest.mark.parametrize("nodes", [
    ["n1.cluster.local", "n2.cluster.local"], ["a", "b"],
    ["x.a.b", "y.a.c"], ["solo.example.com"], [],
    ["n1.dc1.example", "n2.dc2.example", "n3.dc1.example"]])
def test_short_node_names(nodes):
    got = mod("jepsen_tpu_torch", "reports.clock").short_node_names(nodes)
    assert got == mod("jepsen_tpu", "reports.clock").short_node_names(nodes)
    if nodes == ["n1.cluster.local", "n2.cluster.local"]:
        assert got == ["n1", "n2"]


def _probe_records(d):
    """A nodes.jsonl with clock offsets for n1 and n3 (the probe's
    series merged into the check-offsets datasets)."""
    recs = []
    for i in range(6):
        for node, off in (("n1", 0.1 * i), ("n3", -0.05 * i)):
            recs.append({"schema": 1, "kind": "sample", "node": node,
                         "t": sec(0.5 + i), "clock_offset_s": off})
    with open(os.path.join(d, "nodes.jsonl"), "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


@pytest.mark.parametrize("probe", [False, True])
def test_clock_plot_writes(tmp_path, probe):
    res = {}
    merged = {}
    for root in ROOTS:
        d = tmp_path / root
        d.mkdir()
        if probe:
            _probe_records(d)
        test = {"name": "clock", "store_dir": str(d)}
        h = mod(root, "history")
        hist = h.History([
            h.op(index=0, time=sec(1), type="info", process="nemesis",
                 f="check-offsets", value=None,
                 **{"clock-offsets": {"n1": 0.0, "n2": 0.1}}),
            h.op(index=1, time=sec(5), type="info", process="nemesis",
                 f="bump", value=None, **{"clock-offsets": {"n1": 8.0}}),
        ], assign_indices=False)
        clock = mod(root, "reports.clock")
        merged[root] = clock.merge_nodeprobe(
            clock.history_to_datasets(hist), test)
        chk = mod(root, "checker")
        r = chk.check_safe(chk.clock_plot(), test, hist)
        assert r["valid?"] is True
        assert (d / "clock-skew.png").stat().st_size > 1000
        res[root] = norm(r, d)
    assert res["jepsen_tpu_torch"] == res["jepsen_tpu"]
    assert merged["jepsen_tpu_torch"] == merged["jepsen_tpu"]
    assert ("n3" in merged["jepsen_tpu_torch"]) is probe


def test_clock_plot_empty_history_ok(tmp_path):
    res = {}
    for root in ROOTS:
        test = {"name": "clock", "store_dir": str(tmp_path)}
        chk = mod(root, "checker")
        res[root] = chk.check_safe(chk.clock_plot(), test,
                                   mod(root, "history").History([]))
        assert res[root]["valid?"] is True
        # without a store directory the plot is skipped
        assert chk.check_safe(chk.clock_plot(), {},
                              mod(root, "history").History([]))[
            "skipped"] == "no store directory"
    assert res["jepsen_tpu_torch"] == res["jepsen_tpu"]
