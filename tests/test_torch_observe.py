"""The port's observability modules against the JAX package's:
telemetry.py (the recorder, save, metrics.json, read_events,
validate_metrics), monitor.py (LogHistogram, the Monitor and its
timeseries.jsonl), watchdog.py (its adapters), coverage.py (the
recorder half: taxonomy, folding, anomaly outcomes, records, atlas) and
nodeprobe.py (the recorder half: parsers, NodeProbe, validation, the
clock-skew series and bound, stamping, the synthetic responder), as in
tests/test_telemetry.py, test_monitor.py, test_coverage.py and
test_nodeprobe.py.

Every scenario runs with each package's modules on the same inputs and
must give the same result; each package reads the other's telemetry.jsonl,
metrics.json, timeseries.jsonl, nodes.jsonl, coverage.json and atlas.
Values that read a clock (span and sample times, offsets the synthetic
nodes report against the control machine's clock, record timestamps)
are left out of a comparison, by name; everything else is exact.
"""

from __future__ import annotations

import importlib
import json
import random
import threading

import numpy as np
import pytest

ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")
PAIRS = [(w, r) for w in ROOTS for r in ROOTS]
LOG = "/var/log/db.log"


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def both(scenario):
    out = []
    for root in ROOTS:
        random.seed(99)
        out.append(scenario(root))
    assert out[0] == out[1]
    return out[1]


def Op(root, **kw):
    return mod(root, "history").Op(**kw)


# ---------------------------------------------------------------------------
# telemetry.py
# ---------------------------------------------------------------------------

def test_span_nesting_counters_and_metrics():
    def scen(root):
        t = mod(root, "telemetry").Telemetry()
        ready = threading.Barrier(3)

        def worker(i):
            with t.span(f"w{i}"):
                with t.span(f"w{i}-child", i=i):
                    ready.wait(timeout=5)
                    t.count("hits")
                    t.count("bytes", 3)

        with t.span("main"):
            with t.span("inner"):
                pass
            ths = [threading.Thread(target=worker, args=(i,))
                   for i in range(2)]
            for th in ths:
                th.start()
            ready.wait(timeout=5)
            for th in ths:
                th.join()
        t.gauge("occupancy", 0.5)
        t.gauge("occupancy", 0.75)
        t.gauge_max("largest", 50)
        t.gauge_max("largest", 2)
        by_id = {e["id"]: e["name"] for e in t.events()}
        shape = {e["name"]: (by_id.get(e["parent"]), e.get("attrs"))
                 for e in t.events()}
        m = t.metrics()
        counts = {n: a["count"] for n, a in m["spans"].items()}
        return shape, counts, m["counters"], m["gauges"], \
            sorted(t.summary()["phases"])

    shape, counts, counters, gauges, phases = both(scen)
    assert shape["inner"] == ("main", None)
    assert shape["w1-child"] == ("w1", {"i": 1}) and shape["w1"][0] is None
    assert counters == {"hits": 2, "bytes": 6}
    assert gauges == {"occupancy": 0.75, "largest": 50}


def test_disabled_epoch_timed_and_record_span():
    def scen(root):
        tel = mod(root, "telemetry")
        off = tel.Telemetry(enabled=False)
        with off.span("x"):
            off.count("c")
        t = tel.Telemetry()
        e0 = t.epoch
        t.count("n")
        t.reset()
        with t.span("stale"):
            t.reset()

        @t.timed("f")
        def f(x):
            return x + 1

        f(1)
        kept = t.record_span("dev", 5, 9, {"rows": 3}, epoch=t.epoch)
        dropped = t.record_span("dev", 5, 9, epoch=t.epoch - 1)
        return (off.events(), off.counters(), t.epoch - e0,
                [(e["name"], e.get("attrs")) for e in t.events()],
                kept["t1"] - kept["t0"], dropped, t.open_spans())

    got = both(scen)
    assert got[2] == 2 and got[3] == [("f", None), ("dev", {"rows": 3})]


def test_port_keeps_spans_as_events():
    from jepsen_tpu_torch import telemetry

    t = telemetry.Telemetry()
    with t.span("a"):
        pass
    assert t.spans() == t.events() and t.spans()[0]["name"] == "a"


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_telemetry_artifacts_read_across(tmp_path, writer, reader):
    tw, tr = mod(writer, "telemetry"), mod(reader, "telemetry")
    t = tw.Telemetry()
    with t.span("run", test="x"):
        with t.span("case"):
            t.count("interpreter.dispatched", 4)
    t.gauge("wgl.batch.occupancy", 0.5)
    trace, metrics = t.save(tmp_path)
    assert (trace.name, metrics.name) == (tr.TRACE_FILE, tr.METRICS_FILE)
    events = list(tr.read_events(trace))
    assert [e["name"] for e in events] == ["case", "run"]
    assert events == t.events()
    m = tr.read_metrics(metrics)
    assert m == json.loads(json.dumps(t.metrics()))
    assert tr.validate_metrics(m) == 4
    with open(trace, "a") as f:
        f.write('{"name": "torn')
    assert len(list(tr.read_events(trace))) == 2
    assert tr.read_metrics(tmp_path / "nope.json") is None


@pytest.mark.parametrize("bad", [
    None, {}, {"spans": {}, "counters": {}},
    {"spans": {"x": {"count": 1, "total_ns": 1, "max_ns": 2}},
     "counters": {}, "gauges": {}},
    {"spans": {"x": {"count": 0, "total_ns": 5, "max_ns": 0}},
     "counters": {}, "gauges": {}},
    {"spans": {"x": {"count": -1, "total_ns": 1, "max_ns": 1}},
     "counters": {}, "gauges": {}},
    {"spans": {}, "counters": {"c": 1.5}, "gauges": {}}])
def test_validate_metrics_rejects(bad):
    for root in ROOTS:
        with pytest.raises(ValueError):
            mod(root, "telemetry").validate_metrics(bad)


# ---------------------------------------------------------------------------
# monitor.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["uniform", "lognormal", "adversarial"])
def test_log_histogram_equal(name):
    values = {
        "uniform": np.random.RandomState(7).uniform(1e3, 1e8, 5000),
        "lognormal": np.exp(np.random.RandomState(7).normal(14, 2, 5000)),
        "adversarial": np.array([1.0] * 500 + [2.0 ** (k / 8)
                                                for k in range(400)] * 5
                                + [1e12] * 100 + [3.0] * 1000 + [0.0])}[
        name]

    def scen(root):
        H = mod(root, "monitor").LogHistogram
        hs = [H() for _ in range(4)]
        for i, v in enumerate(values):
            hs[i % 4].add(float(v))
        whole = hs[0].merge(hs[1]).merge(hs[2].merge(hs[3]))
        back = H.from_dict(json.loads(json.dumps(whole.to_dict())))
        folded = H.merge_dicts([h.to_dict() for h in reversed(hs)])
        qs = (0.1, 0.5, 0.9, 0.95, 0.99)
        return (whole.to_dict(), [whole.quantile(q) for q in qs],
                back.to_dict(), folded.to_dict(), whole.quantiles(qs))

    got = both(scen)
    for q, est in zip((0.1, 0.5, 0.9, 0.95, 0.99), got[1]):
        true = float(np.quantile(values, q, method="lower"))
        H = mod("jepsen_tpu_torch", "monitor").LogHistogram
        if true > 0:
            assert abs(H.bucket_of(est) - H.bucket_of(true)) <= 1


def test_log_histogram_junk():
    def scen(root):
        H = mod(root, "monitor").LogHistogram
        out = [(h.n, h.zeros, h.counts) for h in map(H.from_dict, (
            None, [], "x", {"counts": "nope"}, {"counts": {"a": "b"}},
            {"zeros": "many"}, {"counts": {"3": -2, "4": 0}},
            {"counts": {"3": 2}, "zeros": -1}))]
        e = H()
        return out, e.quantile(0.5)

    assert both(scen)[0][-1] == (2, 0, {3: 2})


def test_monitor_hooks_and_samples():
    def scen(root):
        util, monitor = mod(root, "util"), mod(root, "monitor")
        tel = mod(root, "telemetry")
        seen = []

        def probe_factory():
            def probe(op, mon):
                seen.append(op.f)
                mon.probe_gauge("lag", 42)
            return probe

        util.init_relative_time()
        tel.reset()
        m = monitor.Monitor({"monitor_probes": [probe_factory],
                             "plot": {"nemeses": [
                                 {"name": "partition",
                                  "start": {"start-partition"},
                                  "stop": {"stop-partition"}}]}},
                            interval_s=99)
        now = util.relative_time_nanos()
        inv = Op(root, type="invoke", process=0, f="w", time=now)
        m.on_dispatch(inv, 0, now)
        p1 = m.sample()
        m.on_complete(inv.copy(type="ok"), 0, now + 2_000_000)
        m.on_stall()
        nem = Op(root, type="info", process="nemesis",
                 f="start-partition", time=now)
        m.on_dispatch(nem, "nemesis", now)
        m.on_complete(nem, "nemesis", now + 5_000_000_000)
        tel.gauge("wgl.search.frontier-peak", 7)
        tel.gauge("other.gauge", 1)
        with tel.span("outer"):
            p2 = m.sample()
        m.on_complete(nem.copy(f="stop-partition"), "nemesis", now)
        p3 = m.sample()
        keep = ("dispatched", "completed", "latency_ms", "nemesis",
                "probes", "gauges", "open_spans")
        return ([{k: p.get(k) for k in keep} for p in (p1, p2, p3)],
                list(p1["inflight"]), p2["stall_rate"] > 0, seen,
                m.histogram().to_dict())

    pts, inflight, stalled, seen, _h = both(scen)
    assert inflight == ["0"] and stalled
    assert seen == ["w", "start-partition", "stop-partition"]
    assert pts[1]["nemesis"] == ["partition"] and pts[2]["nemesis"] == []
    assert pts[1]["gauges"] == {"wgl.search.frontier-peak": 7}
    assert pts[1]["open_spans"] == ["outer"]
    assert pts[1]["latency_ms"]["p50"] == pytest.approx(2.0, rel=0.2)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_timeseries_read_across(tmp_path, writer, reader):
    mod(writer, "util").init_relative_time()
    m = mod(writer, "monitor").Monitor({}, interval_s=0.02)
    out = tmp_path / "timeseries.jsonl"
    m.start(out)
    m.flush_point()
    m.stop()
    m.stop()  # idempotent
    pts = list(mod(reader, "monitor").read_points(out))
    assert len(pts) >= 2 and pts == json.loads(json.dumps(m.points()))
    with open(out, "a") as f:
        f.write('{"t": 12')
    assert list(mod(reader, "monitor").read_points(out)) == pts
    assert mod(reader, "store").load_timeseries(tmp_path) == pts


# ---------------------------------------------------------------------------
# watchdog.py
# ---------------------------------------------------------------------------

def _ops(root, *specs):
    return [Op(root, index=i, time=i, type=t, process=0, f=f, value=v)
            for i, (t, f, v) in enumerate(specs)]


WATCHDOG_STREAMS = {
    "register": (["register"], [
        ("invoke", "write", 1), ("ok", "write", 1),
        ("invoke", "read", None), ("ok", "read", 1), ("ok", "read", 777)]),
    "register-tuples": (["register"], [
        ("invoke", "write", ("k1", 5)), ("ok", "write", ("k1", 5)),
        ("ok", "read", ("k1", 5)), ("ok", "read", ("k2", None)),
        ("ok", "cas", ("k2", [123, 5]))]),
    "counter": (["counter"], [
        ("ok", "read", 50), ("invoke", "add", 5), ("ok", "add", 5),
        ("invoke", "add", -2), ("ok", "add", -2), ("ok", "read", 3),
        ("ok", "read", -2), ("ok", "read", 5), ("ok", "read", 6)]),
    "set": (["set"], [
        ("ok", "read", [9]), ("invoke", "add", 1), ("ok", "add", 1),
        ("invoke", "add", 2), ("fail", "add", 2), ("ok", "read", [1]),
        ("ok", "read", [1, 2]), ("invoke", "add", 3),
        ("ok", "read", [77])]),
    "set-retry": (["set"], [
        ("invoke", "add", 5), ("fail", "add", 5), ("invoke", "add", 5),
        ("ok", "read", [5]), ("fail", "add", 5), ("ok", "read", [5]),
        ("invoke", "add", 9), ("info", "add", 9), ("ok", "read", [9])]),
    "all-adapters": (True, [
        ("invoke", "write", 3), ("ok", "write", 3),
        ("invoke", "read", None), ("ok", "read", 3),
        ("invoke", "cas", [3, 1]), ("ok", "cas", [3, 1]),
        ("ok", "read", 1)]),
}


@pytest.mark.parametrize("name", sorted(WATCHDOG_STREAMS))
def test_watchdog_adapters(name):
    spec, stream = WATCHDOG_STREAMS[name]

    def scen(root):
        tel = mod(root, "telemetry")
        tel.reset()
        wd = mod(root, "watchdog").from_test({"watchdog": spec})
        for o in _ops(root, *stream):
            wd.observe(o)
        wd.observe(Op(root, type="info", process="nemesis", f="start"))
        res = wd.results()
        return (res, tel.get().counters().get("watchdog.violations", 0),
                [e["name"] for e in tel.get().events()])

    res, count, names = both(scen)
    assert count == res["count"]
    if name in ("register", "register-tuples", "counter", "set"):
        assert res["tripped"] and "watchdog" in names
    if name == "all-adapters":
        assert not res["tripped"]


def test_watchdog_from_test_shapes():
    def scen(root):
        w = mod(root, "watchdog")
        out = [w.from_test({}), w.from_test({"watchdog": False})]
        wd = w.from_test({"watchdog": True})
        wd2 = w.from_test({"watchdog": {"adapters": ["set"],
                                        "early_abort": True}})
        with pytest.raises(ValueError):
            w.from_test({"watchdog": ["nope"]})
        return out, sorted(a.name for a in wd.adapters), wd2.early_abort

    assert both(scen) == ([None, None], ["counter", "register", "set"],
                          True)


# ---------------------------------------------------------------------------
# coverage.py (the recorder half)
# ---------------------------------------------------------------------------

def synthetic_test(root, tmp_path=None, results=None):
    op = mod(root, "history").op
    hist = mod(root, "history").History([
        op(type="info", process="nemesis", f="start-partition",
           value=None, time=2),
        op(type="info", process="nemesis", f="start-partition",
           value="isolated", time=3),
        op(type="invoke", process=0, f="read", value=None, time=3),
        op(type="ok", process=0, f="read", value=1, time=4),
        op(type="info", process="nemesis", f="stop-partition",
           value=None, time=5),
        op(type="info", process="nemesis", f="kill", value="one",
           time=6),
        op(type="info", process="nemesis", f="bump-clock",
           value={"n1": 4}, time=7),
    ])
    t = {"name": "synthetic", "concurrency": 2,
         "spec": {"workload": "register",
                  "opts": {"rate": 10, "ops": 4}},
         "history": hist,
         "results": results if results is not None else {
             "valid?": False,
             "workload": {"valid?": False,
                          "anomaly-classes": {"nonlinearizable":
                                              "witnessed",
                                              "G0": "clean"},
                          "anomalies": {"nonlinearizable": [
                              {"op-indices": [3, 7]}]}},
             "stats": {"valid?": True},
             "watchdog": {"count": 2}}}
    if tmp_path is not None:
        d = tmp_path / "store" / "synthetic" / "20260801T000000.0000"
        d.mkdir(parents=True, exist_ok=True)
        t["store_dir"] = str(d)
    return t


def no_ts(rec):
    return {k: v for k, v in rec.items() if k != "ts"}


def test_coverage_folding_and_outcomes():
    def scen(root):
        cov = mod(root, "coverage")
        acts = [{"kind": "partition", "f": "start", "phase": "begin",
                 "t0": 10},
                {"kind": "partition", "f": "stop", "phase": "end",
                 "t0": 20, "t1": 25},
                {"kind": "partition", "f": "start", "phase": "begin",
                 "t0": 40},
                {"kind": "file-bitflip", "f": "bitflip", "phase": "pulse",
                 "t0": 7, "t1": 9},
                {"kind": "db-kill", "f": "start", "phase": "end",
                 "t0": 50}]
        t = synthetic_test(root)
        return (cov.fold_faults(acts, {"harness-drop": 3}),
                cov.faults_from_history(t["history"]),
                cov.anomaly_outcomes(t["results"]),
                cov.default_kinds({"start", "kill", "bump-clock", "x"}),
                cov.FAULT_KINDS, cov.F_KINDS, cov.OUTCOMES,
                [cov.outcome(w, v) for w in (True, False)
                 for v in (True, False, None, "unknown")])

    folded, from_hist, outcomes, *_ = both(scen)
    assert folded[2] == {"kind": "partition", "count": 2,
                         "windows": [[10, 25], [40, None]]}
    assert {"kind": "partition", "count": 1, "windows": [[2, 5]]} in \
        from_hist
    assert {"class": "watchdog", "checker": "watchdog",
            "outcome": "witnessed"} in outcomes


def test_coverage_recorder_and_records():
    def scen(root):
        cov = mod(root, "coverage")
        rec = cov.Recorder()
        rec.record("process-pause", "start", "begin", 1, 2)
        rec.record(None, "x", "pulse", 3)
        rec.record_harness("drop", 2)
        live = cov.build_record(synthetic_test(root), recorder=rec)
        hist = cov.build_record(synthetic_test(root),
                                recorder=cov.Recorder())
        return no_ts(live), no_ts(hist), cov.validate_record(live)

    live, hist, n = both(scen)
    assert [f["kind"] for f in live["faults"]] == ["process-pause",
                                                   "harness-drop"]
    assert hist["signature"]["nemesis-ops"] == 4
    assert hist["workload"] == "register" and n > 0


@pytest.mark.parametrize("mutate", [
    lambda r: r.pop("run"),
    lambda r: r.__setitem__("schema", 99),
    lambda r: r.__setitem__("faults", {"not": "a list"}),
    lambda r: r["faults"].append({"count": 1}),
    lambda r: r["faults"].append({"kind": "x", "count": -1}),
    lambda r: r["faults"].append({"kind": "x", "count": 1,
                                  "windows": [[1]]}),
    lambda r: r["anomalies"].append({"class": "g", "outcome": "meh"}),
    lambda r: r["anomalies"].append({"class": "g", "outcome": "clean",
                                     "op-indices": ["x"]})])
def test_coverage_validate_rejects(mutate):
    for root in ROOTS:
        cov = mod(root, "coverage")
        rec = cov.build_record(synthetic_test(root),
                               recorder=cov.Recorder())
        mutate(rec)
        with pytest.raises(ValueError):
            cov.validate_record(rec)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_coverage_record_and_atlas_read_across(tmp_path, writer, reader):
    cw, cr = mod(writer, "coverage"), mod(reader, "coverage")
    t = synthetic_test(writer, tmp_path)
    rec = cw.write_record(t, recorder=cw.Recorder())
    loaded = cr.load_record(t["store_dir"])
    assert loaded == json.loads(json.dumps(rec))
    assert cr.validate_record(loaded) == cw.validate_record(rec)
    base = tmp_path / "store"
    assert cw.append_run(base, rec) == cr.atlas_entry(loaded)
    cw.append_run(base, rec)  # same digest: a no-op
    path = base / cr.ATLAS_FILE
    entries = cr.read_atlas(path)
    assert len(entries) == 1 and cr.validate_atlas(entries) == 1
    assert cr.sync_store(base) == 0  # the live append already landed
    # a changed re-analysis appends; the newest line per run wins
    t["results"]["workload"]["anomaly-classes"]["G0"] = "witnessed"
    rec2 = cw.build_record(t, recorder=cw.Recorder())
    cw.append_run(base, rec2)
    with open(path, "a") as f:
        f.write('{"run": "torn')
    entries = cr.read_atlas(path)
    assert len(entries) == 2
    newest = cr.dedup_entries(entries)
    assert newest[rec["run"]]["digest"] == cw.atlas_entry(rec2)["digest"]


def test_coverage_sync_store_across(tmp_path):
    for w, r in PAIRS:
        base = tmp_path / f"{w}-{r}" / "store"
        t = synthetic_test(w, tmp_path / f"{w}-{r}")
        mod(w, "coverage").write_record(t, recorder=mod(
            w, "coverage").Recorder())
        assert mod(r, "coverage").sync_store(base) == 1
        assert mod(r, "coverage").sync_store(base) == 0
        assert len(mod(w, "coverage").read_atlas(
            base / "coverage_atlas.jsonl")) == 1


# ---------------------------------------------------------------------------
# nodeprobe.py (the recorder half)
# ---------------------------------------------------------------------------

def probe_test(root, nodes=("n1", "n2"), seed=7, responder=None):
    mod(root, "util").init_relative_time()
    np_ = mod(root, "nodeprobe")
    remote = mod(root, "control.dummy").DummyRemote(
        responder if responder is not None
        else np_.synthetic_responder(seed))
    return {"nodes": list(nodes), "ssh": {"dummy": True},
            "remote": remote, "node_log_files": [LOG]}


def comparable(rec):
    """A node-plane record without what reads a clock: times, offsets,
    rates over measured intervals, log lines (stamped by the control
    machine's clock)."""
    out = {k: v for k, v in rec.items()
           if k not in ("t", "clock_offset_s", "disk", "net", "line",
                        "t_node_s")}
    return out


def ticks(root, test, n=5):
    p = mod(root, "nodeprobe").NodeProbe(test, interval_s=0.01)
    for _ in range(n):
        for node in test["nodes"]:
            p.tick(node)
    p.stop()
    return p


def test_probe_ticks_equal():
    def scen(root):
        np_ = mod(root, "nodeprobe")
        p = ticks(root, probe_test(root), n=6)
        recs = p.records()
        logs = [(r["node"], r["class"], r["ts"], r["line"][20:])
                for r in recs if r["kind"] == "log"]
        return ([comparable(r) for r in recs], logs,
                np_.validate_records(recs),
                {n: s.offsets for n, s in p._states.items()})

    recs, logs, n, offsets = both(scen)
    assert n == len(recs)
    assert {c for _n, c, _ts, _l in logs} == {"election", "oom-kill"}
    samples = [r for r in recs if r["kind"] == "sample"
               and r["node"] == "n1"]
    assert "cpu" not in samples[0] and 0 <= samples[1]["cpu"]["busy"] <= 1


def test_probe_gaps_and_crlf():
    def scen(root):
        np_ = mod(root, "nodeprobe")
        mute = ticks(root, probe_test(root, responder=lambda n, a: None),
                     n=2).records()
        content = {"text": ""}

        def crlf(node, action):
            import re

            if np_.MARK not in action.cmd:
                return None
            out = [f"{np_.MARK} clock", "1.0"]
            for off, path in re.findall(r"tail -c \+(\d+) (\S+)",
                                        action.cmd):
                chunk = content["text"].encode()[int(off) - 1:]
                out.append(f"{np_.MARK} log {path}")
                out.append(chunk.decode() + np_.EOT)
            return "\n".join(out)

        p = np_.NodeProbe(probe_test(root, nodes=["n1"], responder=crlf),
                          interval_s=0.01)
        content["text"] = "panic: first\r\n"
        p.tick("n1")
        content["text"] += "plain line\r\npanic: second\r\n"
        p.tick("n1")
        p.tick("n1")
        p.stop()
        lines = [r["line"] for r in p.records() if r["kind"] == "log"]
        return ([comparable(r) for r in mute], lines,
                p._states["n1"].offsets[LOG], len(content["text"]))

    mute, lines, off, size = both(scen)
    assert {r["reason"] for r in mute} == {"no-data"}
    assert lines == ["panic: first", "panic: second"] and off == size


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_nodes_jsonl_read_across(tmp_path, writer, reader):
    p = mod(writer, "nodeprobe").NodeProbe(probe_test(writer),
                                           interval_s=0.01)
    p.start(tmp_path / "nodes.jsonl")
    for _ in range(3):
        p.tick("n1")
    p.stop()
    r = mod(reader, "nodeprobe")
    loaded = r.load_records(tmp_path)
    assert loaded == json.loads(json.dumps(p.records()))
    assert r.validate_records(loaded) == len(loaded)
    assert mod(reader, "store").load_nodes(tmp_path) == loaded
    assert r.clock_skew_bound(loaded) == \
        mod(writer, "nodeprobe").clock_skew_bound(p.records())


def test_parsers_equal():
    def scen(root):
        np_ = mod(root, "nodeprobe")
        resp = np_.synthetic_responder(3)
        act = mod(root, "control.core").Action(
            cmd=np_.probe_cmd({LOG: 1, "/var/log/b.log": 10}))
        out = [resp(n, act) for n in ("n1", "n2", "n1", "n1", "n2")]
        parsed = []
        for o in out:
            s = np_.parse_probe(o)
            parsed.append([np_.parse_stat(s.get("stat", "")),
                           np_.parse_meminfo(s.get("meminfo", "")),
                           np_.parse_diskstats(s.get("diskstats", "")),
                           np_.parse_netdev(s.get("net", "")),
                           sorted(s.get("logs", {})),
                           [np_.split_tail(v) is not None
                            for v in s.get("logs", {}).values()]])
        return (act.cmd, parsed, np_.probe_cmd(None),
                np_.parse_clock("not a clock"), np_.parse_clock(""),
                [np_.classify_line(x) for x in (
                    "panic: x", "Assertion failed: y",
                    "Out of memory: Killed process 1", "elected leader",
                    "stepping down as leader", "data corruption",
                    "checksum mismatch", "Starting server",
                    "received signal SIGTERM", "slow query", "",
                    "panic: leader election raced")],
                [np_.parse_log_timestamp(x) for x in (
                    "2026-08-03 12:05:10.500 W | x",
                    "2026-08-03T12:05:10Z x", "[1000000000.5] panic",
                    "no time here")])

    got = both(scen)
    assert got[5][-1] == "panic-assert"


def test_clock_normalization_series_and_stamping():
    def scen(root):
        import calendar

        np_ = mod(root, "nodeprobe")
        op = mod(root, "history").op
        History = mod(root, "history").History
        mod(root, "util").init_relative_time()
        p = np_.NodeProbe(probe_test(root, nodes=["n1"]))
        p.origin_epoch = calendar.timegm((2026, 8, 3, 12, 0, 0))
        a = p._log_event("n1", LOG, "2026-08-03 12:05:10.500 W | OOM",
                         "oom-kill", t=999, clock_offset_s=300.0)
        b = p._log_event("n1", LOG, "panic: no timestamp",
                         "panic-assert", t=1234, clock_offset_s=50.0)
        p.origin_epoch = 2e9
        c = p._log_event("n1", LOG, "[1000000000.5] panic: old",
                         "panic-assert", t=7, clock_offset_s=0.0)
        hist = History([
            op(type="info", process="nemesis", f="check-offsets",
               value=None, time=100),
            op(type="info", process="nemesis", f="check-offsets",
               value=None, time=200,
               **{"clock-offsets": {"n1": 0.75, "n2": -0.1}})])
        recs = [{"kind": "sample", "node": "n1", "t": 500,
                 "clock_offset_s": 0.2},
                {"kind": "sample", "node": "n3", "t": 1,
                 "clock_offset_s": -0.9}]
        results = {"valid?": True,
                   "linear": {"valid?": True, "anomaly-classes": {
                       "nonlinearizable": "clean"}},
                   "elle": {"valid?": True, "anomaly-classes": {
                       "G1a": "clean", "G-nonadjacent-realtime":
                       "clean"}},
                   "keys": [{"anomaly-classes": {"G0": "clean"}}],
                   "stats": {"valid?": True}}
        n = np_.stamp_results(results, 0.5)
        return (a, b, c, np_.clock_series(recs, hist),
                np_.clock_skew_bound(recs, hist),
                np_.clock_skew_bound([], History([])), n, results)

    a, b, c, series, bound, none, n, results = both(scen)
    assert a["ts"] == "parsed" and a["t"] == int(10.5 * 1e9)
    assert b == {"kind": "log", "node": "n1", "file": LOG,
                 "class": "panic-assert", "line": "panic: no timestamp",
                 "t": 1234, "ts": "observed"}
    assert c["t"] == 0 and series["n1"] == [[200, 0.75], [500, 0.2]]
    assert bound == 0.9 and none is None and n == 3
    assert "clock-skew-bound" not in results["stats"]


@pytest.mark.parametrize("i", range(12))
def test_validate_records_rejects(i):
    mutations = [
        lambda r: r[0].pop("node"),
        lambda r: r[0].__setitem__("kind", "mystery"),
        lambda r: r[0].__setitem__("t", -1),
        lambda r: r[0].__setitem__("t", 1.5),
        lambda r: r[0].__setitem__("cpu", {"busy": "hot"}),
        lambda r: r[0].__setitem__("clock_offset_s", "skewed"),
        lambda r: r[1].__setitem__("reason", "felt-like-it"),
        lambda r: r[2].__setitem__("class", "novel-anomaly"),
        lambda r: r[2].__setitem__("ts", "guessed"),
        lambda r: r[2].pop("line"),
        lambda r: r[3].__setitem__("state", "ajar"),
        lambda r: r.append({"kind": "sample", "node": "n1", "t": 5})]
    for root in ROOTS:
        good = [{"kind": "sample", "node": "n1", "t": 10,
                 "mem": {"total_kb": 1, "free_kb": 1, "used_frac": 0.0},
                 "clock_offset_s": 0.5},
                {"kind": "gap", "node": "n1", "t": 20,
                 "reason": "unreachable"},
                {"kind": "log", "node": "n1", "t": 30, "class": "oom-kill",
                 "file": LOG, "line": "x", "ts": "observed"},
                {"kind": "breaker", "node": "n1", "t": 40,
                 "state": "open"}]
        assert mod(root, "nodeprobe").validate_records(good) == 4
        mutations[i](good)
        with pytest.raises(ValueError):
            mod(root, "nodeprobe").validate_records(good)


def test_unreachable_node_is_a_gap():
    """A transport failure gives an honest `unreachable` gap and drops
    the session, never a sample (tests/test_nodeprobe.py
    CuttingRemote)."""
    def scen(root):
        core = mod(root, "control.core")
        np_ = mod(root, "nodeprobe")
        synth = np_.synthetic_responder(7)
        cut = {"on": False}

        def responder(node, action):
            if cut["on"] and node == "n2":
                raise core.TransportError("cut", node=node)
            return synth(node, action)

        p = np_.NodeProbe(probe_test(root, responder=responder),
                          interval_s=0.01)
        for step in range(4):
            cut["on"] = step in (1, 2)
            for node in ("n1", "n2"):
                p.tick(node)
        p.stop()
        return [comparable(r) for r in p.records()
                if r["kind"] != "log"]

    recs = both(scen)
    gaps = [r for r in recs if r["kind"] == "gap"]
    assert [(g["node"], g["reason"]) for g in gaps] == [
        ("n2", "unreachable")] * 2
