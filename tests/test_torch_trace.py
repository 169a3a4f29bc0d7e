"""The port's Chrome-trace export (reports/trace.py) against the JAX
package's on the CPU.

- A stored port run (the lifecycle test of tests/test_torch_core.py with
  the per-op trace and the node probe on, so every track has records)
  gives the same trace.json through both packages' write_trace, whole
  and filtered to an anomaly's ops (the JAX package's with the nemesis
  specs read back as tuples: its _nemesis_specs reads no list, ROADMAP
  C7, which the port's does); its document passes
  validate_chrome_trace and holds a device-track slice for each
  `kernel:` span, with the frontier counter track.
- chrome_trace over the same spans, history and records, and
  fleet_chrome_trace over the same flight-recorder records (those of
  test_flightrec.py::TestExports, and those of a port FleetServer's
  session), give the JAX function's document; validate_chrome_trace
  and expand_op_filter give the JAX function's answers.
"""

from __future__ import annotations

import importlib
import json
import random

import pytest

ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")
PORT = "jepsen_tpu_torch"


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def traces():
    return mod(PORT, "reports.trace"), mod("jepsen_tpu", "reports.trace")


@pytest.fixture(autouse=True)
def clear_ip_caches():
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()
    yield
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()


@pytest.fixture(scope="module")
def stored_run(tmp_path_factory):
    """A port run directory with telemetry (kernel spans among them),
    optrace.jsonl, nodes.jsonl and nemesis windows."""
    import test_torch_core as tc

    from jepsen_tpu_torch import nodeprobe
    from jepsen_tpu_torch.control.dummy import DummyRemote

    probe = nodeprobe.synthetic_responder(seed=7)
    mod(PORT, "net").clear_ip_cache()
    random.seed(7)
    t = tc.deterministic_test(PORT, tmp_path_factory.mktemp("store"))
    t["remote"] = DummyRemote(
        lambda node, action: tc.responder(node, action)
        or probe(node, action))
    t.update({"trace?": True, "nodeprobe?": True})
    out = mod(PORT, "core").run(t)
    mod(PORT, "net").clear_ip_cache()
    assert out["results"]["valid?"] is True
    return out


def as_tuples(test: dict) -> dict:
    """A loaded test whose plot's nemesis specs are tuples again, as the
    nemesis package made them before test.json turned them into lists."""
    plot = dict(test.get("plot") or {})
    plot["nemeses"] = [tuple(s) if isinstance(s, list) else s
                       for s in plot.get("nemeses") or []]
    return dict(test, plot=plot)


def jax_write_trace(run_dir, out_path, ops=None):
    """The JAX package's write_trace over the same files, with the spec
    tuples restored (its _nemesis_specs reads no list: ROADMAP C7)."""
    from jepsen_tpu import store as jstore
    from jepsen_tpu.reports import trace as jtrace

    test = as_tuples(jstore.load(run_dir))
    events, _m = jstore.load_telemetry(run_dir)
    doc = jtrace.chrome_trace(test, test.get("history") or [], events,
                              optrace=jstore.load_optrace(run_dir), ops=ops,
                              noderecs=jstore.load_nodes(run_dir))
    out_path.write_text(json.dumps(doc))
    return out_path


def test_the_jax_write_trace_reads_no_stored_spec_lists(stored_run,
                                                        tmp_path):
    """ROADMAP C7, a quirk of the reference: a stored run whose plot
    holds a nemesis package's specs (tuples, lists in test.json) makes
    the JAX package's write_trace raise; the port's writes the trace."""
    t, j = traces()
    with pytest.raises(AttributeError):
        j.write_trace(stored_run["store_dir"], tmp_path / "jax.json")
    doc = json.loads(t.write_trace(stored_run["store_dir"],
                                   tmp_path / "port.json").read_text())
    assert t.validate_chrome_trace(doc) > 0


@pytest.mark.parametrize("ops", [None, [3, 5]])
def test_write_trace_equal_across_packages(stored_run, tmp_path, ops):
    t, j = traces()
    d = stored_run["store_dir"]
    tp = t.write_trace(d, tmp_path / "port.json", ops=ops)
    jp = jax_write_trace(d, tmp_path / "jax.json", ops=ops)
    doc = json.loads(tp.read_text())
    assert doc == json.loads(jp.read_text())
    assert t.validate_chrome_trace(doc) == j.validate_chrome_trace(doc)
    assert [e for e in doc["traceEvents"] if e.get("cat") == "nemesis"]
    pids = {e["args"]["name"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"harness", "clients", "nemesis", "device"} <= pids
    assert any(p.startswith("node ") for p in pids)


def test_a_device_slice_for_each_kernel_span(stored_run, tmp_path):
    from jepsen_tpu_torch import store

    t, _j = traces()
    events, metrics = store.load_telemetry(stored_run["store_dir"])
    kernel_spans = [e for e in events
                    if e["name"].startswith("kernel:")]
    assert kernel_spans, "the run recorded no launch"
    doc = json.loads(t.write_trace(stored_run["store_dir"]).read_text())
    dev = [e for e in doc["traceEvents"]
           if e.get("pid") == t._PID_DEVICE and e["ph"] == "X"]
    assert sorted((e["name"], e["ts"]) for e in dev) == sorted(
        (s["name"][len("kernel:"):], s["t0"] / 1e3) for s in kernel_spans)
    assert any(e["ph"] == "C" and e["name"].endswith(" frontier")
               for e in doc["traceEvents"])
    # nothing of the device track is left on the harness flame
    assert not [e for e in doc["traceEvents"]
                if e.get("pid") == t._PID_HARNESS
                and str(e.get("name", "")).startswith("kernel:")]
    assert metrics["counters"]["profiler.wgl.launches"] == len(
        [s for s in kernel_spans if s["name"] == "kernel:wgl"])


def synthetic_spans():
    return [
        {"id": 1, "parent": None, "name": "analyze", "thread": "main",
         "t0": 0, "t1": 9_000_000, "attrs": {"checker": "lin"}},
        {"id": 2, "parent": None, "name": "kernel:wgl", "thread": "w",
         "t0": 1_000_000, "t1": 3_000_000,
         "attrs": {"rows": 4, "bytes_accessed": 7912, "flops": 16004,
                   "frontier_curve": [1, 4, 9, 4], "bucket": "((4,))",
                   "device_entries": [160], "balance": 1.0}},
        {"id": 3, "parent": None, "name": "kernel:scc", "thread": "w",
         "t0": 4_000_000, "t1": 4_000_000, "attrs": {"edges": 9}},
        {"id": 4, "parent": 1, "name": "open", "t0": 5}]


def synthetic_history(root):
    h = mod(root, "history")
    ops = [h.op(type="invoke", f="write", value=1, process=0, time=10),
           h.op(type="invoke", f="read", value=None, process=1, time=20),
           h.op(type="ok", f="write", value=1, process=0, time=30),
           h.op(type="info", f="read", value=None, process=1, time=40),
           h.op(type="invoke", f="start", value=None, process="nemesis",
                time=50),
           h.op(type="info", f="start", value="cut", process="nemesis",
                time=60),
           h.op(type="invoke", f="cas", value=[1, 2], process=0, time=70)]
    return h.History(ops)


def test_chrome_trace_equal_on_the_same_records():
    t, j = traces()
    spans = synthetic_spans()
    optrace = [{"op": 0, "process": 0, "kind": "client", "name": "w",
                "t0": 11, "t1": 29, "trace": "t0", "span": 1,
                "attrs": {"node": "n1"}},
               {"op": 1, "process": 1, "kind": "event", "name": "x",
                "t0": 21}]
    noderecs = [{"kind": "sample", "node": "n1", "t": 5,
                 "cpu": {"busy": 0.5}, "mem": {"used_frac": 0.25},
                 "net": {"rx_bytes_s": 10, "tx_bytes_s": 20},
                 "clock_offset_s": -0.25},
                {"kind": "log", "node": "n2", "t": 7, "class": "oom",
                 "file": "/var/log/db.log", "line": "killed", "ts": 1},
                {"kind": "gap", "node": "n2", "t": 8, "reason": "x"},
                {"kind": "breaker", "node": "n1", "t": 9,
                 "state": "open"}]
    test = {"name": "reg"}
    for ops in (None, [0, 3]):
        got = t.chrome_trace(test, synthetic_history(PORT), spans,
                             optrace=optrace, ops=ops, noderecs=noderecs)
        want = j.chrome_trace(test, synthetic_history("jepsen_tpu"),
                              spans, optrace=optrace, ops=ops,
                              noderecs=noderecs)
        assert got == want
        assert t.validate_chrome_trace(got) == len(got["traceEvents"])
    assert t.chrome_trace(None, None, None) == j.chrome_trace(None, None,
                                                              None)


@pytest.mark.parametrize("ops", [None, [], [0], [2, 5], [99]])
def test_expand_op_filter_equal(ops):
    t, j = traces()
    assert t.expand_op_filter(synthetic_history(PORT), ops) == \
        j.expand_op_filter(synthetic_history("jepsen_tpu"), ops)


class _Item:
    def __init__(self, tenant):
        self.tenant = tenant


def exports_fixture(root):
    """test_flightrec.py::TestExports' session, in one package."""
    frec = mod(root, "fleet.flightrec")
    fr = frec.FlightRecorder()
    ms = 1_000_000
    for i in range(1, 4):
        fr.chunk("alpha", "r", i, i * 10 * ms, i * 10 * ms + ms,
                 ms // 2, 16, trace="abc123")
    fr.chunk("beta", "r", 1, 5 * ms, 6 * ms, ms // 4, 8)
    fr.launch("slice", "full", 40 * ms, 50 * ms, 64, 64,
              [_Item("alpha"), _Item("beta")], device_ms=5.0)
    fr.launch("final", "timeout", 60 * ms, 80 * ms, 2, 64,
              [_Item("alpha")], device_ms=10.0, certify_ms=1.0)
    fr.verdict("alpha", "r", 60 * ms, 90 * ms,
               frec.latency_block(device_ms=10.0))
    fr.verdict("beta", "r", 60 * ms, 95 * ms, frec.replay_block())
    return fr.records()


def test_fleet_chrome_trace_equal_and_valid():
    t, j = traces()
    recs = exports_fixture(PORT)
    assert recs == exports_fixture("jepsen_tpu")
    doc = t.fleet_chrome_trace(recs)
    assert doc == j.fleet_chrome_trace(recs)
    assert t.validate_chrome_trace(doc) > 0
    evs = doc["traceEvents"]
    names = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"alpha", "beta", "device launches", "wal",
            "scheduler"} <= names
    assert sorted(e["name"] for e in evs if e["ph"] == "i") == \
        ["full", "timeout"]
    assert {"slice": 1.0} in [e["args"] for e in evs
                              if e["ph"] == "C"
                              and e["name"] == "batch occupancy"]
    assert min(e["ts"] for e in evs if e["ph"] != "M") == 0.0
    assert t.fleet_chrome_trace([]) == j.fleet_chrome_trace([])
    assert t.validate_chrome_trace(t.fleet_chrome_trace([])) >= 0


def test_fleet_chrome_trace_of_a_port_server_session(tmp_path):
    """A port FleetServer's own flight-recorder records: two tenants
    streamed, checked on the CPU."""
    from jepsen_tpu_torch.fleet import client as fc
    from jepsen_tpu_torch.fleet import flightrec, server
    from jepsen_tpu_torch.gpu import synth

    t, j = traces()
    srv = server.FleetServer(tmp_path / "fleet", device="cpu").start()
    try:
        for i, tenant in enumerate(("a", "b")):
            c = fc.FleetClient(srv.addr, tenant, "r", io_timeout_s=5)
            ops = list(synth.register_history(200, seed=40 + i))
            for k in range(0, len(ops), 100):
                c.send_chunk(ops[k:k + 100])
            assert c.finish()["result"]["valid?"] is True
            c.close()
        recs = srv.flightrec.records()
    finally:
        srv.stop()
    flightrec.validate_records(recs)
    doc = t.fleet_chrome_trace(recs)
    assert doc == j.fleet_chrome_trace(recs)
    assert t.validate_chrome_trace(doc) > 0
    assert {e["cat"] for e in doc["traceEvents"] if "cat" in e} >= {
        "fleet.chunk", "fleet.launch", "fleet.verdict"}


def _bad_docs():
    ok_meta = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
                "args": {"name": "p"}},
               {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
                "args": {"name": "t"}}]
    x = {"ph": "X", "name": "s", "pid": 1, "tid": 1, "ts": 0, "dur": 1}
    return [
        {},
        {"traceEvents": [{"ph": "Q", "name": "x", "pid": 1}]},
        {"traceEvents": [{"ph": "X", "pid": 1}]},
        {"traceEvents": [{"ph": "M", "name": "process_name", "pid": 1}]},
        {"traceEvents": ok_meta + [dict(x, ts=-1)]},
        {"traceEvents": ok_meta + [dict(x, dur="1")]},
        {"traceEvents": ok_meta + [{"ph": "C", "name": "c", "pid": 1,
                                    "tid": 1, "ts": 0,
                                    "args": {"c": "high"}}]},
        {"traceEvents": [x]},
        {"traceEvents": ok_meta + [dict(x, tid=2)]},
    ]


@pytest.mark.parametrize("doc", _bad_docs())
def test_validate_chrome_trace_rejects_equally(doc):
    t, j = traces()
    with pytest.raises(ValueError) as je:
        j.validate_chrome_trace(doc)
    with pytest.raises(ValueError) as te:
        t.validate_chrome_trace(doc)
    assert str(te.value) == str(je.value)
