"""The port's readers of a stored run and of the coverage atlas against
the JAX package's on the CPU: reports/telemetry.py (span trees, the
--min-ms/--top filter, the metric table, the web page),
reports/nodes.py (summaries, the `nodes` table, the web lanes),
nodeprobe.prometheus_lines, and the coverage readers (aggregate,
cell_status, matrix_text, gaps, suggest, coverage_text,
prometheus_lines).

The records are made once, from a seed (the port's node probe over the
dummy remote's synthetic responder, seeded spans and counters, seeded
atlas entries), and go through both packages' functions: every text,
page and exposition line must be equal, byte for byte. The one
difference is the port's own name in a suggested command line
(`python -m jepsen_tpu_torch`), read as the JAX package's."""

from __future__ import annotations

import importlib
import random

import pytest

ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")
LOG = "/var/log/db.log"


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def as_jax(text: str) -> str:
    """The port's output with its command line's module name read as
    the JAX package's."""
    return text.replace("jepsen_tpu_torch", "jepsen_tpu")


def both(name, fn, *args, **kw):
    """(the JAX package's, the port's) value of `name`'s function `fn`
    on the same arguments."""
    return tuple(getattr(mod(r, name), fn)(*args, **kw) for r in ROOTS)


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def spans(seed, n=60):
    """Seeded span events: a tree of phases with kernel children, a few
    open spans, an orphan (its parent never completed) and attrs."""
    rng = random.Random(seed)
    out = []
    t = 0
    for i in range(n):
        parent = rng.choice([None] + [e["id"] for e in out[-8:]])
        t += rng.randrange(1, 5_000_000)
        e = {"id": i, "parent": parent,
             "name": rng.choice(["run", "case", "analyze",
                                 "kernel:wgl", "checker:workload",
                                 "elle:cycles"]),
             "t0": t, "thread": rng.choice(["MainThread", "worker-1"])}
        if rng.random() < 0.9:
            e["t1"] = t + rng.randrange(1, 2_000_000_000)
        if rng.random() < 0.4:
            e["attrs"] = {"rows": rng.randrange(100),
                          "bucket": rng.choice(["a", "b"])}
        out.append(e)
    out.append({"id": 999, "parent": 12345, "name": "orphan",
                "t0": 5, "t1": 6})
    out.append({"name": "no-t0"})
    return out


def metrics(seed):
    rng = random.Random(seed)
    return {"counters": {"wgl.kernel.launches": rng.randrange(9),
                         "wgl.kernel.execute_ns": rng.randrange(10**10),
                         "scc.path.device": 1},
            "gauges": {"profiler.wgl.peak": rng.random()},
            "spans": {"analyze": {"count": 2, "total_ns": 3_000_000_000,
                                  "max_ns": 2_000_000_000},
                      "kernel:wgl": {"count": 8, "total_ns": 40_000_000,
                                     "max_ns": 9_000_000}}}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("filt", [(None, None), (5.0, None), (None, 4),
                                  (100.0, 2), (0.0, 0)])
def test_telemetry_text_equal(seed, filt):
    ev, m = spans(seed), metrics(seed)
    want, got = both("reports.telemetry", "telemetry_text", ev, m,
                     min_ms=filt[0], top=filt[1])
    assert got == want
    assert both("reports.telemetry", "span_tree", ev)[0] == both(
        "reports.telemetry", "span_tree", ev)[1]


def test_telemetry_text_and_page_without_records():
    for args in (([], None), ([], {}), (spans(4), None)):
        want, got = both("reports.telemetry", "telemetry_text", *args)
        assert got == want
    want, got = both("reports.telemetry", "telemetry_html", "r/1",
                     spans(5), metrics(5))
    assert got == want and "wgl.kernel.launches" in got
    want, got = both("reports.telemetry", "telemetry_html", "<r>", [],
                     None)
    assert got == want and "&lt;r&gt;" in got


# ---------------------------------------------------------------------------
# the node plane
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def node_records():
    """Records of the port's node probe over the dummy remote's seeded
    synthetic responder (samples, tagged log events), plus gap and
    breaker records."""
    from jepsen_tpu_torch import nodeprobe, util
    from jepsen_tpu_torch.control.dummy import DummyRemote

    util.init_relative_time()
    test = {"nodes": ["n1", "n2", "n3"], "ssh": {"dummy": True},
            "remote": DummyRemote(nodeprobe.synthetic_responder(7)),
            "node_log_files": [LOG]}
    p = nodeprobe.NodeProbe(test, interval_s=0.01)
    for _ in range(6):
        for node in test["nodes"]:
            p.tick(node)
    p.stop()
    recs = p.records()
    t_max = max(r["t"] for r in recs)
    recs += [{"kind": "gap", "node": "n1", "t": t_max + 1,
              "reason": "quarantined"},
             {"kind": "gap", "node": "n3", "t": t_max + 2,
              "reason": "unreachable"},
             {"kind": "breaker", "node": "n3", "t": t_max + 3,
              "state": "open"}]
    return recs


def clock_history(root):
    h = mod(root, "history")
    return h.History([
        h.op(index=0, time=10, type="info", process="nemesis",
             f="check-offsets", value=None,
             **{"clock-offsets": {"n1": 0.5, "n2": -3.25}}),
        h.op(index=1, time=20, type="ok", process=0, f="read", value=1),
    ], assign_indices=False)


def test_nodes_text_equal(node_records):
    want, got = both("reports.nodes", "nodes_text", node_records)
    assert got == want
    assert "clock-skew-bound" in got and "election" in got
    assert "[open]" in got and "gap markers: 2" in got
    texts = [mod(r, "reports.nodes").nodes_text(node_records,
                                                clock_history(r))
             for r in ROOTS]
    assert texts[1] == texts[0] and "3.250000s" in texts[1]
    assert both("reports.nodes", "summarize", node_records)[0] == both(
        "reports.nodes", "summarize", node_records)[1]
    want, got = both("reports.nodes", "nodes_text", [])
    assert as_jax(got) == want


@pytest.mark.parametrize("faults", [None, [
    {"kind": "partition", "windows": [[0, 10**6], [2 * 10**6, None]]},
    {"kind": "db-kill", "windows": [[5, 7]]}]])
@pytest.mark.parametrize("bound", [None, 0.125])
def test_lanes_html_equal(node_records, faults, bound):
    want, got = both("reports.nodes", "lanes_html", node_records, faults,
                     bound=bound)
    assert got == want
    assert "<h2>nodes</h2>" in got and "gap: quarantined" in got
    assert both("reports.nodes", "lanes_html", [])[1] == ""


def test_lanes_html_strides_long_lanes():
    rng = random.Random(3)
    recs = [{"kind": "sample", "node": f"n{i % 2}", "t": i * 1000,
             "cpu": {"busy": rng.random()}} for i in range(1500)]
    recs.append({"kind": "log", "node": "n0", "t": 777_000,
                 "class": "oom-kill", "line": "Out of memory"})
    want, got = both("reports.nodes", "lanes_html", recs)
    assert got == want and "oom-kill" in got


def test_node_prometheus_lines_equal(node_records):
    from jepsen_tpu_torch.reports.profile import validate_prometheus_text

    want, got = both("nodeprobe", "prometheus_lines", node_records)
    assert got == want
    assert validate_prometheus_text("\n".join(got) + "\n") > 0
    joined = "\n".join(got)
    assert "jepsen_tpu_node_cpu_busy" in joined
    assert "jepsen_tpu_node_log_events" in joined
    assert "jepsen_tpu_node_probe_gaps" in joined
    odd = [{"kind": "sample", "node": 'n"1\\', "t": 1,
            "cpu": {"busy": 0.5}, "clock_offset_s": 0.25}]
    assert both("nodeprobe", "prometheus_lines", odd)[0] == both(
        "nodeprobe", "prometheus_lines", odd)[1]
    assert both("nodeprobe", "prometheus_lines", [])[1] == []


# ---------------------------------------------------------------------------
# coverage readers
# ---------------------------------------------------------------------------

FAULT_CHOICES = ["partition", "db-kill", "clock-bump", "process-pause",
                 "file-lost-writes", "membership"]
CLASSES = ["nonlinearizable", "G0", "G1c", "set-lost", "bank-imbalance"]
WORKLOADS = ["register", "append", "set", "bank", "queue"]


def atlas_entries(seed, n=40):
    """Seeded atlas entries, through the JAX package's atlas_entry (the
    port's is the same function: tests/test_torch_observe.py), with a
    re-analysed run (same run id, a later line) and witness fractions."""
    from jepsen_tpu_torch import coverage

    rng = random.Random(seed)
    out = []
    for i in range(n):
        faults = [{"kind": k, "count": rng.randrange(1, 4),
                   "windows": []}
                  for k in rng.sample(FAULT_CHOICES, rng.randrange(3))]
        anomalies = []
        for c in rng.sample(CLASSES, rng.randrange(1, 4)):
            a = {"class": c, "outcome": rng.choice(
                ["witnessed", "clean", "clean", "unknown"])}
            if a["outcome"] == "witnessed" and rng.random() < 0.7:
                a["op-indices"] = [rng.randrange(100)]
                a["witness-frac"] = round(rng.random(), 3)
            anomalies.append(a)
        rec = {"run": f"{rng.choice(WORKLOADS)}-demo/{i % 30:04d}",
               "ts": 1_700_000_000.0 + i, "workload": rng.choice(
                   WORKLOADS), "faults": faults, "anomalies": anomalies,
               "valid": rng.choice([True, False, "unknown"])}
        out.append(coverage.atlas_entry(rec))
    return out


@pytest.fixture(params=[1, 2, 3])
def cells(request):
    entries = atlas_entries(request.param)
    want, got = both("coverage", "aggregate", entries)
    assert got == want
    return got


def test_cell_status_and_gaps_equal(cells):
    for k in ["none"] + FAULT_CHOICES + ["packet"]:
        for w in WORKLOADS + ["kafka"]:
            want, got = both("coverage", "cell_status", cells, k, w)
            assert got == want
    for wls in (None, WORKLOADS, ["kafka", "register"]):
        want, got = both("coverage", "gaps", cells, wls)
        assert got == want
        want, got = both("coverage", "matrix_text", cells, wls)
        assert got == want


@pytest.mark.parametrize("limit", [1, 6, 50])
def test_suggest_equal(cells, limit):
    want, got = both("coverage", "suggest", cells, WORKLOADS + ["kafka"],
                     limit=limit)
    assert [dict(s, config=as_jax(s["config"])) for s in got] == want
    clusterless = [s for s in got if s["fault"] == "partition"]
    for s in clusterless:
        assert s["config"].startswith(
            "python -m jepsen_tpu_torch test --no-ssh ")


@pytest.mark.parametrize("n_suggest", [0, 5])
def test_coverage_text_equal(cells, n_suggest):
    want, got = both("coverage", "coverage_text", cells,
                     WORKLOADS + ["kafka"], n_suggest=n_suggest)
    assert as_jax(got) == want


def test_coverage_prometheus_lines_equal(cells):
    from jepsen_tpu_torch.reports.profile import validate_prometheus_text

    want, got = both("coverage", "prometheus_lines", cells)
    assert got == want
    assert validate_prometheus_text("\n".join(got) + "\n") > 0


def test_empty_atlas_readers_equal():
    want, got = both("coverage", "aggregate", [])
    assert got == want == {}
    for fn, args in (("matrix_text", ({},)), ("gaps", ({}, ["a"])),
                     ("coverage_text", ({}, None)),
                     ("prometheus_lines", ({},))):
        want, got = both("coverage", fn, *args)
        assert got == want
