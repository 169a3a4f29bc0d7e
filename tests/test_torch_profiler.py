"""The port's device profiler (gpu/profiler.py and its launch sites), the
profile report (reports/profile.py) and the bench ledger (ledger.py),
held against the JAX package on the CPU.

- The same seeded check_batch, check_batch_reach, scc (past
  DEVICE_MIN_EDGES), check_list_append and one-device ensemble run (the
  JAX package on its single-device path, JEPSEN_TPU_SPMD=0) give
  the same set of `profiler.<k>.*` counter and gauge names as the JAX
  package's, but for `profiler.scc.flops`: the port counts no
  operations for scc, whose bound counts bytes only. Launches, rows,
  iterations, states and dedup hits are equal, kernel by kernel.
- Each record's cost fields equal the shape formulas (and the bytes and
  operations chip_smoke's bound counts for the same launch).
- The recorder's guards (straggler, disabled, span cap, bucket unclaim,
  pending overflow) and the compile accounting behave as the JAX
  package's.
- kernel_rows, profile_text, profile_html, prometheus_text and every
  ledger function give the JAX function's output for the same inputs.
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest

ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")
PORT = "jepsen_tpu_torch"
PER_KERNEL = ("launches", "rows", "iterations", "states", "dedup_hits")


def mod(root, name):
    if root == PORT:
        name = name.replace("tpu.", "gpu.")
    return importlib.import_module(f"{root}.{name}")


def dev(root) -> dict:
    return {"device": "cpu"} if root == PORT else {}


def fresh_state(root):
    mod(root, "util").init_relative_time()
    mod(root, "telemetry").reset()
    mod(root, "tpu.profiler").reset()


@pytest.fixture
def fresh():
    """Fresh clocks and recorders in both packages; each wgl module's
    claimed-bucket set is cleared (and restored) so cache accounting is
    deterministic per test."""
    saved = {}
    for root in ROOTS:
        fresh_state(root)
        w = mod(root, "tpu.wgl")
        saved[root] = set(w._compiled_buckets)
        w._compiled_buckets.clear()
    yield mod(PORT, "tpu.profiler").get()
    for root in ROOTS:
        mod(root, "tpu.wgl")._compiled_buckets.update(saved[root])


def _encs(root, n=3, ops=64, seed0=0):
    synth = mod(root, "tpu.synth")
    models = mod(root, "checker.models")
    encode = mod(root, "tpu.encode").encode
    return [encode(models.cas_register(),
                   synth.register_history(ops, n_procs=3, seed=seed0 + i))
            for i in range(n)]


def _graph(n=2000, e=25_000, seed=0):
    rng = np.random.default_rng(seed)
    return n, rng.integers(0, n, e), rng.integers(0, n, e)


def workload(root):
    """check_batch, check_batch_reach, an scc past DEVICE_MIN_EDGES, a
    list-append check on the device engine and a one-device ensemble
    launch, each package through its own entry points."""
    wgl = mod(root, "tpu.wgl")
    scc = mod(root, "tpu.scc")
    ens = mod(root, "tpu.ensemble")
    elle = mod(root, "tpu.elle")
    synth = mod(root, "tpu.synth")
    encs = _encs(root)
    wgl.check_batch(encs, **dev(root))
    wgl.check_batch_reach(encs[:2], **dev(root))
    n, src, dst = _graph()
    if root == PORT:
        scc.Edges(n, src, dst, device="cpu").scc()
        ens.check_batch_sharded(encs, W=16, F=16, mesh="cpu")
    else:
        scc.scc(n, src, dst, device=True)
        ens.check_batch_sharded(encs, mesh=ens.default_mesh(1), W=16, F=16)
    elle.check_list_append(synth.list_append_history(600, seed=3),
                           {"engine": "device", **dev(root)})


def profiled(root) -> tuple[dict, dict, list]:
    """(profiler counters, profiler gauges, records) of a warm run: the
    workload once to see every shape, then again on fresh recorders."""
    workload(root)
    fresh_state(root)
    workload(root)
    tel = mod(root, "telemetry").get()
    keep = lambda d: {k: v for k, v in d.items()  # noqa: E731
                      if k.startswith("profiler.")}
    return (keep(tel.counters()), keep(tel.gauges()),
            mod(root, "tpu.profiler").get().records())


@pytest.fixture(scope="module")
def both():
    # the JAX package on its single-device path (conftest gives JAX 8
    # CPU devices, over which it would shard): the port's one card
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_SPMD", "0")
        return {root: profiled(root) for root in ROOTS}


# ---------------------------------------------------------------------------
# counters against the JAX package
# ---------------------------------------------------------------------------

def test_counter_names_equal_the_jax_packages(both):
    jc, jg, _ = both["jepsen_tpu"]
    tc, tg, _ = both[PORT]
    assert set(jc) ^ set(tc) == {"profiler.scc.flops"}
    assert "profiler.scc.flops" in jc
    assert set(jg) == set(tg)
    kernels = {k.split(".")[1] for k in tc}
    assert kernels == {"wgl", "wgl-reach", "wgl-sharded", "scc",
                       "elle-append", "encode", "pack", "shard-layout"}


@pytest.mark.parametrize("field", PER_KERNEL)
def test_counter_values_equal_the_jax_packages(both, field):
    jc, tc = both["jepsen_tpu"][0], both[PORT][0]
    want = {k: v for k, v in jc.items() if k.endswith(f".{field}")}
    got = {k: v for k, v in tc.items() if k.endswith(f".{field}")}
    assert want and got == want


def test_gauges_equal_where_shape_only(both):
    jg, tg = both["jepsen_tpu"][1], both[PORT][1]
    for k in ("profiler.wgl.frontier_peak", "profiler.wgl-sharded.devices",
              "profiler.wgl-sharded.balance",
              "profiler.wgl-reach.frontier_peak"):
        assert tg[k] == jg[k], k


def test_records_carry_the_jax_schema(both):
    recs = {r["kernel"]: r for r in both[PORT][2]}
    jrecs = {r["kernel"]: r for r in both["jepsen_tpu"][2]}
    assert set(recs) == set(jrecs)
    for k in ("wgl", "wgl-reach", "wgl-sharded"):
        want = set(jrecs[k]) - {"compile_ns"}
        assert want <= set(recs[k]), (k, want - set(recs[k]))
        assert set(recs[k]) - set(jrecs[k]) == {"wait_ns"}
        for f in ("rows", "batch", "m", "states", "iterations",
                  "states_explored", "dedup_hits", "frontier_peak",
                  "frontier_curve"):
            assert recs[k][f] == jrecs[k][f], (k, f)
    assert recs["wgl-sharded"]["devices"] == 1
    assert recs["wgl-sharded"]["device_entries"] == \
        jrecs["wgl-sharded"]["device_entries"]
    assert recs["wgl-sharded"]["balance"] == 1.0
    for k in ("scc", "elle-append"):
        assert set(recs[k]) == set(jrecs[k]), k
    for f in ("nodes", "edges"):
        assert recs["scc"][f] == jrecs["scc"][f]
    for f in ("txns", "edges"):
        assert recs["elle-append"][f] == jrecs["elle-append"][f]
    assert recs["elle-append"]["encode_ns"] > 0
    assert recs["elle-append"]["compute_ns"] > 0


def test_rw_register_record(fresh):
    from jepsen_tpu_torch.gpu import elle, synth

    res = elle.check_rw_register(synth.rw_register_history(400, seed=5),
                                 {"engine": "device", "device": "cpu"})
    recs = [r for r in fresh.records() if r["kernel"] == "elle-rw"]
    assert len(recs) == 1 and res["txn-count"] == recs[0]["txns"]
    assert recs[0]["edges"] == res["edge-count"]
    assert recs[0]["encode_ns"] > 0 and recs[0]["compute_ns"] > 0


# ---------------------------------------------------------------------------
# cost fields: the shape formulas
# ---------------------------------------------------------------------------

def test_wgl_cost_fields_equal_the_shape_formula(fresh):
    import chip_smoke
    import torch

    from jepsen_tpu_torch.gpu import profiler, wgl
    from jepsen_tpu_torch.gpu.kernels import wgl_search as ws

    encs = _encs(PORT, n=3, ops=80, seed0=11)
    wgl.check_batch(encs, W=32, F=64, device="cpu")
    (rec,) = [r for r in fresh.records() if r["kernel"] == "wgl"]
    pb = wgl.PackedBatch(encs)
    rows = [(i, e.init_state) for i, e in enumerate(encs)]
    packed, rs, s0 = pb.tensors(*pb.rows(rows), torch.device("cpu"))
    kw = dict(W=32, F=64, max_iters=pb.M + 4, reach=False,
              crash_free=not pb.has_crashed)
    out = ws.wgl_search(packed, rs, s0, **kw)
    n_it = int(out[-4])
    live = int(out[-3][:n_it].sum())
    gen = int(out[-2][:n_it].sum() + out[-1][:n_it].sum())
    entries = sum(e.m for e in encs)
    held = sum(t.numel() * t.element_size()
               for t in (*packed, rs, s0, *out))
    want = profiler.wgl_cost(entries, pb.S, rs.numel(), pb.M + 4, 32,
                             live, gen, held)
    assert {k: rec[k] for k in profiler.COST_FIELDS} == want
    assert want["bytes_accessed"] == (
        entries * 4 * (3 + pb.S) + rs.numel() * 14 + 12 * (pb.M + 4))
    # the bytes and operations of chip_smoke's bound for this launch
    nbytes, ops, _ms = chip_smoke._launch_bound(packed, rs, kw, out)
    assert (rec["bytes_accessed"], rec["flops"]) == (nbytes, ops)


def test_scc_cost_fields_equal_the_shape_formula(fresh):
    from jepsen_tpu_torch.gpu import scc

    n, src, dst = _graph(1500, 21_000, seed=4)
    scc.Edges(n, src, dst, device="cpu").scc()
    (rec,) = [r for r in fresh.records() if r["kernel"] == "scc"]
    assert rec["flops"] is None
    assert rec["bytes_accessed"] == 9 * 21_000 + 4 * (n + 3)
    # the plain version takes no launcher scratch
    assert rec["peak_memory_bytes"] == rec["bytes_accessed"]
    c = mod(PORT, "telemetry").get().counters()
    assert c["profiler.scc.bytes"] == rec["bytes_accessed"]
    assert "profiler.scc.flops" not in c


def test_record_phases_present(fresh):
    from jepsen_tpu_torch.gpu import wgl

    wgl.check_batch(_encs(PORT), device="cpu")
    (rec,) = [r for r in fresh.records() if r["kernel"] == "wgl"]
    for ph in ("h2d_ns", "dispatch_ns", "compute_ns", "d2h_ns"):
        assert rec.get(ph, 0) > 0, ph
    # on the CPU the compute phase is the host wait
    assert rec["compute_ns"] == rec["wait_ns"]
    assert rec["t1"] > rec["t0"] and rec["iterations"] > 0
    assert len(rec["frontier_curve"]) <= 32


# ---------------------------------------------------------------------------
# cache and compile accounting
# ---------------------------------------------------------------------------

def test_cache_hit_miss_across_repeated_buckets(fresh):
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.gpu import wgl

    wgl.check_batch(_encs(PORT, n=1, seed0=1), device="cpu")
    assert fresh.cache_stats["wgl"] == {"hits": 0, "misses": 1}
    wgl.check_batch(_encs(PORT, n=1, seed0=2), device="cpu")
    assert fresh.cache_stats["wgl"] == {"hits": 1, "misses": 1}
    wgl.check_batch(_encs(PORT, n=1, ops=200, seed0=3), device="cpu")
    assert fresh.cache_stats["wgl"]["misses"] == 2
    c = telemetry.get().counters()
    assert (c["profiler.wgl.compile.hit"], c["profiler.wgl.compile.miss"]) \
        == (1, 2)
    assert telemetry.get().gauges()["profiler.wgl.bucket_cardinality"] == 2
    assert any(b[0] == (2, 64) for b in fresh.shape_buckets()["wgl"])


def test_compile_ns_is_the_librarys_load_on_the_first_launch(fresh,
                                                              monkeypatch):
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.gpu import scc, wgl
    from jepsen_tpu_torch.gpu.kernels import build

    monkeypatch.setattr(build, "_load_ns", {"wgl_search": 123_456,
                                            "scc": 654_321})
    for seed in (1, 2):
        wgl.check_batch(_encs(PORT, n=1, seed0=seed), device="cpu")
    n, src, dst = _graph()
    scc.Edges(n, src, dst, device="cpu").scc()
    recs = fresh.records()
    assert [r.get("compile_ns") for r in recs if r["kernel"] == "wgl"] \
        == [123_456, None]
    assert [r.get("compile_ns") for r in recs if r["kernel"] == "scc"] \
        == [654_321]
    c = telemetry.get().counters()
    assert c["profiler.wgl.compile_ns"] == 123_456
    assert c["wgl.kernel.compiles"] == 1
    assert build.take_load_ns("wgl_search") is None


def test_scc_failure_unclaims_bucket(fresh, monkeypatch):
    from jepsen_tpu_torch.gpu import scc
    from jepsen_tpu_torch.gpu.kernels import scc as kscc

    def boom(*a, **k):
        raise RuntimeError("scc launch failed: CUDA error 2")

    n, src, dst = _graph()
    bucket = ("scc", n, len(src), "cpu")
    fresh.bucket_unclaim("scc", bucket)
    monkeypatch.setattr(kscc, "scc_labels", boom)
    with pytest.raises(RuntimeError):
        scc.Edges(n, src, dst, device="cpu").scc()
    assert fresh.cache_stats["scc"] == {"hits": 0, "misses": 1}
    assert fresh.bucket_fresh("scc", bucket) is True
    # the failed launch still aggregates, as in the JAX package
    assert [r["kernel"] for r in fresh.records()] == ["scc"]


def test_wgl_failure_unclaims_bucket(fresh, monkeypatch):
    from jepsen_tpu_torch.gpu import wgl

    def boom(*a, **k):
        raise RuntimeError("wgl_search launch failed: CUDA error 2")

    monkeypatch.setattr(wgl, "_run", boom)
    with pytest.raises(RuntimeError):
        wgl.check_batch(_encs(PORT, n=1), device="cpu")
    assert not wgl._compiled_buckets
    monkeypatch.undo()
    wgl.check_batch(_encs(PORT, n=1), device="cpu")
    assert fresh.cache_stats["wgl"] == {"hits": 0, "misses": 2}


# ---------------------------------------------------------------------------
# recorder guards, against the JAX package's recorder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("root", ROOTS)
def test_straggler_record_dropped_after_reset(root):
    fresh_state(root)
    telemetry = mod(root, "telemetry")
    p = mod(root, "tpu.profiler").Profiler()
    rec = p.begin("wgl", bucket=("b",))
    telemetry.reset()
    p.finish(rec)
    assert p.records() == []
    assert not [s for s in telemetry.get().events()
                if s["name"].startswith("kernel:")]
    assert "profiler.wgl.launches" not in telemetry.get().counters()


@pytest.mark.parametrize("root", ROOTS)
def test_disabled_profiler_is_noop(root):
    fresh_state(root)
    profiler = mod(root, "tpu.profiler")
    telemetry = mod(root, "telemetry")
    p = profiler.Profiler(enabled=False)
    rec = p.begin("wgl")
    p.cache_event("wgl", True)
    p.record_host("pack", 100, entries=5)
    p.finish(rec)
    assert p.records() == [] and p.cache_stats == {}
    cost = p.bucket_cost(("b",), lambda: 1 / 0, True)
    assert cost == {k: None for k in profiler.COST_FIELDS}
    assert not [c for c in telemetry.get().counters()
                if c.startswith("profiler.")]


def span_cap(root, monkeypatch):
    fresh_state(root)
    monkeypatch.setenv("JEPSEN_TPU_PROFILE_MAX_SPANS", "3")
    telemetry = mod(root, "telemetry")
    p = mod(root, "tpu.profiler").Profiler()
    for _ in range(5):
        p.finish(p.begin("wgl"))
    spans = [s for s in telemetry.get().events()
             if s["name"] == "kernel:wgl"]
    c = telemetry.get().counters()
    return len(spans), c["profiler.wgl.spans_dropped"], \
        c["profiler.wgl.launches"]


def test_span_mirror_cap_counts_drops(monkeypatch):
    got = span_cap(PORT, monkeypatch)
    assert got == span_cap("jepsen_tpu", monkeypatch) == (3, 2, 5)
    from jepsen_tpu_torch.gpu import profiler

    monkeypatch.delenv("JEPSEN_TPU_PROFILE_MAX_SPANS")
    assert profiler.max_mirrored_launches() == \
        profiler.MAX_MIRRORED_LAUNCHES == 64


@pytest.mark.parametrize("root", ROOTS)
def test_bucket_unclaim_re_fresh(root):
    fresh_state(root)
    p = mod(root, "tpu.profiler").Profiler()
    assert p.bucket_fresh("scc", ("x",)) is True
    assert p.bucket_fresh("scc", ("x",)) is False
    p.bucket_unclaim("scc", ("x",))
    assert p.bucket_fresh("scc", ("x",)) is True
    assert p.cache_stats["scc"] == {"hits": 1, "misses": 2}


@pytest.mark.parametrize("root", ROOTS)
def test_pending_overflow_finalizes_every_stray(root):
    fresh_state(root)
    p = mod(root, "tpu.profiler").Profiler()
    objs = [object() for _ in range(257)]
    for o in objs:
        p.attach(o, p.begin("wgl"))
    p.attach(object(), p.begin("wgl"))  # trips the sweep
    assert len(p.records()) == 257
    c = mod(root, "telemetry").get().counters()
    assert c["profiler.wgl.launches"] == 257


def test_an_abandoned_launch_is_swept_and_its_drain_still_works(fresh):
    """A launch whose record the pending sweep finalized drains without
    its record: the verdicts come back and nothing raises."""
    from jepsen_tpu_torch.gpu import wgl

    encs = _encs(PORT, n=2)
    pb = wgl.PackedBatch(encs)
    out = wgl._launch(pb, [(0, encs[0].init_state)], 32, 64, False,
                      __import__("torch").device("cpu"))
    alive = [object() for _ in range(257)]
    for o in alive:
        fresh.attach(o, fresh.begin("wgl"))
    assert fresh.take(out) is None
    assert int(wgl._drain(out, reach=False)[0]) == wgl.VALID


def test_records_mirror_into_kernel_spans(fresh):
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.gpu import wgl

    wgl.check_batch(_encs(PORT), device="cpu")
    spans = [s for s in telemetry.get().events()
             if s["name"] == "kernel:wgl"]
    assert len(spans) == 1
    assert spans[0]["attrs"]["bytes_accessed"] > 0
    assert spans[0]["attrs"]["iterations"] > 0


# ---------------------------------------------------------------------------
# scaling helpers: the JAX package's answers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("times", [
    {1: 8.0, 2: 4.0, 4: 2.0, 8: 1.0}, {1: 3.77, 2: 3.43, 4: 3.29, 8: 3.43},
    {2: 1.0}, {}])
def test_parallel_efficiency_equal(times):
    got = mod(PORT, "tpu.profiler").parallel_efficiency(times)
    assert got == mod("jepsen_tpu", "tpu.profiler").parallel_efficiency(
        times)


@pytest.mark.parametrize("eff", [{1: 1.0, 2: 0.9, 4: 0.3, 8: 0.14},
                                 {1: 1.0, 8: 0.9}])
def test_check_efficiency_equal(eff):
    out = {}
    for root in ROOTS:
        msgs = []
        bad = mod(root, "tpu.profiler").check_efficiency(eff,
                                                         log=msgs.append)
        out[root] = (bad, msgs)
    assert out[PORT] == out["jepsen_tpu"]


@pytest.mark.parametrize("work", [[40, 40, 40, 40], [80, 40], [], [0, 0],
                                  [7]])
def test_work_balance_equal(work):
    assert mod(PORT, "tpu.profiler").work_balance(work) == \
        mod("jepsen_tpu", "tpu.profiler").work_balance(work)


# ---------------------------------------------------------------------------
# the profile report and the Prometheus text: the JAX module's output
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_run():
    """The port's telemetry events and metrics after the workload."""
    fresh_state(PORT)
    workload(PORT)
    tel = mod(PORT, "telemetry").get()
    return tel.events(), tel.metrics()


def both_reports(name):
    return (mod(PORT, "reports.profile"),
            mod("jepsen_tpu", "reports.profile"))


@pytest.mark.parametrize("fn", ["kernel_stats", "kernel_rows",
                                "profile_html"])
def test_report_tables_equal(port_run, fn):
    _events, metrics = port_run
    t, j = both_reports(fn)
    assert getattr(t, fn)(metrics) == getattr(j, fn)(metrics)
    assert getattr(t, fn)(metrics)


def test_profile_text_equal(port_run):
    events, metrics = port_run
    t, j = both_reports("profile_text")
    text = t.profile_text(events, metrics)
    assert text == j.profile_text(events, metrics)
    assert "wgl-sharded" in text and "Slowest launches" in text
    assert t.slowest_launches(events, 3) == j.slowest_launches(events, 3)
    assert t.profile_text([], {}) == j.profile_text([], {})
    assert t.profile_html({}) == ""


@pytest.mark.parametrize("run", [None, "reg/20260803", 'we"ird\\run'])
def test_prometheus_text_equal(port_run, run):
    _events, metrics = port_run
    t, j = both_reports("prometheus_text")
    text = t.prometheus_text(metrics, run=run)
    assert text == j.prometheus_text(metrics, run=run)
    assert t.validate_prometheus_text(text) == \
        j.validate_prometheus_text(text) > 5
    assert "jepsen_tpu_profiler_wgl_launches" in text


@pytest.mark.parametrize("bad", ["jepsen bad line", "x{a=b} 1",
                                 "x 1 2"])
def test_prometheus_validator_rejects_equally(bad):
    t, j = both_reports("validate_prometheus_text")
    with pytest.raises(ValueError):
        j.validate_prometheus_text(bad)
    with pytest.raises(ValueError):
        t.validate_prometheus_text(bad)


def test_metrics_json_validates(port_run, tmp_path):
    from jepsen_tpu_torch import telemetry

    _events, metrics = port_run
    p = tmp_path / "metrics.json"
    p.write_text(json.dumps(metrics))
    assert telemetry.validate_metrics(json.loads(p.read_text())) > 0


# ---------------------------------------------------------------------------
# the bench ledger: the JAX module's answers
# ---------------------------------------------------------------------------

def entry(rnd, hl=70000.0, **kernels):
    return {"round": rnd, "ts": 1000.0 + rnd,
            "headline": {"metric": "m", "value": hl, "unit": "ops/s"},
            "kernels": {k: ({"value": v, "higher_is_better": True}
                            if isinstance(v, (int, float)) else v)
                        for k, v in kernels.items()}}


def ledgers():
    return mod(PORT, "ledger"), mod("jepsen_tpu", "ledger")


@pytest.mark.parametrize("values,kw", [
    ([100.0, 100.0, 90.0, 81.0, 72.9], {}),
    ([100.0, 96.0, 104.0, 99.0, 101.0], {}),
    ([100.0, 85.0, 100.0], {}), ([100.0, 50.0], {}),
    ([10.0, 10.0, 11.1, 12.3, 13.7], {"higher_is_better": False}),
    ([13.7, 12.3, 11.1, 10.0, 10.0], {"higher_is_better": False}),
    ([5.0] * 9, {"window": 3, "threshold": 0.01})])
def test_slow_bleed_and_ewma_equal(values, kw):
    t, j = ledgers()
    assert t.slow_bleed(values, **kw) == j.slow_bleed(values, **kw)
    assert t.ewma(values) == j.ewma(values)


def test_detect_and_kernel_series_equal():
    t, j = ledgers()
    entries = [entry(i + 1, wgl=100.0 * (0.9 ** max(0, i - 1)),
                     elle=50.0 + (i % 2)) for i in range(5)]
    assert t.detect(entries) == j.detect(entries)
    assert t.detect(entries)["wgl"]["bleeding"] is True
    for name in ("wgl", "elle", "absent"):
        assert t.kernel_series(entries, name) == \
            j.kernel_series(entries, name)


def test_append_read_validate_equal(tmp_path):
    t, j = ledgers()
    out = {}
    for lib, d in ((t, tmp_path / "t"), (j, tmp_path / "j")):
        d.mkdir()
        path = d / lib.LEDGER_FILE
        for i in range(3):
            lib.append_entry(path, entry(i + 1, wgl=100.0))
        lib.append_entry(path, {k: v for k, v in entry(4).items()
                                if k != "ts"} | {"ts": 7.0})
        entries = lib.read_entries(path)
        with open(path, "a") as f:
            f.write('{"round": 5, "ts"')
        out[lib.__name__] = (path.read_bytes(), entries,
                             lib.validate_entries(entries),
                             lib.next_round(entries),
                             lib.next_round(entries, floor=9),
                             lib.read_entries(path))
    assert out["jepsen_tpu_torch.ledger"] == out["jepsen_tpu.ledger"]
    assert out["jepsen_tpu.ledger"][2] == 4
    assert t.LEDGER_FILE == j.LEDGER_FILE and t.REQUIRED == j.REQUIRED


def _bad_entries():
    good = entry(1)
    no_headline = entry(2)
    no_headline["headline"] = {"metric": "m"}
    bad_kernel = entry(2)
    bad_kernel["kernels"] = {"wgl": {"value": "fast"}}
    bad_search = entry(2) | {"search": {"peak": "x"}}
    bad_fleet = entry(2) | {"fleet": {"occupancy": {"slice": 2.0}}}
    return [[good, entry(1)], [{"round": 1, "ts": 1.0}], [no_headline],
            [bad_kernel], [bad_search], [bad_fleet], ["not a dict"]]


@pytest.mark.parametrize("entries", _bad_entries())
def test_validate_rejects_equally(entries):
    t, j = ledgers()
    with pytest.raises(ValueError) as je:
        j.validate_entries(entries)
    with pytest.raises(ValueError) as te:
        t.validate_entries(entries)
    assert str(te.value) == str(je.value)


def test_new_modules_are_held_by_the_import_rule():
    import test_torch_package as tp

    names = {str(p.relative_to(tp.ROOT)) for p in tp.PORT_FILES}
    assert {"jepsen_tpu_torch/gpu/profiler.py",
            "jepsen_tpu_torch/reports/trace.py",
            "jepsen_tpu_torch/reports/profile.py",
            "jepsen_tpu_torch/ledger.py"} <= names


# ---------------------------------------------------------------------------
# chip_smoke's phase 23 on the CPU, at a small size
# ---------------------------------------------------------------------------

def test_chip_smoke_phase_23_on_the_cpu(tmp_path):
    """Phase 23's profiled runs, reports, fleet trace, sweeps and ledger
    on the CPU (the card's checks of kernel events and CUDA-event times
    apply on the card only)."""
    import torch

    import chip_smoke
    from test_torch_trace import exports_fixture

    out = chip_smoke.profiler_path(
        torch.device("cpu"), False, exports_fixture(PORT),
        # 3,000 txns infer ~33,000 edges: past DEVICE_MIN_EDGES whatever
        # the interleaving (2,000 give ~20,000, either side of it)
        {"register_keys": 4, "register_concurrency": 10,
         "txn_ops": 3_000, "bank_ops": 2_000, "nemesis_ops": 2},
        {"reps": 1, "scc_edges": (2_500,), "bank_reads": (1_250,),
         "wgl_m": (1_024,)})
    # the bank run's ~1,000 reads stay under DEVICE_MIN_READS
    assert out == {"wgl_search": {"profiled-register": 1},
                   "scc": {"profiled-list-append": 1},
                   "bank_reduce": {"profiled-bank": 0}}
    kernels = [{"name": n, "ms": None, "plain_ms": 1.5}
               for n in ("wgl_search", "scc", "bank_reduce")]
    assert chip_smoke.ledger_entries(kernels, 0.5, False) == 3


def test_chip_smoke_headline_profile_on_the_cpu():
    import chip_smoke

    from jepsen_tpu_torch.gpu import profiler, wgl

    fresh_state(PORT)
    enc = _encs(PORT, n=1, ops=600, seed0=5)[0]
    res = wgl.check_segmented(enc, target_len=128, device="cpu")
    assert res["valid?"] is True
    by_kernel = chip_smoke.headline_profile(profiler.get().records(), [],
                                            0, False)
    assert set(by_kernel) == {"wgl-reach"}
    assert all(r["compute_ns"] == r["wait_ns"]
               for r in by_kernel["wgl-reach"])
