"""Parity of the port's reports of an invalid result with the JAX
package's on the CPU: the counterexample SVG and trace excerpt of the
linearizable checker (`Linearizable._explain`), the elle/ anomaly files,
cycle plots and trace excerpts of the cycle checkers (`_with_artifacts`),
and the functions of reports/explain.py one by one.

Each case runs both packages' checkers over the same seeded history, each
into its own store directory, with and without the same synthetic
optrace.jsonl and nodes.jsonl (nodes.jsonl with a torn trailing line).
The directories must hold the same file names with the same bytes, and
the results must be equal once the store directory's prefix of every
path is replaced. Everything is exact."""

import copy
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu import independent as jind
from jepsen_tpu import nodeprobe as jnodeprobe
from jepsen_tpu import store as jstore
from jepsen_tpu import telemetry as jtel
from jepsen_tpu import tracing as jtracing
from jepsen_tpu.checker import cycle as jcycle
from jepsen_tpu.checker import models as jmodels
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import op as jop
from jepsen_tpu.reports import explain as jexplain
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu_torch import checker as pchecker
from jepsen_tpu_torch import independent as pind
from jepsen_tpu_torch import nodeprobe as pnodeprobe
from jepsen_tpu_torch import store as pstore
from jepsen_tpu_torch import telemetry as ptel
from jepsen_tpu_torch import tracing as ptracing
from jepsen_tpu_torch.checker import cycle as pcycle
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.gpu import synth as psynth
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import op as pop
from jepsen_tpu_torch.reports import explain as pexplain

torch.set_num_threads(1)

CPU = {"device": "cpu"}
RENAME = {"tpu": "gpu", "tpu-segmented": "gpu-segmented",
          "tpu-extend": "gpu-extend",
          "tpu+host-fallback": "gpu+host-fallback"}


def norm(x, store_dir=None):
    """A result tree with ops as to_dict(), models as repr, the JAX
    analyzer names as the port's, and `store_dir` in every path replaced
    by '<store>'."""
    if isinstance(x, dict):
        return {k: (RENAME.get(v, v) if k == "analyzer"
                    else norm(v, store_dir)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v, store_dir) for v in x]
    if hasattr(x, "to_dict") and hasattr(x, "index"):
        return {"op": norm(x.to_dict(), store_dir)}
    if type(x).__module__.endswith(".models"):
        return {"model": repr(x)}
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, str) and store_dir is not None:
        return x.replace(str(store_dir), "<store>")
    return x


def files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(Path(d).rglob("*")) if p.is_file()}


def jax_twin(ph):
    """The JAX package's history with the port history's ops."""
    return JHistory([jop(**copy.deepcopy(o.to_dict())) for o in ph],
                    assign_indices=False)


def write_traces(d: Path, hist, seed: int) -> None:
    """A synthetic optrace.jsonl and nodes.jsonl for `hist` in d: trace
    records for most invocations (some with more than the excerpt's 12
    records, some with none), node events across the run (a burst of
    more than 16 in one window), and a torn trailing line in
    nodes.jsonl."""
    rng = random.Random(seed)
    recs, span = [], 0
    for o in hist:
        if o.type != "invoke" or rng.random() < 0.1:
            continue
        t = 1_000_000 * o.index
        n = 14 if rng.random() < 0.05 else rng.randint(1, 4)
        for j in range(n):
            span += 1
            kind = ("op", "client", "remote", "event")[min(j, 3)]
            rec = {"span": span, "trace": o.index, "op": o.index,
                   "kind": kind, "name": f"{kind}-{j}",
                   "t0": t + 1000 * j, "t1": t + 1000 * j + 700_000}
            if kind == "remote":
                rec["attrs"] = {"node": f"n{j % 3}", "exit": 0,
                                "cmd": "echo " + "x" * 60}
            elif kind == "client":
                rec["attrs"] = {"retries": rng.randint(0, 2),
                                "type": "ok"}
                rec["status"] = "ok"
            elif kind == "event":
                rec["attrs"] = {"error": "reset"}
            recs.append(rec)
    recs.append({"span": span + 1, "kind": "event", "name": "free",
                 "t0": 5, "t1": 5})
    (d / "optrace.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    t_end = 1_000_000 * len(hist)
    nodes = []
    for i in range(40):
        t = rng.randrange(0, t_end + 1)
        kind = rng.choice(["sample", "log", "gap", "breaker"])
        rec = {"kind": kind, "node": f"n{i % 3}", "t": t}
        if kind == "log":
            rec.update({"class": "election", "ts": "observed",
                        "line": "leader changed " + "y" * 150})
        elif kind == "gap":
            rec["reason"] = "unreachable"
        elif kind == "breaker":
            rec["state"] = "open"
        nodes.append(rec)
    burst = rng.randrange(0, t_end + 1)
    nodes += [{"kind": "log", "node": "n1", "t": burst + k,
               "class": "oom-kill", "ts": "observed", "line": "killed"}
              for k in range(20)]
    (d / "nodes.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in nodes)
        + '{"kind": "log", "node": "n0", "t')


def dirs(tmp_path, traced: bool, hist, seed: int = 1):
    jd, pd = tmp_path / "jax", tmp_path / "port"
    for d in (jd, pd):
        d.mkdir()
        if traced:
            write_traces(d, hist, seed)
    return jd, pd


def assert_same_dirs(jd, pd, jres, pres, want_files=True):
    jf, pf = files(jd), files(pd)
    assert sorted(pf) == sorted(jf)
    for name in jf:
        assert pf[name] == jf[name], name
    assert norm(pres, pd) == norm(jres, jd)
    if want_files:
        assert len(jf) > (2 if "optrace.jsonl" in jf else 0)


# ---------------------------------------------------------------------------
# The linearizable checker
# ---------------------------------------------------------------------------

def register_twins(n_ops, seed, frac, n_procs=4, crash_p=0.0):
    kw = dict(n_procs=n_procs, seed=seed, crash_p=crash_p)
    ph = psynth.register_history(n_ops, **kw)
    jh = jsynth.register_history(n_ops, **kw)
    if frac is not None:
        ph = psynth.corrupt_register_history(ph, at_frac=frac)[0]
        jh = jsynth.corrupt_register_history(jh, at_frac=frac)[0]
    return jh, ph


def lin_pair():
    return (jchecker.linearizable({"model": jmodels.cas_register()}),
            pchecker.linearizable({"model": pmodels.cas_register(), **CPU}))


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("n_ops,frac,crash_p", [
    (300, 0.2, 0.0), (300, 0.5, 0.0), (300, 0.85, 0.0), (150, 0.3, 0.15)],
    ids=["0.2", "0.5", "0.85", "0.3-crashed"])
def test_linearizable_writes_the_same_counterexample(tmp_path, n_ops, frac,
                                                     crash_p, traced):
    """The crashed case is resolved by the host search (its configs come
    from search_host); an invalid crashed history is kept short, since
    that search is exponential in the pending crashed writes."""
    jh, ph = register_twins(n_ops, 5, frac, crash_p=crash_p)
    jd, pd = dirs(tmp_path, traced, ph)
    jc, pc = lin_pair()
    jres = jc.check({"store_dir": str(jd)}, jh)
    pres = pc.check({"store_dir": str(pd)}, ph)
    assert pres["valid?"] is False
    assert Path(pres["counterexample-svg"]).read_text().startswith("<svg")
    assert ("trace-excerpt" in pres) is traced
    assert_same_dirs(jd, pd, jres, pres)


def test_segmented_counterexample_names_its_segment(tmp_path):
    """A history past SEGMENT_MIN_M entries: the SVG carries the failed
    segment and its range."""
    jh, ph = register_twins(5500, 8, 0.6, n_procs=5)
    jd, pd = dirs(tmp_path, True, ph)
    jc, pc = lin_pair()
    jres = jc.check({"store_dir": str(jd)}, jh)
    pres = pc.check({"store_dir": str(pd)}, ph)
    assert pres["analyzer"] == "gpu-segmented"
    assert "failed segment" in Path(pres["counterexample-svg"]).read_text()
    assert_same_dirs(jd, pd, jres, pres)


def test_valid_history_writes_nothing(tmp_path):
    jh, ph = register_twins(300, 5, None)
    jd, pd = dirs(tmp_path, True, ph)
    jc, pc = lin_pair()
    jres = jc.check({"store_dir": str(jd)}, jh)
    pres = pc.check({"store_dir": str(pd)}, ph)
    assert pres["valid?"] is True
    assert sorted(files(pd)) == ["nodes.jsonl", "optrace.jsonl"]
    assert_same_dirs(jd, pd, jres, pres, want_files=False)


def fold_keys(hists, History, op):
    """One multi-key history out of single-key ones (key k = hists[k])."""
    events = sorted(((o.time, k, o) for k, h in enumerate(hists)
                     for o in h), key=lambda e: (e[0], e[1]))
    return History([op(index=i, time=i, type=o.type,
                       process=k * 1000 + o.process, f=o.f,
                       value=(k, o.value))
                    for i, (_t, k, o) in enumerate(events)],
                   assign_indices=False)


def keyed_twins(n_keys, n_ops, bad, frac=0.5):
    js, ps = [], []
    for k in range(n_keys):
        jh, ph = register_twins(n_ops, 300 + k, frac if k in bad else None,
                                n_procs=3)
        js.append(jh)
        ps.append(ph)
    return fold_keys(js, JHistory, jop), fold_keys(ps, PHistory, pop)


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
def test_independent_keys_share_one_store_dir(tmp_path, traced):
    jh, ph = keyed_twins(6, 120, bad=(1, 4))
    jd, pd = dirs(tmp_path, traced, ph)
    jres = jind.checker(jchecker.linearizable(
        {"model": jmodels.cas_register()})).check({"store_dir": str(jd)}, jh)
    pres = pind.checker(pchecker.linearizable(
        {"model": pmodels.cas_register(), **CPU})).check(
        {"store_dir": str(pd)}, ph)
    assert pres["failures"] == [1, 4]
    svgs = {pres["results"][k]["counterexample-svg"] for k in (1, 4)}
    assert len(svgs) == 2 and all(Path(p).exists() for p in svgs)
    assert_same_dirs(jd, pd, jres, pres)


@pytest.mark.parametrize("algorithm", ["gpu", "wgl"])
def test_check_batch_explains_every_history(tmp_path, algorithm):
    """Both branches of check_batch: the batched search and the per-
    history one."""
    pairs = [register_twins(200, 40 + i, 0.5 if i % 2 else None)
             for i in range(4)]
    jd, pd = dirs(tmp_path, True, pairs[1][1])
    jc = jchecker.linearizable({"model": jmodels.cas_register(),
                                "algorithm": {"gpu": "tpu"}.get(
                                    algorithm, algorithm)})
    pc = pchecker.linearizable({"model": pmodels.cas_register(),
                                "algorithm": algorithm, **CPU})
    jres = jc.check_batch({"store_dir": str(jd)}, [j for j, _ in pairs])
    pres = pc.check_batch({"store_dir": str(pd)}, [p for _, p in pairs])
    assert [r["valid?"] for r in pres] == [True, False, True, False]
    assert all("counterexample-svg" in r for r in pres[1::2])
    assert_same_dirs(jd, pd, jres, pres)


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
def test_extend_path_explains(tmp_path, traced):
    jh, ph = register_twins(300, 9, 0.5)
    jd, pd = dirs(tmp_path, traced, ph)
    jc, pc = lin_pair()
    jres = jc.check({"store_dir": str(jd), "extend?": True}, jh)
    pres = pc.check({"store_dir": str(pd), "extend?": True}, ph)
    assert pres["valid?"] is False and "counterexample-svg" in pres
    assert_same_dirs(jd, pd, jres, pres)


def test_rendering_failure_is_logged_not_raised(tmp_path, monkeypatch,
                                                caplog):
    _jh, ph = register_twins(300, 5, 0.5)

    def boom(*_a, **_k):
        raise OSError("disk full")

    monkeypatch.setattr(pexplain, "render_linear_svg", boom)
    res = pchecker.linearizable({"model": pmodels.cas_register(),
                                 **CPU}).check({"store_dir": str(tmp_path)},
                                               ph)
    assert res["valid?"] is False and "counterexample-svg" not in res
    assert "rendering linear counterexample failed" in caplog.text


# ---------------------------------------------------------------------------
# The cycle checkers
# ---------------------------------------------------------------------------

G0 = [("invoke", 0, [["append", "x", 1], ["append", "y", 1]]),
      ("invoke", 1, [["append", "x", 2], ["append", "y", 2]]),
      ("ok", 0, [["append", "x", 1], ["append", "y", 1]]),
      ("ok", 1, [["append", "x", 2], ["append", "y", 2]]),
      ("invoke", 2, [["r", "x", None], ["r", "y", None]]),
      ("ok", 2, [["r", "x", [1, 2]], ["r", "y", [2, 1]]])]


def elle_case(name):
    """(family, port history) of one invalid elle case."""
    if name == "g0":
        return "list-append", PHistory([pop(type=t, process=p, f="txn",
                                            value=m) for t, p, m in G0])
    family, seed, frac = {
        "append-g2-item": ("list-append", 1, 0.6),
        "append-g-single-g1b": ("list-append", 3, 0.6),
        "wr-g1c": ("rw-register", 0, 0.3),
        "wr-g1c-process": ("rw-register", 2, 0.6)}[name]
    if family == "list-append":
        ph = psynth.corrupt_list_append_history(
            psynth.list_append_history(400, seed=seed), at_frac=frac)[0]
    else:
        ph = psynth.corrupt_rw_register_history(
            psynth.rw_register_history(400, seed=seed), at_frac=frac)[0]
    return family, ph


ELLE_CASES = ["g0", "append-g2-item", "append-g-single-g1b", "wr-g1c",
              "wr-g1c-process"]


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("engine", ["auto", "device"])
@pytest.mark.parametrize("name", ELLE_CASES)
def test_cycle_checkers_write_the_same_artifacts(tmp_path, name, engine,
                                                 traced):
    """Under the auto engine these sizes take the host engine; the
    device engine builds its anomaly records from tensors."""
    family, ph = elle_case(name)
    jh = jax_twin(ph)
    jd, pd = dirs(tmp_path, traced, ph)
    make_j, make_p = ((jcycle.append_checker, pcycle.append_checker)
                      if family == "list-append"
                      else (jcycle.wr_checker, pcycle.wr_checker))
    jres = make_j({"engine": engine}).check({"store_dir": str(jd)}, jh)
    pres = make_p({"engine": engine, **CPU}).check(
        {"store_dir": str(pd)}, ph)
    assert pres["valid?"] is False
    names = [Path(p).name for p in pres["artifacts"]]
    if name == "g0":
        assert any(n.startswith("G0-") and n.endswith(".txt")
                   for n in names)
    assert any(n.startswith("cycle-") for n in names)
    assert any("-trace-" in n for n in names) is traced
    assert_same_dirs(jd, pd, jres, pres)


def test_valid_elle_result_has_no_artifacts(tmp_path):
    ph = psynth.list_append_history(300, seed=2)
    res = pcycle.append_checker(CPU).check({"store_dir": str(tmp_path)},
                                           ph)
    assert res["valid?"] is True and "artifacts" not in res
    assert files(tmp_path) == {}


# ---------------------------------------------------------------------------
# reports/explain.py function by function, and the readers below it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def g0_results():
    ph = PHistory([pop(type=t, process=p, f="txn", value=m)
                   for t, p, m in G0])
    jh = jax_twin(ph)
    jres = jcycle.append_checker().check({}, jh)
    pres = pcycle.append_checker(CPU).check({}, ph)
    return jres, pres


@pytest.fixture(scope="module")
def linear_results():
    jh, ph = register_twins(300, 5, 0.5)
    jc, pc = lin_pair()
    return jc.check({}, jh), pc.check({}, ph), ph


@pytest.mark.parametrize("obj", [(1, "a"), [3, None, {"k": [1, 2]}],
                                 "x" * 100, ((1, 2), frozenset({3}))],
                         ids=["tuple", "list", "str", "nested"])
def test_fingerprint(obj):
    assert pexplain._fingerprint(obj) == jexplain._fingerprint(obj)


def test_write_elle_artifacts(tmp_path, g0_results):
    jres, pres = g0_results
    jd, pd = tmp_path / "j", tmp_path / "p"
    jp = jexplain.write_elle_artifacts(jd, jres, subdir="x")
    pp = pexplain.write_elle_artifacts(pd, pres, subdir="x")
    assert [Path(p).relative_to(pd) for p in pp] == \
        [Path(p).relative_to(jd) for p in jp]
    assert files(pd) == files(jd) != {}
    assert pexplain.write_elle_artifacts(pd, {"valid?": True}) == []


def _excerpt_inputs(d, ph, seed=3):
    """(trace records, node records) of write_traces(d, ph, seed)."""
    d.mkdir(exist_ok=True)
    write_traces(d, ph, seed)
    return (list(ptracing.read_records(d / "optrace.jsonl")),
            list(pnodeprobe.read_records(d / "nodes.jsonl")))


def test_trace_excerpt_and_node_context_lines(tmp_path, linear_results):
    _j, _p, ph = linear_results
    optrace, noderecs = _excerpt_inputs(tmp_path, ph)
    by_op = ptracing.by_op(optrace)
    assert by_op == jtracing.by_op(optrace)
    idxs = sorted(by_op)[:6] + [10 ** 6]
    assert pexplain.trace_excerpt_lines(by_op, idxs) == \
        jexplain.trace_excerpt_lines(by_op, idxs)
    for lo, hi in ((0, 10 ** 12), (5 * 10 ** 8, 6 * 10 ** 8), (-5, -4)):
        assert pexplain.node_context_lines(noderecs, lo, hi) == \
            jexplain.node_context_lines(noderecs, lo, hi)
        assert pexplain.node_context_lines(noderecs, lo, hi, 0) == \
            jexplain.node_context_lines(noderecs, lo, hi, 0)


def test_write_trace_excerpts(tmp_path, g0_results):
    jres, pres = g0_results
    jd, pd = tmp_path / "j", tmp_path / "p"
    ph = PHistory([pop(type=t, process=p, f="txn", value=m)
                   for t, p, m in G0])
    optrace, noderecs = _excerpt_inputs(tmp_path / "t", ph)
    for d in (jd, pd):
        d.mkdir()
    jp = jexplain.write_trace_excerpts(jd, jres, optrace=optrace,
                                       noderecs=noderecs)
    pp = pexplain.write_trace_excerpts(pd, pres, optrace=optrace,
                                       noderecs=noderecs)
    assert len(pp) == len(jp) > 0
    assert files(pd) == files(jd)
    # untraced: nothing is written
    assert pexplain.write_trace_excerpts(pd, pres, optrace=[]) == []


def test_write_linear_trace_excerpt(tmp_path, linear_results):
    jres, pres, ph = linear_results
    optrace, _n = _excerpt_inputs(tmp_path / "t", ph)
    jd, pd = tmp_path / "j", tmp_path / "p"
    for d in (jd, pd):
        d.mkdir()
    jp = jexplain.write_linear_trace_excerpt(jd, jres, optrace=optrace)
    pp = pexplain.write_linear_trace_excerpt(pd, pres, optrace=optrace)
    assert Path(pp).name == Path(jp).name
    assert files(pd) == files(jd)
    assert pexplain.write_linear_trace_excerpt(
        pd, {**pres, "valid?": True}, optrace=optrace) is None


def test_cycle_svg(g0_results):
    jres, pres = g0_results
    for (jname, jrecs), (pname, precs) in zip(
            sorted(jres["anomalies"].items()),
            sorted(pres["anomalies"].items())):
        for jr, pr in zip(jrecs, precs):
            if isinstance(pr, dict) and pr.get("steps"):
                assert pexplain._cycle_svg(pname, pr["steps"],
                                           pr.get("cycle")) == \
                    jexplain._cycle_svg(jname, jr["steps"],
                                        jr.get("cycle"))
    steps = [{"from": 1, "to": 2, "type": "ww"},
             {"from": 2, "to": 1, "type": "<wr>"}]
    assert pexplain._cycle_svg("G<1>", steps) == \
        jexplain._cycle_svg("G<1>", steps)


def test_render_linear_svg(tmp_path, linear_results):
    jres, pres, _ph = linear_results
    jp = jexplain.render_linear_svg(jres, tmp_path / "j" / "ce.svg")
    pp = pexplain.render_linear_svg(pres, tmp_path / "p" / "ce.svg")
    assert Path(pp).read_bytes() == Path(jp).read_bytes()
    assert pexplain.render_linear_svg({"valid?": True},
                                      tmp_path / "x.svg") is None
    assert not (tmp_path / "x.svg").exists()


def test_readers_drop_a_torn_trailing_line(tmp_path):
    _j, ph = register_twins(50, 1, None)
    write_traces(tmp_path, ph, 7)
    with open(tmp_path / "optrace.jsonl", "a") as f:
        f.write('{"span": 1, "ki')
    for name in ("optrace.jsonl", "nodes.jsonl"):
        assert list(ptel.read_jsonl(tmp_path / name)) == \
            list(jtel.read_jsonl(tmp_path / name)) != []
    assert pstore.load_optrace(tmp_path) == jstore.load_optrace(tmp_path)
    assert pstore.load_nodes(tmp_path) == jstore.load_nodes(tmp_path)
    assert pnodeprobe.load_records(tmp_path) == \
        jnodeprobe.load_records(tmp_path)
    assert pnodeprobe.load_records(None) == [] == \
        list(ptel.read_jsonl(tmp_path / "missing.jsonl"))
    assert ptracing.TRACE_FILE == jtracing.TRACE_FILE
    assert pnodeprobe.NODES_FILE == jnodeprobe.NODES_FILE


def test_describe():
    recs = [{"kind": "remote", "name": "exec", "t0": 10, "t1": 2_000_010,
             "status": "ok", "attrs": {"node": "n1", "exit": 1,
                                       "cmd": "c" * 80, "retries": 2}},
            {"kind": "event", "name": "net", "t0": 4, "t1": 4,
             "attrs": {"error": "x", "type": "partition"}},
            {"kind": "client", "name": None}]
    for r in recs:
        assert ptracing.describe(r) == jtracing.describe(r)


@pytest.mark.parametrize("test", [
    {"store_dir": "/x/y"},
    {"name": "reg", "start_time": "20260101T000000.0000"},
    {"name": "reg", "start_time": "20260101T000000.0000",
     "store_base": "/b"}], ids=["store-dir", "name", "base"])
def test_store_paths(test):
    assert pstore.path(test, "a", 1) == jstore.path(test, "a", 1)
    if "store_dir" not in test:
        assert pstore.test_dir(test) == jstore.test_dir(test)
        assert pstore.base_dir(test) == jstore.base_dir(test)
        assert pstore.dir_name(test) == jstore.dir_name(test)
