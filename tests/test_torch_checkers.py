"""Parity of the port's host checkers with the JAX package's on the CPU,
and of the slice as a whole: the register workload's composed checker
over a folded multi-key history with corrupted keys.

Histories are made from seeds by the functions below, once as port ops,
and handed to the JAX package as the same ops (jax_twin). Results are
compared exactly (ops by to_dict(), models by repr, store-directory
paths by their part below the directory); files byte for byte."""

import copy
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu import independent as jind
from jepsen_tpu.checker import models as jmodels
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import op as jop
from jepsen_tpu.reports import timeline as jtimeline
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu_torch import checker as pchecker
from jepsen_tpu_torch import independent as pind
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.gpu import synth as psynth
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import op as pop
from jepsen_tpu_torch.reports import timeline as ptimeline

torch.set_num_threads(1)

RENAME = {"tpu": "gpu", "tpu-segmented": "gpu-segmented",
          "tpu+host-fallback": "gpu+host-fallback"}


def norm(x, store_dir=None):
    if isinstance(x, dict):
        return {k: (RENAME.get(v, v) if k == "analyzer"
                    else norm(v, store_dir)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v, store_dir) for v in x]
    if hasattr(x, "to_dict") and hasattr(x, "index"):
        return {"op": norm(x.to_dict(), store_dir)}
    if type(x).__module__.endswith(".models"):
        # some models (the queues) have no repr of their own
        return {"model": type(x).__name__, **norm(vars(x))}
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, str) and store_dir is not None:
        return x.replace(str(store_dir), "<store>")
    return x


def files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(Path(d).rglob("*")) if p.is_file()}


def jax_twin(ph):
    return JHistory([jop(**copy.deepcopy(o.to_dict())) for o in ph],
                    assign_indices=False)


def history(events):
    """A port history of (type, process, f, value, extra) events, one
    millisecond apart."""
    return PHistory([pop(type=t, process=p, f=f, value=v, time=i * 10 ** 6,
                         **(x or {}))
                     for i, (t, p, f, v, x) in enumerate(events)])


def same(make_j, make_p, ph, test=None):
    """Both packages' checkers over the same history: (JAX, port)."""
    jres = make_j().check(dict(test or {}), jax_twin(ph), {})
    pres = make_p().check(dict(test or {}), ph, {})
    assert norm(pres) == norm(jres)
    return jres, pres


# ---------------------------------------------------------------------------
# Seeded histories
# ---------------------------------------------------------------------------

def set_events(seed, n=80, lose=0, dup=False, values=int):
    """Adds by four processes, reads by process 9 of the elements that
    took effect, and a final read; `lose` acknowledged elements vanish
    from the reads after the middle, `dup` repeats one element in a
    read."""
    rng = random.Random(seed)
    events, present, acked = [], [], []
    for i in range(n):
        p = rng.randrange(4)
        v = values(i)
        events.append(("invoke", p, "add", v, None))
        r = rng.random()
        if r < 0.8:
            present.append(v)
            acked.append(v)
            events.append(("ok", p, "add", v, None))
        elif r < 0.9:
            events.append(("fail", p, "add", v, None))
        else:
            if rng.random() < 0.5:
                present.append(v)
            events.append(("info", p, "add", v, None))
        if i == n // 2 and lose:
            for v in rng.sample(acked, lose):
                present.remove(v)
        if rng.random() < 0.3:
            seen = sorted(present, key=str)
            if dup and seen and i > n // 3:
                seen = seen + seen[:1]
                dup = False
            events += [("invoke", 9, "read", None, None),
                       ("ok", 9, "read", seen, None)]
    events += [("invoke", 9, "read", None, None),
               ("ok", 9, "read", sorted(present, key=str), None)]
    return events


def queue_events(seed, n=60, unexpected=False, drop=0, dup=False,
                 drain="ok"):
    rng = random.Random(seed)
    events, queued = [], []
    for i in range(n):
        p = rng.randrange(3)
        events.append(("invoke", p, "enqueue", i, None))
        if rng.random() < 0.9:
            queued.append(i)
            events.append(("ok", p, "enqueue", i, None))
        else:
            events.append(("fail", p, "enqueue", i, None))
        if queued and rng.random() < 0.4:
            v = queued.pop(rng.randrange(len(queued)))
            events += [("invoke", 5, "dequeue", None, None),
                       ("ok", 5, "dequeue", v, None)]
    for _ in range(drop):
        queued.pop(0)
    if unexpected:
        events += [("invoke", 5, "dequeue", None, None),
                   ("ok", 5, "dequeue", 10 ** 6, None)]
    if dup and events[-1][2] == "dequeue":
        events += [("invoke", 5, "dequeue", None, None),
                   ("ok", 5, "dequeue", events[-1][3], None)]
    events.append(("invoke", 6, "drain", None, None))
    if drain == "fail":
        events.append(("fail", 6, "drain", None, None))
    else:
        events.append((drain, 6, "drain", list(queued), None))
    return events


def counter_events(seed, n=60, bad=False):
    rng = random.Random(seed)
    events, lower = [], 0
    for i in range(n):
        if rng.random() < 0.6:
            d = rng.randint(1, 5)
            events.append(("invoke", 0, "add", d, None))
            t = rng.choice(["ok", "ok", "fail", "info"])
            events.append((t, 0, "add", d, None))
            if t == "ok":
                lower += d
        else:
            v = lower + (1000 if bad and i > n // 2 else 0)
            events += [("invoke", 1, "read", None, None),
                       ("ok", 1, "read", v, None)]
    return events


def ids_events(seed, n=50, dups=0):
    rng = random.Random(seed)
    vals = rng.sample(range(10 ** 6), n)
    for k in range(dups):
        vals[-1 - k] = vals[k]
    events = []
    for i, v in enumerate(vals):
        events.append(("invoke", i % 4, "generate", None, None))
        events.append(("ok" if rng.random() < 0.9 else "info", i % 4,
                       "generate", v, None))
    return events


def mixed_events(seed, n=60):
    """Reads, writes and a nemesis; :info completions carry exceptions
    of three classes, :fail ones none."""
    rng = random.Random(seed)
    events = []
    for i in range(n):
        p = rng.randrange(4)
        f = rng.choice(["read", "write", "cas"])
        events.append(("invoke", p, f, i, None))
        r = rng.random()
        if r < 0.7:
            events.append(("ok", p, f, i, None))
        elif r < 0.8:
            events.append(("fail", p, f, i, None))
        else:
            exc = rng.choice(["Traceback\nTimeoutError: read timed out",
                              "ConnectionResetError: peer",
                              "java.net.SocketTimeoutException"])
            events.append(("info", p, f, i, {"exception": exc}))
        if i % 20 == 0:
            events += [("info", "nemesis", "start", None, None),
                       ("info", "nemesis", "stop", None, None)]
    return events


# ---------------------------------------------------------------------------
# The host checkers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_stats_and_unhandled_exceptions(seed):
    ph = history(mixed_events(seed))
    _, st = same(jchecker.stats, pchecker.stats, ph)
    assert set(st["by-f"]) == {"read", "write", "cas"}
    _, ex = same(jchecker.unhandled_exceptions,
                 pchecker.unhandled_exceptions, ph)
    assert len(ex["exceptions"]) == 3
    clean = history([e for e in mixed_events(seed) if e[0] != "info"])
    assert same(jchecker.unhandled_exceptions,
                pchecker.unhandled_exceptions, clean)[1] == {"valid?": True}


def test_stats_without_oks_is_invalid():
    ph = history([("invoke", 0, "read", None, None),
                  ("fail", 0, "read", None, None)])
    assert same(jchecker.stats, pchecker.stats, ph)[1]["valid?"] is False


@pytest.mark.parametrize("case", ["valid", "lost", "dup-and-lost",
                                  "never-read"])
def test_set_checker(case):
    events = {"valid": set_events(4),
              "lost": set_events(5, lose=3),
              "dup-and-lost": set_events(6, lose=1, dup=True),
              "never-read": [e for e in set_events(7)
                             if e[2] != "read"]}[case]
    _, res = same(jchecker.set_checker, pchecker.set_checker,
                  history(events))
    assert res["valid?"] == {"valid": True, "lost": False,
                             "dup-and-lost": False,
                             "never-read": "unknown"}[case]


@pytest.mark.parametrize("linearizable", [False, True])
@pytest.mark.parametrize("case", ["valid", "lost", "dup", "strings",
                                  "no-reads"])
def test_set_full(case, linearizable):
    events = {"valid": set_events(8),
              "lost": set_events(9, lose=4),
              "dup": set_events(10, dup=True),
              "strings": set_events(11, lose=2, values=lambda i: f"e{i}"),
              "no-reads": [e for e in set_events(12)
                           if e[2] != "read"]}[case]
    opts = {"linearizable?": linearizable}
    _, res = same(lambda: jchecker.set_full(opts),
                  lambda: pchecker.set_full(opts), history(events))
    if case in ("lost", "strings"):
        assert res["valid?"] is False and res["lost-count"] > 0
        assert res["lost-op-indices"]
    if case == "dup":
        assert res["duplicated-count"] == 1


def _without_last_absent(results):
    rows, dups = norm(results)
    return [{k: v for k, v in r.items() if k != "last-absent"}
            for r in rows], dups


@pytest.mark.parametrize("seed", [13, 14, 15])
def test_set_full_fast_and_slow_paths(seed):
    """The array fold and the object fold over one int-valued history
    each equal the JAX package's. They agree with each other but for
    `last-absent`, as in the JAX package: the object fold counts only
    reads after the element's add was invoked, the array fold every
    read. A non-int history takes the object fold."""
    ph = history(set_events(seed, n=120, lose=3, dup=True))
    jh = jax_twin(ph)
    fast = pchecker._set_full_results_fast(ph)
    slow = pchecker._set_full_results_slow(ph)
    assert norm(fast) == norm(jchecker._set_full_results_fast(jh))
    assert norm(slow) == norm(jchecker._set_full_results_slow(jh))
    assert _without_last_absent(fast) == _without_last_absent(slow)
    sh = history(set_events(seed, values=str))
    assert pchecker._set_full_results_fast(sh) is None
    assert norm(pchecker._set_full_results_slow(sh)) == \
        norm(jchecker._set_full_results_slow(jax_twin(sh)))


@pytest.mark.parametrize("case", ["valid", "unexpected"])
def test_queue_model_checker(case):
    ph = history(queue_events(16, unexpected=case == "unexpected",
                              drain="fail"))
    _, res = same(lambda: jchecker.queue(jmodels.unordered_queue()),
                  lambda: pchecker.queue(pmodels.unordered_queue()), ph)
    assert res["valid?"] is (case == "valid")


@pytest.mark.parametrize("case,kw,valid", [
    ("drained", {}, True),
    ("lost", {"drop": 2}, False),
    ("lost-aborted-drain", {"drop": 2, "drain": "info"}, "unknown"),
    ("unexpected", {"unexpected": True}, False),
    ("duplicated", {"dup": True}, True),
    ("failed-drain", {"drain": "fail"}, False)])
def test_total_queue(case, kw, valid):
    ph = history(queue_events(17, **kw))
    _, res = same(jchecker.total_queue, pchecker.total_queue, ph)
    assert res["valid?"] == valid
    if case == "duplicated":
        assert res["duplicated-count"] >= 1 or res["unexpected-count"] == 0
    ops, aborted = pchecker._expand_drains(ph)
    jops, jaborted = jchecker._expand_drains(jax_twin(ph))
    assert norm(ops) == norm(jops) and aborted == jaborted


@pytest.mark.parametrize("dups", [0, 3])
def test_unique_ids(dups):
    _, res = same(jchecker.unique_ids, pchecker.unique_ids,
                  history(ids_events(18, dups=dups)))
    assert res["valid?"] is (dups == 0)


@pytest.mark.parametrize("bad", [False, True])
def test_counter(bad):
    _, res = same(jchecker.counter, pchecker.counter,
                  history(counter_events(19, bad=bad)))
    assert res["valid?"] is (not bad)


def test_log_file_pattern(tmp_path):
    for node, text in (("n1", "ok\npanic: boom\nfine\n"),
                       ("n2", "assertion failed here\n"),
                       ("n3", "all quiet\n")):
        (tmp_path / node).mkdir()
        (tmp_path / node / "db.log").write_text(text)
    test = {"nodes": ["n1", "n2", "n3", "n4"], "store_dir": str(tmp_path)}
    ph = history(counter_events(20))
    for pattern, n in (("panic|assert", 2), ("nothing", 0)):
        _, res = same(lambda: jchecker.log_file_pattern(pattern, "db.log"),
                      lambda: pchecker.log_file_pattern(pattern, "db.log"),
                      ph, test)
        assert res["count"] == n


# ---------------------------------------------------------------------------
# The timeline
# ---------------------------------------------------------------------------

def write_optrace(d: Path, hist) -> None:
    recs = [{"span": i + 1, "op": o.index, "kind": kind, "name": kind,
             "t0": o.time, "t1": o.time + 5, "attrs": {"node": "n1"}}
            for i, o in enumerate(hist) if o.type == "invoke"
            for kind in ("op", "client")]
    (d / "optrace.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs) + '{"op"')


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("sub", [None, "key-3"])
def test_timeline_html(tmp_path, traced, sub):
    ph = history(mixed_events(21, n=40))
    jd, pd = tmp_path / "j", tmp_path / "p"
    for d in (jd, pd):
        d.mkdir()
        if traced:
            write_optrace(d, ph)
    opts = {"subdirectory": sub} if sub else {}
    jres = jchecker.timeline().check({"store_dir": str(jd), "name": "t"},
                                     jax_twin(ph), opts)
    pres = pchecker.timeline().check({"store_dir": str(pd), "name": "t"},
                                     ph, opts)
    assert norm(pres, pd) == norm(jres, jd)
    assert files(pd) == files(jd)
    html = Path(pres["file"]).read_text()
    assert html.startswith("<!DOCTYPE html>")
    assert ("— trace —" in html) is traced


def test_timeline_truncates_and_skips():
    ph = history([e for i in range(10_050) for e in (
        ("invoke", i % 7, "read", None, None),
        ("ok", i % 7, "read", i, None))] + [
        ("invoke", 8, "write", 1, None)])
    jh = jax_twin(ph)
    html = ptimeline.render_html({"name": "big"}, ph)
    assert html == jtimeline.render_html({"name": "big"}, jh)
    assert "Truncated to 10000 operations" in html
    assert norm(ptimeline.pairs(ph)) == norm(jtimeline.pairs(jh))
    assert pchecker.timeline().check({}, ph, {}) == \
        jchecker.timeline().check({}, jh, {}) == {
            "valid?": True, "skipped": "no store directory"}


# ---------------------------------------------------------------------------
# The slice: the register workload's composed checker
# ---------------------------------------------------------------------------

def fold_keys(hists, History, op):
    """One multi-key history out of single-key ones (key k = hists[k])."""
    events = sorted(((o.time, k, o) for k, h in enumerate(hists)
                     for o in h), key=lambda e: (e[0], e[1]))
    return History([op(index=i, time=i, type=o.type,
                       process=k * 1000 + o.process, f=o.f,
                       value=(k, o.value))
                    for i, (_t, k, o) in enumerate(events)],
                   assign_indices=False)


def register_stack(chk, ind, models, **lin_opts):
    return chk.compose({
        "linear": ind.checker(chk.linearizable(
            {"model": models.cas_register(), **lin_opts})),
        "stats": chk.stats(),
        "exceptions": chk.unhandled_exceptions(),
        "timeline": chk.timeline()})


def test_register_workload_composed_checker(tmp_path):
    """16 folded keys, keys 3 and 11 corrupted, into two store dirs with
    the same per-op trace: equal results and equal files (counterexample
    SVGs, trace excerpts, timeline.html)."""
    bad = (3, 11)
    js, ps = [], []
    for k in range(16):
        kw = dict(n_ops=100, n_procs=3, seed=500 + k)
        jh, ph = jsynth.register_history(**kw), psynth.register_history(**kw)
        if k in bad:
            jh = jsynth.corrupt_register_history(jh, at_frac=0.5)[0]
            ph = psynth.corrupt_register_history(ph, at_frac=0.5)[0]
        js.append(jh)
        ps.append(ph)
    jmulti, pmulti = fold_keys(js, JHistory, jop), fold_keys(ps, PHistory,
                                                              pop)
    jd, pd = tmp_path / "j", tmp_path / "p"
    for d in (jd, pd):
        d.mkdir()
        write_optrace(d, pmulti)
    jres = register_stack(jchecker, jind, jmodels).check(
        {"store_dir": str(jd), "name": "register"}, jmulti)
    pres = register_stack(pchecker, pind, pmodels, device="cpu").check(
        {"store_dir": str(pd), "name": "register"}, pmulti)
    assert pres["valid?"] is False
    assert pres["linear"]["failures"] == sorted(bad, key=str)
    for k in bad:
        svg = Path(pres["linear"]["results"][k]["counterexample-svg"])
        assert svg.read_text().startswith("<svg")
        assert Path(pres["linear"]["results"][k]["trace-excerpt"]).exists()
    assert all(r["valid?"] != "unknown" and "error" not in r
               for r in pres.values() if isinstance(r, dict))
    assert norm(pres, pd) == norm(jres, jd)
    assert files(pd) == files(jd)
    assert len(files(pd)) == 1 + 1 + 2 * len(bad)
