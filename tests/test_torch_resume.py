"""The port's resumable analysis (resume.py, the `analyze` subcommand)
against the JAX package's on the CPU.

Counterparts of tests/test_resume.py, each run on both packages: the
same run (a 40-read register test with its spec.json) is stored by each
package's core.run, cut back the same way (results.json removed, a torn
history tail, a partial-results log, spec.json removed or naming an
unknown workload, a degraded marker), and analysed again by the same
package's analyze_run (the port's with device "cpu"). The verdicts, the
`analysis` block and every checker result must be equal between the
packages, with the telemetry summary left out (durations), the store
directory of each path replaced and the JAX analyzer names read as the
port's. A run stored by one package is analysed by the other's analyze
with equal results. The SIGKILL end-to-end test kills the port's command
line in a subprocess mid-run and resumes its analysis with the port's
`analyze --resume`."""

from __future__ import annotations

import importlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")
PORT = "jepsen_tpu_torch"
RENAME = {"tpu": "gpu", "tpu-segmented": "gpu-segmented",
          "tpu-extend": "gpu-extend"}

SPEC = {"workload": "register",
        "opts": {"workload": "register", "nodes": ["n1", "n2"],
                 "concurrency": 2, "ssh": {"dummy": True},
                 "time_limit": 1, "ops": 40, "rate": 1000}}


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def clear_ip_caches():
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()
    yield
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()


def full_run(root, tmp_path, name="resume-full"):
    """tests/test_resume.py's run, on `root`'s package."""
    testing = mod(root, "testing")
    checker = mod(root, "checker")
    gen = mod(root, "generator")
    state = testing.AtomState()
    test = testing.noop_test()
    test.update(
        name=name, store_base=str(tmp_path / root), nodes=["n1", "n2"],
        concurrency=2, db=testing.AtomDB(state),
        client=testing.AtomClient(state, latency_s=0.0002),
        checker=checker.compose({"stats": checker.stats()}),
        spec=SPEC,
        generator=gen.clients(gen.limit(40, lambda: {"f": "read"})))
    return mod(root, "core").run(test)


def analyze(root, d, **kw):
    if root == "jepsen_tpu_torch":
        kw.setdefault("device", "cpu")
    return mod(root, "resume").analyze_run(d, **kw)


def norm(x, d):
    """A result tree without durations, with `d` in every path replaced
    and the JAX analyzer names read as the port's."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k == "telemetry":
                continue
            if k == "analyzer" and isinstance(v, str):
                v = RENAME.get(v, v)
            out[str(k)] = norm(v, d)
        return out
    if isinstance(x, (list, tuple)):
        return [norm(v, d) for v in x]
    if isinstance(x, str):
        return x.replace(str(d), "<store>")
    return x


def each(tmp_path, cut=None, **kw):
    """Runs the scenario on both packages: a stored run, cut back by
    `cut(root, d)`, then analysed again. Returns {root: (results
    normalized, test, d)} after holding the two results equal."""
    out = {}
    for root in ROOTS:
        t = full_run(root, tmp_path)
        d = mod(root, "store").path(t)
        if cut is not None:
            cut(root, d)
        t2 = analyze(root, d, **kw)
        out[root] = (norm(t2["results"], d), t2, d, t)
    assert out["jepsen_tpu_torch"][0] == out["jepsen_tpu"][0]
    return out


def test_reanalysis_matches_original_verdict(tmp_path):
    for root, (_r, t2, _d, t) in each(tmp_path).items():
        assert t2["results"]["valid?"] == t["results"]["valid?"]
        assert t2["results"]["analysis"]["offline?"] is True
        assert t2["results"]["analysis"]["resumed?"] is False


def _tear(root, d):
    (d / "results.json").unlink()
    log = d / "history.jlog"
    with open(log, "r+b") as f:
        f.truncate(log.stat().st_size - 5)


def test_crashed_run_recovers_valid_prefix(tmp_path):
    """Simulated kill -9 mid-run: results.json never written, the op log
    has a torn tail; analyze drops the torn record."""
    for root, (_r, t2, d, t) in each(tmp_path, _tear,
                                     resume=True).items():
        assert t2["results"]["valid?"] == t["results"]["valid?"]
        assert (t2["results"]["analysis"]["recovered-ops"]
                == len(t["history"]) - 1)
        assert (d / "results.json").exists()


def _partial(entries, drop_spec=False):
    def cut(root, d):
        (d / "results.json").unlink()
        if drop_spec:
            (d / "spec.json").unlink()
        w = mod(root, "store.format").PartialResultsWriter(
            d / "results.partial.jlog")
        for k, v in entries.items():
            w.put(k, v)
        w.close()
    return cut


def test_resume_reuses_partial_results_verbatim(tmp_path):
    out = each(tmp_path, _partial({"stats": {"valid?": True,
                                             "marker": 42}}), resume=True)
    for root, (res, *_rest) in out.items():
        assert res["stats"]["marker"] == 42
        assert res["analysis"]["resumed-checkers"] == ["stats"]


def test_resume_reruns_unknown_checkers(tmp_path):
    out = each(tmp_path, _partial({"stats": {
        "valid?": "unknown", "error": "checker timed out after 60s"}}),
        resume=True)
    for root, (res, *_rest) in out.items():
        assert res["stats"]["valid?"] is True
        assert res["analysis"]["resumed-checkers"] == []


def test_resume_preserves_orphaned_checker_results(tmp_path):
    out = each(tmp_path, _partial({"workload": {"valid?": False,
                                                "marker": 7}},
                                  drop_spec=True), resume=True)
    for root, (res, *_rest) in out.items():
        assert res["workload"]["marker"] == 7
        assert res["valid?"] is False
        assert "workload" in res["analysis"]["resumed-checkers"]


def test_no_resume_ignores_partials(tmp_path):
    def cut(root, d):
        w = mod(root, "store.format").PartialResultsWriter(
            d / "results.partial.jlog")
        w.put("stats", {"valid?": True, "marker": 42})
        w.close()

    for root, (res, *_rest) in each(tmp_path, cut, resume=False).items():
        assert "marker" not in res["stats"]


def test_run_without_spec_falls_back(tmp_path):
    out = each(tmp_path, lambda root, d: (d / "spec.json").unlink())
    for root, (res, t2, *_rest) in out.items():
        assert t2["rebuilt-from"] == "fallback"
        assert res["stats"]["valid?"] is True


def test_unbuildable_spec_falls_back(tmp_path):
    def cut(root, d):
        spec = json.loads((d / "spec.json").read_text())
        spec["workload"] = "no-such-workload"
        spec["opts"]["workload"] = "no-such-workload"
        (d / "spec.json").write_text(json.dumps(spec))

    for root, (res, t2, *_rest) in each(tmp_path, cut).items():
        assert t2["rebuilt-from"] == "fallback"
        assert res["stats"]["valid?"] is True


def test_offline_analysis_preserves_degraded_marker(tmp_path):
    def cut(root, d):
        prev = json.loads((d / "results.json").read_text())
        prev["degraded"] = {"quarantined-nodes": ["n2"],
                            "still-quarantined": []}
        (d / "results.json").write_text(json.dumps(prev))

    for root, (res, _t2, d, _t) in each(tmp_path, cut,
                                        resume=True).items():
        assert res["degraded"]["quarantined-nodes"] == ["n2"]
        on_disk = json.loads((d / "results.json").read_text())
        assert on_disk["degraded"]["quarantined-nodes"] == ["n2"]


def test_offline_analyze_leaves_live_run_artifacts_alone(tmp_path):
    before = {}

    def cut(root, d):
        before[root] = (d / "test.json").read_text()
        base = d.parent.parent
        live = base / "live-run"
        live.mkdir()
        cur = base / "current"
        if cur.is_symlink() or cur.exists():
            cur.unlink()
        cur.symlink_to(live.resolve())

    for root, (_res, _t2, d, _t) in each(tmp_path, cut,
                                         resume=True).items():
        cur = d.parent.parent / "current"
        assert cur.is_symlink()
        assert cur.resolve() == (d.parent.parent / "live-run").resolve()
        assert (d / "test.json").read_text() == before[root]


def test_analyze_cli_exit_codes(tmp_path, capsys):
    codes = {}
    for root in ROOTS:
        t = full_run(root, tmp_path)
        d = mod(root, "store").path(t)
        checker = mod(root, "checker")
        cli = mod(root, "cli")

        def rebuild(opts, checker=checker):
            return {"checker": checker.compose(
                {"stats": checker.stats()}), "name": "x"}

        argv = ["analyze", str(d), "--resume"]
        if root == "jepsen_tpu_torch":
            argv += ["--device", "cpu"]
        with pytest.raises(SystemExit) as e:
            cli.run_cli(cli.analyze_cmd(rebuild), argv)
        codes[root] = (e.value.code, capsys.readouterr().out.replace(
            str(d), "<run>"))
    assert codes["jepsen_tpu_torch"] == codes["jepsen_tpu"]
    assert codes["jepsen_tpu_torch"][0] == 0


def test_analyze_cli_missing_dir(tmp_path, capsys):
    outs = []
    for root in ROOTS:
        cli = mod(root, "cli")
        argv = ["analyze", str(tmp_path / "nope")]
        if root == "jepsen_tpu_torch":
            argv += ["--device", "cpu"]
        with pytest.raises(SystemExit) as e:
            cli.run_cli(cli.analyze_cmd(None), argv)
        assert e.value.code == 254
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]


def test_analyze_refuses_the_cpu_unasked(tmp_path, monkeypatch):
    """Without CUDA and without device="cpu", analyze_run and the
    `analyze` subcommand raise (exit 255) before reading the run: no
    results.json is written."""
    import torch

    t = full_run("jepsen_tpu_torch", tmp_path)
    d = mod("jepsen_tpu_torch", "store").path(t)
    (d / "results.json").unlink()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod("jepsen_tpu_torch", "resume").analyze_run(d)
    cli = mod("jepsen_tpu_torch", "cli")
    with pytest.raises(SystemExit) as e:
        cli.run_cli(cli.analyze_cmd(None), ["analyze", str(d)])
    assert e.value.code == 255
    assert not (d / "results.json").exists()


@pytest.mark.parametrize("writer,reader", [("jepsen_tpu", "jepsen_tpu_torch"),
                                           ("jepsen_tpu_torch", "jepsen_tpu")])
def test_stored_run_analysed_by_the_other_package(tmp_path, writer,
                                                  reader):
    """A run stored by one package, its analysis cut back as
    TestOfflineAnalyze cuts it (results.json removed, torn tail), is
    resumed by the other package's analyze with the results the
    writer's own resume gives."""
    t = full_run(writer, tmp_path)
    d = mod(writer, "store").path(t)
    _tear(writer, d)
    import shutil

    twin = d.parent / (d.name + "-twin")
    shutil.copytree(d, twin)
    own = analyze(writer, twin, resume=True)["results"]
    other = analyze(reader, d, resume=True)["results"]
    assert norm(other, d) == norm(own, twin)
    assert other["analysis"]["recovered-ops"] == len(t["history"]) - 1


def test_sigkill_then_analyze_resume(tmp_path):
    """The end-to-end acceptance on the port's command line: a run
    SIGKILLed mid-execution is recovered by `analyze --resume`, whose
    results equal the JAX package's resume of the same stored run."""
    import shutil

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    cmd = [sys.executable, "-m", "jepsen_tpu_torch"]
    runs_dir = tmp_path / "store" / "register-demo"
    proc = subprocess.Popen(cmd + [
        "test", "--workload", "register", "--no-ssh", "--nodes", "n1,n2",
        "--concurrency", "2", "--device", "cpu", "--time-limit", "30",
        "--rate", "50"], cwd=tmp_path, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    victim = None
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            dirs = [p for p in runs_dir.glob("2*")
                    if (p / "history.jlog").exists()
                    and (p / "history.jlog").stat().st_size > 4096]
            if dirs:
                victim = sorted(dirs)[-1]
                break
            if proc.poll() is not None:
                break
            time.sleep(0.2)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    assert victim is not None, "victim run never produced history"
    assert not (victim / "results.json").exists()
    twin = victim.parent / (victim.name + "-jax")
    shutil.copytree(victim, twin)
    cli = mod(PORT, "cli")
    with pytest.raises(SystemExit) as e:
        cli.run_cli(cli.analyze_cmd(None), ["analyze", str(victim),
                                            "--resume", "--device", "cpu"])
    got = json.loads((victim / "results.json").read_text())
    want = mod("jepsen_tpu", "resume").analyze_run(twin, resume=True)[
        "results"]
    assert norm(got, victim) == norm(json.loads(json.dumps(want,
                                                           default=repr)),
                                     twin)
    assert e.value.code == {True: 0, False: 1}.get(got["valid?"], 2)
    # the verdict of the recovered prefix: linearizable (the run as a
    # whole may still be invalid by stats alone, ROADMAP C12)
    assert got["workload"]["valid?"] is True
    assert got["analysis"]["resumed?"] is True
    assert got["analysis"]["recovered-ops"] > 0
