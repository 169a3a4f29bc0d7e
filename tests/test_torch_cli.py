"""The port's command line (cli.py, __main__.py, repl.py) against the JAX
package's on the CPU.

- Counterparts of tests/test_cli.py (option parsing, run_cli's exit
  codes, test-all's summary, a clusterless `test`, the runner's
  workloads), of test_fleet.py::TestCli and of the `fleet top` half of
  test_flightrec.py::TestRenderers, each run on both packages with the
  same arguments: parsed options, printed output and exit codes must be
  equal. The port's own name in its output (`python -m
  jepsen_tpu_torch`) is read as the JAX package's, and its one extra
  option, `--device`, is left out of the parsed options.
- `python -m jepsen_tpu_torch` offers every subcommand of `python -m
  jepsen_tpu` under the same options, plus `--device` on test,
  test-all, analyze and fleet; `lint` gates the port's static analysis
  against lint-baseline-torch.json with the JAX package's exit codes.
- The readers of a stored run (telemetry, profile, nodes, trace,
  certify, coverage) print the same text in both packages over the same
  run directory, and each package's `analyze` of a run the other stored
  writes the results the writer stored (durations left out, the JAX
  analyzer names read as the port's).
- Without CUDA and without `--device cpu`, test, test-all, analyze and
  fleet serve exit 255 before any run directory is written.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")
PORT = "jepsen_tpu_torch"
RENAME = {"tpu": "gpu", "tpu-segmented": "gpu-segmented",
          "tpu-extend": "gpu-extend"}
# the runs the stored-run tests share: 120 register ops at 100 ops/s on
# three nodes, the node probe ticking every 0.2 s
RUN_ARGS = ["test", "--workload", "register", "--no-ssh",
            "--time-limit", "3", "--ops", "120", "--nodes", "n1,n2,n3",
            "--nodeprobe-interval", "0.2"]


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def as_jax(text: str) -> str:
    """The port's output with its module name read as the JAX
    package's."""
    return text.replace("jepsen_tpu_torch", "jepsen_tpu")


def port_argv(root, argv):
    """argv with `--device cpu` for the port (its entry points run on
    the card unless asked)."""
    return argv + ["--device", "cpu"] if root == PORT else argv


@pytest.fixture(autouse=True)
def clear_ip_caches():
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()
    yield
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()


def main(root, argv, cwd=None):
    """(exit code, stdout) of `python -m <root> argv` run in-process,
    in `cwd`."""
    out = io.StringIO()
    old = os.getcwd()
    try:
        if cwd is not None:
            os.chdir(cwd)
        with contextlib.redirect_stdout(out):
            with pytest.raises(SystemExit) as e:
                mod(root, "__main__").main(argv)
    finally:
        os.chdir(old)
    return e.value.code, out.getvalue()


def commands(root) -> dict:
    """The subcommand table `main` hands to run_cli."""
    cli = mod(root, "cli")
    seen = {}
    real = cli.run_cli

    def capture(subcommands, argv=None):
        seen.update(subcommands)

    cli.run_cli = capture
    try:
        mod(root, "__main__").main([])
    finally:
        cli.run_cli = real
    return seen


def options(spec) -> list:
    p = argparse.ArgumentParser()
    if spec.get("parser_fn"):
        spec["parser_fn"](p)
    return sorted((tuple(a.option_strings), a.dest, repr(a.default),
                   repr(a.choices)) for a in p._actions)


def norm(x, d=None):
    """A results tree without durations or the offline analysis block,
    with the JAX analyzer names read as the port's and the paths of the
    run `d`'s files from the run directory on."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in ("telemetry", "analysis"):
                continue
            if k == "analyzer" and isinstance(v, str):
                v = RENAME.get(v, v)
            out[str(k)] = norm(v, d)
        return out
    if isinstance(x, list):
        return [norm(v, d) for v in x]
    if isinstance(x, str) and d is not None and d.name in x:
        # a file of the run, by an absolute or a store-relative path
        return "<run>" + x.split(d.name, 1)[1]
    return x


# ---------------------------------------------------------------------------
# option parsing (test_cli.py)
# ---------------------------------------------------------------------------

def parse(root, argv):
    cli = mod(root, "cli")
    p = argparse.ArgumentParser()
    cli.add_test_opts(p)
    return cli.test_opt_fn(p.parse_args(argv))


def parsed(argv):
    """(the JAX package's options, the port's without --device)."""
    want = parse("jepsen_tpu", argv)
    got = parse(PORT, argv)
    assert got.pop("device") == "cuda"
    return want, got


def test_default_options():
    want, o = parsed([])
    assert o == want
    assert o["nodes"] == mod(PORT, "cli").DEFAULT_NODES
    assert o["concurrency"] == 5
    assert o["time_limit"] == 60
    assert o["test_count"] == 1
    assert o["ssh"]["username"] == "root"
    assert o["ssh"]["dummy"] is False
    assert parse(PORT, ["--device", "cpu"])["device"] == "cpu"


@pytest.mark.parametrize("argv,nodes", [
    (["--nodes", "a,b, c"], ["a", "b", "c"]),
    (["-n", "x", "-n", "y"], ["x", "y"]),
    (["--nodes", "a", "-n", "z"], ["a"])])
def test_nodes_parsing(argv, nodes):
    want, got = parsed(argv)
    assert got == want
    assert got["nodes"] == nodes


def test_nodes_file(tmp_path):
    f = tmp_path / "nodes"
    f.write_text("h1\nh2\n\n")
    want, got = parsed(["--nodes-file", str(f)])
    assert got == want and got["nodes"] == ["h1", "h2"]


@pytest.mark.parametrize("argv,n", [
    (["--nodes", "a,b,c", "--concurrency", "2n"], 6),
    (["--concurrency", "7"], 7), (["--concurrency", "1n"], 5),
    (["--nodes", "a,b", "--concurrency", "10n"], 20)])
def test_concurrency_2n(argv, n):
    want, got = parsed(argv)
    assert got == want and got["concurrency"] == n
    u = mod(PORT, "util")
    ju = mod("jepsen_tpu", "util")
    for s, k in (("3n", 4), ("7", 2), ("n", 3), ("1.5n", 4)):
        assert u.coll_scaled(s, k) == ju.coll_scaled(s, k)
    assert u.coll_scaled("3n", 4) == 12
    for frac, k in (("50%", 10), ("1%", 3), (4, 10), ("0%", 9), (2.7, 5)):
        assert u.fraction_of(frac, k) == ju.fraction_of(frac, k)


def test_bad_concurrency_is_a_usage_error(capsys):
    for root in ROOTS:
        with pytest.raises(SystemExit) as e:
            parse(root, ["--concurrency", "x2"])
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.count("Must be an integer, optionally followed by n.") == 2


def test_ssh_options():
    want, o = parsed(["--no-ssh", "--username", "admin",
                      "--ssh-private-key", "/id"])
    assert o == want
    assert o["ssh"] == {"username": "admin", "password": "root",
                        "strict_host_key_checking": False,
                        "private_key_path": "/id", "dummy": True}


@pytest.mark.parametrize("value", ["dir", "0"])
def test_compile_cache_sets_the_variable_as_in_jax(value, monkeypatch,
                                                   caplog, tmp_path):
    """`--compile-cache` parses as in the JAX package and sets the same
    variable, which the port reads as its kernel build cache."""
    from jepsen_tpu_torch.gpu.kernels import build

    cache = str(tmp_path / "cache") if value == "dir" else value
    env = {}
    # recorded, so that the variable both parses set is undone after
    monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE", "")
    for root in ROOTS:
        monkeypatch.delenv("JEPSEN_TPU_COMPILE_CACHE")
        with caplog.at_level("WARNING"):
            env[root] = parse(root, ["--compile-cache", cache]), \
                os.environ["JEPSEN_TPU_COMPILE_CACHE"]
    (want, jenv), (got, penv) = env["jepsen_tpu"], env[PORT]
    assert got.pop("device") == "cuda"
    assert got == want
    assert "compile_cache" not in got
    assert penv == jenv == cache
    assert not [r for r in caplog.records
                if "compile-cache" in r.getMessage()]
    if value == "dir":
        assert build.build_dir() == tmp_path / "cache"
    else:
        assert build.build_dir().name.startswith("jepsen-tpu-kernels-")


# ---------------------------------------------------------------------------
# run_cli and test-all (test_cli.py)
# ---------------------------------------------------------------------------

def test_run_cli_unknown_command(capsys):
    outs = []
    for root in ROOTS:
        with pytest.raises(SystemExit) as e:
            mod(root, "cli").run_cli({"test": {"run": lambda o: 0}},
                                     ["bogus"])
        assert e.value.code == 254
        outs.append(capsys.readouterr().out)
    assert "Commands:" in outs[1]
    assert as_jax(outs[1]) == outs[0]


def test_run_cli_exit_codes():
    for root in ROOTS:
        cli = mod(root, "cli")
        for ret, expect in [(0, 0), (1, 1), (2, 2), (None, 0)]:
            with pytest.raises(SystemExit) as e:
                cli.run_cli({"go": {"run": lambda o, r=ret: r}}, ["go"])
            assert e.value.code == expect
        with pytest.raises(SystemExit) as e:
            cli.run_cli({"go": {"run": lambda o: 1 / 0}}, ["go"])
        assert e.value.code == 255
        with pytest.raises(SystemExit) as e:
            cli.run_cli({"go": {"run": lambda o: 0}}, ["go", "--nope"])
        assert e.value.code == 254


@pytest.mark.parametrize("results", [
    {True: ["a"], False: ["b"], "unknown": ["c"]}, {True: ["a"]},
    {False: ["a"]}, {"crashed": ["a"], True: ["b", "c"]}, {}])
def test_test_all_summary_and_exit(capsys, results):
    outs, codes = [], []
    for root in ROOTS:
        cli = mod(root, "cli")
        cli.test_all_print_summary(results)
        outs.append(capsys.readouterr().out)
        codes.append(cli.test_all_exit_code(results))
    assert outs[1] == outs[0] and codes[1] == codes[0]
    if len(results) == 3:
        assert "# Successful tests" in outs[1]
        assert "# Failed tests" in outs[1]
        assert "1 successes" in outs[1]
        assert codes[1] == 2


# ---------------------------------------------------------------------------
# the subcommand table
# ---------------------------------------------------------------------------

def test_every_subcommand_under_the_same_options():
    want, got = commands("jepsen_tpu"), commands(PORT)
    assert sorted(got) == sorted(want)
    device = (("--device",), "device", "'cuda'", "['cuda', 'cpu']")
    for name in want:
        extra = [device] if name in ("test", "test-all", "analyze",
                                     "fleet") else []
        assert options(got[name]) == sorted(options(want[name]) + extra), \
            name


def test_lint_gates_against_the_port_baseline(tmp_path):
    code, out = main(PORT, ["lint", "--baseline",
                            str(ROOT / "lint-baseline-torch.json"),
                            "--json"], cwd=tmp_path)
    assert code == 0
    doc = json.loads(out)
    assert doc["ratchet"]["new"] == [] and doc["ratchet"]["stale"] == []
    assert doc["ratchet"]["baselined"] == len(doc["findings"]) > 0
    assert not doc.get("errors")
    code, out = main(PORT, ["lint", "--baseline",
                            str(ROOT / "lint-baseline-torch.json")],
                     cwd=tmp_path)
    assert code == 0 and out.startswith("graftlint: ")
    assert "0 NEW, 0 stale" in out


@pytest.mark.parametrize("argv", [
    ["--update", "--rules", "R1"], ["--update", "--full"],
    ["--update", "--runtime-buckets"], ["--update"]],
    ids=["rules", "full", "runtime-buckets", "no-baseline"])
def test_lint_refused_updates_exit_as_in_jax(tmp_path, argv):
    base = tmp_path / "b.json"
    base.write_text((ROOT / "lint-baseline-torch.json").read_text())
    extra = [] if argv == ["--update"] else ["--baseline", str(base)]
    codes = {root: main(root, ["lint", *argv, *extra], cwd=tmp_path)[0]
             for root in ROOTS}
    assert codes[PORT] == codes["jepsen_tpu"] == 254
    assert base.read_text() == \
        (ROOT / "lint-baseline-torch.json").read_text()


def test_lint_reports_new_findings_with_exit_1(tmp_path):
    empty = tmp_path / "empty.json"
    empty.write_text('{"version": 1, "findings": []}')
    code, out = main(PORT, ["lint", "--baseline", str(empty)],
                     cwd=tmp_path)
    assert code == 1 and "NEW R1 " in out


# ---------------------------------------------------------------------------
# the runner (__main__.py)
# ---------------------------------------------------------------------------

def test_runner_covers_every_workload():
    from jepsen_tpu.__main__ import CLIENTS as JCLIENTS
    from jepsen_tpu.__main__ import NEMESES as JNEMESES
    from jepsen_tpu_torch import workloads
    from jepsen_tpu_torch.__main__ import CLIENTS, NEMESES

    assert set(CLIENTS) == set(workloads.REGISTRY)
    assert list(CLIENTS) == list(JCLIENTS)
    assert list(NEMESES) == list(JNEMESES)
    for name, make in CLIENTS.items():
        assert type(make()).__name__ == type(JCLIENTS[name]()).__name__


@pytest.mark.parametrize("concurrency", [1, 5, 10])
def test_workload_opts_equal(concurrency):
    from jepsen_tpu.__main__ import _workload_opts as jopts
    from jepsen_tpu_torch.__main__ import CLIENTS, _workload_opts

    for name in CLIENTS:
        for ops in (1, 40, 500):
            opts = {"ops": ops, "concurrency": concurrency}
            assert _workload_opts(name, opts) == jopts(name, opts)
            got = _workload_opts(name, dict(opts, device="cpu"))
            assert got.pop("device") == "cpu"
            assert got == jopts(name, opts)


def test_make_test_equal_shape():
    """make_test builds the same test map in both packages: the same
    keys, spec, checker names and nemesis; the port's workload checkers
    carry the device."""
    from jepsen_tpu.__main__ import make_test as jmake
    from jepsen_tpu_torch.__main__ import CLIENTS, make_test

    for name in CLIENTS:
        opts = {"workload": name, "nodes": ["n1", "n2"],
                "concurrency": 3, "ssh": {"dummy": True}, "ops": 40,
                "time_limit": 5, "rate": 100, "nemesis": "partition",
                "trace": True, "quarantine": True}
        want = jmake(dict(opts))
        got = make_test(dict(opts, device="cpu"))
        assert sorted(got) == sorted(want), name
        assert got["spec"]["opts"].pop("device") == "cpu"
        assert got["spec"] == want["spec"]
        assert sorted(got["checker"].checker_map) == sorted(
            want["checker"].checker_map)
        assert type(got["nemesis"]).__name__ == type(
            want["nemesis"]).__name__
    for bad in ({"workload": "nope"}, {"workload": "register",
                                        "nemesis": "nope"}):
        with pytest.raises(SystemExit) as e:
            make_test(dict(opts, **bad))
        with pytest.raises(SystemExit) as j:
            jmake(dict(opts, **bad))
        assert as_jax(str(e.value)) == str(j.value)


def _run_workloads(names, concurrency):
    for root in ROOTS:
        core = mod(root, "core")
        make = mod(root, "__main__").make_test
        for name in names:
            opts = {"workload": name, "nodes": ["n1"],
                    "concurrency": concurrency, "ssh": {"dummy": True},
                    "ops": 40 if concurrency == 2 else 30,
                    "time_limit": 20, "rate": 5000}
            t = make(port_opts(root, opts))
            t.pop("name")
            t = core.run(t)
            assert t["results"]["valid?"] in (True, "unknown"), (
                root, name, t["results"])


def port_opts(root, opts):
    return dict(opts, device="cpu") if root == PORT else opts


def test_runner_new_workloads_end_to_end():
    _run_workloads(("kafka", "causal", "causal-reverse", "adya-g2"), 2)


def test_runner_paired_workloads_tolerate_odd_concurrency():
    _run_workloads(("adya-g2", "causal-reverse"), 5)


def test_make_all_tests_sweeps_the_named_workloads():
    for root in ROOTS:
        make_all = mod(root, "__main__").make_all_tests
        opts = {"nodes": ["n1"], "concurrency": 2, "ssh": {"dummy": True},
                "ops": 10, "workload": "register,bank"}
        assert [t["spec"]["workload"] for t in make_all(
            port_opts(root, opts))] == ["register", "bank"]
        opts.pop("workload")
        assert len(list(make_all(port_opts(root, opts)))) == 28


# ---------------------------------------------------------------------------
# a clusterless test, and the runs the reader tests share
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """One run stored by each package's `test` subcommand with the same
    arguments: {root: (exit code, run dir)}."""
    out = {}
    for root in ROOTS:
        cwd = tmp_path_factory.mktemp(root)
        for r in ROOTS:
            mod(r, "net").clear_ip_cache()
        code, _ = main(root, port_argv(root, list(RUN_ARGS)), cwd=cwd)
        out[root] = (code, (cwd / "store" / "register-demo" / "latest")
                     .resolve())
    for r in ROOTS:
        mod(r, "net").clear_ip_cache()
    return out


def test_single_test_cmd_runs_clusterless(stored):
    """`python -m jepsen_tpu_torch test --workload register --no-ssh
    --device cpu` works and stores what the JAX package's stores."""
    files = {}
    for root, (code, d) in stored.items():
        assert code == 0
        assert json.loads((d / "results.json").read_text())[
            "valid?"] is True
        for f in ("timeline.html", "rate.png", "latency-raw.png",
                  "latency-quantiles.png", "monitor.png", "spec.json",
                  "nodes.jsonl", "coverage.json", "metrics.json"):
            assert (d / f).stat().st_size > 0, (root, f)
        files[root] = sorted(p.name for p in d.iterdir())
    assert files[PORT] == files["jepsen_tpu"]
    spec = json.loads((stored[PORT][1] / "spec.json").read_text())
    jspec = json.loads((stored["jepsen_tpu"][1] / "spec.json").read_text())
    assert spec["opts"].pop("device") == "cpu"
    assert spec == jspec


@pytest.mark.parametrize("cmd", [["telemetry"], ["telemetry", "--top", "3"],
                                 ["telemetry", "--min-ms", "1"],
                                 ["profile"], ["nodes"], ["certify"],
                                 ["certify", "--print"], ["trace"],
                                 ["trace", "--ops", "1,2,5"]])
@pytest.mark.parametrize("writer", ROOTS)
def test_stored_run_readers_print_the_same(stored, cmd, writer, tmp_path):
    """Each package's reader subcommand over the same run directory (a
    copy a package) prints the same text and exits alike."""
    src = stored[writer][1]
    got = {}
    for root in ROOTS:
        d = tmp_path / root / src.parent.name / src.name
        shutil.copytree(src, d)
        code, out = main(root, [cmd[0], str(d)] + cmd[1:], cwd=tmp_path)
        got[root] = (code, as_jax(out.replace(str(d.parent.parent),
                                              "<store>")))
        if cmd[0] == "trace":
            got[root] += (json.loads((d / "trace.json").read_text()),)
    assert got[PORT] == got["jepsen_tpu"]
    assert got[PORT][0] == 0


@pytest.mark.parametrize("sync", [False, True])
def test_coverage_prints_the_same(stored, tmp_path, sync):
    got = {}
    for root in ROOTS:
        base = tmp_path / root / "store"
        for w, (_c, d) in stored.items():
            shutil.copytree(d, base / f"{w}-run" / d.name)
        argv = ["coverage", "--store", str(base), "--suggest", "4"]
        if not sync:
            argv.append("--no-sync")
        got[root] = main(root, argv, cwd=tmp_path)
        got[root] = (got[root][0], as_jax(got[root][1]))
    assert got[PORT] == got["jepsen_tpu"]
    assert got[PORT][0] == 0
    assert ("folded 2 run record(s)" in got[PORT][1]) is sync


@pytest.mark.parametrize("writer,reader", [("jepsen_tpu", PORT),
                                           (PORT, "jepsen_tpu")])
def test_stores_carried_across(stored, tmp_path, writer, reader):
    """A run stored by one package's `test` and checked again by the
    other's `analyze` gives the results the writer stored, untimed."""
    src = stored[writer][1]
    d = tmp_path / src.parent.name / src.name
    shutil.copytree(src, d)
    want = json.loads((d / "results.json").read_text())
    code, out = main(reader, port_argv(reader, ["analyze", str(d)]),
                     cwd=tmp_path)
    assert code == 0 and "results written to" in out
    got = json.loads((d / "results.json").read_text())
    assert got["analysis"]["offline?"] is True
    assert norm(got, d) == norm(want, src)


# ---------------------------------------------------------------------------
# the card's absence
# ---------------------------------------------------------------------------

def test_test_without_a_card_exits_before_any_run(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-m", PORT, "test", "--no-ssh"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 255, out.stderr[-2000:]
    assert "no CUDA device is available" in out.stderr
    assert not (tmp_path / "store").exists()


@pytest.mark.parametrize("argv", [
    ["test", "--no-ssh", "--workload", "bank"],
    ["test-all", "--no-ssh", "--workload", "register,set"],
    ["analyze", "store/register-demo/latest"],
    ["fleet", "serve", "--base", "fleet-base"]])
def test_commands_refuse_the_cpu_unasked(tmp_path, monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out = main(PORT, argv, cwd=tmp_path)
    assert code == 255 and out == ""
    assert not (tmp_path / "store").exists()
    assert not (tmp_path / "fleet-base").exists()


def test_cli_loads_no_jax(tmp_path):
    code = f"""
import sys
from jepsen_tpu_torch import resume, web
from jepsen_tpu_torch.__main__ import main
for argv in ({RUN_ARGS + ['--device', 'cpu', '--ops', '40']!r},
             ["telemetry"], ["nodes"], ["certify"]):
    try:
        main(argv)
    except SystemExit as e:
        # a 40-op register run may be invalid by stats alone (C12)
        assert e.code in ((0, 1) if argv[0] == "test" else (0,)), (
            argv, e.code)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LOADED", loaded)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


# ---------------------------------------------------------------------------
# fleet (test_fleet.py::TestCli, test_flightrec.py::TestRenderers)
# ---------------------------------------------------------------------------

class _Item:
    def __init__(self, tenant):
        self.tenant = tenant


def stats_fixture(root):
    frec = mod(root, "fleet.flightrec")
    fr = frec.FlightRecorder()
    fr.chunk("a", "r", 1, 0, 2_000_000, 1_000_000, 10)
    fr.launch("final", "timeout", 0, 5_000_000, 4, 64, [_Item("a")])
    fr.verdict("a", "r", 0, 9_000_000, frec.latency_block())
    return {"streams": 1, "chunks": 1, "verdicts": 1,
            "scheduler": {"launches": 1}, "flightrec": fr.snapshot()}


@pytest.mark.parametrize("case", ["fixture", "disabled", "empty"])
def test_fleet_top_lines(case):
    lines = []
    for root in ROOTS:
        st = {"fixture": stats_fixture(root),
              "disabled": {"flightrec": {"enabled": False}},
              "empty": {}}[case]
        lines.append(mod(root, "cli")._fleet_top_lines(st))
    assert lines[1] == lines[0]
    text = "\n".join(lines[1])
    if case == "fixture":
        assert "verdict ms" in text and "final" in text
        assert "timeout=1" in text
    else:
        assert "disabled" in text


def _fleet(root, argv):
    spec = mod(root, "cli").fleet_cmd()["fleet"]
    p = spec["parser_fn"](argparse.ArgumentParser())
    return spec["run"](p.parse_args(argv))


def test_fleet_submit_status_explain_trace(tmp_path, capsys):
    """`fleet submit` of a stored history.jlog, then `status`, `explain`
    and `trace`, against each package's own server: the verdicts and
    exit codes equal (the latency block is timing), the status counts
    equal, and `fleet ckpt` prints the same over the same record."""
    import test_torch_fleet as tf

    got = {}
    for p in tf.PKGS:
        root = p.root
        h = p.hist(31, 150)
        run_dir = tmp_path / root / "some-run"
        p.m("store.format").write_history(run_dir / "history.jlog",
                                          list(h))
        base = tmp_path / root / "fleet"
        srv = p.server(base).start()
        try:
            host, port = srv.addr
            addr = ["--addr", f"{host}:{port}"]
            assert _fleet(root, ["submit", str(run_dir), *addr,
                                 "--tenant", "cli-t", "--chunk-ops",
                                 "40"]) == 0
            env = json.loads(capsys.readouterr().out)
            assert env["result"]["valid?"] is True
            assert _fleet(root, ["status", *addr]) == 0
            st = json.loads(capsys.readouterr().out)
            assert st["tenants"]["cli-t"]["verdicts"] == 1
            assert _fleet(root, ["explain", "some-run", *addr,
                                 "--tenant", "cli-t"]) == 0
            explain = capsys.readouterr().out
            assert "dominant slice:" in explain
            assert _fleet(root, ["top", *addr, "--iterations", "1"]) == 0
            top = capsys.readouterr().out
            assert "verdict ms" in top
        finally:
            srv.stop()
        assert _fleet(root, ["trace", "--base", str(base)]) == 0
        trace = capsys.readouterr().out
        assert trace.startswith(f"wrote {base / 'fleet-trace.json'}")
        env.pop("latency", None)
        got[root] = (norm(env), st["tenants"]["cli-t"],
                     [ln.split()[0] for ln in explain.splitlines()])
    assert got[PORT] == got["jepsen_tpu"]
    # fleet ckpt over one stream-wgl record, read by both packages
    recs = sorted((tmp_path / PORT / "fleet").rglob("*.ckpt"))
    outs = []
    for root in ROOTS:
        for r in recs[:1]:
            assert _fleet(root, ["ckpt", str(r)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]


def test_fleet_commands_without_a_server(tmp_path, capsys):
    for root in ROOTS:
        for argv in (["status", "--base", str(tmp_path)],
                     ["explain", "--base", str(tmp_path)],
                     ["submit", str(tmp_path / "none"), "--addr", "x:1"],
                     ["trace", "--base", str(tmp_path)],
                     ["ckpt", "t/r", "--base", str(tmp_path)]):
            with pytest.raises(SystemExit) as e:
                _fleet(root, argv)
            assert isinstance(e.value, mod(root, "cli").CliError)
        capsys.readouterr()


# ---------------------------------------------------------------------------
# repl.py
# ---------------------------------------------------------------------------

def test_repl_latest_test_and_summary(stored, monkeypatch):
    got = {}
    for root, (_c, d) in stored.items():
        monkeypatch.chdir(d.parent.parent.parent)
        repl = {r: mod(r, "repl") for r in ROOTS}
        sums = [repl[r].summary(repl[r].latest_test()) for r in ROOTS]
        assert sums[1] == sums[0]
        assert sums[1]["valid?"] is True and sums[1]["ops"] > 0
        got[root] = sums[1]
    assert mod(PORT, "repl").summary(None) == {}


def test_register_run_invalid_by_stats_alone_c12():
    """ROADMAP C12 (a reference quirk, the same in both packages): the
    CLI's register test composes `stats`, which calls an f with no ok
    completion invalid, so a short run whose every cas failed is
    invalid with a linearizable workload and no anomaly (seen at
    `--ops 60 --concurrency 2`, about 1 run in 10)."""
    got = []
    for root in ROOTS:
        h = mod(root, "history")
        ops, t = [], 0
        for i, (f, v, typ, out) in enumerate([
                ("write", 3, "ok", 3), ("read", None, "ok", 3),
                ("cas", [1, 2], "fail", [1, 2]),
                ("read", None, "ok", 3), ("cas", [0, 4], "fail", [0, 4])]):
            for key in (0, 1):
                t += 10
                ops.append(h.op(time=t, type="invoke", process=key, f=f,
                                value=[key, v]))
                t += 10
                ops.append(h.op(time=t, type=typ, process=key, f=f,
                                value=[key, out]))
        opts = {"workload": "register", "nodes": ["n1"],
                "concurrency": 2, "ssh": {"dummy": True}, "ops": 10}
        test = mod(root, "__main__").make_test(port_opts(root, opts))
        chk = mod(root, "checker")
        res = chk.check_safe(test["checker"], {"nodes": ["n1"]},
                             h.History(ops))
        assert res["workload"]["valid?"] is True
        assert res["stats"]["by-f"]["cas"]["valid?"] is False
        assert res["valid?"] is False
        got.append((res["valid?"], res["stats"]))
    assert got[1] == got[0]
