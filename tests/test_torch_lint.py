"""The port's static analysis (jepsen_tpu_torch.analysis, gpu/lint.py)
against the JAX package's (jepsen_tpu.analysis, tpu/lint.py) on the CPU.

The rules have no numeric tolerance: the check is equality of finding
keys (and lines and costs where both sides have them) on the same
inputs.

- The copied parts run on the JAX tests' own synthetic inputs
  (tests/test_lint.py): the concurrency lint's sources, the host-feeder
  dtype scan's sources, R3/R4 traces, runtime buckets, the ratchet and
  the baseline round trip. R3's input maps the JAX `donated` flag onto
  the port's `copied` (a copy is what a missed donation costs on CUDA).
- Over the twelve threaded modules and the host-feeder modules each
  package scans its own counterpart; the listed differences are the
  only ones allowed (FEEDER_DIFFERENCES).
- The rules the port adds over launches (R1 host syncs in launch loops,
  R5 mirrored constants, R2 and R6 over launch plans) are tested on
  synthetic sources and on the production report, which must trace
  every registry entry on meta tensors and equal the committed
  lint-baseline-torch.json.
- The launch plans: the library call each wrapper makes is built from
  the plan (a recording stand-in for the library, on meta tensors), and
  the plans allocate what the launchers allocated.

No test here needs jax.experimental.enable_x64, which the installed JAX
lacks (ROADMAP C2).
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu.analysis import concurrency as jconcurrency
from jepsen_tpu.analysis import driver as jdriver
from jepsen_tpu.tpu import lint as JL
from jepsen_tpu_torch.analysis import concurrency, driver, registry
from jepsen_tpu_torch.gpu import lint as L
from jepsen_tpu_torch.gpu.kernels import bank_reduce as kbank
from jepsen_tpu_torch.gpu.kernels import scc as kscc
from jepsen_tpu_torch.gpu.kernels import wgl_search as ws

ROOT = Path(__file__).resolve().parent.parent
BASELINE = ROOT / "lint-baseline-torch.json"

import test_lint as jt  # noqa: E402  (the JAX tests' synthetic sources)


def keys(fs) -> list:
    return sorted((f.rule, f.kernel, f.site) for f in fs)


def lined(fs) -> list:
    return sorted((f.rule, f.kernel, f.site, f.line) for f in fs)


# ---------------------------------------------------------------------------
# the concurrency lint: copied, held to the JAX one
# ---------------------------------------------------------------------------

UNANNOTATED = ("import threading\n"
               "class X:\n"
               "    def __init__(self):\n"
               "        self._lock = threading.Lock()\n"
               "        self.xs = []\n")
LOCKLESS = "class P:\n    def f(self):\n        self.x = 1\n"
LAMBDA = ("import threading\n"
          "class R:\n"
          "    _guarded_by_lock = ('_xs',)\n"
          "    def __init__(self):\n"
          "        self._lock = threading.Lock()\n"
          "        self._xs = []\n"
          "    def defer(self):\n"
          "        with self._lock:\n"
          "            return lambda: self._xs.append(1)\n")
MATCH = ("import threading\n"
         "class M:\n"
         "    _guarded_by_lock = ('_xs',)\n"
         "    def __init__(self):\n"
         "        self._lock = threading.Lock()\n"
         "        self._xs = []\n"
         "    def ok(self, v):\n"
         "        match v:\n"
         "            case 1:\n"
         "                with self._lock:\n"
         "                    self._xs.append(v)\n"
         "    def bad(self, v):\n"
         "        match v:\n"
         "            case 1:\n"
         "                self._xs = [v]\n")
CONCURRENCY_SOURCES = {"good": jt.GOOD, "bad": jt.BAD,
                       "unannotated": UNANNOTATED, "lockless": LOCKLESS,
                       "lambda": LAMBDA, "match": MATCH}


@pytest.mark.parametrize("name", sorted(CONCURRENCY_SOURCES))
def test_concurrency_scan_source_equals_the_jax_one(name):
    src = CONCURRENCY_SOURCES[name]
    got = concurrency.scan_source(src, f"{name}.py", name)
    want = jconcurrency.scan_source(src, f"{name}.py", name)
    assert lined(got) == lined(want)
    assert [f.severity for f in got] == [f.severity for f in want]
    if name == "bad":
        assert ("C2", "bad.Rec", "flush:_flush_locked") in keys(got)


def _module_pairs():
    return [(name, name.replace("jepsen_tpu_torch", "jepsen_tpu")
             .replace(".gpu.", ".tpu."))
            for name in driver.CONCURRENCY_MODULE_NAMES]


@pytest.mark.parametrize("port,jax", _module_pairs(),
                         ids=[p for p, _ in _module_pairs()])
def test_threaded_modules_findings_equal_the_jax_drivers(port, jax):
    import importlib

    assert jax in jdriver.CONCURRENCY_MODULE_NAMES
    got = concurrency.scan_module(importlib.import_module(port))
    want = jconcurrency.scan_module(importlib.import_module(jax))
    assert keys(got) == keys(want) == []


def test_fleet_modules_in_the_driver_list():
    """Counterpart of test_fleet.py::TestFleetLint: the fleet's modules,
    ckpt and the streaming elle are in the port's list, and the lists
    name the same twelve modules."""
    names = driver.CONCURRENCY_MODULE_NAMES
    for m in ("fleet.scheduler", "fleet.server", "fleet.flightrec",
              "gpu.ckpt", "gpu.elle"):
        assert f"jepsen_tpu_torch.{m}" in names
    assert [p.replace("jepsen_tpu_torch", "jepsen_tpu")
            .replace(".gpu.", ".tpu.") for p in names] == \
        list(jdriver.CONCURRENCY_MODULE_NAMES)


# ---------------------------------------------------------------------------
# R2's host-feeder scan: copied and extended to torch dtypes
# ---------------------------------------------------------------------------

FEEDER = ("import numpy as np\n"
          "def feeder(n):\n"
          "    ids = np.arange(n, dtype=np.int64)\n"
          "    return np.zeros(n, dtype='float64')\n"
          "def clean(n):\n"
          "    return np.zeros(n, dtype=np.int32)\n")
CLASS_FEEDER = ("import numpy as np\n"
                "class C:\n"
                "    def __init__(self):\n"
                "        self.x = np.int64(0)\n")
TORCH_FEEDER = ("import torch\n"
                "def a(t):\n"
                "    return t.to(torch.int64)\n"
                "def b(t):\n"
                "    return t.long().to(dtype=torch.long)\n"
                "class C:\n"
                "    def f(self, t):\n"
                "        return t.to(torch.double), torch.float64\n"
                "def c(t):\n"
                "    return t.to(torch.int32)\n")


@pytest.mark.parametrize("src", [FEEDER, CLASS_FEEDER],
                         ids=["feeder", "class"])
def test_dtype_scan_equals_the_jax_one(src):
    got = L.scan_source_dtypes(src, "x.py", "x")
    want = JL.scan_source_dtypes(src, "x.py", "x")
    assert lined(got) == lined(want) and got


def test_dtype_scan_reads_torch_dtypes_as_numpys():
    fs = L.scan_source_dtypes(TORCH_FEEDER, "x.py", "x")
    assert {f.site for f in fs} == {"a:int64", "b:int64",
                                    "C.f:float64"}
    # the JAX scan knows numpy's names only
    assert JL.scan_source_dtypes(TORCH_FEEDER, "x.py", "x") == []


# The host-feeder findings that differ between a port module and its
# JAX counterpart: the checkpoint fingerprint moved from
# _SegmentCheckpoint.__init__ into its fingerprint_of method.
FEEDER_DIFFERENCES = {
    "wgl": ({"_SegmentCheckpoint.fingerprint_of:int64"},
            {"_SegmentCheckpoint.__init__:int64"}),
}


@pytest.mark.parametrize("name", ["encode", "wgl", "scc", "ensemble"])
def test_host_feeder_findings_equal_the_jax_scan(name):
    import importlib

    port = {f.site for f in L.scan_module_dtypes(
        importlib.import_module(f"jepsen_tpu_torch.gpu.{name}"))}
    jax = {f.site for f in JL.scan_module_dtypes(
        importlib.import_module(f"jepsen_tpu.tpu.{name}"))}
    only_port, only_jax = FEEDER_DIFFERENCES.get(name, (set(), set()))
    assert port - jax == only_port
    assert jax - port == only_jax
    assert [m.__name__.rsplit(".", 1)[-1]
            for m in registry.host_feeder_modules()] == \
        ["encode", "wgl", "scc", "ensemble"]


# ---------------------------------------------------------------------------
# R3, R4, runtime buckets, the ratchet, the baseline: copied
# ---------------------------------------------------------------------------

def _args(pairs):
    """The same arguments for both packages: (name, nbytes, donated)."""
    jax = [JL.ArgSpec(name=n, shape=(b // 4,), dtype="int32", nbytes=b,
                      donated=d) for n, b, d in pairs]
    port = [L.ArgSpec(name=n, shape=(b // 4,), dtype="int32", nbytes=b,
                      copied=not d) for n, b, d in pairs]
    return jax, port


R3_CASES = {"large-not-donated": [("big", 1 << 20, False),
                                  ("tiny", 128, False)],
            "donated-and-small": [("big", 1 << 20, True),
                                  ("tiny", 128, False)],
            "at-the-threshold": [("edge", L.DONATION_MIN_BYTES, False),
                                 ("under", L.DONATION_MIN_BYTES - 4,
                                  False)]}


@pytest.mark.parametrize("case", sorted(R3_CASES))
def test_r3_equals_the_jax_rule(case):
    jax, port = _args(R3_CASES[case])
    want = JL.rule_donation(JL.KernelTrace(name="k", bucket="t", args=jax))
    got = L.rule_copy(L.LaunchTrace(name="k", bucket="t", args=port))
    assert keys(got) == keys(want)
    assert [f.cost_bytes for f in got] == [f.cost_bytes for f in want]


R4_CASES = {
    "replicated": dict(args=[("tbl", 1 << 21, False)],
                       partition={"axis": "b", "sharded": ["rows"],
                                  "replicated": ["tbl"]}),
    "unsharded-axis": dict(args=[("rows", 4096, False)],
                           batch_axes=[("rows", 0, "independent")]),
    "sharded-axis": dict(args=[("rows", 4096, False)],
                         partition={"axis": "b", "sharded": ["rows"],
                                    "replicated": []},
                         batch_axes=[("rows", 0, "independent")]),
    "collective": dict(args=[], hlo_text="... stablehlo.all-gather ..."),
    "one-card": dict(args=[("rows", 1 << 22, False)]),
}


@pytest.mark.parametrize("case", sorted(R4_CASES))
def test_r4_equals_the_jax_rule(case):
    kw = dict(R4_CASES[case])
    jax, port = _args(kw.pop("args"))
    want = JL.rule_sharding(JL.KernelTrace(name="k", bucket="t", args=jax,
                                           **kw))
    got = L.rule_sharding(L.LaunchTrace(name="k", bucket="t", args=port,
                                        **kw))
    assert keys(got) == keys(want)
    assert [f.cost_bytes for f in got] == [f.cost_bytes for f in want]


def test_runtime_bucket_findings_equal_the_jax_ones():
    buckets = {"leaky": set(range(40)), "ok": {1, 2, 3},
               "edge": set(range(L.MAX_RUNTIME_BUCKETS)),
               "over": set(range(L.MAX_RUNTIME_BUCKETS + 1))}
    got = L.runtime_bucket_findings(buckets)
    assert keys(got) == keys(JL.runtime_bucket_findings(buckets))
    assert [f.kernel for f in got] == ["leaky", "over"]
    assert keys(L.runtime_bucket_findings(buckets, 2)) == \
        keys(JL.runtime_bucket_findings(buckets, 2))


def _pair(site, rule="R3", kernel="k", line=None):
    return (JL.Finding(rule=rule, kernel=kernel, site=site,
                       message=f"m-{site}", line=line),
            L.Finding(rule=rule, kernel=kernel, site=site,
                      message=f"m-{site}", line=line))


def test_ratchet_equals_the_jax_one():
    base = [_pair("a"), _pair("gone"), _pair("c", rule="R6", line=3)]
    now = [_pair("a", line=999), _pair("b"), _pair("c", rule="R6",
                                                   line=40)]
    want = JL.ratchet([j for j, _ in now],
                      JL.baseline_doc([j for j, _ in base]))
    got = L.ratchet([p for _, p in now],
                    L.baseline_doc([p for _, p in base]))
    for k in ("new", "baselined"):
        assert [f.key for f in got[k]] == [f.key for f in want[k]]
    assert got["stale"] == want["stale"] == ["R3:k:gone"]


def test_baseline_round_trip_equals_the_jax_one(tmp_path):
    fs = [_pair("b"), _pair("a", rule="R1"), _pair("z", rule="C1")]
    L.write_baseline(tmp_path / "port.json", [p for _, p in fs])
    JL.write_baseline(tmp_path / "jax.json", [j for j, _ in fs])
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert L.load_baseline(tmp_path / "port.json") == \
        JL.load_baseline(tmp_path / "jax.json")
    assert L.load_baseline(tmp_path / "nope.json") == \
        JL.load_baseline(tmp_path / "nope.json")
    (tmp_path / "bad.json").write_text('{"findings": 3}')
    for mod in (L, JL):
        with pytest.raises(ValueError):
            mod.load_baseline(tmp_path / "bad.json")


def test_gate_equals_the_jax_gate(tmp_path):
    p = tmp_path / "b.json"
    L.write_baseline(p, [_pair("a")[1]])
    for fs in (["a"], ["a", "b"], []):
        got = driver.gate(driver.LintReport(
            findings=[_pair(s)[1] for s in fs]), p)
        want = jdriver.gate(jdriver.LintReport(
            findings=[_pair(s)[0] for s in fs]), p)
        assert [f.key for f in got.ratchet["new"]] == \
            [f.key for f in want.ratchet["new"]]
        assert got.ratchet["stale"] == want.ratchet["stale"]


# ---------------------------------------------------------------------------
# the rules the port adds: R1 over launch loops, R5's mirror, R2/R6 over
# launch plans
# ---------------------------------------------------------------------------

LAUNCH_LOOPS = '''
import torch
from .kernels import scc as kernel

def solve(graph, masks):
    out = []
    for m in masks:                       # launch + sync: a finding
        out.append(kernel.scc_labels(*graph, m, 4).cpu())
    return out

def solve_later(graph, masks):
    outs = [kernel.scc_labels(*graph, m, 4) for m in masks]
    return [o.cpu() for o in outs]        # launches, then syncs: clean

def labels(graph, m):
    launch = kernel.scc_labels
    return launch(*graph, m, 4).numpy()

def through_a_helper(graph, masks):
    while masks:                          # via labels(): a finding
        labels(graph, masks.pop())

def waits_in_the_test(graph, ev, masks):
    i = 0
    while not ev.synchronize():           # the test runs every time
        kernel.bank_reduce(masks[i])
        i += 1

def comprehension(mats):
    return [kernel.bank_reduce(m)[0].tolist() for m in mats]

def host_only(xs):
    return [x.item() for x in xs]
'''


def test_r1_flags_launch_loops_that_wait():
    index = L.launch_sync_index({"pkg.gpu.m": LAUNCH_LOOPS})
    assert {"pkg.gpu.m:solve", "pkg.gpu.m:labels",
            "pkg.gpu.m:through_a_helper"} <= index.launch
    assert "pkg.gpu.m:host_only" in index.sync
    assert "pkg.gpu.m:host_only" not in index.launch
    fs = L.scan_source_host_sync("pkg.gpu.m", "m.py", index)
    assert keys(fs) == [
        ("R1", "module:m", "comprehension:bank_reduce+tolist"),
        ("R1", "module:m", "solve:cpu+scc_labels"),
        ("R1", "module:m", "through_a_helper:labels"),
        ("R1", "module:m", "waits_in_the_test:bank_reduce+synchronize"),
    ]
    assert all(f.line and f.file == "m.py" for f in fs)
    # no launch without its sync, and no sync without a launch
    index.sync.clear()
    clean = L.scan_source_host_sync("pkg.gpu.m", "m.py", index)
    assert "solve_later" not in {f.site.split(":")[0] for f in clean}


RESOLVE_LAUNCHER = '''
from .kernels import scc as kernel

def analysis(g, m):
    return kernel.scc_labels(*g, m, 4).cpu()

class Graph:
    def scc(self, m):
        return analysis(self.g, m)
'''

RESOLVE_CALLER = '''
from . import launcher
from .launcher import analysis as run

def analysis(xs):                   # a host function of the same name
    return [x.item() for x in xs]

class Lane:
    def probe(self, g, m):
        return launcher.analysis(g, m)

    def serve(self, g, ms):
        for m in ms:                    # self.probe: a finding
            self.probe(g, m)

    def host(self, xs):
        for x in xs:                    # this module's analysis: clean
            analysis(x)

def imported(g, ms):
    return [run(g, m) for m in ms]      # the import's target: a finding

def on_any_graph(graph, ms):
    for m in ms:                        # a method named scc: a finding
        graph.scc(m)

def elsewhere(g, ms):
    for m in ms:                        # outside the index: clean
        g.partition(m)
'''


def test_r1_resolves_calls_per_module():
    """A call reaches the function its module names: a bare name this
    module's own definition, then its imports; self.f the enclosing
    class's method; mod.f the imported module's function; an unknown
    receiver's method the indexed methods of that name. A function of
    the same bare name elsewhere is not reached."""
    index = L.launch_sync_index({"pkg.gpu.launcher": RESOLVE_LAUNCHER,
                                 "pkg.gpu.caller": RESOLVE_CALLER})
    assert "pkg.gpu.launcher:Graph.scc" in index.launch
    assert "pkg.gpu.caller:analysis" not in index.launch
    assert "pkg.gpu.caller:Lane.probe" in index.launch
    fs = L.scan_source_host_sync("pkg.gpu.caller", "c.py", index)
    assert keys(fs) == [
        ("R1", "module:caller", "Lane.serve:probe"),
        ("R1", "module:caller", "imported:run"),
        ("R1", "module:caller", "on_any_graph:scc"),
    ]


def test_r1_host_only_loops_are_found_and_written_down():
    """Every loop R1_HOST_ONLY leaves out is still one the scan finds
    (the list cannot outlive its code), has its reason, and is not
    pinned in the baseline."""
    raw = {f.key for f in driver.host_sync_findings()}
    assert set(registry.R1_HOST_ONLY) <= raw
    assert all(registry.R1_HOST_ONLY.values())
    kept = {f.key for f in driver.source_findings()}
    assert not kept & set(registry.R1_HOST_ONLY)
    pinned = {e["key"] for e in L.load_baseline(BASELINE)["findings"]}
    assert not pinned & set(registry.R1_HOST_ONLY)


def test_r1_production_finds_the_elle_subset_loop():
    fs = driver.source_findings()
    sites = {(f.kernel, f.site) for f in fs if f.rule == "R1"}
    assert ("module:elle_device", "cycle_anomalies_arrays:scc") in sites
    assert ("module:wgl", "check_segmented:_resolve_wave") in sites
    assert all(f.file and f.line for f in fs)


@pytest.mark.parametrize("kernel,pairs", registry.MIRRORS,
                         ids=[k for k, _ in registry.MIRRORS])
def test_r5_mirrored_constants_agree(kernel, pairs):
    py_path, cu_path = registry.mirror_paths(kernel)
    py = L.python_constants(py_path)
    cu = L.cuda_constants(cu_path.read_text())
    for p, c in pairs:
        assert p in py and c in cu, (p, c)
        assert py[p] == cu[c], (p, py[p], c, cu[c])
    assert L.mirror_findings(kernel, py_path, cu_path, pairs) == []


@pytest.mark.parametrize("kernel,name,value", [
    ("scc", "FIRST_ROUND_SWEEPS", "65"),
    ("scc", "PRIO", "0x9E3779B3"),
    ("wgl_search", "RUNNING", "-3"),
    ("wgl_search", "_SERIES", "32"),
])
def test_r5_one_changed_constant_is_one_finding(kernel, name, value):
    import re

    pairs = dict(registry.MIRRORS)[kernel]
    py_path, cu_path = registry.mirror_paths(kernel)
    src = py_path.read_text()
    changed, n = re.subn(rf"^{name} = .*$", f"{name} = {value}", src,
                         count=1, flags=re.MULTILINE)
    assert n == 1
    fs = L.mirror_findings(kernel, py_path, cu_path, pairs,
                           py_src=changed)
    assert [(f.rule, f.kernel, f.site) for f in fs] == \
        [("R5", kernel, f"mirror:{name}")]
    assert changed.splitlines()[fs[0].line - 1].startswith(f"{name} = ")
    # ... and the CUDA side alone changed is the same one finding
    cu_name = dict(pairs)[name]
    cu_src, n = re.subn(rf"(constexpr[^;\n]*?\b{cu_name} = )[^,;]*",
                        r"\g<1>7", cu_path.read_text(), count=1)
    assert n == 1
    fs = L.mirror_findings(kernel, py_path, cu_path, pairs, cu_src=cu_src)
    assert [f.site for f in fs] == [f"mirror:{name}"]


def test_cuda_constants_read_c_integer_expressions():
    src = ("constexpr int kA = 1 << 30;  // a comment = 3\n"
           "constexpr unsigned kB = 0x9E3779B1u, kC = 0x7fffffffu;\n"
           "/* constexpr int kHidden = 4; */\n"
           "  constexpr int kD = kA / 3;\n"
           "constexpr int kE = -1;\n"
           "constexpr long long kF = kG * 2;\n")
    assert L.cuda_constants(src) == {"kA": 1 << 30, "kB": 0x9E3779B1,
                                     "kC": 0x7fffffff,
                                     "kD": (1 << 30) // 3, "kE": -1}


def test_r2_and_r6_over_launch_traces():
    t = L.LaunchTrace(name="k", bucket="t", args=[
        L.ArgSpec("mat", (4, 2), "int64", 64),
        L.ArgSpec("ids", (8,), "int32", 32)],
        carry_bytes=L.CARRY_WARN_BYTES - 1)
    assert keys(L.run_rules(t)) == [("R2", "k", "arg:mat:int64")]
    t.carry_bytes = L.CARRY_WARN_BYTES
    t.scratch_bytes = L.CARRY_WARN_BYTES
    assert keys(L.run_rules(t)) == [("R2", "k", "arg:mat:int64"),
                                    ("R6", "k", "carry")]


# ---------------------------------------------------------------------------
# the launch plans
# ---------------------------------------------------------------------------

class Recorder:
    """A stand-in for a kernel library: records each call's arguments
    and answers 0 (launched)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("reach,crash_free", [(False, False), (True, True)])
def test_wgl_plan_is_the_library_call(reach, crash_free):
    K, M, S, B, W, F = 9, 64, 8, 16, 24, 48
    packed = (_meta((K, M)), _meta((K, M)), _meta((K, M, S)), _meta((K,)),
              _meta((K, M + 1)))
    plan = ws.launch_plan(packed, _meta((B,)), _meta((B,)), W, F, M + 4,
                          reach=reach, crash_free=crash_free)
    # what the launcher allocated before the plan existed
    want = {"result": ((B,), torch.int8), "out_mask": ((B,), torch.uint32),
            "unknown": ((B,), torch.bool), "it": ((), torch.int32),
            "lvl": ((3, M + 4), torch.int32)}
    assert {k: (tuple(t.shape), t.dtype)
            for k, t in plan.outputs.items()} == want
    lib = Recorder()
    assert ws._submit(lib, plan, None, "stream", "e0", "e1") == 0
    [(name, args)] = lib.calls
    assert name == "wgl_search_launch"
    # the signature ctypes declares: 7 inputs, 8 ints, 11 pointers
    assert len(args) == 7 + 8 + 11
    assert args[7:15] == (B, M, S, W, F, M + 4, int(reach),
                          int(crash_free))
    assert args[-3:] == ("stream", "e0", "e1")
    assert plan.smem_bytes == ws.smem_bytes(W, F, crash_free)
    with pytest.raises(ValueError, match="32 bits"):
        ws.launch_plan(packed, _meta((B,)), _meta((B,)), 33, F, M + 4)


def test_wgl_smem_bytes_mirror_the_library_formula():
    # wgl_search.cu: successor slots x (u64 + int) + F x 3 ints + kWarps
    # ints + kSeries x 3 ints + ring x 3 ints
    assert ws.smem_bytes(32, 64, False) == 4096 * 12 + 64 * 12 + 32 \
        + 64 * 12 + 128 * 12
    assert ws.smem_bytes(24, 48, True) == 2048 * 12 + 48 * 12 + 32 \
        + 64 * 12 + 128 * 12
    assert ws.smem_bytes(1, 1, True) == 12 + 12 + 32 + 64 * 12 + 64 * 12


@pytest.mark.parametrize("converge", [False, True])
def test_scc_plan_is_the_library_call(converge):
    n, E = 1000, 5000
    plan = kscc.launch_plan(_meta((E,)), _meta((E,)),
                            _meta((E,), torch.bool), n, converge=converge)
    assert tuple(plan.outputs["out"].shape) == (n + (4 if converge else 3),)
    assert plan.scratch.numel() == kscc.carve_bytes(n, E, converge)
    assert plan.scratch.dtype == torch.uint8
    lib = Recorder()
    fn = lib.scc_converge_launch if converge else lib.scc_launch
    assert kscc._submit(fn, plan, None, "s", None, None) == 0
    [(name, args)] = lib.calls
    # scc_launch: 3 inputs, n, e, sweep_cap, round_cap, 6 pointers;
    # scc_converge_launch: 3 inputs, n, e, tail_work, 6 pointers
    assert len(args) == (12 if converge else 13)
    assert args[3:5] == (n, E)
    if not converge:
        assert args[5:7] == (kscc.SWEEP_CAP, kscc.ROUND_CAP)
    # the card's launch passes the library's own scratch size
    given = kscc.launch_plan(_meta((E,)), _meta((E,)),
                             _meta((E,), torch.bool), n,
                             converge=converge, scratch=123)
    assert given.scratch.numel() == 123


def test_scc_carve_bytes_mirror_the_library_carves():
    n, E = 131072, 262144
    take = lambda c, s: (max(c, 1) * s + 15) & ~15  # noqa: E731
    capped = (take(n, 1) + 2 * (3 * take(n, 4) + 2 * take(E + 1024, 4))
              + take(1024, 4) + take(24, 4))
    conv = (15 * take(n, 4) + 2 * take(n + 1, 4) + 2 * take(E, 4)
            + take(2048, 4) + take(24, 4))
    assert kscc.carve_bytes(n, E) == capped
    assert kscc.carve_bytes(n, E, converge=True) == conv
    # empty arrays still take one element, 16-byte aligned
    assert kscc.carve_bytes(0, 0) == 16 + 2 * (3 * 16 + 2 * 4096) \
        + 4096 + 96


def test_bank_plan_is_the_library_call():
    plan = kbank.launch_plan(_meta((100, 32), torch.int64))
    assert {k: (tuple(t.shape), t.dtype) for k, t in
            plan.outputs.items()} == {"sums": ((100,), torch.int64),
                                      "negs": ((100,), torch.bool)}
    lib = Recorder()
    assert kbank._submit(lib, plan, "s") == 0
    [(name, args)] = lib.calls
    assert name == "bank_reduce_launch" and args[1:3] == (100, 32)
    assert len(args) == 6
    with pytest.raises(TypeError):
        kbank.launch_plan(_meta((100, 32), torch.int32))


def test_cpu_launches_never_build_a_plan(monkeypatch):
    """On CPU tensors the wrappers run their plain versions: the plan
    (and the library) belongs to the card's path alone."""
    def refuse(*a, **k):
        raise AssertionError("planned a CPU launch")

    for mod in (ws, kscc, kbank):
        monkeypatch.setattr(mod, "launch_plan", refuse)
    src = torch.tensor([0, 1], dtype=torch.int32)
    dst = torch.tensor([1, 0], dtype=torch.int32)
    on = torch.ones(2, dtype=torch.bool)
    assert kscc.scc_labels(src, dst, on, 2)[:2].tolist() == [1, 1]
    sums, _ = kbank.bank_reduce(torch.ones((3, 2), dtype=torch.int64))
    assert sums.tolist() == [2, 2, 2]


# ---------------------------------------------------------------------------
# the production report
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def production_report():
    return driver.run_lint()


def test_every_entry_traces_on_meta_tensors(production_report):
    rep = production_report
    assert rep.errors == []
    assert {t["kernel"] for t in rep.traces} == {
        "wgl", "wgl-reach", "wgl-segmented", "wgl-sharded", "wgl-slices",
        "scc", "scc-converge", "scc-sharded", "scc-shard-apply",
        "scc-shard-retire", "bank_reduce"}
    assert {t["kernel"] for t in rep.traces} == \
        {e.name for e in registry.entries()}
    assert all(t["bucket_policy"] == "exact" for t in rep.traces)
    # the JAX registry's entries the port keeps, by the same names
    from jepsen_tpu.analysis import registry as jregistry

    jax = {e.name for e in jregistry.entries()}
    assert jax - {t["kernel"] for t in rep.traces} == \
        {"wgl-single", "scc-single"}


def test_the_baseline_gate(production_report):
    """THE tier-1 ratchet of the port: a finding not pinned in
    lint-baseline-torch.json fails here. Fix it, or re-pin with
    `python -m jepsen_tpu_torch lint --baseline
    lint-baseline-torch.json --update` and explain it."""
    rep = driver.gate(copy.deepcopy(production_report), BASELINE)
    assert rep.ratchet["new"] == [], [f.key for f in rep.ratchet["new"]]
    assert rep.ratchet["stale"] == []


def test_two_runs_give_identical_keys(production_report):
    again = driver.run_lint()
    assert [f.key for f in again.findings] == \
        [f.key for f in production_report.findings]
    assert again.traces == production_report.traces


def test_rule_breadth_and_provenance(production_report):
    rep = production_report
    agg = rep.aggregates()
    # one card: no R4, and no launch copies its inputs
    assert agg["replicated_bytes"] == agg["unsharded_axes"] == 0
    assert agg["non_donated_bytes"] == 0
    assert set(agg["findings"]) == {"R1", "R2", "R6"}
    assert all(f.file and f.line for f in rep.findings)
    r2 = {(f.kernel, f.site) for f in rep.findings if f.rule == "R2"}
    assert ("bank_reduce", "arg:mat:int64") in r2
    r6 = {f.kernel for f in rep.findings if f.rule == "R6"}
    assert r6 == {"scc", "scc-converge", "wgl-segmented"}


def test_trace_sizes_are_the_plans(production_report):
    by = {(t["kernel"], t["bucket"]): t for t in production_report.traces}
    t = by[("scc", "N131072xE262144")]
    assert t["scratch_bytes"] == kscc.carve_bytes(131072, 262144)
    assert t["carry_bytes"] == t["scratch_bytes"]
    t = by[("wgl-sharded", "B1024xM512xS8")]
    assert t["smem_bytes"] == ws.smem_bytes(32, 64, False)
    assert t["args_bytes"] == 4 * (2 * 1025 * 512 + 1025 * 512 * 8 + 1025
                                   + 1025 * 513 + 2 * 1024)
    assert by[("bank_reduce", "R250000xA32")]["args_bytes"] == \
        250_000 * 32 * 8


def test_wgl_slices_registered_and_traced():
    """Counterpart of TestFleetLint.test_wgl_slices_registered_and_traces:
    the fleet's slice launch traces, its packed tables reach the kernel
    as they are (no copy)."""
    entry = {e.name: e for e in registry.entries()}["wgl-slices"]
    tr = entry.trace(entry.buckets[0])
    assert tr.name == "wgl-slices"
    assert [a.name for a in tr.args][:1] == ["inv_t"]
    assert not any(a.copied for a in tr.args)


def test_report_json_round_trip(production_report):
    doc = json.loads(json.dumps(production_report.to_dict()))
    assert doc["aggregates"]["unsharded_axes"] == 0
    assert len(doc["findings"]) == len(production_report.findings)
    assert len(doc["traces"]) == len(production_report.traces)


def test_telemetry_counters():
    from jepsen_tpu_torch import telemetry

    tel = telemetry.get()
    before = tel.counters().get("lint.runs", 0)
    driver.run_lint(trace_kernels=False)
    assert tel.counters().get("lint.runs", 0) == before + 1
    assert "lint.non-donated-bytes" in tel.gauges()


def test_runtime_buckets_trace_the_shapes_this_process_launched():
    from jepsen_tpu_torch.checker import models
    from jepsen_tpu_torch.gpu import profiler, scc, wgl
    from jepsen_tpu_torch.gpu.encode import encode
    from jepsen_tpu_torch.gpu.synth import register_history

    hist = register_history(60, n_procs=3, seed=11)
    wgl.check_batch([encode(models.register(), hist)], device="cpu")
    src = np.arange(30_000, dtype=np.int32) % 999
    scc.Edges(1000, src, (src + 1) % 1000, "cpu").labels_device()
    raw = profiler.shape_buckets()
    rb = registry.runtime_wgl_buckets(raw["wgl"])
    assert rb and all(b["label"].startswith("rt-") for b in rb)
    assert {"entry": "scc", "label": "rt-N1000xE30000", "n_pad": 1000,
            "e_pad": 30000} in registry.runtime_scc_buckets(raw["scc"])
    rep = driver.run_lint(runtime_buckets=True, concurrency_lint=False)
    assert rep.errors == []
    labels = {t["bucket"] for t in rep.traces}
    assert {b["label"] for b in rb} <= labels and "rt-N1000xE30000" in labels


def test_runtime_bucket_translation_skips_what_it_cannot_read():
    raw = [((9, 64), 8, 16, 24, 48, 68, True, False, "cpu"),
           ("one-device", (5, 512), 8, 4, 4, 32, 64, 516, False, True,
            "cuda"),
           ("garbage",), None, ((9, "x"), 8, 16, 24, 48, 68, True, False,
                                "cpu")]
    got = registry.runtime_wgl_buckets(raw)
    assert [(b["entry"], b["label"], b["crash_free"]) for b in got] == [
        ("wgl-sharded", "rt-K5xB4xM512xS8xW32xF64", False),
        ("wgl", "rt-K9xB16xM64xS8xW24xF48rc", True)]
    assert registry.runtime_scc_buckets(
        [("scc-converge", 10, 20, "cuda"), ("other", 1, 2, "cpu"), 3]) == \
        [{"entry": "scc-converge", "label": "rt-N10xE20", "n_pad": 10,
          "e_pad": 20}]


def test_full_mode_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.run_lint(full=True)


def test_full_mode_holds_python_sizes_to_the_library(monkeypatch):
    """With the library's answers stood in for (no card here), a size
    that differs is a trace error: exit 2."""
    monkeypatch.setattr(ws, "library_smem_bytes",
                        lambda W, F, c: ws.smem_bytes(W, F, c))
    monkeypatch.setattr(kscc, "scratch_bytes",
                        lambda n, E, converge=False:
                        kscc.carve_bytes(n, E, converge) + converge)
    entries = {e.name: e for e in registry.entries()}
    for name in ("wgl", "wgl-sharded", "scc"):
        e = entries[name]
        tr = e.trace(e.buckets[0], full=True)
        assert tr.library and all(
            getattr(tr, k) == v for k, v in tr.library.items())
    e = entries["scc-converge"]
    with pytest.raises(registry.SizingMismatch, match="scratch_bytes"):
        e.trace(e.buckets[0], full=True)


# ---------------------------------------------------------------------------
# the driver's exit codes against the JAX driver's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_report():
    return jdriver.run_lint()


def _main_rc(drv, report, argv, monkeypatch, capsys):
    monkeypatch.setattr(drv, "run_lint",
                        lambda **kw: copy.deepcopy(report))
    rc = drv.main(argv)
    capsys.readouterr()
    return rc


def test_exit_codes_equal_the_jax_drivers(production_report, jax_report,
                                          tmp_path, monkeypatch, capsys):
    jax_base = ROOT / "lint-baseline.json"
    reports = {"port": (driver, production_report, BASELINE),
               "jax": (jdriver, jax_report, jax_base)}
    empty = tmp_path / "empty.json"
    L.write_baseline(empty, [])
    got = {}
    for side, (drv, rep, base) in reports.items():
        broken = copy.deepcopy(rep)
        broken.errors = [{"entry": "wgl", "bucket": "x", "error": "boom"}]
        got[side] = [
            _main_rc(drv, rep, ["--baseline", str(base)], monkeypatch,
                     capsys),
            _main_rc(drv, rep, ["--baseline", str(empty)], monkeypatch,
                     capsys),
            _main_rc(drv, broken, ["--baseline", str(base)], monkeypatch,
                     capsys),
            _main_rc(drv, rep, ["--update"], monkeypatch, capsys),
            _main_rc(drv, rep, ["--update", "--rules", "R1",
                                "--baseline", str(empty)], monkeypatch,
                     capsys),
            _main_rc(drv, rep, ["--update", "--full", "--baseline",
                                str(empty)], monkeypatch, capsys),
            _main_rc(drv, rep, ["--update", "--runtime-buckets",
                                "--baseline", str(empty)], monkeypatch,
                     capsys),
        ]
    assert got["port"] == got["jax"] == [0, 1, 2, 254, 254, 254, 254]
    assert json.loads(empty.read_text())["findings"] == []


def test_rules_gate_is_not_destructive(tmp_path, capsys):
    """--rules narrows both sides of the ratchet (other rules' pinned
    findings are not 'stale'), and --update refuses to combine with
    --rules (it would drop them from the file)."""
    rc = driver.main(["--rules", "R3", "--baseline", str(BASELINE)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "stale" not in out.replace("0 stale", "")
    bp = tmp_path / "b.json"
    bp.write_text(BASELINE.read_text())
    assert driver.main(["--rules", "R3", "--update",
                        "--baseline", str(bp)]) == 254
    for flag in ("--runtime-buckets", "--full"):
        assert driver.main([flag, "--update", "--baseline", str(bp)]) == 254
    assert json.loads(bp.read_text()) == json.loads(BASELINE.read_text())


def test_update_writes_what_the_gate_reads(tmp_path, capsys):
    bp = tmp_path / "b.json"
    assert driver.main(["--baseline", str(bp), "--update"]) == 0
    assert json.loads(bp.read_text()) == json.loads(BASELINE.read_text())
    capsys.readouterr()


def test_the_lint_loads_no_jax():
    code = ("import sys\n"
            "from jepsen_tpu_torch.analysis import driver\n"
            "rep = driver.run_lint()\n"
            "assert not rep.errors, rep.errors\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'jepsen_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
