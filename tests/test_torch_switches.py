"""The JAX package's run-time switches in the port, on the CPU.

- JEPSEN_TPU_CERTIFY=0: attach_wgl and attach_elle leave the absent
  marker "extraction disabled (JEPSEN_TPU_CERTIFY=0)" and record no
  `certify.attach` span; stamp_results and the independent checker's key
  stamping count the marker as any other absence.
- JEPSEN_TPU_EARLY_EXIT=0: check_segmented(early_exit=None) resolves
  every segment in one wave; an explicit argument still wins.
- JEPSEN_TPU_NATIVE_DIR: the host C helpers build into that directory.
- JEPSEN_TPU_COMPILE_CACHE (`--compile-cache`): the kernel build cache,
  gpu/kernels/build.py build_dir(); a library's name covers the nvcc
  version.

Under each of the first three, the same seeded histories (numpy-seeded
generators, op for op the same in both packages) go through the
linearizable checker, check_segmented, append_checker, the independent
checker and certify.stamp_results of both packages, whose results and
counts must be equal. The port runs its kernels' plain versions
(device="cpu").
"""

import os
from pathlib import Path

import pytest
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu import independent as jind
from jepsen_tpu import native as jnative
from jepsen_tpu.checker import cycle as jcycle
from jepsen_tpu.checker import models as jmodels
from jepsen_tpu.tpu import certify as jcertify
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu.tpu import wgl as jwgl
from jepsen_tpu.tpu.encode import encode as jencode
from jepsen_tpu_torch import checker as pchecker
from jepsen_tpu_torch import independent as pind
from jepsen_tpu_torch import native as pnative
from jepsen_tpu_torch import telemetry as ptel
from jepsen_tpu_torch.checker import cycle as pcycle
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.gpu import certify as pcertify
from jepsen_tpu_torch.gpu import spmd as pspmd
from jepsen_tpu_torch.gpu import synth as psynth
from jepsen_tpu_torch.gpu import wgl as pwgl
from jepsen_tpu_torch.gpu.encode import encode as pencode
from jepsen_tpu_torch.gpu.kernels import build
from test_torch_independent import _keyed, _norm

torch.set_num_threads(1)

CPU = {"device": "cpu"}
DISABLED = {"v": 1, "absent": "extraction disabled (JEPSEN_TPU_CERTIFY=0)"}
SWITCHES = ("certify-off", "early-exit-off", "native-dir")


@pytest.fixture(params=SWITCHES)
def switch(request, monkeypatch, tmp_path):
    """Sets one switch for both packages; the native helpers load again
    (into the switch's directory) in both."""
    name = request.param
    if name == "certify-off":
        monkeypatch.setenv("JEPSEN_TPU_CERTIFY", "0")
    elif name == "early-exit-off":
        monkeypatch.setenv("JEPSEN_TPU_EARLY_EXIT", "0")
    else:
        monkeypatch.setenv("JEPSEN_TPU_NATIVE_DIR", str(tmp_path / "native"))
        monkeypatch.setattr(pnative, "_libs", {})
        for attr, value in (("_lib", None), ("_tried", False),
                            ("_ef_lib", None), ("_ef_tried", False)):
            monkeypatch.setattr(jnative, attr, value)
    return name


def _register(n_ops, seed, corrupt):
    """(JAX history, port history)."""
    kw = dict(n_ops=n_ops, n_procs=4, seed=seed)
    jh, ph = jsynth.register_history(**kw), psynth.register_history(**kw)
    if corrupt:
        jh = jsynth.corrupt_register_history(jh, at_frac=0.3)[0]
        ph = psynth.corrupt_register_history(ph, at_frac=0.3)[0]
    return jh, ph


def _certificates(res):
    """Every certificate in a result tree, in walk order."""
    return [r["certificate"] for _p, r in pcertify.iter_certificates(res)]


def _expect_certificates(switch, res):
    certs = _certificates(res)
    assert certs
    if switch == "certify-off":
        assert all(c == DISABLED for c in certs)
        assert not [s for s in ptel.get().spans()
                    if s["name"] == "certify.attach"]
    else:
        assert DISABLED not in certs


@pytest.mark.parametrize("corrupt", [False, True], ids=["valid", "corrupt"])
def test_linearizable_checker_equal(switch, corrupt):
    jh, ph = _register(150, 31, corrupt)
    want = jchecker.linearizable(
        {"model": jmodels.cas_register()}).check({}, jh)
    ptel.reset()
    got = pchecker.linearizable(
        {"model": pmodels.cas_register(), **CPU}).check({}, ph)
    assert got["valid?"] is (not corrupt)
    assert _norm(got) == _norm(want)
    _expect_certificates(switch, got)


@pytest.mark.parametrize("corrupt", [False, True], ids=["valid", "corrupt"])
def test_check_segmented_equal(switch, corrupt):
    jh, ph = _register(500, 62, corrupt)
    want = jwgl.check_segmented(jencode(jmodels.cas_register(), jh),
                                target_len=24, witness=True)
    ptel.reset()
    got = pwgl.check_segmented(pencode(pmodels.cas_register(), ph),
                               target_len=24, witness=True, device="cpu")
    assert got["valid?"] is (not corrupt)
    assert len(got["search-chain"]["chain"]) >= 2
    assert _norm(got) == _norm(want)
    c = ptel.get().counters()
    if switch == "early-exit-off":
        # one wave: every segment in one launch
        assert c["wgl.kernel.launches"] == 1
        assert "wgl.segmented.early-exit" not in c
    else:
        # geometric waves, the corrupted history's cut short
        assert c["wgl.kernel.launches"] == (2 if corrupt else 3)
        assert c.get("wgl.segmented.early-exit", 0) == int(corrupt)


def test_early_exit_argument_wins_over_the_variable(monkeypatch):
    _jh, ph = _register(500, 62, True)
    enc = pencode(pmodels.cas_register(), ph)
    runs = {}
    for env, arg in (("0", None), ("0", True), ("1", False), (None, None)):
        if env is None:
            monkeypatch.delenv("JEPSEN_TPU_EARLY_EXIT", raising=False)
        else:
            monkeypatch.setenv("JEPSEN_TPU_EARLY_EXIT", env)
        ptel.reset()
        res = pwgl.check_segmented(enc, target_len=24, witness=True,
                                   early_exit=arg, device="cpu")
        runs[(env, arg)] = (_norm(res), ptel.get().counters().get(
            "wgl.segmented.early-exit", 0))
    # verdicts, masks and witness: identical whichever way it ran
    assert len({repr(res) for res, _e in runs.values()}) == 1
    assert runs[("0", None)][1] == runs[("1", False)][1] == 0
    assert runs[("0", True)][1] == runs[(None, None)][1] == 1


def test_append_checker_equal(switch, tmp_path):
    jh = jsynth.list_append_history(300, seed=8)
    ph = psynth.list_append_history(300, seed=8)
    # the device engine, which flattens through the native elleflat
    want = jcycle.append_checker({"engine": "device"}).check({}, jh)
    ptel.reset()
    got = pcycle.append_checker({"engine": "device", **CPU}).check({}, ph)
    assert got["valid?"] is True
    assert _norm(got) == _norm(want)
    _expect_certificates(switch, got)
    if switch == "native-dir":
        # the port's flattener was built into, and loaded from, the
        # switch's directory
        lib = Path(pnative.elleflat()._name)
        assert lib.parent == tmp_path / "native"
        assert lib.name.startswith("elleflat-")


def test_independent_checker_equal(switch):
    jh, ph = _keyed(3, 30, bad=(1,))
    want = jind.checker(jchecker.linearizable(
        {"model": jmodels.cas_register()})).check({}, jh)
    ptel.reset()
    got = pind.checker(pchecker.linearizable(
        {"model": pmodels.cas_register(), **CPU})).check({}, ph)
    assert got["failures"] == want["failures"] == [1]
    assert _norm(got) == _norm(want)
    _expect_certificates(switch, got)
    if switch != "certify-off":
        for k, r in got["results"].items():
            assert r["certificate"]["key"] == k


def test_stamp_results_counts_equal(switch):
    jh, ph = _register(150, 31, True)
    want = {"w": jchecker.linearizable(
        {"model": jmodels.cas_register()}).check({}, jh)}
    got = {"w": pchecker.linearizable(
        {"model": pmodels.cas_register(), **CPU}).check({}, ph)}
    jk, pk = _keyed(3, 30)
    want["k"] = jind.checker(jchecker.linearizable(
        {"model": jmodels.cas_register()})).check({}, jk)
    got["k"] = pind.checker(pchecker.linearizable(
        {"model": pmodels.cas_register(), **CPU})).check({}, pk)
    counts = {name: (jcertify.stamp_results({name: want[name]}, h),
                     pcertify.stamp_results({name: got[name]}, p))
              for name, h, p in (("w", jh, ph), ("k", jk, pk))}
    for name, (j, p) in counts.items():
        assert p == j, name
        if switch == "certify-off":
            assert p == {"certified": 0, "errors": 0,
                         "absent": 1 if name == "w" else 3}
        else:
            assert p["errors"] == 0 and p["certified"] >= 1
    assert _norm(got) == _norm(want)


def test_native_dir_holds_both_packages_helpers(monkeypatch, tmp_path):
    d = tmp_path / "native"
    monkeypatch.setenv("JEPSEN_TPU_NATIVE_DIR", str(d))
    monkeypatch.setattr(pnative, "_libs", {})
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert pnative.build_dir() == d
    assert pnative.order() is not None and jnative.jlog() is not None
    assert len(list(d.glob("order-*.so"))) == 1
    assert len(list(d.glob("jlog*.so"))) == 1
    monkeypatch.setenv("JEPSEN_TPU_NATIVE_DIR", "")
    assert pnative.build_dir() == pnative._HERE / "build"
    monkeypatch.delenv("JEPSEN_TPU_NATIVE_DIR")
    assert pnative.build_dir() == pnative._HERE / "build"


# ---------------------------------------------------------------------------
# the kernel build cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", ["path", "0", "", None],
                         ids=["path", "zero", "empty", "unset"])
def test_build_dir_follows_the_variable(value, monkeypatch, tmp_path):
    monkeypatch.setattr(build, "nvcc_version", lambda: "Cuda 12.x")
    default = build.CSRC.parent / "build"
    if value is None:
        monkeypatch.delenv("JEPSEN_TPU_COMPILE_CACHE", raising=False)
        want = default
    elif value == "path":
        monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE", str(tmp_path))
        want = tmp_path
    else:
        monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE", value)
        want = None
    got = build.build_dir()
    if want is None:
        # the cache is off: a private directory of this process, under
        # the system's temporary directory, the same at every call
        assert pspmd.compile_cache_dir() is None
        assert got.is_dir() and got != default
        assert got.name.startswith("jepsen-tpu-kernels-")
        assert build.build_dir() == got
    else:
        assert got == want
        assert pspmd.compile_cache_dir() == str(want)
    path = build.library_path("scc")
    assert path.parent == got
    assert path.name == f"libscc-{build._digest()}.so"


def test_digest_covers_the_nvcc_version(monkeypatch):
    digests = set()
    for version in ("Cuda compilation tools, release 12.4, V12.4.131",
                    "Cuda compilation tools, release 12.8, V12.8.93", ""):
        monkeypatch.setattr(build, "nvcc_version", lambda v=version: v)
        digests.add(build._digest())
        assert build.library_path("wgl_search").name.endswith(
            f"-{build._digest()}.so")
    assert len(digests) == 3


def test_nvcc_version_without_nvcc_is_empty(monkeypatch):
    def missing():
        raise build.BuildError("nvcc not found")

    monkeypatch.setattr(build, "nvcc_path", missing)
    assert build.nvcc_version() == ""
    assert len(build._digest()) == 16


def test_chip_smoke_switches_phase_on_the_cpu(monkeypatch):
    """chip_smoke's phase 31 at a small size: (c) and (d) run; the cache
    part (a, b) needs nvcc and the card, and cache_launches() runs its
    launches' plain versions."""
    import chip_smoke as cs

    for name in ("JEPSEN_TPU_CERTIFY", "JEPSEN_TPU_EARLY_EXIT"):
        monkeypatch.delenv(name, raising=False)
    out = cs.cache_launches(torch.device("cpu"))
    assert sorted(out) == ["bank_reduce", "scc", "scc_shard", "wgl_search"]
    assert all(v == {"mismatches": 0, "launches": 0} for v in out.values())
    h = psynth.register_history(3000, n_procs=5, seed=42)
    bad = psynth.corrupt_register_history(h, at_frac=0.85)[0]
    m = pmodels.cas_register()
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    cs.switches_path(torch.device("cpu"), False, h, pencode(m, h),
                     pencode(m, bad), 256)
    parts = {x.get("part", x["phase"]): x for x in lines}
    assert sorted(parts) == ["certify", "early-exit", "switches-total"]
    assert parts["certify"]["certificate_off"] == DISABLED
    assert parts["early-exit"]["early_exits"]["off"] == 0
    assert "JEPSEN_TPU_CERTIFY" not in os.environ
