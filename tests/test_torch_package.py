"""Hygiene of the port package: it imports neither JAX nor the JAX
package, and its entry points never run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "jepsen_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "jepsen_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_runs_without_loading_jax():
    code = """
import sys
from jepsen_tpu_torch.checker import linearizable, models
from jepsen_tpu_torch.gpu import synth, wgl
h = synth.register_history(200, n_procs=4, seed=3)
bad, _ = synth.corrupt_register_history(h, at_frac=0.5)
a = wgl.analysis(models.cas_register(), h, certify=True, device="cpu")
b = linearizable({"model": models.cas_register(), "device": "cpu"}).check(
    {}, bad)
assert a["valid?"] is True and b["valid?"] is False, (a, b)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LOADED", loaded)
assert not loaded, loaded
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_entry_points_refuse_the_cpu_by_default(monkeypatch):
    from jepsen_tpu_torch.checker import linearizable, models
    from jepsen_tpu_torch.device import resolve_device
    from jepsen_tpu_torch.gpu import synth, wgl
    from jepsen_tpu_torch.gpu.encode import encode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = synth.register_history(100, n_procs=3, seed=1)
    enc = encode(models.cas_register(), h)
    calls = []
    monkeypatch.setattr(wgl, "_launch",
                        lambda *a, **k: calls.append(a) or None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wgl.analysis(models.cas_register(), h)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wgl.check_batch([enc])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wgl.check_batch_reach([enc])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wgl.check_segmented(enc, target_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linearizable({"model": models.cas_register()}).check({}, h)
    # the batch path (analysis_batch, check_slices, the ensemble, the
    # independent-key checker)
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.gpu import ensemble

    lin = linearizable({"model": models.cas_register()})
    multi = [o.copy(value=(0, o.value)) for o in h]
    for fn in (lambda: wgl.analysis_batch(models.cas_register(), [h]),
               lambda: wgl.analysis_batch_streamed(models.cas_register(),
                                                   [h, h], chunk=1),
               lambda: wgl.check_slices([(enc, 0)]),
               lambda: wgl.extract_witness(enc),
               lambda: ensemble.check_batch_sharded([enc]),
               lambda: ensemble.analysis_batch_sharded(
                   models.cas_register(), [h]),
               lambda: lin.check_batch({}, [h]),
               lambda: independent.checker(lin).check({}, multi)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert calls == []
    assert resolve_device("cpu") == torch.device("cpu")


def test_no_fallback_ladder_and_no_device_wide_sync():
    """Nothing in the package steps down from the card (no ladder, no
    `degradation` key) and no wait covers the whole device: a drain
    waits on its own launch's event."""
    for path in sorted((ROOT / "jepsen_tpu_torch").rglob("*.py")):
        text = path.read_text()
        assert "degradation" not in text, path
        assert "cuda.synchronize" not in text, path


def test_elle_and_bank_run_without_loading_jax():
    code = """
import sys
from jepsen_tpu_torch.checker import cycle
from jepsen_tpu_torch.gpu import certify, synth
from jepsen_tpu_torch.workloads import bank
h = synth.list_append_history(300, seed=1)
bad, _ = synth.corrupt_list_append_history(h)
a = cycle.append_checker({"device": "cpu"}).check({}, h)
b = cycle.append_checker({"device": "cpu", "engine": "device"}).check(
    {}, bad)
w = cycle.wr_checker({"device": "cpu"}).check(
    {}, synth.rw_register_history(300, seed=2))
assert a["valid?"] is True and b["valid?"] is False, (a, b)
assert w["valid?"] is True, w
for h_, r in ((h, a), (bad, b)):
    certify.validate(h_, r["certificate"])
c = bank.check_fast(synth.bank_history(300, n_accounts=32, seed=3), 320,
                    device="cpu")
assert c["valid?"] is True, c
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LOADED", loaded)
assert not loaded, loaded
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_elle_and_bank_refuse_the_cpu_by_default(monkeypatch):
    from jepsen_tpu_torch.checker import cycle
    from jepsen_tpu_torch.gpu import elle, elle_device, scc, synth
    from jepsen_tpu_torch.gpu.kernels import bank_reduce
    from jepsen_tpu_torch.gpu.kernels import scc as scc_kernel
    from jepsen_tpu_torch.workloads import bank

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(scc_kernel, "scc_labels",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(bank_reduce, "bank_reduce",
                        lambda *a, **k: calls.append(a))
    la = synth.list_append_history(50, seed=1)
    rw = synth.rw_register_history(50, seed=1)
    for fn in (lambda: elle.check_list_append(la),
               lambda: elle.check_rw_register(rw),
               lambda: elle.check_list_append(la, {"engine": "device"}),
               lambda: elle_device.check_list_append_device(la),
               lambda: elle_device.check_rw_register_device(rw),
               lambda: cycle.append_checker().check({}, la),
               lambda: cycle.wr_checker().check({}, rw),
               lambda: scc.scc(3, [0, 1], [1, 0]),
               lambda: scc.scc_device(3, [0, 1], [1, 0]),
               lambda: bank.check_fast(synth.bank_history(50, seed=1), 80),
               lambda: bank.checker().check({}, synth.bank_history(
                   50, seed=1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert calls == []
    # the host engine never touches a device
    assert elle.check_list_append(la, {"engine": "host"})["valid?"] is True
