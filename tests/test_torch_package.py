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
    assert calls == []
    assert resolve_device("cpu") == torch.device("cpu")
