"""Builds the port's CUDA kernels and loads them with ctypes.

Each `csrc/<name>.cu` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

into `jepsen_tpu_torch/gpu/kernels/build/` (listed in .gitignore). The
file name carries a hash of the sources, so an edited source rebuilds and
an unchanged one loads the library already there. The libraries have a
plain C interface (no PyTorch headers), which keeps a build to seconds.
Nothing is built when the module is imported: the first load() of a
kernel builds it, and build_all() builds every source at once, one nvcc
process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc failed or is missing; the message carries its stderr."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise BuildError("nvcc not found on PATH or in /usr/local/cuda/bin")


def sources() -> list[str]:
    """Names of the kernels in csrc/ (one shared library each)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def _start(name: str):
    """Starts nvcc for one source unless its library is current; returns
    (name, process or None, output path, ptxas log path)."""
    out = library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        return name, None, out, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return name, (proc, tmp), out, log


def _finish(started) -> Path:
    name, job, out, log = started
    if job is None:
        return out
    proc, tmp = job
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed for {name}.cu "
                         f"(exit {proc.returncode}):\n{stderr}{stdout}")
    log.write_text(stderr + stdout)
    os.replace(tmp, out)
    return out


def build_all() -> dict:
    """Builds every kernel source in parallel; returns {"seconds",
    "libraries": {name: path}, "ptxas": {name: log text}}."""
    t0 = time.monotonic()
    with _lock:
        started = [_start(n) for n in sources()]
        paths = {}
        err = None
        for s in started:
            try:
                paths[s[0]] = _finish(s)
            except BuildError as e:  # wait for the others, then raise
                err = err or e
        if err is not None:
            raise err
    logs = {n: (p.with_suffix(".log").read_text()
                if p.with_suffix(".log").exists() else "")
            for n, p in paths.items()}
    return {"seconds": time.monotonic() - t0,
            "libraries": {n: str(p) for n, p in paths.items()},
            "ptxas": logs}


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if it is missing or its
    sources changed. The caller sets argtypes/restype."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_finish(_start(name))))
            _loaded[name] = lib
        return lib
