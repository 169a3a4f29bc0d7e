"""Builds the port's CUDA kernels and loads them with ctypes.

Each `csrc/<name>.cu` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <dir>/lib<name>-<hash>.so csrc/<name>.cu

into build_dir(), the kernel build cache: the port's counterpart of the
JAX package's persistent compilation cache, set the same way
(`--compile-cache DIR` or JEPSEN_TPU_COMPILE_CACHE, read through
gpu/spmd.py compile_cache_dir() at each load() and build_all(), never at
import). A path there is the cache: libraries are built into it and
loaded from it, so processes sharing it build each library once. "0" or
an empty value turns the cache off: each process builds into a private
directory under the system's temporary directory, removed when it exits.
Unset, the cache is `jepsen_tpu_torch/gpu/kernels/build/` (listed in
.gitignore, where chip_smoke.py's build lands), not the JAX package's
store/.xla-cache. The file name carries a hash of the sources, the flags
and `nvcc --version`'s output, so an edited source or another toolchain
rebuilds and an unchanged one loads the library already there. A build
writes a file named for its process and renames it into place, so
processes building into one directory never load a half-written
library. The libraries have a plain C interface (no PyTorch headers),
which keeps a build to seconds. Nothing is built when the module is
imported: the first load() of a kernel builds it, and build_all() builds
every source at once, one nvcc process each.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# ns each library took to build (if its sources changed) and load, until
# the profiler takes it as the compile_ns of that kernel's first launch
_load_ns: dict[str, int] = {}
# `nvcc --version` by nvcc path, read once a process
_nvcc_versions: dict[str, str] = {}
# the private build directory of a process whose cache is off
_private: Path | None = None
_private_lock = threading.Lock()


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


def nvcc_version() -> str:
    """What `nvcc --version` prints for nvcc_path(); "" without nvcc."""
    try:
        nvcc = nvcc_path()
    except BuildError:
        return ""
    if nvcc not in _nvcc_versions:
        try:
            _nvcc_versions[nvcc] = subprocess.run(
                [nvcc, "--version"], capture_output=True, text=True,
                timeout=60).stdout
        except (OSError, subprocess.SubprocessError):
            return ""
    return _nvcc_versions[nvcc]


def build_dir() -> Path:
    """The directory libraries are built into and loaded from: the
    cache gpu/spmd.py compile_cache_dir() names, or the process's
    private directory when it names none (the cache is off)."""
    from .. import spmd

    global _private
    d = spmd.compile_cache_dir()
    if d is not None:
        return Path(d)
    with _private_lock:
        if _private is None:
            _private = Path(tempfile.mkdtemp(prefix="jepsen-tpu-kernels-"))
            atexit.register(shutil.rmtree, _private, True)
        return _private


def sources() -> list[str]:
    """Names of the kernels in csrc/ (one shared library each)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    h.update(nvcc_version().encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest()}.so"


def _start(name: str):
    """Starts nvcc for one source unless its library is current; returns
    (name, process or None, output path, ptxas log path)."""
    out = library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        return name, None, out, log
    out.parent.mkdir(parents=True, exist_ok=True)
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
    tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    tmp_log.write_text(stderr + stdout)
    os.replace(tmp_log, log)
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


def event_handles(events) -> tuple:
    """The raw cudaEvent_t handles of `events`, a (start, end) pair of
    torch.cuda.Event(enable_timing=True), for a launcher that records
    them on its stream just around its kernel; (None, None) without
    events. A torch event makes its handle at its first record, so an
    event without one is recorded once here, on the current stream (the
    launcher records it again)."""
    if events is None:
        return None, None
    out = []
    for ev in events:
        if not ev.cuda_event:
            ev.record()
        out.append(ev.cuda_event)
    return tuple(out)


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if it is missing or its
    sources changed. The caller sets argtypes/restype."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            t0 = time.monotonic_ns()
            lib = ctypes.CDLL(str(_finish(_start(name))))
            _loaded[name] = lib
            _load_ns[name] = time.monotonic_ns() - t0
        return lib


def take_load_ns(name: str) -> int | None:
    """The ns the library `name` took to build and load, once: the first
    call after its load returns it, later calls None (gpu/profiler.py's
    compile_ns of the kernel's first recorded launch)."""
    with _lock:
        return _load_ns.pop(name, None)
