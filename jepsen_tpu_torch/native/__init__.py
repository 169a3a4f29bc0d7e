"""Host C helpers and their loader: the port's copy of jepsen_tpu/native
(`jlog`, `scan`, `frame`, `elle_flatten`, `realtime_edges`).

This is host code, not a device kernel: `jlog.c` scans and frames the
CRC-framed history log (store/format.py), `elleflat.c` flattens a
history's op list into the dense int64 arrays the elle device engine
consumes, and `order.c` is the realtime-order sweep. Each source is
compiled with the system C compiler at first use into `build/` beside
this file (listed in .gitignore), named by a hash of its contents, and
loaded over ctypes. Each has a pure Python fallback: a missing
toolchain raises RuntimeError here, and the callers then take the
Python path, which computes the same bytes and arrays.

JEPSEN_TPU_NATIVE_DIR, when set (and not empty), names the build
directory instead, as in the JAX package, whose default differs
(~/.cache/jepsen_tpu). A build prunes the older builds of its stem in
that directory, so a directory shared with the JAX package has each
package prune the other's `jlog` and `elleflat` libraries (other
hashes, never a wrong load: the file names carry the sources' hash);
the next process of that package builds them again.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

logger = logging.getLogger(__name__)

_HERE = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_libs: dict = {}


def build_dir() -> Path:
    """Where the helpers are built: JEPSEN_TPU_NATIVE_DIR, else build/
    beside this file (read at each helper's first load in a process)."""
    return Path(os.environ.get("JEPSEN_TPU_NATIVE_DIR") or _HERE / "build")


def _compile_src(src: Path, stem: str, extra_args=()) -> Path | None:
    """Compiles one C source into a content-hash-named .so under
    build_dir(); None if no compiler accepts it. A compile writes a
    private temporary file and renames it into place, so a killed build
    never leaves a half-written library at the trusted path."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    build = build_dir()
    build.mkdir(parents=True, exist_ok=True)
    out = build / f"{stem}-{digest}.so"
    if out.exists():
        return out
    for cc in ("cc", "gcc", "g++"):
        tmp = build / f".{stem}-{os.getpid()}.so.tmp"
        try:
            proc = subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", str(src), "-o", str(tmp),
                 *extra_args],
                capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            tmp.unlink(missing_ok=True)
            continue
        if proc.returncode == 0:
            os.replace(tmp, out)
            for old in build.glob(f"{stem}-*.so"):
                if old != out:
                    old.unlink(missing_ok=True)
            return out
        tmp.unlink(missing_ok=True)
        logger.debug("%s failed to build %s.so: %s", cc, stem, proc.stderr)
    return None


def _load(stem: str, loader, bind, extra_args=()) -> ctypes.CDLL | None:
    """The compiled library `stem`, or None (callers use the Python
    path). Built and bound once per process; a failure is remembered."""
    with _LOCK:
        if stem in _libs:
            return _libs[stem]
        lib = None
        try:
            path = _compile_src(_HERE / f"{stem}.c", stem, extra_args)
            if path is not None:
                lib = loader(str(path))
                bind(lib)
        except Exception:  # noqa: BLE001 — both have a Python path
            logger.exception("loading native %s failed", stem)
            lib = None
        _libs[stem] = lib
        return lib


def _bind_order(lib) -> None:
    p = ctypes.POINTER(ctypes.c_int64)
    lib.jt_realtime_edges.restype = ctypes.c_int64
    lib.jt_realtime_edges.argtypes = [p, p, ctypes.c_int64, p, p,
                                      ctypes.c_int64]


def _bind_elleflat(lib) -> None:
    lib.ef_flatten.restype = ctypes.c_void_p
    lib.ef_flatten.argtypes = [ctypes.py_object, ctypes.c_int64]
    lib.ef_status.restype = ctypes.c_int64
    lib.ef_status.argtypes = [ctypes.c_void_p]
    lib.ef_len.restype = ctypes.c_int64
    lib.ef_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ef_copy.restype = None
    lib.ef_copy.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_int64)]
    lib.ef_keys.restype = ctypes.py_object
    lib.ef_keys.argtypes = [ctypes.c_void_p]
    lib.ef_free.restype = None
    lib.ef_free.argtypes = [ctypes.c_void_p]


def _bind_jlog(lib) -> None:
    lib.jlog_scan.restype = ctypes.c_int64
    lib.jlog_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.jlog_frame.restype = ctypes.c_int64
    lib.jlog_frame.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_char_p]


def jlog() -> ctypes.CDLL | None:
    """The compiled history-log codec (jlog.c), or None (callers use
    the Python path)."""
    return _load("jlog", ctypes.CDLL, _bind_jlog, ("-lz",))


def scan(buf: bytes, start: int) -> tuple[list[tuple[int, int]], int]:
    """(payload (start, end) offsets, valid_prefix_end) via the C
    codec; raises RuntimeError if the codec is unavailable."""
    import numpy as np

    lib = jlog()
    if lib is None:
        raise RuntimeError("native jlog codec unavailable")
    # generous bound: every record needs >= 8 bytes of header
    max_records = max((len(buf) - start) // 8 + 1, 1)
    offsets = (ctypes.c_int64 * (2 * max_records))()
    valid_end = ctypes.c_int64(start)
    n = lib.jlog_scan(buf, len(buf), start, offsets, max_records,
                      ctypes.byref(valid_end))
    # one C-speed materialization: per-item ctypes access costs more
    # than the scan itself
    arr = np.ctypeslib.as_array(offsets)[:2 * n].reshape(-1, 2)
    return arr.tolist(), int(valid_end.value)


def frame(payloads: list[bytes]) -> bytes:
    """Concatenated framed records for payloads via the C codec;
    raises RuntimeError if unavailable."""
    lib = jlog()
    if lib is None:
        raise RuntimeError("native jlog codec unavailable")
    blob = b"".join(payloads)
    lens = (ctypes.c_int64 * len(payloads))(*map(len, payloads))
    out = ctypes.create_string_buffer(len(blob) + 8 * len(payloads))
    written = lib.jlog_frame(blob, lens, len(payloads), out)
    return out.raw[:written]


def order() -> ctypes.CDLL | None:
    """The compiled realtime sweep (order.c), or None."""
    return _load("order", ctypes.CDLL, _bind_order)


def elleflat() -> ctypes.PyDLL | None:
    """The compiled flattener (PyDLL: it calls the CPython C-API under
    the GIL), or None."""
    inc = sysconfig.get_paths().get("include")
    if not inc:
        return None
    return _load("elleflat", ctypes.PyDLL, _bind_elleflat,
                 (f"-I{inc}",))


# field ids — must match elleflat.c's enum
EF_APPEND_FIELDS = ("t_type", "t_proc", "t_inv", "t_comp", "t_opidx",
                    "ap_txn", "ap_key", "ap_val",
                    "rd_txn", "rd_key", "rd_len", "re_vals", "flag_rd")
EF_RW_FIELDS = ("t_type", "t_proc", "t_inv", "t_comp", "t_opidx",
                "wr_txn", "wr_key", "wr_val", "wr_nonfinal",
                "rd_txn", "rd_key", "rd_val",
                "fr_txn", "fr_key", "fr_prev", "fr_new",
                "er_txn", "er_key", "er_val", "int_row", "int_expected")


class NotVectorizable(Exception):
    """The native flattener found non-int values / too many keys."""


def elle_flatten(ops: list, kind: int) -> tuple[dict, list]:
    """One C pass over a history's op list. kind 0 = list-append,
    1 = rw-register. Returns ({field: int64 array}, key list); raises
    RuntimeError if the native flattener is unavailable and
    NotVectorizable when the history can't take the int fast path."""
    import numpy as np

    lib = elleflat()
    if lib is None:
        raise RuntimeError("native elleflat unavailable")
    h = lib.ef_flatten(ops, kind)
    if not h:
        raise RuntimeError("native elleflat failed")
    try:
        if lib.ef_status(h):
            raise NotVectorizable()
        fields = EF_RW_FIELDS if kind else EF_APPEND_FIELDS
        out = {}
        p = ctypes.POINTER(ctypes.c_int64)
        for fid, name in enumerate(fields):
            n = lib.ef_len(h, fid)
            arr = np.empty(n, dtype=np.int64)
            if n:
                lib.ef_copy(h, fid, arr.ctypes.data_as(p))
            out[name] = arr
        keys = lib.ef_keys(h)
        return out, keys
    finally:
        lib.ef_free(h)


def realtime_edges(inv, comp):
    """(src_idx, dst_idx) int64 arrays of reduced realtime-order edges
    over dense txn positions, via the C sweep (order.c); raises
    RuntimeError if it is unavailable. inv/comp are int64 arrays of
    invocation/completion history positions."""
    import numpy as np

    lib = order()
    if lib is None:
        raise RuntimeError("native order sweep unavailable")
    inv = np.ascontiguousarray(inv, dtype=np.int64)
    comp = np.ascontiguousarray(comp, dtype=np.int64)
    n = len(inv)
    if n == 0:
        return (np.empty(0, dtype=np.int64),
                np.empty(0, dtype=np.int64))
    p = ctypes.POINTER(ctypes.c_int64)
    cap = max(8 * n, 1024)
    while True:
        src = np.empty(cap, dtype=np.int64)
        dst = np.empty(cap, dtype=np.int64)
        m = lib.jt_realtime_edges(
            inv.ctypes.data_as(p), comp.ctypes.data_as(p), n,
            src.ctypes.data_as(p), dst.ctypes.data_as(p), cap)
        if m == -1:
            cap *= 4
            continue
        if m < 0:
            raise RuntimeError(f"native order sweep failed ({m})")
        return src[:m].copy(), dst[:m].copy()
