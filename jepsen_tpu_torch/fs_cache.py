"""Control-node filesystem cache for expensive artifacts (the port's
copy of jepsen_tpu/fs_cache.py: the same JEPSEN_TPU_CACHE_DIR variable
and default directory, so a cache either package filled serves both).

Capability reference: jepsen/src/jepsen/fs_cache.clj — cached values
live under logical paths (vectors of strings/keywords/numbers,
url-encoded into directories, 58-120), writers are atomic
(temp-file-then-rename, 141-186), values store as strings, data, local
files, or node files pulled over the control connection, and
deploy_remote pushes a cached file back onto a node (250-276). A
named-lock table serializes expensive cache misses (278-282).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import urllib.parse
from contextlib import contextmanager
from pathlib import Path

from . import control, util

DEFAULT_DIR = Path("/tmp/jepsen/cache")

_locks = util.named_locks()


def _base() -> Path:
    return Path(os.environ.get("JEPSEN_TPU_CACHE_DIR", DEFAULT_DIR))


def _encode_part(part) -> str:
    """One path element -> a safe directory name (fs_cache.clj Encode,
    58-103: keywords/numbers/bools/strings, url-escaped)."""
    if isinstance(part, bool):
        s = "true" if part else "false"
    elif part is None:
        s = "nil"
    else:
        s = str(part)
    # quote leaves '.' unreserved, so '.'/'..' parts would escape the
    # cache root — encode dots too
    return urllib.parse.quote(s, safe="").replace(".", "%2E")


def file(path) -> Path:
    """The cache File for a logical path (a list/tuple of parts)."""
    if not isinstance(path, (list, tuple)):
        path = [path]
    return _base().joinpath(*[_encode_part(p) for p in path])


def cached_p(path) -> bool:
    return file(path).is_file()


@contextmanager
def _atomic(final: Path):
    """Write to a temp file in the same directory, rename into place
    (fs_cache.clj write-atomic!, 160-186)."""
    final.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=final.parent,
                               prefix=f".{final.name}.", suffix=".tmp")
    os.close(fd)
    tmp_p = Path(tmp)
    try:
        yield tmp_p
        os.replace(tmp_p, final)
    finally:
        tmp_p.unlink(missing_ok=True)


def save_string(s: str, path) -> str:
    with _atomic(file(path)) as tmp:
        tmp.write_text(s)
    return s


def load_string(path) -> str | None:
    f = file(path)
    return f.read_text() if f.is_file() else None


def save_data(value, path):
    """JSON analog of save-edn!. Non-JSON values raise at save time:
    silently storing reprs would corrupt the round-trip."""
    with _atomic(file(path)) as tmp:
        with open(tmp, "w") as fh:
            json.dump(value, fh)
    return value


def load_data(path):
    f = file(path)
    if not f.is_file():
        return None
    with open(f) as fh:
        return json.load(fh)


def save_file(local, path):
    """Copies a local file into the cache."""
    with _atomic(file(path)) as tmp:
        shutil.copy2(local, tmp)
    return local


def load_file(path) -> Path | None:
    f = file(path)
    return f if f.is_file() else None


def save_remote(remote_path: str, path) -> str:
    """Downloads a node file (over the current control session) into
    the cache (fs_cache.clj save-remote!, 250-258)."""
    with _atomic(file(path)) as tmp:
        control.download([remote_path], tmp)
    return remote_path


def deploy_remote(path, remote_path: str) -> str:
    """Pushes a cached file onto the node at remote_path, replacing it
    (fs_cache.clj deploy-remote!, 260-276)."""
    if not cached_p(path):
        raise RuntimeError(f"path {path!r} is not cached and cannot "
                           "be deployed")
    import re

    if not re.match(r"/\w+/.+", remote_path):
        raise ValueError(
            f"remote path {remote_path!r} looks relative or "
            "suspiciously short — this might be dangerous!")
    control.exec_("rm", "-rf", remote_path)
    parent = str(Path(remote_path).parent)
    control.exec_("mkdir", "-p", parent)
    control.upload([str(file(path))], remote_path)
    return remote_path


@contextmanager
def locking(path):
    """Serializes expensive cache misses per logical path
    (fs_cache.clj locking, 278-282)."""
    key = (tuple(path) if isinstance(path, (list, tuple))
           else (path,))  # same normalization file() applies
    with _locks.hold(key):
        yield


def clear() -> None:
    """Wipes the whole cache (tests)."""
    shutil.rmtree(_base(), ignore_errors=True)
