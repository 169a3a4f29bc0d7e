"""The crash-safe write primitives of the port's checkpoint store and
coverage atlas: the part of jepsen_tpu/ledger.py that gpu/ckpt.py and
coverage.py need (the run ledger itself is not ported)."""

from __future__ import annotations

import os


def write_all(fd: int, buf: bytes) -> None:
    """os.write until every byte lands, raising on a zero-progress
    write: a silently torn record behind a durability promise is the
    failure this exists to prevent."""
    view = memoryview(buf)
    while view:
        n = os.write(fd, view)
        if n <= 0:
            raise OSError("short write")
        view = view[n:]


def atomic_append_line(path, line: str) -> None:
    """One whole line, one os.write, O_APPEND: the shared-journal
    append primitive of the coverage atlas. Short writes (ENOSPC,
    signals) are continued rather than silently torn; the continuation
    can interleave with another writer only in the already-degraded
    disk-full case, where the torn-tail read rule still drops the
    damage."""
    fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        write_all(fd, (line + "\n").encode())
    finally:
        os.close(fd)
