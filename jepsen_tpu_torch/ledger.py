"""The crash-safe write primitive the port's checkpoint store uses: the
part of jepsen_tpu/ledger.py that gpu/ckpt.py needs (the run ledger
itself is not ported)."""

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
