"""CRC-framed records and the canonical op codec: the part of
jepsen_tpu/store/format.py that the port's checkpoints read and write.

  file:    8 bytes magic b"JTPUHIS1"
  record:  [u32 payload_len][u32 crc32(payload)][payload bytes]

The segment frontier log (gpu/wgl.py:_SegmentCheckpoint) is such a
file, and ckpt.ops_digest hashes encode_op's bytes, so both must be the
JAX package's byte for byte: a store written by one package is resumed
by the other. A torn or corrupt tail record ends a scan; it never fails
the read.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path
from typing import Any, Iterator

from ..history import Op

MAGIC = b"JTPUHIS1"
_HDR = struct.Struct("<II")


def frame(payload: bytes) -> bytes:
    """One record: the header [u32 len][u32 crc32] and the payload."""
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def unframe(buf: bytes, pos: int) -> bytes | None:
    """The payload of the record at buf[pos:], or None when the record
    is torn (short header or payload) or corrupt (CRC mismatch)."""
    if len(buf) < pos + _HDR.size:
        return None
    n, crc = _HDR.unpack_from(buf, pos)
    payload = buf[pos + _HDR.size:pos + _HDR.size + n]
    if len(payload) < n or zlib.crc32(payload) != crc:
        return None
    return payload


def _scan_records(f) -> Iterator[tuple[bytes, int]]:
    """Walks intact CRC-framed records from just after the magic,
    yielding (payload, end_offset) and stopping at a torn or corrupt
    tail."""
    end = len(MAGIC)
    while True:
        hdr = f.read(_HDR.size)
        if len(hdr) < _HDR.size:
            return  # clean EOF or torn header
        n, crc = _HDR.unpack(hdr)
        payload = f.read(n)
        if len(payload) < n or zlib.crc32(payload) != crc:
            return  # torn or corrupt tail
        end += _HDR.size + n
        yield payload, end


def _scan_path(path) -> Iterator[tuple[bytes, int]]:
    """Yields (payload, end_offset) for the intact records of the file
    at `path`; raises ValueError on a bad magic. (The JAX package may
    take its native codec here; the records are the same.)"""
    with open(Path(path), "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: bad magic")
        yield from _scan_records(f)


def _valid_prefix_end(path) -> int:
    """Byte offset just past the last intact record (0 if even the
    magic is bad, so the writer restarts the file)."""
    try:
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                return 0
    except OSError:
        return 0
    end = len(MAGIC)
    for _payload, end in _scan_path(path):
        pass
    return end


def _default(o):
    if isinstance(o, Op):
        return o.to_dict()
    if isinstance(o, (set, frozenset)):
        return sorted(o, key=repr)
    if isinstance(o, bytes):
        return o.decode("utf-8", "replace")
    return repr(o)


def encode_op(o: Op) -> bytes:
    """The canonical bytes of one op (the store codec's record
    payload)."""
    return json.dumps(o.to_dict(), default=_default,
                      separators=(",", ":")).encode()


def jsonable(v: Any, depth: int = 0) -> Any:
    """Best-effort JSON view of a value; what is not data degrades to
    its repr."""
    if depth > 12:
        return repr(v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [jsonable(x, depth + 1) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted((jsonable(x, depth + 1) for x in v), key=repr)
    if isinstance(v, dict):
        return {str(k): jsonable(x, depth + 1) for k, x in v.items()}
    if isinstance(v, Op):
        return jsonable(v.to_dict(), depth + 1)
    if hasattr(v, "isoformat"):
        return v.isoformat()
    return repr(v)
