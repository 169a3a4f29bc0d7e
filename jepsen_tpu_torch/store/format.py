"""On-disk history log: append-only, CRC-framed, chunk-sealed,
crash-recoverable (the port's copy of jepsen_tpu/store/format.py).

Capability reference: jepsen/src/jepsen/store/format.clj: the reference
writes histories as CRC32-checked typed blocks inside a single container
file, sealing FressianStream chunks into a BigVector so a crash loses at
most the unsealed tail (format.clj:36-200, 182-200; the interpreter
appends ops while the test runs, interpreter.clj:251-253).

  history.jlog:
    header: 8 bytes magic b"JTPUHIS1"
    record: [u32 payload_len][u32 crc32(payload)][payload bytes]
    payload: one JSON-encoded op dict (utf-8)

Records are flushed per append. On read, a torn or corrupt tail record
is dropped rather than failing the whole load (the reference's
crash-recovery behavior). The segment frontier log
(gpu/wgl.py:_SegmentCheckpoint) and the checkpoint records (gpu/ckpt.py)
are framed the same way, and ckpt.ops_digest hashes encode_op's bytes,
so every file here is the JAX package's byte for byte: a store written
by one package is read and resumed by the other. The native codec
(native/jlog.c, loaded by native.jlog()) scans and frames the same bytes
as the Python walker; without a C compiler the Python path runs.
"""

from __future__ import annotations

import bisect
import json
import struct
import threading
import zlib
from pathlib import Path
from typing import Any, Iterator

from ..history import History, Op, op as make_op

MAGIC = b"JTPUHIS1"
IDX_MAGIC = b"JTPUIDX1"
_HDR = struct.Struct("<II")
_IDX_ENTRY = struct.Struct("<qq")  # (op_count_so_far, byte_end)
_CRC = struct.Struct("<I")


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


def index_path(path) -> Path:
    return Path(str(path) + ".idx")


def _scan_path(path):
    """Yields (payload, end_offset) for intact records, via the native
    codec when available (one mmap-free bulk scan in C) else the
    Python walker."""
    path = Path(path)
    try:
        from .. import native

        if native.jlog() is not None:
            buf = path.read_bytes()
            if buf[:len(MAGIC)] != MAGIC:
                raise ValueError(f"{path}: bad magic")
            offs, _end = native.scan(buf, len(MAGIC))
            for a, b in offs:
                yield buf[a:b], b
            return
    except RuntimeError:
        pass
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: bad magic")
        yield from _scan_records(f)


def _default(o):
    if isinstance(o, Op):
        return o.to_dict()
    if isinstance(o, (set, frozenset)):
        return sorted(o, key=repr)
    if isinstance(o, bytes):
        return o.decode("utf-8", "replace")
    return repr(o)


def encode_op(o: Op) -> bytes:
    return json.dumps(o.to_dict(), default=_default,
                      separators=(",", ":")).encode()


def decode_op(payload: bytes) -> Op:
    return make_op(**json.loads(payload))


class HistoryWriter:
    """Incremental history log writer with the interpreter's
    append/close/read_back interface. Every `chunk_size` appends, an
    entry [ops_so_far, byte_end] is sealed into a CRC'd sidecar index
    (<log>.idx), the analog of the reference's periodically-sealed
    BigVector chunks (store/format.clj:182-200): a crash loses at most
    the unsealed tail, and readers can count ops and seek chunks
    without decoding the whole log."""

    def __init__(self, path: Path, chunk_size: int = 4096):
        self.path = Path(path)
        self.chunk_size = chunk_size
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # rebuild index state consistent with the (possibly truncated)
        # log: start the index fresh rather than trusting a stale one
        idx_path = index_path(self.path)
        if idx_path.exists():
            idx_path.unlink()
        self._idx = open(idx_path, "ab")
        self._idx.write(IDX_MAGIC)
        self._count = 0
        seals: list[int] = []
        end = 0
        if self.path.exists() and self.path.stat().st_size > 0:
            # Reopening after a crash: ONE scan yields both the valid
            # prefix (truncation point — appends after a torn tail
            # would be silently dropped by the recovering reader) and
            # the chunk seal offsets.
            try:
                with open(self.path, "rb") as f:
                    bad_magic = f.read(len(MAGIC)) != MAGIC
            except OSError:
                bad_magic = True
            end = 0 if bad_magic else len(MAGIC)
            if not bad_magic:
                for _payload, end in _scan_path(self.path):
                    self._count += 1
                    if self._count % self.chunk_size == 0:
                        seals.append(end)
            if end < self.path.stat().st_size:
                with open(self.path, "r+b") as f:
                    f.truncate(end)
        self._f = open(self.path, "ab")
        if self._f.tell() == 0:
            self._f.write(MAGIC)
            self._f.flush()
        for i, e in enumerate(seals):
            self._seal((i + 1) * self.chunk_size, e, flush=False)
        self._idx.flush()

    def _seal(self, count: int, byte_end: int, flush: bool = True
              ) -> None:
        entry = _IDX_ENTRY.pack(count, byte_end)
        self._idx.write(entry)
        self._idx.write(_CRC.pack(zlib.crc32(entry)))
        if flush:
            self._idx.flush()

    def append(self, o: Op) -> None:
        self._f.write(frame(encode_op(o)))
        self._f.flush()
        self._count += 1
        if self._count % self.chunk_size == 0:
            self._seal(self._count, self._f.tell())

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()
        if not self._idx.closed:
            self._idx.flush()
            self._idx.close()

    def read_back(self) -> list[Op]:
        self.close()
        return list(read_ops(self.path))


def _scan_records(f) -> Iterator[tuple[bytes, int]]:
    """Walks intact CRC-framed records from just after the magic,
    yielding (payload, end_offset) and stopping at a torn/corrupt tail.
    The single framing walker behind both reads and reopen-truncation,
    so the writer can never truncate what the reader would accept."""
    end = len(MAGIC)
    while True:
        hdr = f.read(_HDR.size)
        if len(hdr) < _HDR.size:
            return  # clean EOF or torn header
        n, crc = _HDR.unpack(hdr)
        payload = f.read(n)
        if len(payload) < n or zlib.crc32(payload) != crc:
            return  # torn/corrupt tail: drop and recover
        end += _HDR.size + n
        yield payload, end


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


def read_ops(path) -> Iterator[Op]:
    """Reads ops, tolerating a torn tail (crash recovery)."""
    for payload, _end in _scan_path(path):
        yield decode_op(payload)


def read_history(path) -> History:
    return History(list(read_ops(path)), assign_indices=False)


def _read_index(path) -> list[tuple[int, int]]:
    """Sealed (op_count, byte_end) entries; torn/corrupt entries are
    dropped from the tail (same recovery rule as the log)."""
    p = index_path(path)
    out: list[tuple[int, int]] = []
    try:
        buf = p.read_bytes()
    except OSError:
        return out
    if buf[:len(IDX_MAGIC)] != IDX_MAGIC:
        return out
    pos = len(IDX_MAGIC)
    step = _IDX_ENTRY.size + _CRC.size
    while pos + step <= len(buf):
        entry = buf[pos:pos + _IDX_ENTRY.size]
        (crc,) = _CRC.unpack(
            buf[pos + _IDX_ENTRY.size:pos + step])
        if zlib.crc32(entry) != crc:
            break
        out.append(_IDX_ENTRY.unpack(entry))
        pos += step
    return out


class LazyHistory:
    """Lazy chunked history view over a log + its sidecar index
    (store/format.clj BigVector, 143-173: O(1) count via sealed chunk
    metadata, chunks decoded on demand, the unsealed tail scanned
    once). Supports len/iteration/indexing without ever decoding more
    than the chunks touched."""

    def __init__(self, path):
        self.path = Path(path)
        size = self.path.stat().st_size
        with open(self.path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path}: bad magic")
        # Sealed index entries are CRC'd and written only after their
        # records hit disk, so they need no re-validation: only the
        # unsealed tail past the last seal gets CRC-scanned. That keeps
        # open cost O(tail), not O(file).
        self._chunks = [(0, len(MAGIC))] + [
            (n, e) for n, e in _read_index(self.path) if e <= size]
        last_n, last_end = self._chunks[-1]
        self._tail_offsets: list[tuple[int, int]] = []
        with open(self.path, "rb") as f:
            f.seek(last_end)
            data = f.read(size - last_end)
        pos = 0
        while pos + _HDR.size <= len(data):
            n, crc = _HDR.unpack(data[pos:pos + _HDR.size])
            payload = data[pos + _HDR.size:pos + _HDR.size + n]
            if len(payload) < n or zlib.crc32(payload) != crc:
                break  # torn/corrupt tail
            a = last_end + pos + _HDR.size
            self._tail_offsets.append((a, a + n))
            pos += _HDR.size + n
        self._len = last_n + len(self._tail_offsets)
        self._counts = [n for n, _e in self._chunks]
        self._cache: dict[int, list] = {}

    def __len__(self) -> int:
        return self._len

    def _chunk_ops(self, ci: int) -> list:
        ops = self._cache.get(ci)
        if ops is None:
            start = self._chunks[ci][1]
            end = (self._chunks[ci + 1][1]
                   if ci + 1 < len(self._chunks) else None)
            with open(self.path, "rb") as f:
                f.seek(start)
                data = f.read((end - start) if end is not None
                              else self._tail_offsets[-1][1] - start
                              if self._tail_offsets else 0)
            ops = []
            pos = 0
            while pos + _HDR.size <= len(data):
                n, _crc = _HDR.unpack(data[pos:pos + _HDR.size])
                ops.append(decode_op(
                    data[pos + _HDR.size:pos + _HDR.size + n]))
                pos += _HDR.size + n
            if len(self._cache) > 4:  # keep a few hot chunks
                self._cache.pop(next(iter(self._cache)))
            self._cache[ci] = ops
        return ops

    def __getitem__(self, i: int):
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError(i)
        # find the chunk whose [count_start, count_end) contains i
        ci = bisect.bisect_right(self._counts, i) - 1
        ops = self._chunk_ops(ci)
        return ops[i - self._counts[ci]]

    def __iter__(self):
        for ci in range(len(self._chunks)):
            yield from self._chunk_ops(ci)


def read_history_lazy(path) -> LazyHistory:
    return LazyHistory(path)


def write_history(path, ops, chunk_size: int = 4096) -> Path:
    """Bulk history export: frames whole chunks at a time (through the
    C codec when available) and seals the sidecar index per chunk —
    the batch analog of HistoryWriter for already-complete histories
    (re-exports, converters, test fixtures)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    from .. import native

    if native.jlog() is not None:
        framer = native.frame
    else:
        def framer(payloads):
            return b"".join(map(frame, payloads))
    idx_p = index_path(path)
    with open(path, "wb") as f, open(idx_p, "wb") as idx:
        f.write(MAGIC)
        idx.write(IDX_MAGIC)
        count = 0
        batch: list[bytes] = []

        def flush_batch():
            nonlocal count
            if not batch:
                return
            f.write(framer(batch))
            count += len(batch)
            batch.clear()
            if count % chunk_size == 0:
                entry = _IDX_ENTRY.pack(count, f.tell())
                idx.write(entry)
                idx.write(_CRC.pack(zlib.crc32(entry)))

        for o in ops:
            batch.append(encode_op(o))
            if len(batch) >= chunk_size - (count % chunk_size):
                flush_batch()
        flush_batch()
    return path


# ---------------------------------------------------------------------------
# Partial results: each checker's result lands on disk the moment it
# completes, so a crash mid-analysis leaves everything finished so far
# readable (store/format.clj PartialMap, 143-200; save-2! phases)
# ---------------------------------------------------------------------------

class PartialResultsWriter:
    """Append-only CRC-framed (key, result) log."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)
        self._f.flush()
        self._lock = threading.Lock()

    def put(self, key, result) -> None:
        payload = json.dumps({"key": key, "result": jsonable(result)},
                             default=_default,
                             separators=(",", ":")).encode()
        with self._lock:
            self._f.write(frame(payload))
            self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_partial_results(path) -> dict:
    """Whatever results survived, keyed by checker name."""
    out: dict = {}
    try:
        for payload, _end in _scan_path(path):
            d = json.loads(payload)
            out[d["key"]] = d["result"]
    except (OSError, ValueError):
        pass
    return out


# ---------------------------------------------------------------------------
# JSON round-trip for test maps / results
# ---------------------------------------------------------------------------

def jsonable(v: Any, depth: int = 0) -> Any:
    """Best-effort JSON view of a test/results value; non-data values
    (clients, generators, ...) degrade to their repr, mirroring the
    reference's :nonserializable-keys escape hatch (store.clj:92-106)."""
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
