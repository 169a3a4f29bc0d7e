"""Per-(tenant, run) write-ahead journal + atomic verdict files (the
port's copy of jepsen_tpu/fleet/wal.py).

Every chunk a tenant streams is journaled here BEFORE its ack goes
back on the wire, so the ack is a durability promise: a SIGKILL'd
server replays its WAL on restart and reaches byte-identical verdicts
for every acked byte. The framing is the jlog discipline
(store/format.py): CRC-framed JSON records, torn/corrupt tail dropped
on read. Each append is ONE os.write on an O_APPEND fd — the same
single-write discipline the shared cross-run ledgers use — so even a
buggy second writer could not interleave partial records.

Records (JSON dicts with a "t" key):

  {"t": "hello", "tenant", "run", "model", "weight", "ts"}
  {"t": "chunk", "seq", "ops": [...]}     seq starts at 1
  {"t": "base",  "seq": n, "ops": [...]}  compaction: chunks 1..n
                                          coalesced into one record
  {"t": "fin",   "chunks": n}

Replay folds duplicates idempotently (a retrying client may re-send a
chunk the crash lost the ack for: first intact copy of a seq wins) and
ignores seqs past a torn tail — exactly what the client will re-send
after its resume handshake.

Compaction (checkpoint-and-extend, doc/robustness.md): once a
streaming checkpoint certifies a prefix — or the final verdict lands —
the chunk records before that point no longer need replaying one by
one, so `compact()` rewrites the journal as hello + one "base" record
(the coalesced wire-format ops of seqs 1..n) + the surviving suffix
records. The rewrite is itself crash-safe: the complete new journal is
built in a tmp file, fsync'd, then os.replace'd — until that atomic
swap the PRE-compaction file wins, and a torn tmp is invisible to
readers. A half-written base record inside the swapped file is caught
by the same CRC framing as any other record. Replay of a compacted
journal yields the identical ops list, so verdicts stay byte-identical
across compact-then-crash at any instant.

Verdicts are written ONCE per run as
`verdicts/<tenant>/<run>.json`, via tmp + rename (atomic on POSIX),
with deterministic serialization (sorted keys) so the crash-replay
test can compare verdict files byte-for-byte.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from pathlib import Path

# the repo's one short-write loop (a silently-torn record behind an
# ack would break the durability promise; better no ack than a half-
# journaled chunk)
from ..ledger import write_all

WAL_MAGIC = b"JTPUWAL1"
_HDR = struct.Struct("<II")

# chaos hook: called as hook(path, rec) before every journal append;
# may raise OSError (ENOSPC/EIO injection — the server sheds the
# chunk with retry-after instead of crashing or acking un-journaled
# bytes). Installed/cleared under _hook_lock (chaos.DurabilityChaos).
_fault_hook = None
_hook_lock = threading.Lock()


def set_fault_hook(hook) -> None:
    global _fault_hook
    with _hook_lock:
        _fault_hook = hook

# tenant/run names become path components: keep them boring. Enforced
# at admission (server) AND here (defense in depth).
_SAFE = set("abcdefghijklmnopqrstuvwxyz"
            "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def safe_name(name) -> bool:
    s = str(name)
    return (0 < len(s) <= 128 and set(s) <= _SAFE
            and not s.startswith("."))


def wal_path(base, tenant: str, run: str) -> Path:
    assert safe_name(tenant) and safe_name(run), (tenant, run)
    return Path(base) / "wal" / tenant / f"{run}.wal"


def verdict_path(base, tenant: str, run: str) -> Path:
    assert safe_name(tenant) and safe_name(run), (tenant, run)
    return Path(base) / "verdicts" / tenant / f"{run}.json"




class RunWAL:
    """Append-only journal for one (tenant, run) stream. The server
    serializes appends per run (RunState lock); the O_APPEND
    single-write is belt-and-braces against any second fd on the same
    file (e.g. a half-dead handler thread surviving a kill())."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fresh = not self.path.exists() or \
            self.path.stat().st_size == 0
        self._fd = os.open(self.path,
                           os.O_APPEND | os.O_CREAT | os.O_WRONLY)
        if fresh:
            write_all(self._fd, WAL_MAGIC)  # a short magic poisons
            # the whole WAL for every future reader — loop or raise

    def append(self, rec: dict) -> None:
        with _hook_lock:
            hook = _fault_hook
        if hook is not None:
            hook(self.path, rec)  # may raise OSError (injected fault)
        payload = json.dumps(rec, separators=(",", ":"),
                             sort_keys=True).encode()
        write_all(self._fd,
                  _HDR.pack(len(payload), zlib.crc32(payload))
                  + payload)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def compact_through(self, through_seq: int) -> bool:
        """Atomically rewrites this journal with seqs 1..through_seq
        coalesced into one "base" record. Caller serializes against
        appends (RunState lock). The fd is reopened on the new file so
        later appends land after the swap."""
        if self._fd is None:
            return compact(self.path, through_seq)
        os.close(self._fd)
        self._fd = None
        try:
            return compact(self.path, through_seq)
        finally:
            self._fd = os.open(self.path,
                               os.O_APPEND | os.O_CREAT | os.O_WRONLY)


def read_records(path) -> list[dict]:
    """Intact records in append order; torn/corrupt tail dropped (the
    jlog recovery rule)."""
    p = Path(path)
    try:
        buf = p.read_bytes()
    except OSError:
        return []
    if buf[:len(WAL_MAGIC)] != WAL_MAGIC:
        return []
    out: list[dict] = []
    pos = len(WAL_MAGIC)
    while pos + _HDR.size <= len(buf):
        n, crc = _HDR.unpack(buf[pos:pos + _HDR.size])
        payload = buf[pos + _HDR.size:pos + _HDR.size + n]
        if len(payload) < n or zlib.crc32(payload) != crc:
            break  # torn tail: the client will re-send from last_seq
        try:
            rec = json.loads(payload)
        except ValueError:
            break
        if isinstance(rec, dict) and isinstance(rec.get("t"), str):
            out.append(rec)
        pos += _HDR.size + n
    return out


def replay(path) -> dict:
    """Folds a WAL into {'hello', 'base', 'chunks': {seq: ops},
    'last_seq', 'fin'}. Duplicate seqs keep the FIRST intact copy (a
    client retransmit after a lost ack carries identical ops — and if
    a buggy client ever sent different ones, first-wins keeps replay
    stable across restarts). A "base" record (compaction) floors the
    seq space: chunks at or below its seq are already coalesced into
    it. last_seq is the highest CONTIGUOUS seq from the base (or 1) —
    the resume point the hello handshake reports; a gap means the
    missing chunk was never journaled, so everything after it will be
    re-sent."""
    hello = None
    base = None
    chunks: dict[int, list] = {}
    fin = None
    for rec in read_records(path):
        t = rec.get("t")
        if t == "hello" and hello is None:
            hello = rec
        elif t == "base" and base is None:
            seq = rec.get("seq")
            if isinstance(seq, int) and seq >= 0:
                base = {"seq": seq, "ops": rec.get("ops") or []}
        elif t == "chunk":
            seq = rec.get("seq")
            if isinstance(seq, int) and seq >= 1 \
                    and seq not in chunks:
                chunks[seq] = rec.get("ops") or []
        elif t == "fin" and fin is None:
            fin = rec
    floor = base["seq"] if base else 0
    last = floor
    while (last + 1) in chunks:
        last += 1
    return {"hello": hello,
            "base": base,
            "chunks": {s: o for s, o in chunks.items()
                       if floor < s <= last},
            "last_seq": last,
            "fin": fin}


def replay_ops(folded: dict) -> list:
    """The journaled history ops, in stream order, as Op objects —
    identical whether or not the journal was compacted (the base
    record IS seqs 1..base['seq'], coalesced)."""
    from . import wire

    out: list = []
    base = folded.get("base")
    start = 1
    if base:
        out.extend(wire.ops_from_wire(base["ops"]))
        start = base["seq"] + 1
    for seq in range(start, folded["last_seq"] + 1):
        out.extend(wire.ops_from_wire(folded["chunks"][seq]))
    return out


def _frame(rec: dict) -> bytes:
    payload = json.dumps(rec, separators=(",", ":"),
                         sort_keys=True).encode()
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def compact(path, through_seq: int) -> bool:
    """Rewrites the journal at `path` with seqs 1..through_seq folded
    into one "base" record. Atomic (tmp + fsync + os.replace): a crash
    at ANY instant leaves either the old journal or the complete new
    one — never a mix — so replay stays byte-identical. Returns False
    (journal untouched) when there is nothing to fold: through_seq at
    or below the existing base, beyond the contiguous tail, or a
    magic-less/empty file."""
    from .. import telemetry

    p = Path(path)
    folded = replay(p)
    floor = folded["base"]["seq"] if folded["base"] else 0
    if folded["hello"] is None or not floor < through_seq \
            <= folded["last_seq"]:
        return False
    base_ops: list = []
    if folded["base"]:
        base_ops.extend(folded["base"]["ops"])
    for seq in range(floor + 1, through_seq + 1):
        base_ops.extend(folded["chunks"][seq])
    out = bytearray(WAL_MAGIC)
    out += _frame(folded["hello"])
    out += _frame({"t": "base", "seq": through_seq, "ops": base_ops})
    for seq in range(through_seq + 1, folded["last_seq"] + 1):
        out += _frame({"t": "chunk", "seq": seq,
                       "ops": folded["chunks"][seq]})
    if folded["fin"] is not None:
        out += _frame(folded["fin"])
    tmp = p.with_suffix(".compact-tmp")
    fd = os.open(tmp, os.O_CREAT | os.O_TRUNC | os.O_WRONLY)
    try:
        write_all(fd, bytes(out))
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, p)
    telemetry.count("fleet.wal.compactions")
    return True


def scan_runs(base) -> list[tuple[str, str, Path]]:
    """Every (tenant, run, wal_path) under the base dir — the crash
    recovery walk."""
    root = Path(base) / "wal"
    out = []
    if not root.is_dir():
        return out
    for tdir in sorted(root.iterdir()):
        if not tdir.is_dir() or not safe_name(tdir.name):
            continue
        for w in sorted(tdir.glob("*.wal")):
            run = w.name[:-4]
            if safe_name(run):
                out.append((tdir.name, run, w))
    return out


def json_safe(v):
    """JSON-representable (and deterministically serializable) view of
    an analysis result — the store codec's rule (sets sorted, Ops as
    dicts, non-data values degrade to repr)."""
    from ..store import format as fmt

    return fmt.jsonable(v)


def verdict_bytes(verdict: dict) -> bytes:
    """Deterministic serialization — the byte-identical-replay
    contract (and the tamper-evidence story: a tenant can hash this)."""
    return (json.dumps(verdict, separators=(",", ":"), sort_keys=True)
            + "\n").encode()


def write_verdict(base, tenant: str, run: str, verdict: dict) -> Path:
    p = verdict_path(base, tenant, run)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    tmp.write_bytes(verdict_bytes(verdict))
    os.replace(tmp, p)  # atomic: readers see old-or-new, never torn
    return p


def read_verdict(base, tenant: str, run: str) -> dict | None:
    try:
        return json.loads(verdict_path(base, tenant, run).read_text())
    except (OSError, ValueError):
        return None
