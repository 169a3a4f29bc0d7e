"""Crash-consistent checkpoint store for incremental re-checking: the
port of jepsen_tpu/tpu/ckpt.py.

A checker that already certified a prefix of a history should not pay
for that prefix again, not after a crash and not when a run grows. This
module is the durable store those resumes trust:

  record    one schema-validated JSON dict per checkpoint file, keyed
            by a history-prefix digest. Three kinds:
              stream-wgl   a streaming run's frontier: entries
                           certified, reachable-state mask, raw-op
                           prefix digest (the fleet's streams)
              wgl-extend   the segmented extend-check's frontier: the
                           stride-stable cut layout, per-cut entry
                           digests, and every resolved
                           (segment, state) -> reach mask
                           (wgl.analysis_extend)
              elle         a committed-txn graph summary: per-key
                           version orders and the stream's state
                           (elle.StreamingElle)
  framing   CKPT_MAGIC + <len, crc32> + payload. Writes go to a tmp
            file (fsync'd) then os.replace, so a reader sees old or
            new, never torn. A torn, truncated or schema-invalid file
            reads as None with a counted telemetry event, and the
            caller checks the whole history again.
  digests   sha256 over the canonical codec bytes of the history prefix
            (ops_digest) or over the encoded entry prefix
            (entry_digest_chain). A digest mismatch means the record is
            not of a prefix of the history at hand: `ckpt.stale` is
            counted and the record ignored. Never a wrong verdict, only
            a slower one.

The records, their framing and their digests are the JAX package's byte
for byte, so a store written by one package is resumed by the other.
Durability faults (ENOSPC, EIO; a test injects them via set_fault_hook)
surface as OSError from write(); try_write() turns them into False and a
`ckpt.write-error` count, so a check goes on from its previous record.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from pathlib import Path

from .. import telemetry
from ..ledger import write_all
from ..store import format as fmt

CKPT_MAGIC = b"JTPUCKP1"
VERSION = 1

KINDS = ("stream-wgl", "wgl-extend", "elle")

# fault hook: called as hook(path, data) before the tmp write; may raise
# OSError (ENOSPC, EIO) or return changed bytes (a torn or stale
# record). Installed and cleared under _hook_lock.
_fault_hook = None
_hook_lock = threading.Lock()


def set_fault_hook(hook) -> None:
    """Installs (or, with None, clears) the write path's fault hook:
    where a test injects ENOSPC or EIO, or torn or stale bytes."""
    global _fault_hook
    with _hook_lock:
        _fault_hook = hook


# ---------------------------------------------------------------------------
# Digests
# ---------------------------------------------------------------------------

def ops_digest(ops, n: int | None = None) -> str:
    """sha256 hex over the canonical codec bytes of ops[:n]: the
    history-prefix key."""
    h = hashlib.sha256()
    take = len(ops) if n is None else min(n, len(ops))
    for i in range(take):
        h.update(fmt.encode_op(ops[i]))
        h.update(b"\n")
    return h.hexdigest()


def entry_digest_chain(enc, cuts) -> list[str]:
    """One sha256 hex per cut: digest i covers the ENCODED entries
    [0, cuts[i]). Entries before a valid cut are fixed by the history
    prefix (every one completed before later ops invoked), so the chain
    is stable as the history grows: what wgl-extend records key on."""
    h = hashlib.sha256()
    out: list[str] = []
    pos = 0
    for c in cuts:
        while pos < c:
            op = enc.entry_ops[pos]
            line = json.dumps(
                [int(getattr(op, "index", -1)), str(op.process),
                 str(op.f), fmt.jsonable(op.value),
                 bool(enc.crashed[pos])],
                separators=(",", ":"), sort_keys=True)
            h.update(line.encode())
            h.update(b"\n")
            pos += 1
        out.append(h.hexdigest())
    return out


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def _bad(msg: str) -> None:
    raise ValueError(f"checkpoint record: {msg}")


def _is_count(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 0


def validate_record(rec) -> None:
    """Raises ValueError unless `rec` is a schema-valid checkpoint
    record. A record that fails here is never trusted: the reader
    treats it like a torn file."""
    if not isinstance(rec, dict):
        _bad(f"not a dict: {type(rec).__name__}")
    if rec.get("v") != VERSION:
        _bad(f"bad version {rec.get('v')!r}")
    kind = rec.get("kind")
    if kind not in KINDS:
        _bad(f"unknown kind {kind!r}")
    dig = rec.get("digest")
    if not (isinstance(dig, str) and len(dig) == 64):
        _bad(f"bad digest {dig!r}")
    if not _is_count(rec.get("n_ops")):
        _bad(f"bad n_ops {rec.get('n_ops')!r}")
    if kind == "stream-wgl":
        for k in ("checked", "mask"):
            if not _is_count(rec.get(k)):
                _bad(f"bad {k} {rec.get(k)!r}")
        if not isinstance(rec.get("model"), str):
            _bad("bad model")
    elif kind == "wgl-extend":
        for k in ("stride", "model_fp"):
            if not _is_count(rec.get(k)):
                _bad(f"bad {k} {rec.get(k)!r}")
        cuts = rec.get("cuts")
        if not (isinstance(cuts, list) and len(cuts) >= 2
                and all(_is_count(c) for c in cuts)
                and all(a <= b for a, b in zip(cuts, cuts[1:]))):
            _bad(f"bad cuts {cuts!r}")
        digs = rec.get("digests")
        if not (isinstance(digs, list) and len(digs) == len(cuts)
                and all(isinstance(d, str) and len(d) == 64
                        for d in digs)):
            _bad("bad digests")
        states = rec.get("states")
        if not (isinstance(states, list) and 0 < len(states) <= 32
                and all(isinstance(s, str) for s in states)):
            _bad("bad states")
        masks = rec.get("masks")
        if not isinstance(masks, dict):
            _bad("bad masks")
        for key, m in masks.items():
            parts = str(key).split(":")
            if len(parts) != 2 or not all(p.isdigit() for p in parts):
                _bad(f"bad mask key {key!r}")
            if not _is_count(m):
                _bad(f"bad mask {m!r}")
    elif kind == "elle":
        if not isinstance(rec.get("family"), str):
            _bad("bad family")
        if not _is_count(rec.get("n_closed")):
            _bad(f"bad n_closed {rec.get('n_closed')!r}")
        versions = rec.get("versions")
        if not isinstance(versions, dict) or not all(
                isinstance(vs, list) for vs in versions.values()):
            _bad("bad versions")
        if not isinstance(rec.get("frontier"), dict):
            _bad("bad frontier")


# ---------------------------------------------------------------------------
# Paths
# ---------------------------------------------------------------------------

def run_dir_path(d, name: str) -> Path:
    """A stored run directory's checkpoint file."""
    return Path(d) / "ckpt" / f"{name}.ckpt"


# ---------------------------------------------------------------------------
# Atomic write, validated read
# ---------------------------------------------------------------------------

def write(path, rec: dict) -> Path:
    """Schema-validates and atomically writes one checkpoint record:
    the CRC-framed payload to a tmp file, fsync, os.replace. Raises
    OSError on a durability fault (ENOSPC, EIO) after counting
    `ckpt.write-error`; try_write() absorbs it."""
    validate_record(rec)
    p = Path(path)
    payload = json.dumps(rec, separators=(",", ":"),
                         sort_keys=True).encode()
    data = CKPT_MAGIC + fmt.frame(payload)
    with _hook_lock:
        hook = _fault_hook
    try:
        if hook is not None:
            data = hook(p, data)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        fd = os.open(tmp, os.O_CREAT | os.O_TRUNC | os.O_WRONLY)
        try:
            write_all(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, p)
    except OSError:
        telemetry.count("ckpt.write-error")
        raise
    telemetry.count("ckpt.saved")
    return p


def try_write(path, rec: dict) -> bool:
    """write(), with durability faults absorbed: False means the record
    did not land, and the previous one stays in place."""
    try:
        write(path, rec)
        return True
    except OSError:
        return False


def read(path) -> dict | None:
    """The record, or None for a missing, torn, truncated, corrupt or
    schema-invalid file; each but a missing file is counted."""
    p = Path(path)
    try:
        buf = p.read_bytes()
    except OSError:
        return None
    payload = (fmt.unframe(buf, len(CKPT_MAGIC))
               if buf[:len(CKPT_MAGIC)] == CKPT_MAGIC else None)
    if payload is None:
        telemetry.count("ckpt.torn")
        return None
    try:
        rec = json.loads(payload)
        validate_record(rec)
    except ValueError:
        telemetry.count("ckpt.invalid")
        return None
    return rec


def load(path, kind: str, digest: str | None = None,
         n_ops: int | None = None) -> dict | None:
    """read() and a screen of kind, digest and op count. A digest (or op
    count) mismatch means the record describes a different history
    prefix: `ckpt.stale` is counted and the caller checks everything."""
    rec = read(path)
    if rec is None or rec.get("kind") != kind:
        return None
    if n_ops is not None and rec.get("n_ops", 0) > n_ops:
        telemetry.count("ckpt.stale")
        return None
    if digest is not None and rec.get("digest") != digest:
        telemetry.count("ckpt.stale")
        return None
    return rec
