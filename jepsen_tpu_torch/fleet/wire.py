"""The fleet wire protocol: CRC-framed JSON messages over a stream (the
port's copy of jepsen_tpu/fleet/wire.py).

The store's jlog framing (store/format.py: [u32 len][u32 crc][payload])
applied to a socket. On disk a torn tail is dropped; on a stream a
torn or corrupt frame means the connection is unusable — the receiver
raises FrameError, the connection closes, and the CLIENT recovers by
reconnecting and resyncing from the server's acked sequence number.
Nothing is ever half-applied: a frame either passes its CRC whole or
the stream dies at that frame.

Messages are JSON dicts with a "type" key:

  client -> server
    hello   {tenant, run, model, weight}   open/resume a stream
    chunk   {seq, ops, tc?}                one batch of history ops
    fin     {chunks, tc?}                  stream complete; check it
    claim   {}                             wait for the run's verdict
    status  {}                             server + per-tenant stats

  server -> client
    helloed {last_seq, verdict?, latency?} admitted (resume point)
    reject  {reason, retry_after}          admission control said no
    ack     {seq}                          chunk journaled (WAL'd)
    verdict {result, latency?}             the run's verdict + cert
    stats   {...}                          status reply
    error   {reason}                       protocol violation

`tc` is the flight recorder's trace context (fleet/flightrec.py),
minted by the client per (tenant, run, seq): {"t":
monotonic-ns send stamp, "trace"?: the run's optrace trace id}. It is
OPTIONAL and backward-compatible both ways — an old server ignores
it, an old client simply never sends it — so every chunk's lifecycle
links into one cross-process span without a protocol version bump.
`latency` rides NEXT to the verdict for the same reason: the verdict
file's bytes must stay timing-free (byte-identical crash replay).
"""

from __future__ import annotations

import json
import socket
import struct
import zlib

MAGIC = b"JTPUFLT1"
_HDR = struct.Struct("<II")
MAX_FRAME = 16 << 20  # one chunk of ops fits comfortably


class FrameError(Exception):
    """Torn/corrupt frame or dead peer: the connection is unusable."""


def frame_msg(msg: dict) -> bytes:
    payload = json.dumps(msg, separators=(",", ":"),
                         sort_keys=True).encode()
    if len(payload) > MAX_FRAME:
        # ValueError, not FrameError: retrying an oversized frame can
        # never succeed — the caller must split the chunk, not
        # reconnect (the retry layer only absorbs FrameError/OSError)
        raise ValueError(
            f"message too large ({len(payload)} > {MAX_FRAME} bytes);"
            " lower chunk_ops")
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def send_msg(sock: socket.socket, msg: dict) -> None:
    try:
        sock.sendall(frame_msg(msg))
    except OSError as e:
        raise FrameError(f"send failed: {e}") from e


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            part = sock.recv(n - len(buf))
        except OSError as e:
            raise FrameError(f"recv failed: {e}") from e
        if not part:
            raise FrameError("connection closed mid-frame")
        buf.extend(part)
    return bytes(buf)


def recv_msg(sock: socket.socket) -> dict:
    hdr = recv_exact(sock, _HDR.size)
    n, crc = _HDR.unpack(hdr)
    if n > MAX_FRAME:
        raise FrameError(f"frame too large ({n} bytes)")
    payload = recv_exact(sock, n)
    if zlib.crc32(payload) != crc:
        raise FrameError("frame CRC mismatch")
    try:
        msg = json.loads(payload)
    except ValueError as e:
        raise FrameError(f"frame not JSON: {e}") from e
    if not isinstance(msg, dict) or not isinstance(msg.get("type"),
                                                   str):
        raise FrameError("frame not a typed message")
    return msg


def send_magic(sock: socket.socket) -> None:
    try:
        sock.sendall(MAGIC)
    except OSError as e:
        raise FrameError(f"send failed: {e}") from e


def recv_magic(sock: socket.socket) -> None:
    if recv_exact(sock, len(MAGIC)) != MAGIC:
        raise FrameError("bad protocol magic")


# ---------------------------------------------------------------------------
# Op <-> wire round trip (the store codec's JSON view of an Op)
# ---------------------------------------------------------------------------

def ops_to_wire(ops) -> list[dict]:
    from ..store import format as fmt

    return [fmt.jsonable(o.to_dict() if hasattr(o, "to_dict") else o)
            for o in ops]


def ops_from_wire(ds: list) -> list:
    from ..history import op as make_op

    return [make_op(**d) for d in ds]
