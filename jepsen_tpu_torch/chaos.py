"""Harness chaos rig: seeded fault injection for the harness ITSELF
(the port's copy of jepsen_tpu/chaos.py).

Jepsen injects faults into the system under test; this module injects
faults into *jepsen's own plumbing* — flaky control transports, client
calls that time out, duplicate, or blow up — to prove the pipeline
keeps its crash-safety promises under the same abuse it dishes out.
The invariants a chaotic run must keep (tests/test_chaos.py asserts
all of them):

  1. the run TERMINATES — no fault wedges the interpreter;
  2. the history stays WELL-FORMED (validate_history below);
  3. teardown HEALS — the final heal fires even when the nemesis died;
  4. the STORE VALIDATES — history.jlog is fully readable, results
     land;
  5. analysis SUCCEEDS OR DEGRADES CLEANLY — valid? is True, False, or
     'unknown', never an exception.

Faults are driven by util.seeded_rng, so a failing combination replays
from its seed. Rates are per-call probabilities:

  drop-connection  control: TransportError BEFORE the command runs
                   client:  definite :fail (the op never executed)
  command-timeout  control: the command RUNS, then TransportError (the
                   classic indeterminate window — a retry double-
                   applies, exactly the hazard retries create)
                   client:  the op RUNS, then completes :info
  duplicate        the command/op is applied twice (an internally
                   retrying client), completion reports the second run
  exception        client only: the invoke raises — the interpreter
                   must crash the worker to :info and reincarnate the
                   process

See doc/robustness.md.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Optional

from . import client as jclient
from . import coverage, telemetry, util
from .nemesis import core as _jnemesis_core
from .control.core import Action, Remote, Result, Session, TransportError
from .history import History

DEFAULT_REMOTE_RATES = {
    "drop-connection": 0.05,
    "command-timeout": 0.05,
    "duplicate": 0.02,
}

DEFAULT_CLIENT_RATES = {
    "drop-connection": 0.05,
    "command-timeout": 0.05,
    "duplicate": 0.03,
    "exception": 0.03,
}


class ChaosError(RuntimeError):
    """The injected client-side failure (a 'bug' in the client/worker
    the interpreter must absorb as a crash-to-:info)."""


class _Injector:
    """Shared seeded dice + tally. One per wrapped session/client so
    call sequences stay deterministic per (seed, scope)."""

    def __init__(self, seed, scope: tuple, rates: dict,
                 tally: Counter):
        self.rng = util.seeded_rng(seed, *scope)
        self.rates = rates
        self.tally = tally

    def roll(self) -> Optional[str]:
        """At most one fault per call: the rates partition [0, 1)."""
        r = self.rng.random()
        acc = 0.0
        for kind, p in self.rates.items():
            acc += p
            if r < acc:
                self.tally[kind] += 1
                telemetry.count(f"chaos.{kind}")
                # harness faults are coverage cells too (`harness-*`
                # kinds): a run abused by the chaos rig exercises the
                # pipeline's crash-safety column in the atlas
                coverage.record_harness(kind)
                return kind
        return None


class ChaosSession(Session):
    def __init__(self, inner: Session, inj: _Injector, node):
        self.inner = inner
        self.inj = inj
        self.node = node

    def execute(self, action: Action) -> Result:
        kind = self.inj.roll()
        if kind == "drop-connection":
            raise TransportError("chaos: connection dropped",
                                 node=self.node, cmd=action.cmd)
        res = self.inner.execute(action)
        if kind == "duplicate":
            res = self.inner.execute(action)
        elif kind == "command-timeout":
            # the command RAN; the caller only sees a dead transport
            raise TransportError("chaos: command timed out after "
                                 "completing", node=self.node,
                                 cmd=action.cmd)
        return res

    def upload(self, local_paths, remote_path) -> None:
        if self.inj.roll() == "drop-connection":
            raise TransportError("chaos: connection dropped",
                                 node=self.node)
        return self.inner.upload(local_paths, remote_path)

    def download(self, remote_paths, local_path) -> None:
        if self.inj.roll() == "drop-connection":
            raise TransportError("chaos: connection dropped",
                                 node=self.node)
        return self.inner.download(remote_paths, local_path)

    def disconnect(self) -> None:
        self.inner.disconnect()


class ChaosRemote(Remote):
    """Wraps a Remote so every session misbehaves with seeded
    probabilities. `tally` (a Counter) records what was injected."""

    _guarded_by_lock = {"_lock": ("_n_conns",)}

    def __init__(self, inner: Remote, seed=0, rates: dict | None = None,
                 connect_rate: float = 0.0):
        self.inner = inner
        self.seed = seed
        self.rates = dict(DEFAULT_REMOTE_RATES if rates is None
                          else rates)
        self.connect_rate = connect_rate
        self.tally: Counter = Counter()
        self._lock = threading.Lock()
        self._n_conns: Counter = Counter()

    def connect(self, conn_spec: dict) -> Session:
        host = conn_spec.get("host")
        with self._lock:
            self._n_conns[host] += 1
            nth = self._n_conns[host]
        inj = _Injector(self.seed, ("remote", str(host), nth),
                        self.rates, self.tally)
        if self.connect_rate and inj.rng.random() < self.connect_rate:
            self.tally["connect-refused"] += 1
            telemetry.count("chaos.connect-refused")
            raise TransportError("chaos: connect refused", node=host)
        return ChaosSession(self.inner.connect(conn_spec), inj, host)


class ChaosClient(jclient.Client):
    """Wraps a Client so invocations misbehave with seeded
    probabilities. Each fault maps to an HONEST completion — a dropped
    op (never ran) is a definite :fail, a timed-out op (ran!) is
    :info, an injected exception crashes the worker — so a correct
    checker over a chaotic history still reaches a sound verdict."""

    def __init__(self, inner: jclient.Client, seed=0,
                 rates: dict | None = None, tally: Counter | None = None,
                 _inj: _Injector | None = None,
                 _shared=None):
        self.inner = inner
        self.seed = seed
        self.rates = dict(DEFAULT_CLIENT_RATES if rates is None
                          else rates)
        self.tally = tally if tally is not None else Counter()
        self._inj = _inj
        # open-counter shared across the open tree (workers reopen
        # clients on process reincarnation: each reopen needs a fresh
        # deterministic stream)
        self._shared = _shared if _shared is not None else \
            {"lock": threading.Lock(), "opens": Counter()}

    def open(self, test, node):
        with self._shared["lock"]:
            self._shared["opens"][node] += 1
            nth = self._shared["opens"][node]
        inj = _Injector(self.seed, ("client", str(node), nth),
                        self.rates, self.tally)
        return ChaosClient(self.inner.open(test, node), self.seed,
                           self.rates, self.tally, _inj=inj,
                           _shared=self._shared)

    def setup(self, test):
        self.inner.setup(test)
        return self

    def invoke(self, test, op):
        kind = self._inj.roll() if self._inj is not None else None
        if kind == "exception":
            raise ChaosError("chaos: injected worker exception")
        if kind == "drop-connection":
            # never reached the database: definite fail
            return op.copy(type="fail", error="chaos: connection "
                                              "refused")
        op2 = self.inner.invoke(test, op)
        if kind == "duplicate":
            op2 = self.inner.invoke(test, op)
        elif kind == "command-timeout":
            # the op took effect but the reply was lost: indeterminate
            return op.copy(type="info", error="chaos: timeout")
        return op2

    def teardown(self, test):
        self.inner.teardown(test)

    def close(self, test):
        self.inner.close(test)

    def reusable(self, test):
        return jclient.is_reusable(self.inner, test)


class CrashingNemesis(_jnemesis_core.Nemesis):
    """A nemesis whose teardown dies — the case final heal must still
    fire (core.final_heal). Wraps any nemesis; setup/invoke delegate."""

    def __init__(self, inner, crash_teardown: bool = True):
        self.inner = inner
        self.crash_teardown = crash_teardown

    def setup(self, test):
        return CrashingNemesis(self.inner.setup(test),
                               self.crash_teardown)

    def invoke(self, test, op):
        return self.inner.invoke(test, op)

    def teardown(self, test):
        if self.crash_teardown:
            telemetry.count("chaos.nemesis-teardown-crashes")
            coverage.record_harness("nemesis-teardown-crash")
            raise ChaosError("chaos: nemesis teardown crashed")
        self.inner.teardown(test)

    def fs(self):
        return self.inner.fs()

    def fault_kinds(self):
        return self.inner.fault_kinds()


# ---------------------------------------------------------------------------
# Fleet transport chaos
# ---------------------------------------------------------------------------

DEFAULT_FLEET_RATES = {
    "drop-frame": 0.05,       # the frame vanishes (ack never comes)
    "duplicate-frame": 0.04,  # sent twice (server dedups by seq)
    "reorder-frame": 0.04,    # held back; rides behind the next frame
    "truncate-frame": 0.03,   # half a frame, then the socket dies
}


class ChaosFleetTransport:
    """Seeded chaos on the fleet client's frame stream
    (fleet/client.py's Transport seam): frames are dropped,
    duplicated, reordered, or torn mid-frame with per-send
    probabilities, driving the exact recovery machinery a hostile
    network exercises — ack timeouts, seq-dedup, resync rewinds, and
    torn-frame reconnects. The invariant (tests/test_fleet.py): a
    chaos-wrapped stream still journals the identical op sequence and
    yields the identical verdict + certificate as a clean one.

    One injector per connection attempt keeps the fault schedule
    deterministic per (seed, connection ordinal) even as retries
    reconnect. `hello` frames are exempt from drop/reorder (a client
    whose every hello is eaten isn't a transport test, it's a timeout
    test) but NOT from truncate — a torn hello must also recover."""

    _guarded_by_lock = {"_lock": ("_conns", "_inj", "_inj_sock",
                                  "_held")}

    def __init__(self, seed=0, rates: dict | None = None,
                 tally: Counter | None = None):
        self.seed = seed
        self.rates = dict(DEFAULT_FLEET_RATES if rates is None
                          else rates)
        self.tally = tally if tally is not None else Counter()
        self._lock = threading.Lock()
        self._conns = 0
        self._inj: Optional[_Injector] = None
        self._inj_sock = None
        self._held: Optional[bytes] = None  # reordered frame in limbo

    def _injector(self, sock) -> _Injector:
        # a new socket object = a new connection: fresh seeded stream
        with self._lock:
            if self._inj is None or self._inj_sock is not sock:
                self._conns += 1
                self._inj = _Injector(
                    self.seed, ("fleet", self._conns),
                    self.rates, self.tally)
                self._inj_sock = sock
                self._held = None
            return self._inj

    def send(self, sock, msg: dict) -> None:
        import socket as _socket

        from .fleet import wire

        inj = self._injector(sock)
        kind = inj.roll()
        buf = wire.frame_msg(msg)
        is_hello = msg.get("type") == "hello"
        if kind == "truncate-frame" and len(buf) > 8:
            # half a frame on the wire, then a dead socket: the
            # receiver sees a torn tail and both sides resync
            try:
                sock.sendall(buf[:len(buf) // 2])
                sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            raise wire.FrameError("chaos: frame torn mid-send")
        if kind == "drop-frame" and not is_hello:
            return  # vanished: the ack timeout will notice
        with self._lock:
            held, self._held = self._held, None
            if kind == "reorder-frame" and not is_hello \
                    and held is None:
                self._held = buf  # rides behind the NEXT frame
                return
        try:
            if held is not None:
                sock.sendall(buf + held)  # swapped order
            else:
                sock.sendall(buf)
                if kind == "duplicate-frame":
                    sock.sendall(buf)
        except OSError as e:
            raise wire.FrameError(f"send failed: {e}") from e

    def recv(self, sock) -> dict:
        from .fleet import wire

        return wire.recv_msg(sock)


# ---------------------------------------------------------------------------
# Durability chaos (checkpoint-and-extend, doc/robustness.md)
# ---------------------------------------------------------------------------

DEFAULT_WAL_FAULT_RATES = {
    "enospc": 0.05,
    "eio": 0.05,
}

DEFAULT_CKPT_FAULT_RATES = {
    "enospc": 0.05,
    "eio": 0.05,
    "torn-ckpt": 0.05,
    "stale-ckpt": 0.03,
}


class DurabilityChaos:
    """Seeded durability faults on the fleet's two write-behind paths
    — WAL appends (fleet.wal.set_fault_hook) and checkpoint writes
    (gpu/ckpt.py set_fault_hook). The invariants (tests/test_fleet.py):
    the server SHEDS un-journalable chunks with retry-after and an
    honest degraded stamp (never crashes, never acks bytes it didn't
    journal), torn/stale checkpoints are detected-and-discarded on
    read, and the verdict every stream eventually reaches is
    byte-identical to a solo run's.

      enospc / eio   OSError raised from the write call itself
      torn-ckpt      the checkpoint lands truncated mid-frame (the
                     atomic-rename discipline normally prevents this;
                     the injection simulates a broken filesystem)
      stale-ckpt     the PREVIOUS checkpoint's bytes land instead of
                     the new ones (a frozen cache) — valid framing,
                     wrong frontier: the digest screen must catch it

    Use as a context manager; hooks are process-global, so one rig at
    a time."""

    _guarded_by_lock = {"_lock": ("_last_ckpt",)}

    def __init__(self, seed=0, wal_rates: dict | None = None,
                 ckpt_rates: dict | None = None,
                 tally: Counter | None = None):
        self.tally = tally if tally is not None else Counter()
        self._wal_inj = _Injector(
            seed, ("durability", "wal"),
            dict(DEFAULT_WAL_FAULT_RATES if wal_rates is None
                 else wal_rates), self.tally)
        self._ckpt_inj = _Injector(
            seed, ("durability", "ckpt"),
            dict(DEFAULT_CKPT_FAULT_RATES if ckpt_rates is None
                 else ckpt_rates), self.tally)
        self._lock = threading.Lock()
        self._last_ckpt: dict[str, bytes] = {}

    def __enter__(self) -> "DurabilityChaos":
        from .fleet import wal as fwal
        from .gpu import ckpt as tckpt

        fwal.set_fault_hook(self._wal_hook)
        tckpt.set_fault_hook(self._ckpt_hook)
        return self

    def __exit__(self, *exc) -> None:
        from .fleet import wal as fwal
        from .gpu import ckpt as tckpt

        fwal.set_fault_hook(None)
        tckpt.set_fault_hook(None)

    @staticmethod
    def _oserror(kind: str) -> OSError:
        import errno

        code = errno.ENOSPC if kind == "enospc" else errno.EIO
        return OSError(code, f"chaos: injected {kind}")

    def _wal_hook(self, path, rec) -> None:
        kind = self._wal_inj.roll()
        if kind in ("enospc", "eio"):
            raise self._oserror(kind)

    def _ckpt_hook(self, path, data: bytes) -> bytes:
        kind = self._ckpt_inj.roll()
        if kind in ("enospc", "eio"):
            raise self._oserror(kind)
        with self._lock:
            prev = self._last_ckpt.get(str(path))
            self._last_ckpt[str(path)] = data
        if kind == "torn-ckpt":
            return data[:max(len(data) // 2, 1)]
        if kind == "stale-ckpt" and prev is not None:
            return prev
        return data


def corrupt_checkpoint(path, mode: str = "torn") -> None:
    """Damages an on-disk checkpoint file in exactly the ways
    `gpu/ckpt.py read` must detect and discard:

      torn      truncated mid-frame (short payload)
      garbage   one payload byte flipped (CRC mismatch)
      magic     the magic scribbled (not a checkpoint at all)
    """
    from pathlib import Path

    p = Path(path)
    buf = bytearray(p.read_bytes())
    if mode == "torn":
        buf = buf[:max(len(buf) // 2, 9)]
    elif mode == "garbage":
        buf[-1] ^= 0xFF
    elif mode == "magic":
        buf[0] ^= 0xFF
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    p.write_bytes(bytes(buf))


# ---------------------------------------------------------------------------
# Invariant checks
# ---------------------------------------------------------------------------

_COMPLETIONS = ("ok", "fail", "info")


def validate_history(hist) -> list[str]:
    """Well-formedness problems in a history ([] = well-formed):
    contiguous indices, each client completion pairs the process's open
    invocation with the same :f, completion types legal, no client op
    on a process with an already-open invocation."""
    problems: list[str] = []
    if not isinstance(hist, History):
        hist = History(hist)
    open_inv: dict = {}
    for i, op in enumerate(hist):
        if op.index != i:
            problems.append(
                f"op {i} has index {op.index} (not contiguous)")
        if not isinstance(op.process, int):
            continue  # nemesis ops pair loosely (info/info)
        if op.type == "invoke":
            if op.process in open_inv:
                problems.append(
                    f"op {op.index}: process {op.process} invoked "
                    "while already in flight")
            open_inv[op.process] = op
        elif op.type in _COMPLETIONS:
            inv = open_inv.pop(op.process, None)
            if inv is None:
                problems.append(
                    f"op {op.index}: completion without invocation "
                    f"(process {op.process})")
            elif inv.f != op.f:
                problems.append(
                    f"op {op.index}: completion f={op.f!r} != "
                    f"invocation f={inv.f!r}")
        else:
            problems.append(
                f"op {op.index}: illegal type {op.type!r}")
    return problems
