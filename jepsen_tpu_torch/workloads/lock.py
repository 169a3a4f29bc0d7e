"""Distributed lock-service workloads: mutual exclusion under faults,
checked as linearizability against mutex models — plain, owner-aware,
reentrant, fenced (monotonic fencing tokens), and a permit semaphore.

Capability reference: hazelcast/src/jepsen/hazelcast.clj —
fenced-lock-client (334-360: tryLockAndGetFence, ok carries the fence,
IllegalMonitorState -> fail not-lock-owner, IO "not send to owner" ->
definite fail, other IO -> info), the model zoo (513-650: ReentrantMutex,
OwnerAwareMutex, FencedMutex, ReentrantFencedMutex, AcquiredPermitsModel)
and the workloads map (660-760: acquire/release cycled per thread).

Design notes: the reference threads a mutable
client-uid->name atom through the test map because knossos models can
only see op values; here the interpreter's process IS the client
identity, so models read `op.process` directly and declare
`tabulable = False`, routing them to the object-model host search
(`gpu/wgl.search_host_model`). Lock histories are short (locks
serialize!), so the host path is the right engine and no kernel runs;
the device kernels keep handling the high-volume register/queue
families. This module is the port's copy of jepsen_tpu/workloads/lock.py;
opts["device"] reaches the linearizable checker as in the other
workloads, and the host search ignores it.

Client contract:
  {"f": "acquire"} -> ok with value {"fence": int} (or None when the
                      lock service has no fencing tokens); fail when
                      the lock was busy / the try timed out.
  {"f": "release"} -> ok; fail with error "not-lock-owner" when the
                      client did not hold the lock.
Crashed (:info) acquires/releases are handled by the search's
indeterminacy rules like any other op.
"""

from __future__ import annotations

from .. import checker as chk
from .. import generator as gen
from ..checker import models

INVALID_FENCE = -1


def _fence(op) -> int:
    v = op.value
    if isinstance(v, dict) and v.get("fence") is not None:
        return v["fence"]
    return INVALID_FENCE


class OwnerMutex(models.Model):
    """Non-reentrant mutex that tracks WHO holds it: a release by a
    non-owner is inconsistent even if the lock is held
    (hazelcast.clj OwnerAwareMutex, 539-556)."""

    tabulable = False  # steps on op.process

    def __init__(self, owner=None):
        self.owner = owner

    def step(self, op):
        if op.f == "acquire":
            if self.owner is None:
                return OwnerMutex(op.process)
            return models.inconsistent(
                f"process {op.process} acquired a lock held by "
                f"{self.owner}")
        if op.f == "release":
            if self.owner is None or self.owner != op.process:
                return models.inconsistent(
                    f"process {op.process} released a lock held by "
                    f"{self.owner}")
            return OwnerMutex(None)
        return models.inconsistent(f"unknown f {op.f!r}")

    def __repr__(self):
        return f"OwnerMutex<{self.owner}>"


class FencedMutex(models.Model):
    """Owner-aware mutex whose successful acquires carry fencing
    tokens that must be strictly monotonic across the lock's lifetime
    (hazelcast.clj FencedMutex, 564-585): a stale fence means two
    holders could order their writes inconsistently at a downstream
    resource even if mutual exclusion held."""

    tabulable = False

    def __init__(self, owner=None, max_fence=INVALID_FENCE):
        self.owner = owner
        self.max_fence = max_fence

    def step(self, op):
        if op.f == "acquire":
            if self.owner is not None:
                return models.inconsistent(
                    f"process {op.process} acquired a lock held by "
                    f"{self.owner}")
            fence = _fence(op)
            if fence == INVALID_FENCE:
                return FencedMutex(op.process, self.max_fence)
            if fence > self.max_fence:
                return FencedMutex(op.process, fence)
            return models.inconsistent(
                f"non-monotonic fence {fence} (max seen "
                f"{self.max_fence})")
        if op.f == "release":
            if self.owner is None or self.owner != op.process:
                return models.inconsistent(
                    f"process {op.process} released a lock held by "
                    f"{self.owner}")
            return FencedMutex(None, self.max_fence)
        return models.inconsistent(f"unknown f {op.f!r}")

    def __repr__(self):
        return f"FencedMutex<{self.owner}, fence={self.max_fence}>"


class ReentrantMutex(models.Model):
    """Reentrant mutex: the holder may re-acquire up to `limit` times
    total; each release pops one level; releases by non-holders are
    inconsistent (hazelcast.clj ReentrantMutex, 513-531)."""

    tabulable = False

    def __init__(self, owner=None, count=0, limit=2):
        self.owner = owner
        self.count = count
        self.limit = limit

    def step(self, op):
        if op.f == "acquire":
            if self.count < self.limit and (
                    self.owner is None or self.owner == op.process):
                return ReentrantMutex(op.process, self.count + 1,
                                      self.limit)
            return models.inconsistent(
                f"process {op.process} cannot acquire "
                f"(owner={self.owner}, count={self.count})")
        if op.f == "release":
            if self.owner is None or self.owner != op.process:
                return models.inconsistent(
                    f"process {op.process} released a lock held by "
                    f"{self.owner}")
            if self.count == 1:
                return ReentrantMutex(None, 0, self.limit)
            return ReentrantMutex(self.owner, self.count - 1, self.limit)
        return models.inconsistent(f"unknown f {op.f!r}")

    def __repr__(self):
        return (f"ReentrantMutex<{self.owner}, {self.count}/"
                f"{self.limit}>")


class Semaphore(models.Model):
    """`permits` permits shared across processes; over-acquisition or
    releasing more than held is inconsistent (hazelcast.clj
    AcquiredPermitsModel, 630-650)."""

    tabulable = False

    def __init__(self, permits=2, held=()):
        self.permits = permits
        # held is a sorted tuple of (process, count) — hashable state
        self.held = tuple(held)

    def _held_by(self, process) -> int:
        for p, c in self.held:
            if p == process:
                return c
        return 0

    def _with(self, process, count):
        items = [(p, c) for p, c in self.held
                 if p != process and c > 0]
        if count > 0:
            items.append((process, count))
        return Semaphore(self.permits, tuple(sorted(items, key=repr)))

    def step(self, op):
        total = sum(c for _, c in self.held)
        mine = self._held_by(op.process)
        if op.f == "acquire":
            if total < self.permits:
                return self._with(op.process, mine + 1)
            return models.inconsistent(
                f"all {self.permits} permits held, process "
                f"{op.process} acquired another")
        if op.f == "release":
            if mine > 0:
                return self._with(op.process, mine - 1)
            return models.inconsistent(
                f"process {op.process} released a permit it never "
                f"held")
        return models.inconsistent(f"unknown f {op.f!r}")

    def __repr__(self):
        return f"Semaphore<{self.permits}, {self.held}>"


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------

def _acquire_release_gen(o: dict, repeats: int = 1):
    """Each thread cycles acquire^repeats, release^repeats — matching
    the reference's per-thread cycled [acquire release] generator
    (hazelcast.clj workloads map)."""
    ops = ([{"f": "acquire", "value": None}] * repeats
           + [{"f": "release", "value": None}] * repeats)
    g = gen.each_thread(gen.cycle(ops))
    n = o.get("ops", 200)
    return gen.limit(n, gen.stagger(o.get("stagger", 0.001), g))


def _workload(o, model, repeats=1) -> dict:
    return {
        "generator": _acquire_release_gen(o, repeats),
        "checker": chk.linearizable({"model": model,
                                     "device": o.get("device")}),
    }


def lock_workload(opts: dict | None = None) -> dict:
    """Plain mutex — only tracks held/free (model.mutex parity)."""
    return _workload(dict(opts or {}), models.mutex())


def owner_lock_workload(opts: dict | None = None) -> dict:
    """Owner-aware mutex: wrong-owner releases are violations."""
    return _workload(dict(opts or {}), OwnerMutex())


def fenced_lock_workload(opts: dict | None = None) -> dict:
    """Owner-aware mutex + strictly monotonic fencing tokens."""
    return _workload(dict(opts or {}), FencedMutex())


def reentrant_lock_workload(opts: dict | None = None) -> dict:
    """Reentrant owner-aware mutex, acquire/acquire/release/release."""
    o = dict(opts or {})
    return _workload(o, ReentrantMutex(limit=o.get("limit", 2)),
                     repeats=o.get("limit", 2))


def semaphore_workload(opts: dict | None = None) -> dict:
    """Permit semaphore: conservation of `permits` permits."""
    o = dict(opts or {})
    return _workload(o, Semaphore(permits=o.get("permits", 2)))
