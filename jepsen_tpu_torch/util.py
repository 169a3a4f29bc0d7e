"""Host helpers of the port: the part of jepsen_tpu/util.py that the
checkers, the generators and the interpreter need (the port keeps its own
copy and imports nothing of the JAX package).

Mirrors the roles of jepsen/src/jepsen/util.clj (relative-time-nanos
util.clj:388-407, real-pmap util.clj:71-83, timeout util.clj:430,
with-retry util.clj:487-529, nemesis-intervals util.clj:780). The
relative-time origin is this module's own state: ops, telemetry spans
and trace records of the port are stamped on it.
"""

from __future__ import annotations

import random
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Any, Callable, Iterable

# ---------------------------------------------------------------------------
# Relative time
# ---------------------------------------------------------------------------

_relative_time_origin: int | None = None
_origin_lock = threading.Lock()


def init_relative_time(origin: int | None = None) -> int:
    """Fixes the origin of the test's linear clock (monotonic nanoseconds).

    Mirrors jepsen.util/with-relative-time (util.clj:397-407): all op
    times in a history are nanoseconds since this origin.
    """
    global _relative_time_origin
    with _origin_lock:
        _relative_time_origin = _time.monotonic_ns() if origin is None else origin
    return _relative_time_origin


def relative_time_nanos() -> int:
    """Nanoseconds since the origin fixed by init_relative_time."""
    origin = _relative_time_origin
    if origin is None:
        origin = init_relative_time()
    return _time.monotonic_ns() - origin


@contextmanager
def with_relative_time():
    """Scopes a fresh relative-time origin, restoring the old one after."""
    global _relative_time_origin
    old = _relative_time_origin
    init_relative_time()
    try:
        yield
    finally:
        with _origin_lock:
            _relative_time_origin = old


def secs_to_nanos(secs: float) -> int:
    return int(secs * 1_000_000_000)


def nanos_to_secs(nanos: float) -> float:
    return nanos / 1_000_000_000


def ms_to_nanos(ms: float) -> int:
    return int(ms * 1_000_000)


# ---------------------------------------------------------------------------
# Parallelism helpers (host-side control plane)
# ---------------------------------------------------------------------------


class RealPmapError(Exception):
    """One or more real_pmap tasks failed; carries all underlying errors."""

    def __init__(self, errors):
        self.errors = errors
        super().__init__(f"{len(errors)} parallel task(s) failed: {errors[0]!r}")


def real_pmap(f: Callable[[Any], Any], xs: Iterable[Any]) -> list:
    """Failure-propagating parallel map over a thread per element.

    Mirrors jepsen.util/real-pmap (util.clj:71-83): unlike lazy pmap, runs
    every element eagerly on its own thread and raises if any task raised.
    """
    xs = list(xs)
    if not xs:
        return []
    if len(xs) == 1:
        return [f(xs[0])]
    with ThreadPoolExecutor(max_workers=len(xs)) as pool:
        futures = [pool.submit(f, x) for x in xs]
        results, errors = [], []
        for fut in futures:
            try:
                results.append(fut.result())
            except Exception as e:  # noqa: BLE001 - propagate all task failures
                errors.append(e)
        if errors:
            raise RealPmapError(errors)
        return results


def bounded_pmap(f: Callable[[Any], Any], xs: Iterable[Any],
                 limit: int = 16) -> list:
    """Parallel map with at most `limit` concurrent tasks. An exception
    of any task is raised when its result is read."""
    xs = list(xs)
    if not xs:
        return []
    with ThreadPoolExecutor(max_workers=min(limit, len(xs))) as pool:
        return list(pool.map(f, xs))


class Timeout(Exception):
    pass


def timeout(seconds: float, f: Callable[[], Any],
            default: Any = Timeout) -> Any:
    """Runs f on a worker thread; if it exceeds the deadline, returns
    `default` (or raises Timeout when no default is given). The worker is
    abandoned, not interrupted, as in jepsen.util/timeout
    (util.clj:430-442): work it started on a device goes on running."""
    result: list = []
    error: list = []

    def run():
        try:
            result.append(f())
        except Exception as e:  # noqa: BLE001 — re-raised by the caller
            error.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        if default is Timeout:
            raise Timeout(f"timed out after {seconds}s")
        return default
    if error:
        raise error[0]
    return result[0]


def integer_interval_set_str(xs: Iterable[int]) -> str:
    """Compact string for a set of ints, e.g. '#{1..3 5 7..9}'
    (jepsen.util/integer-interval-set-str, util.clj:691)."""
    xs = sorted(set(xs))
    if not xs:
        return "#{}"
    parts = []
    lo = hi = xs[0]
    for x in xs[1:]:
        if x == hi + 1:
            hi = x
        else:
            parts.append(f"{lo}..{hi}" if lo != hi else f"{lo}")
            lo = hi = x
    parts.append(f"{lo}..{hi}" if lo != hi else f"{lo}")
    return "#{" + " ".join(parts) + "}"


def with_retry(
    f: Callable[[], Any],
    *,
    retries: int = 5,
    backoff: float = 1.0,
    exceptions: tuple = (Exception,),
) -> Any:
    """Calls f, retrying up to `retries` times on the given exceptions with
    linear backoff. Mirrors the common jepsen.util/with-retry idiom
    (util.clj:487-529)."""
    attempt = 0
    while True:
        try:
            return f()
        except exceptions:
            attempt += 1
            if attempt > retries:
                raise
            _time.sleep(backoff * attempt)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


def name_str(x: Any) -> str:
    """Printable name for a thread/process id (int or str like 'nemesis')."""
    return str(x)


def seeded_rng(seed, *key):
    """A `random.Random` deterministically derived from (seed, *key).

    Uses a string seed (CPython seeds str via SHA-512) so replays are
    stable across processes regardless of PYTHONHASHSEED; a None seed
    yields a nondeterministic generator, matching every workload's
    "no seed = fresh randomness" convention.
    """
    return random.Random(None if seed is None else repr((seed,) + key))


def nemesis_intervals(history, specs=None) -> list:
    """Pairs up nemesis start/stop ops into [start, stop] intervals.

    Mirrors jepsen.util/nemesis-intervals (util.clj:780-827). `specs` is a
    list of {'start': set_of_fs, 'stop': set_of_fs} maps; defaults to
    {:start}/{:stop}.
    """
    specs = specs or [{"start": {"start"}, "stop": {"stop"}}]
    nemesis_ops = [op for op in history if op.process == "nemesis"]
    intervals = []
    for spec in specs:
        starts, stops = spec["start"], spec["stop"]
        open_start = None
        for op in nemesis_ops:
            if op.f in starts and op.type == "info":
                if open_start is None:
                    open_start = op
            elif op.f in stops and op.type == "info" and open_start is not None:
                intervals.append([open_start, op])
                open_start = None
        if open_start is not None:
            intervals.append([open_start, None])
    return intervals
