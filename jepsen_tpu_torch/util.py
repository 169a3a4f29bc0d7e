"""Host helpers of the port: the part of jepsen_tpu/util.py that the
checkers, the generators, the interpreter and the test lifecycle need
(the port keeps its own copy and imports nothing of the JAX package).

Mirrors the roles of jepsen/src/jepsen/util.clj (relative-time-nanos
util.clj:388-407, real-pmap util.clj:71-83, timeout util.clj:430,
await-fn util.clj:443-486, with-retry util.clj:487-529, named-locks
util.clj:855-943, rand-distribution util.clj:140-184, nemesis-intervals
util.clj:780, the CLI's concurrency syntax cli.clj:64-206), and the
kernel-level profiling hook (profile_trace, on torch.profiler where
the JAX package takes jax.profiler). The relative-time origin is this
module's own state: ops, telemetry spans and trace records of the port
are stamped on it.
"""

from __future__ import annotations

import math
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


def await_fn(
    f: Callable[[], Any],
    *,
    retry_interval: float = 1.0,
    log_interval: float = 10.0,
    log_message: str | None = None,
    timeout_secs: float = 60.0,
) -> Any:
    """Calls f repeatedly until it returns without raising; raises Timeout
    after timeout_secs. Mirrors jepsen.util/await-fn (util.clj:443-486)."""
    deadline = _time.monotonic() + timeout_secs
    last_log = _time.monotonic()
    while True:
        try:
            return f()
        except Exception as e:  # noqa: BLE001
            now = _time.monotonic()
            if now > deadline:
                raise Timeout(
                    f"await_fn timed out after {timeout_secs}s: {e!r}"
                ) from e
            if log_message and now - last_log >= log_interval:
                import logging

                logging.getLogger(__name__).info("%s (%r)", log_message, e)
                last_log = now
            _time.sleep(retry_interval)


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


class NamedLocks:
    """A family of locks keyed by name (jepsen.util/named-locks,
    util.clj:855-943): with_named_lock serializes bodies per key."""

    def __init__(self):
        self._guard = threading.Lock()
        self._locks: dict = {}

    @contextmanager
    def hold(self, name):
        with self._guard:
            lock = self._locks.setdefault(name, threading.Lock())
        with lock:
            yield


def named_locks() -> NamedLocks:
    return NamedLocks()


def meh(f: Callable[[], Any]) -> Any:
    """Calls f, returning its value, or the exception it raised instead
    of propagating it (jepsen.util/meh)."""
    try:
        return f()
    except Exception as e:  # noqa: BLE001
        return e


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


def majority(n: int) -> int:
    """Smallest majority of n nodes (util.clj)."""
    return n // 2 + 1


def minority_third(n: int) -> int:
    """Largest integer strictly less than n/3 (util.clj:95-99), for
    byzantine-fault thresholds."""
    return (n - 1) // 3


def random_nonempty_subset(coll, rng: Any = None) -> list | None:
    """A randomly selected, randomly ordered, non-empty subset; None for
    an empty collection (util.clj:51-56)."""

    rng = rng or random
    coll = list(coll)
    if not coll:
        return None
    rng.shuffle(coll)
    return coll[:1 + rng.randrange(len(coll))]


def rand_distribution(dist_map: dict | None = None, rng: Any = None):
    """Random value from a distribution spec (util.clj:140-184):
    {'distribution': 'uniform', 'min': 0, 'max': 1024} |
    {'distribution': 'geometric', 'p': 1e-3} |
    {'distribution': 'one-of', 'values': [...]} |
    {'distribution': 'weighted', 'weights': {value: weight, ...}}"""

    rng = rng or random
    d = dict(dist_map or {})
    kind = d.get("distribution", "uniform")
    if kind == "uniform":
        lo = d.get("min", 0)
        hi = d.get("max", 2 ** 63 - 1)
        assert lo < hi, f"invalid distribution-map: {d}"
        return int(math.floor(lo + rng.random() * (hi - lo)))
    if kind == "geometric":
        p = d["p"]
        return int(math.ceil(math.log(rng.random()) / math.log(1.0 - p)))
    if kind == "one-of":
        values = list(d["values"])
        assert values, f"invalid distribution-map: {d}"
        return rng.choice(values)
    if kind == "weighted":
        weights = d["weights"]
        values = list(weights.keys())
        return rng.choices(values, weights=[weights[v] for v in values])[0]
    raise AssertionError(f"invalid distribution-map: {d}")


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


def coll_scaled(n_str: str, n_nodes: int) -> int:
    """Parses a concurrency spec like '10' or '3n' (n = node count).

    Mirrors the CLI's '2n' concurrency syntax (cli.clj:64-206)."""
    s = str(n_str)
    if s.endswith("n"):
        return int(float(s[:-1] or 1) * n_nodes)
    return int(s)


def fraction_of(frac: float | str, n: int) -> int:
    if isinstance(frac, str) and frac.endswith("%"):
        return max(1, math.floor(n * float(frac[:-1]) / 100))
    return int(frac)


# The Chrome-trace JSON profile_trace exports into its directory.
PROFILE_TRACE_FILE = "torch-trace.json"


@contextmanager
def profile_trace(trace_dir=None):
    """Captures a torch.profiler trace around the body when trace_dir is
    set; no-op otherwise. With a CUDA device the profiler records CUDA
    activity (every kernel and copy on the card: the device timeline)
    beside the host's PyTorch ops; on the CPU it records CPU activity.
    The trace is exported as Chrome-trace JSON (PROFILE_TRACE_FILE, for
    Perfetto or chrome://tracing) into trace_dir when the body ends,
    also when it raises. A profiler that fails to start or to export
    raises, as jax.profiler.trace does. On the H100 machine the CUPTI
    collection behind it has lost device records in the traces of a
    process that had already run a Jepsen test: a trace that must hold
    every kernel is best the first of a fresh process."""
    if not trace_dir:
        yield
        return
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    d = Path(trace_dir)
    d.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        # stopping the profiler collects the device records
        prof.stop()
        prof.export_chrome_trace(str(d / PROFILE_TRACE_FILE))
