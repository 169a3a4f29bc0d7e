"""Host helpers the port's checkers share: the part of jepsen_tpu/util.py
that the checkers need (that module imports JAX)."""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable


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
