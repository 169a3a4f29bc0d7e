"""Host helpers the port's checkers share: the part of jepsen_tpu/util.py
that the independent-key checker needs (that module imports JAX)."""

from __future__ import annotations

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
