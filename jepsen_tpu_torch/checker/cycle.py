"""Transactional cycle workload bundles: list-append and rw-register
(jepsen_tpu/checker/cycle.py, ported).

Capability reference: jepsen/src/jepsen/tests/cycle/append.clj (checker
11-27 wrapping elle.list-append/check, gen 29-46) and wr.clj (10-25
wrapping elle.rw-register/check). Generators emit txn ops whose values
are lists of micro-ops; clients fill in read results on completion.

The checkers run the port's elle engines (gpu/elle). opts["device"]
picks the card (None, the default) or "cpu", as for the linearizable
checker. An invalid result with a test["store_dir"] leaves the elle/
anomaly files, cycle plots and trace excerpts there (_with_artifacts),
the same files as the JAX package's.
"""

from __future__ import annotations

import logging
import random
from typing import Iterator

from . import Checker, _Fn
from ..gpu import elle

logger = logging.getLogger(__name__)


def _with_artifacts(test, result: dict) -> dict:
    """On an invalid result with a store directory, writes the elle/
    anomaly files and cycle plots (the reference passes :directory to
    elle so it drops the same artifacts, append.clj:17-27) and, when
    the run was traced, each anomaly's trace excerpt. Best effort: an
    exception is logged, and the result has no `artifacts`."""
    store_dir = isinstance(test, dict) and test.get("store_dir")
    if store_dir and result.get("anomalies"):
        try:
            from ..reports import explain

            paths = explain.write_elle_artifacts(store_dir, result)
            paths += explain.write_trace_excerpts(store_dir, result)
            if paths:
                result = dict(result)
                result["artifacts"] = paths
        except Exception:  # noqa: BLE001 — artifacts are best-effort
            logger.exception("writing elle artifacts failed")
    return result


def append_checker(opts: dict | None = None) -> Checker:
    """Checks list-append histories via the elle-equivalent engine
    (append.clj:11-27). Checker-driven verdicts carry a verdict
    certificate by default (gpu/certify; pass {'certify': False} to
    skip the proof)."""
    o = dict(opts or {})
    o.setdefault("certify", True)

    def run(test, hist, copts):
        return _with_artifacts(test, elle.check_list_append(hist, o))

    return _Fn(run)


def wr_checker(opts: dict | None = None) -> Checker:
    """Checks rw-register histories (wr.clj:10-25). Verdicts carry a
    certificate by default, like append_checker."""
    o = dict(opts or {})
    o.setdefault("certify", True)

    def run(test, hist, copts):
        return _with_artifacts(test, elle.check_rw_register(hist, o))

    return _Fn(run)


def append_gen(key_count: int = 3, min_txn_length: int = 1,
               max_txn_length: int = 4, max_writes_per_key: int = 32,
               seed: int | None = None) -> Iterator[dict]:
    """Infinite stream of list-append txn ops (append.clj:29-46 /
    elle.list-append/gen): each key sees monotonically increasing
    append values; keys rotate out once fully written."""
    rng = random.Random(seed)
    next_val: dict[int, int] = {}
    first_key = 0

    while True:
        # retire the lowest key once IT fills; the window always holds
        # key_count keys and no key exceeds its write budget
        while next_val.get(first_key, 0) >= max_writes_per_key:
            first_key += 1
        keys = list(range(first_key, first_key + key_count))
        txn = []
        for _ in range(rng.randint(min_txn_length, max_txn_length)):
            k = rng.choice(keys)
            if (rng.random() < 0.5
                    or next_val.get(k, 0) >= max_writes_per_key):
                txn.append(["r", k, None])
            else:
                v = next_val.get(k, 0) + 1
                next_val[k] = v
                txn.append(["append", k, v])
        yield {"f": "txn", "value": txn}


def wr_gen(key_count: int = 3, min_txn_length: int = 1,
           max_txn_length: int = 4, max_writes_per_key: int = 32,
           seed: int | None = None) -> Iterator[dict]:
    """Infinite stream of rw-register txn ops with globally distinct
    written values per key (elle.rw-register/gen)."""
    rng = random.Random(seed)
    next_val: dict[int, int] = {}
    first_key = 0
    while True:
        while next_val.get(first_key, 0) >= max_writes_per_key:
            first_key += 1
        keys = list(range(first_key, first_key + key_count))
        txn = []
        for _ in range(rng.randint(min_txn_length, max_txn_length)):
            k = rng.choice(keys)
            if (rng.random() < 0.5
                    or next_val.get(k, 0) >= max_writes_per_key):
                txn.append(["r", k, None])
            else:
                v = next_val.get(k, 0) + 1
                next_val[k] = v
                txn.append(["w", k, v])
        yield {"f": "txn", "value": txn}
