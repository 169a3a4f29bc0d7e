"""Transaction micro-op algebra (jepsen_tpu/txn.py, copied for the port).

A transaction is a list of micro-ops ("mops") [f, k, v]:
  ["r", k, v-or-None]   read key k, observing v
  ["w", k, v]           write v to k
  ["append", k, v]      append v to the list at k

Capability reference: txn/src/jepsen/txn.clj (reduce-mops 6-28,
ext-reads 48-63, ext-writes 65-80) — the external read/write sets feed
elle-style dependency inference.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable


def reduce_mops(f: Callable, init: Any, txn: Iterable) -> Any:
    """Fold f(acc, [fk, k, v]) over the mops of a transaction
    (txn.clj:6-28)."""
    acc = init
    for mop in txn:
        acc = f(acc, mop)
    return acc


def ext_reads(txn: Iterable) -> dict:
    """Externally visible reads: the first read of each key *before any
    write to it* in this txn observes external state (txn.clj:48-63)."""
    ignore: set = set()
    reads: dict = {}
    for fk, k, v in txn:
        if fk == "r":
            if k not in ignore and k not in reads:
                reads[k] = v
        else:  # any write form masks later reads of k
            ignore.add(k)
    return reads


def ext_writes(txn: Iterable) -> dict:
    """Externally visible writes: the last write of each key
    (txn.clj:65-80)."""
    writes: dict = {}
    for fk, k, v in txn:
        if fk != "r":
            writes[k] = v
    return writes


def writes(txn: Iterable) -> dict:
    """All written values per key, in order (list-append txns make every
    append externally visible)."""
    out: dict = {}
    for fk, k, v in txn:
        if fk != "r":
            out.setdefault(k, []).append(v)
    return out


def keys(txn: Iterable) -> set:
    return {k for _f, k, _v in txn}
