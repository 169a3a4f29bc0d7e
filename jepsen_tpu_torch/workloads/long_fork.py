"""Long-fork (PSI) anomaly workload: single-key writes plus group reads;
two reads that observe a pair of writes in incompatible orders are a
long fork.

Capability reference: jepsen/src/jepsen/tests/long_fork.clj (docstring
1-95: groups of n keys, one write per key, reads over whole groups;
detection = incomparable read pairs). The reference builds a read
adjacency by Hamming-like distance; here the pairwise incomparability
test is two boolean matmuls over the read-presence matrix (fork(i,j) iff
(R @ ~R.T)[i,j] and [j,i]).

The port's copy of jepsen_tpu/workloads/long_fork.py; the boolean matmul
stays numpy on the host. No kernel runs.
"""

from __future__ import annotations

import itertools

import numpy as np

from .. import checker as chk
from .. import generator as gen
from ..checker import _Fn


def generator(group_size: int = 3, ops: int = 300):
    """Writes each key once (value 1); reads whole key groups."""
    counter = itertools.count()

    def one():
        i = next(counter)
        group = (i // (group_size * 4)) * group_size
        keys = list(range(group, group + group_size))
        if i % 4 == 0:  # one write slot per key round-robin
            k = keys[(i // 4) % group_size]
            return {"f": "txn", "value": [["w", k, 1]]}
        return {"f": "txn", "value": [["r", k, None] for k in keys]}

    return gen.limit(ops, one)


def checker(group_size: int = 3) -> chk.Checker:
    def run(test, hist, opts):
        # group reads by their key set
        reads: dict = {}
        for op in hist:
            if op.type != "ok" or not op.value:
                continue
            mops = op.value
            if all(m[0] == "r" for m in mops):
                ks = tuple(sorted(m[1] for m in mops))
                vals = {m[1]: m[2] for m in mops}
                reads.setdefault(ks, []).append((op, vals))
        forks = []
        for ks, rs in reads.items():
            if len(rs) < 2:
                continue
            r_mat = np.array([[1.0 if vals.get(k) is not None else 0.0
                               for k in ks] for _op, vals in rs],
                             dtype=np.float32)
            a = (r_mat @ (1.0 - r_mat).T) > 0
            fork = a & a.T
            for i, j in zip(*np.nonzero(np.triu(fork, 1))):
                forks.append({"read1": rs[i][0], "read2": rs[j][0]})
        return {"valid?": not forks,
                "fork-count": len(forks),
                "forks": forks[:8]}

    return _Fn(run)


def workload(opts: dict | None = None) -> dict:
    o = dict(opts or {})
    gsize = o.get("group-size", 3)
    return {
        "generator": generator(gsize, o.get("ops", 300)),
        "checker": checker(gsize),
    }
