"""Linearizable register workload: per-key read/write/cas ops checked
with the linearizable checker over independent keys, every key's history
in one launch of the wgl_search kernel (the port's copy of
jepsen_tpu/workloads/register.py).

Capability reference: jepsen/src/jepsen/tests/linearizable_register.clj
(independent/checker over checker/linearizable with a cas-register
model, per-key generators r/w/cas). opts["device"] picks the card
(None, the default) or "cpu" for the checker.
"""

from __future__ import annotations

from .. import util

from .. import checker as chk
from .. import independent
from ..checker import models


def r(rng):
    return {"f": "read", "value": None}


def w(rng, n=5):
    return {"f": "write", "value": rng.randrange(n)}


def cas(rng, n=5):
    return {"f": "cas", "value": [rng.randrange(n), rng.randrange(n)]}


def key_gen(k, ops_per_key=100, seed=None):
    """Mixed r/w/cas ops for one key."""
    rng = util.seeded_rng(seed, k)

    def one():
        return rng.choice([r, w, cas])(rng)

    from .. import generator as gen

    return gen.limit(ops_per_key, one)


def workload(opts: dict | None = None) -> dict:
    o = dict(opts or {})
    keys = o.get("keys", list(range(8)))
    n_group = o.get("group-size", o.get(
        "group_size", o.get("concurrency_per_key", 5)))
    ops_per_key = o.get("ops_per_key", 100)
    seed = o.get("seed")
    return {
        "generator": independent.concurrent_generator(
            n_group, keys, lambda k: key_gen(k, ops_per_key, seed)),
        "checker": independent.checker(chk.linearizable(
            {"model": models.cas_register(o.get("initial")),
             "device": o.get("device")})),
    }


def cas_op_mix(rng, n_values: int = 5):
    """One random read/write/cas op dict per call — the canonical
    cas-register op mix every register suite uses (etcd, zookeeper;
    zookeeper.clj:74-76)."""
    r = rng.random()
    if r < 0.4:
        return {"f": "read", "value": None}
    if r < 0.7:
        return {"f": "write", "value": rng.randrange(n_values)}
    return {"f": "cas", "value": [rng.randrange(n_values),
                                  rng.randrange(n_values)]}
