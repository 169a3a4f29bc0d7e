"""DB test suites: consumers of the framework that install and drive
real databases (the reference ships ~26 of these; see SURVEY.md 2.6).

The port's copy of jepsen_tpu/suites/__init__.py. SUITES maps the same
21 suite names, in the same order, to module paths; `load(name)` imports
lazily (a suite pulls in its client transport only when actually
driven). Each module exposes `main(argv)` — `python -m
jepsen_tpu_torch.suites.<name> test --device cuda ...` — plus a
`<name>_test(opts)` builder whose checkers run on the card
(opts["device"]: None, the default, or "cpu").

All 21 suites are ported: `load` returns the port's module for every
name of SUITES."""

from importlib import import_module

SUITES = {
    "aerospike": "jepsen_tpu_torch.suites.aerospike",
    "cockroach": "jepsen_tpu_torch.suites.cockroach",
    "consul": "jepsen_tpu_torch.suites.consul",
    "crate": "jepsen_tpu_torch.suites.crate",
    "dgraph": "jepsen_tpu_torch.suites.dgraph",
    "disque": "jepsen_tpu_torch.suites.disque",
    "elasticsearch": "jepsen_tpu_torch.suites.elasticsearch",
    "etcd": "jepsen_tpu_torch.suites.etcd",
    "galera": "jepsen_tpu_torch.suites.galera",
    "hazelcast": "jepsen_tpu_torch.suites.hazelcast",
    "mongodb": "jepsen_tpu_torch.suites.mongodb",
    "postgres": "jepsen_tpu_torch.suites.postgres",
    "rabbitmq": "jepsen_tpu_torch.suites.rabbitmq",
    "raftis": "jepsen_tpu_torch.suites.raftis",
    "redis-sentinel": "jepsen_tpu_torch.suites.redis_sentinel",
    "rethinkdb": "jepsen_tpu_torch.suites.rethinkdb",
    "stolon": "jepsen_tpu_torch.suites.stolon",
    "tidb": "jepsen_tpu_torch.suites.tidb",
    "voltdb": "jepsen_tpu_torch.suites.voltdb",
    "yugabyte": "jepsen_tpu_torch.suites.yugabyte",
    "zookeeper": "jepsen_tpu_torch.suites.zookeeper",
}


def load(name: str):
    """Imports and returns a suite module by registry name."""
    if name not in SUITES:
        raise KeyError(f"unknown suite {name!r}; known: "
                       + ", ".join(sorted(SUITES)))
    return import_module(SUITES[name])
