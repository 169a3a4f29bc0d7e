"""Fault-injection nemeses (the port's copy of jepsen_tpu/nemesis/).

Capability reference: jepsen/src/jepsen/nemesis.clj. The core protocol,
pure grudge/partition math, and process/file nemeses live in `core`;
composed packages in `combined`; clock manipulation in `time`. The membership nemesis
(nemesis/membership.py) is ROADMAP A3c.
"""

from .core import (Nemesis, NoopNemesis, Validate, noop, validate, invoke,
                   setup, teardown, compose, f_map,
                   bisect, split_one, complete_grudge, bridge,
                   majorities_ring, partitioner, partition_halves,
                   partition_random_halves, partition_random_node,
                   partition_majorities_ring,
                   node_start_stopper, hammer_time, truncate_file,
                   bitflip, start_stop_cycle)

__all__ = [
    "Nemesis", "NoopNemesis", "Validate", "noop", "validate", "invoke",
    "setup", "teardown", "compose", "f_map",
    "bisect", "split_one", "complete_grudge", "bridge", "majorities_ring",
    "partitioner", "partition_halves", "partition_random_halves",
    "partition_random_node", "partition_majorities_ring",
    "node_start_stopper", "hammer_time", "truncate_file", "bitflip",
    "start_stop_cycle",
]
