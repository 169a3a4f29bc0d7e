"""Composable nemesis packages: clock skew, crashes, pauses,
partitions, packet mangling, file corruption — each as a
{nemesis, generator, final_generator, perf} bundle that composes (the
port's copy of jepsen_tpu/nemesis/combined.py). The membership fault
(nemesis/membership.py) and lazyfs's lose-unfsynced-writes (lazyfs.py)
are ROADMAP A3c and raise NotImplementedError.

Capability reference: jepsen/src/jepsen/nemesis/combined.clj —
node-spec language db-nodes (40-71), db-package kill/pause flip-flops
(72-163), partition-package (164-249), packet-package (250-328),
clock-package (329-362), file-corruption-package (363-460), f-map +
compose-packages + nemesis-package (461-568).
"""

from __future__ import annotations

import random
from typing import Iterable

from .. import control
from .. import generator as gen
from .. import util
from . import core as n
from . import time as nt

DEFAULT_INTERVAL = 10
"""Default seconds between nemesis operations (combined.clj:29-31)."""

NOOP_PACKAGE = {
    "generator": None,
    "final_generator": None,
    "nemesis": n.noop,
    "perf": set(),
}


def db_nodes(test, db, node_spec):
    """Nodes selected by a node spec (combined.clj:40-63):
    None | 'one' | 'minority' | 'majority' | 'minority-third' |
    'primaries' | 'all' | explicit list."""
    nodes = list(test["nodes"])
    if node_spec is None:
        return util.random_nonempty_subset(nodes)
    if node_spec == "one":
        return [random.choice(nodes)]
    if node_spec == "minority":
        random.shuffle(nodes)
        return nodes[:util.majority(len(nodes)) - 1]
    if node_spec == "majority":
        random.shuffle(nodes)
        return nodes[:util.majority(len(nodes))]
    if node_spec == "minority-third":
        random.shuffle(nodes)
        return nodes[:util.minority_third(len(nodes))]
    if node_spec == "primaries":
        return util.random_nonempty_subset(db.primaries(test))
    if node_spec == "all":
        return nodes
    return node_spec


def node_specs(db) -> list:
    """All node specs valid for a DB (combined.clj:65-71)."""
    specs = [None, "one", "minority-third", "minority", "majority",
             "all"]
    if db is not None and db.supports_primaries:
        specs.append("primaries")
    return specs


class DbNemesis(n.Nemesis):
    """start/kill/pause/resume on nodes picked by a node spec
    (combined.clj:73-103)."""

    def __init__(self, db):
        self.db = db

    def invoke(self, test, op):
        f = {"start": self.db.start, "kill": self.db.kill,
             "pause": self.db.pause, "resume": self.db.resume}[op.f]
        # None (e.g. 'primaries' with no known primaries) must no-op,
        # not fall through to on_nodes' all-nodes default
        nodes = db_nodes(test, self.db, op.value) or []
        res = control.on_nodes(test, lambda t, node: f(t, node), nodes)
        return op.copy(value=res)

    def fs(self):
        return {"start", "kill", "pause", "resume"}

    def fault_kinds(self):
        # here 'start' HEALS a kill window (the db restarts), unlike
        # the partitioner's 'start' — exactly why kinds are declared
        # per nemesis rather than guessed from f names
        return {"kill": ("db-kill", "begin"),
                "start": ("db-kill", "end"),
                "pause": ("db-pause", "begin"),
                "resume": ("db-pause", "end")}


def db_generators(opts: dict) -> dict:
    """kill/pause flip-flop generators for a DB (combined.clj:105-146)."""
    db = opts["db"]
    faults = opts["faults"]
    kill_p = db.supports_kill and "kill" in faults
    pause_p = db.supports_pause and "pause" in faults
    kill_targets = (opts.get("kill") or {}).get("targets",
                                                node_specs(db))
    pause_targets = (opts.get("pause") or {}).get("targets",
                                                  node_specs(db))

    start = {"type": "info", "f": "start", "value": "all"}
    resume = {"type": "info", "f": "resume", "value": "all"}

    def kill(test, ctx):
        return {"type": "info", "f": "kill",
                "value": random.choice(kill_targets)}

    def pause(test, ctx):
        return {"type": "info", "f": "pause",
                "value": random.choice(pause_targets)}

    modes, final = [], []
    if pause_p:
        modes.append(gen.flip_flop(pause, gen.repeat(resume)))
        final.append(resume)
    if kill_p:
        modes.append(gen.flip_flop(kill, gen.repeat(start)))
        final.append(start)
    return {"generator": gen.mix(modes) if modes else None,
            "final_generator": final or None}


def db_package(opts: dict) -> dict:
    """Kill/pause package (combined.clj:148-163). With no db (e.g. a
    membership-only nemesis) there is nothing to kill: noop."""
    if opts.get("db") is None:
        return dict(NOOP_PACKAGE)
    needed = bool({"kill", "pause"} & set(opts["faults"]))
    gens = db_generators(opts)
    generator = gens["generator"]
    if generator is not None:
        generator = gen.stagger(opts.get("interval", DEFAULT_INTERVAL),
                                generator)
    return {
        "generator": generator if needed else None,
        "final_generator": gens["final_generator"] if needed else None,
        "nemesis": DbNemesis(opts["db"]),
        "perf": {("kill", frozenset({"kill"}), frozenset({"start"}),
                  "#E9A4A0"),
                 ("pause", frozenset({"pause"}), frozenset({"resume"}),
                  "#A0B1E9")},
    }


def grudge(test, db, part_spec) -> dict:
    """Grudge for a partition spec (combined.clj:166-190): 'one' |
    'majority' | 'majorities-ring' | 'minority-third' | 'primaries' |
    explicit grudge dict."""
    nodes = list(test["nodes"])
    if part_spec == "one":
        return n.complete_grudge(n.split_one(random.choice(nodes),
                                             nodes))
    if part_spec == "majority":
        random.shuffle(nodes)
        return n.complete_grudge(n.bisect(nodes))
    if part_spec == "majorities-ring":
        return n.majorities_ring(nodes)
    if part_spec == "minority-third":
        random.shuffle(nodes)
        k = util.minority_third(len(nodes))
        return n.complete_grudge([nodes[:k], nodes[k:]])
    if part_spec == "primaries":
        primaries = util.random_nonempty_subset(db.primaries(test)) or []
        others = [x for x in nodes if x not in set(primaries)]
        return n.complete_grudge([others] + [[p] for p in primaries])
    return part_spec


def partition_specs(db) -> list:
    """All partition specs for a DB (combined.clj:192-196)."""
    specs = ["one", "minority-third", "majority", "majorities-ring"]
    if db is not None and db.supports_primaries:
        specs.append("primaries")
    return specs


class PartitionNemesis(n.Nemesis):
    """Wraps a Partitioner with partition-spec support
    (combined.clj:198-227)."""

    def __init__(self, db, p=None):
        self.db = db
        self.p = p or n.partitioner(lambda nodes: None)

    def setup(self, test):
        return PartitionNemesis(self.db, self.p.setup(test))

    def invoke(self, test, op):
        if op.f == "start-partition":
            g = grudge(test, self.db, op.value)
            out = self.p.invoke(test, op.copy(f="start", value=g))
        elif op.f == "stop-partition":
            out = self.p.invoke(test, op.copy(f="stop", value=None))
        else:
            raise ValueError(f"unknown f {op.f!r}")
        return out.copy(f=op.f)

    def teardown(self, test):
        self.p.teardown(test)

    def fs(self):
        return {"start-partition", "stop-partition"}

    def fault_kinds(self):
        return {"start-partition": ("partition", "begin"),
                "stop-partition": ("partition", "end")}


def partition_package(opts: dict) -> dict:
    """Network partition package (combined.clj:229-249)."""
    needed = "partition" in opts["faults"]
    db = opts["db"]
    targets = (opts.get("partition") or {}).get(
        "targets", partition_specs(db))

    def start(test, ctx):
        return {"type": "info", "f": "start-partition",
                "value": random.choice(targets)}

    stop = {"type": "info", "f": "stop-partition", "value": None}
    g = gen.stagger(opts.get("interval", DEFAULT_INTERVAL),
                    gen.flip_flop(start, gen.repeat(stop)))
    return {
        "generator": g if needed else None,
        "final_generator": stop if needed else None,
        "nemesis": PartitionNemesis(db),
        "perf": {("partition", frozenset({"start-partition"}),
                  frozenset({"stop-partition"}), "#E9DCA0")},
    }


class PacketNemesis(n.Nemesis):
    """tc-netem packet disruption on spec-selected nodes
    (combined.clj:251-287). Ops:
    {'f': 'start-packet', 'value': [node-spec, behaviors]} /
    {'f': 'stop-packet'}."""

    def __init__(self, db):
        self.db = db

    def setup(self, test):
        test["net"].shape(test, None, None)
        return self

    def invoke(self, test, op):
        net = test["net"]
        if op.f == "start-packet":
            spec, behaviors = op.value
            targets = db_nodes(test, self.db, spec)
            res = net.shape(test, targets, behaviors)
        elif op.f == "stop-packet":
            res = net.shape(test, None, None)
        else:
            raise ValueError(f"unknown f {op.f!r}")
        return op.copy(value=res)

    def teardown(self, test):
        test["net"].shape(test, None, None)

    def fs(self):
        return {"start-packet", "stop-packet"}

    def fault_kinds(self):
        return {"start-packet": ("packet", "begin"),
                "stop-packet": ("packet", "end")}


def packet_package(opts: dict) -> dict:
    """Packet-behavior package (combined.clj:289-328). opts['packet']:
    {'targets': [spec...], 'behaviors': [{'delay': {}}, ...]}.
    The default behaviors list is [{}] — a no-disruption behavior —
    matching the reference; configure 'behaviors' to actually disturb
    packets."""
    needed = "packet" in opts["faults"]
    db = opts["db"]
    popts = opts.get("packet") or {}
    targets = popts.get("targets", node_specs(db))
    behaviors = popts.get("behaviors", [{}])

    def start(test, ctx):
        return {"type": "info", "f": "start-packet",
                "value": [random.choice(targets),
                          random.choice(behaviors)]}

    stop = {"type": "info", "f": "stop-packet", "value": None}
    g = gen.stagger(opts.get("interval", DEFAULT_INTERVAL),
                    gen.flip_flop(start, gen.repeat(stop)))
    return {
        "generator": g if needed else None,
        "final_generator": stop if needed else None,
        "nemesis": PacketNemesis(db),
        "perf": {("packet", frozenset({"start-packet"}),
                  frozenset({"stop-packet"}), "#D1E8A0")},
    }


def clock_package(opts: dict) -> dict:
    """Clock-skew package (combined.clj:330-362)."""
    needed = "clock" in opts["faults"]
    db = opts["db"]
    nemesis = n.compose([({"reset-clock": "reset",
                           "check-clock-offsets": "check-offsets",
                           "strobe-clock": "strobe",
                           "bump-clock": "bump"},
                          nt.clock_nemesis())])
    target_specs = (opts.get("clock") or {}).get("targets",
                                                 node_specs(db))

    def targets(test):
        spec = random.choice(target_specs) if target_specs else None
        return db_nodes(test, db, spec)

    clock_gen = gen.phases(
        {"type": "info", "f": "check-offsets"},
        gen.mix([nt.reset_gen_select(targets),
                 nt.bump_gen_select(targets),
                 nt.strobe_gen_select(targets)]))
    g = gen.stagger(
        opts.get("interval", DEFAULT_INTERVAL),
        gen.f_map({"reset": "reset-clock",
                   "check-offsets": "check-clock-offsets",
                   "strobe": "strobe-clock",
                   "bump": "bump-clock"}, clock_gen))
    return {
        "generator": g if needed else None,
        "final_generator": ({"type": "info", "f": "reset-clock"}
                            if needed else None),
        "nemesis": nemesis,
        "perf": {("clock", frozenset({"bump-clock"}),
                  frozenset({"reset-clock"}), "#A0E9E3")},
    }


class FileCorruptionNemesis(n.Nemesis):
    """bitflip/truncate on spec-selected nodes (combined.clj:364-399).
    Ops: {'f': 'bitflip'|'truncate', 'value': [node-spec,
    corruption-map]}. lazyfs's lose-unfsynced-writes
    (jepsen/src/jepsen/lazyfs.clj:246-295) is not ported: a lazyfs map
    raises."""

    def __init__(self, db, bf=None, trunc=None, lazyfs_map=None):
        if lazyfs_map is not None:
            raise NotImplementedError(
                "lazyfs (lose-unfsynced-writes) is not ported "
                "(ROADMAP A3c)")
        self.db = db
        self.bf = bf or n.bitflip()
        self.trunc = trunc or n.truncate_file()

    def setup(self, test):
        return FileCorruptionNemesis(self.db, self.bf.setup(test),
                                     self.trunc.setup(test))

    def invoke(self, test, op):
        spec, corruption = op.value
        targets = db_nodes(test, self.db, spec) or []
        plan = {node: corruption for node in targets}
        op2 = op.copy(value=plan)
        if op.f == "bitflip":
            return self.bf.invoke(test, op2)
        if op.f == "truncate":
            return self.trunc.invoke(test, op2)
        raise ValueError(f"unknown f {op.f!r}")

    def teardown(self, test):
        self.bf.teardown(test)
        self.trunc.teardown(test)

    def fs(self):
        return {"bitflip", "truncate"}

    def fault_kinds(self):
        return {"bitflip": ("file-bitflip", "pulse"),
                "truncate": ("file-truncate", "pulse")}


def file_corruption_package(opts: dict) -> dict:
    """File corruption package (combined.clj:401-460).
    opts['file_corruption']: {'targets': [spec...], 'lazyfs': map?,
    'corruptions':
    [{'type': 'bitflip', 'file': ..., 'probability': p-or-dist},
     {'type': 'truncate', 'file': ..., 'drop': n-or-dist},
     {'type': 'lose-unfsynced-writes'}  # needs 'lazyfs' (A3c: raises)
    ]}."""
    faults = opts["faults"]
    needed = "file-corruption" in faults
    fc = opts.get("file_corruption") or {}
    db = opts["db"]
    targets = fc.get("targets", node_specs(db))
    corruptions = fc.get("corruptions") or []
    lazyfs_map = fc.get("lazyfs")
    if lazyfs_map is None and any(
            c["type"] == "lose-unfsynced-writes" for c in corruptions):
        raise ValueError("lose-unfsynced-writes corruption needs "
                         "file_corruption['lazyfs'] (a lazyfs map)")

    def g_fn(test, ctx):
        target = random.choice(targets)
        c = random.choice(corruptions)
        corruption = {"file": c["file"]}
        if c["type"] == "bitflip":
            p = c.get("probability")
            p = util.rand_distribution(p) if isinstance(p, dict) else p
            if p is not None:
                corruption["probability"] = p
        else:
            d = c.get("drop")
            d = util.rand_distribution(d) if isinstance(d, dict) else d
            if d is not None:
                corruption["drop"] = d
        return {"type": "info", "f": c["type"],
                "value": [target, corruption]}

    g = (gen.stagger(opts.get("interval", DEFAULT_INTERVAL), g_fn)
         if corruptions else None)
    nem = FileCorruptionNemesis(db, lazyfs_map=lazyfs_map)
    return {
        "generator": g if needed else None,
        "final_generator": None,
        "nemesis": nem,
        "perf": {("file-corruption", frozenset(nem.fs()),
                  frozenset(), "#99F2E2")},
    }


def compose_packages(packages: Iterable[dict]) -> dict:
    """Combines packages: generators via any (soonest wins), final
    generators sequentially, nemeses by f routing
    (combined.clj:496-510)."""
    packages = list(packages)
    if not packages:
        return dict(NOOP_PACKAGE)
    if len(packages) == 1:
        return packages[0]
    gens = [p["generator"] for p in packages if p.get("generator")]
    finals = [p["final_generator"] for p in packages
              if p.get("final_generator")]
    perf = set()
    for p in packages:
        perf |= set(p.get("perf") or ())
    return {
        "generator": gen.any_gen(*gens) if gens else None,
        "final_generator": finals or None,
        "nemesis": n.compose([p["nemesis"] for p in packages
                              if p.get("nemesis")]),
        "perf": perf,
    }


DEFAULT_FAULTS = ["partition", "packet", "kill", "pause", "clock",
                  "file-corruption"]


def nemesis_packages(opts: dict) -> list:
    """The standard package list for an option map
    (combined.clj:512-522). The membership fault
    (nemesis/membership.clj package) is not ported."""
    opts = dict(opts)
    opts["faults"] = set(opts.get("faults", DEFAULT_FAULTS))
    if "membership" in opts["faults"]:
        raise NotImplementedError(
            "the membership fault (nemesis/membership.py) is not ported "
            "(ROADMAP A3c)")
    return [partition_package(opts), packet_package(opts),
            file_corruption_package(opts), clock_package(opts),
            db_package(opts)]


def nemesis_package(opts: dict) -> dict:
    """One combined package: {nemesis, generator, final_generator,
    perf} (combined.clj:524-568). Mandatory opts: db. Optional:
    interval, faults, partition/packet/kill/pause/clock/
    file_corruption sub-options."""
    return compose_packages(nemesis_packages(opts))
