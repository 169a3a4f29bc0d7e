"""SPMD plumbing shared by the sharded launches: the port of
jepsen_tpu/tpu/spmd.py.

One place answers the questions every sharded launch site asks:

  - *May I shard, and over how many devices?* `spmd_devices()` counts
    the distinct cards (every rank's, once the process is a rank of a
    group, gpu/dist.py: ranks sharing a card count it once) through
    the JEPSEN_TPU_SPMD / JEPSEN_TPU_SPMD_DEVICES knobs (0/1 = the
    one-device path). The knobs are re-read per call,
    so tests can flip them without re-importing anything.
  - *Which devices?* `mesh_for(n)` is the memoized 1-D mesh over the
    first n cards; `mesh_of(devices)` a mesh over an explicit device
    list whose entries may repeat (shards sharing the CPU or one card:
    the port's counterpart of the JAX tests' virtual CPU devices). Only
    an explicit list, never the automatic route, puts two shards on one
    device.
  - *How do the kernels' arguments lay out over the mesh?* The regex
    partition-rule table (SNIPPETS.md [1]): argument names match rules,
    rules name the axes an argument shards over. The lint registry
    reads the same table, so R4 prices the layout the launch sites use.
  - *Where do compiled kernels persist?* `compile_cache_dir()`, the
    counterpart of the JAX package's persistent compilation cache
    directory: the port's kernel build cache (gpu/kernels/build.py),
    set by `--compile-cache` (cli.py) or JEPSEN_TPU_COMPILE_CACHE.
"""

from __future__ import annotations

import functools
import os
import re

import torch

from ..device import resolve_device
from . import dist

# The mesh's single batch axis name, shared by every sharded kernel.
AXIS = "b"

# Below this many independent rows a sharded launch is pure overhead.
MIN_ROWS = 2


class Mesh:
    """A 1-D mesh over the batch axis: one shard per entry of `devices`
    (torch.device, repeats allowed), each launched by the rank in
    `ranks` that owns it."""

    __slots__ = ("devices", "ranks", "axis_names")

    def __init__(self, devices, ranks):
        self.devices = tuple(devices)
        self.ranks = tuple(ranks)
        self.axis_names = (AXIS,)
        if not self.devices or len(self.ranks) != len(self.devices):
            raise ValueError(f"a mesh needs one rank per device: "
                             f"{self.devices}, {self.ranks}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def local(self) -> list[int]:
        """The shards this rank launches."""
        me = dist.rank()
        return [d for d, r in enumerate(self.ranks) if r == me]

    def home(self) -> torch.device:
        """Where this rank combines its shards: the device of its first
        shard (a rank without a shard: its own card, else the host)."""
        mine = self.local()
        if mine:
            return self.devices[mine[0]]
        own = [d for r, d in dist.cards() if r == dist.rank()]
        return own[0] if own else torch.device("cpu")

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.ranks == other.ranks)

    def __hash__(self) -> int:
        return hash((self.devices, self.ranks))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, ranks={self.ranks})"


def spmd_enabled() -> bool:
    """SPMD launches may be disabled outright (JEPSEN_TPU_SPMD=0): the
    one-device launches are then the differential reference."""
    return os.environ.get("JEPSEN_TPU_SPMD", "1") != "0"


def cards() -> list:
    """(rank, torch.device) of every card a mesh may span (dist.cards():
    every rank's once the process is a rank of a group)."""
    return dist.cards()


def spmd_devices() -> int:
    """How many devices a sharded launch may span right now: the cards,
    capped by JEPSEN_TPU_SPMD_DEVICES (a value that is no integer is
    ignored), 0 when sharding is disabled or there is no card. Values
    <= 1 mean 'take the one-device path'."""
    if not spmd_enabled():
        return 0
    n = len(cards())
    cap = os.environ.get("JEPSEN_TPU_SPMD_DEVICES")
    if cap:
        try:
            n = min(n, max(int(cap), 0))
        except ValueError:
            pass
    return n


def compile_cache_dir() -> str | None:
    """The kernel build cache's directory: JEPSEN_TPU_COMPILE_CACHE (a
    path, or "0" / "" to turn the cache off: None), read at each call.
    Unset, the gitignored jepsen_tpu_torch/gpu/kernels/build/, which
    .gitignore and chip_smoke.py name (the JAX package defaults to
    store/.xla-cache)."""
    env = os.environ.get("JEPSEN_TPU_COMPILE_CACHE")
    if env is None:
        return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "kernels", "build")
    return None if env in ("0", "") else env


def mesh_for(n_devices: int) -> Mesh:
    """The memoized 1-D mesh over the first n cards, clamped to the
    cards there are; raises when there is none."""
    dist.ensure_initialized()
    have = cards()
    if not have:
        resolve_device(None)  # raises: no CUDA device
        raise RuntimeError("no card is visible to the process group")
    return _mesh(tuple(have[:max(1, min(n_devices, len(have)))]))


@functools.lru_cache(maxsize=None)
def _mesh(entries: tuple) -> Mesh:
    return Mesh([d for _r, d in entries], [r for r, _d in entries])


def _normal(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_of(devices) -> Mesh:
    """A mesh over an explicit device list (str or torch.device, repeats
    allowed): this process owns every shard, or, in a group of W ranks,
    rank r owns the r-th of W equal contiguous blocks."""
    dist.ensure_initialized()
    devs = [_normal(d) for d in devices]
    world = dist.world_size()
    if len(devs) % world:
        raise ValueError(f"{len(devs)} devices do not split over "
                         f"{world} ranks")
    per = len(devs) // world
    return Mesh(devs, [d // per for d in range(len(devs))])


def as_mesh(mesh) -> Mesh:
    """A Mesh from a Mesh, one device (str or torch.device) or a device
    list."""
    if isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, (list, tuple)):
        return mesh_of(mesh)
    return mesh_of([mesh])


def route(device: torch.device, n_rows: int) -> Mesh | None:
    """The mesh a launch of n_rows independent rows for `device` takes
    on its own, or None for the one-device launch: only when more than
    one card may be spanned, the rows reach MIN_ROWS, and the cards are
    of the launch's device type. Power-of-two sizes only, as in the JAX
    package."""
    n = min(spmd_devices(), n_rows)
    if n <= 1 or n_rows < MIN_ROWS:
        return None
    mesh = mesh_for(1 << (n.bit_length() - 1))
    return mesh if mesh.devices[0].type == device.type else None


# ---------------------------------------------------------------------------
# Regex partition rules (SNIPPETS.md [1]: match_partition_rules)
# ---------------------------------------------------------------------------

# WGL kernel family: the packed segment tensors are laid out in
# per-device blocks (ensemble.shard_layout), so their leading axis
# shards with the search rows — nothing big is replicated. Only the
# tiny result-ordering permutation stays replicated.
WGL_RULES = (
    (r"^(inv_t|ret_t|trans|mseg|sufmin)$", (AXIS,)),
    (r"^(row_seg|st0)$", (AXIS,)),
    (r"^inv_perm$", ()),
)

# SCC colouring: the edge list (the big operand — the colour array is n
# ints) shards over the mesh; colours stay replicated and are
# max-combined once a sweep.
SCC_RULES = (
    (r"^(src|dst|edge_on)$", (AXIS,)),
    (r"^active$", ()),
)


def _axes(rules, name: str) -> tuple:
    for rule, axes in rules:
        if re.search(rule, name):
            return axes
    raise ValueError(f"no partition rule for arg {name!r}")


def match_partition_rules(rules, names) -> tuple:
    """The axes each argument shards over, ("b",) or (), by the first
    matching regex rule (re.search, like the reference snippet). Raises
    on an unmatched name — a silently-replicated new argument is exactly
    the bug the table exists to prevent."""
    return tuple(_axes(rules, name) for name in names)


def describe_partition(rules, names) -> dict:
    """The lint-facing view of a rule table: which args shard over the
    mesh axis and which stay replicated (R4's input: the registry reads
    the table the launch sites use)."""
    sharded, replicated = [], []
    for name in names:
        (sharded if _axes(rules, name) else replicated).append(name)
    return {"axis": AXIS, "sharded": sharded, "replicated": replicated}
