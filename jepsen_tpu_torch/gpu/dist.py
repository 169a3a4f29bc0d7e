"""Process groups for the multi-device form: the port of
jepsen_tpu/tpu/dist.py over torch.distributed.

Capability reference: SURVEY §2.5. The reference's analysis plane is
single-JVM; the JAX package brings every process's devices into one
global mesh with jax.distributed. Here each process is one rank of a
torch.distributed process group, and the mesh (gpu/spmd.py) lists the
cards of every rank: a rank launches the shards on its own cards, and
the per-row results and the search statistics of a sharded launch
cross ranks by collectives (gpu/ensemble.py), as do the SCC colours
once a sweep (gpu/scc.py).

Environment contract, the JAX package's variables:
  JAX_COORDINATOR_ADDRESS  host:port of rank 0 (tcp:// rendezvous)
  JAX_NUM_PROCESSES        world size
  JAX_PROCESS_ID           this process's rank
A bare JEPSEN_TPU_MULTIHOST=1 rendezvouses through env:// instead,
which reads torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK.
DEFAULT_TIMEOUT_S bounds the rendezvous and every collective. Without
any of them, and with no group the caller joined itself (which is
adopted), ensure_initialized() is a no-op.

The backend follows the layout, by a stated rule: nccl when every rank
on this host has a card of its own (the host's ranks, LOCAL_WORLD_SIZE
or else the world size, are no more than its cards; rank r takes card
LOCAL_RANK, or else r modulo the cards), gloo when the ranks run on the
CPU or share a card. process_info()["backend"] and the gauge
`dist.nccl` record the choice. The group's cards (cards()) are its
distinct physical cards, each under the first rank that uses it: ranks
sharing a card give it one entry, so the automatic mesh (gpu/spmd.py)
never puts two shards on one card.

Unlike the JAX package, which logs a failed initialization and goes on
single-host (tpu/dist.py:63-71), a failure here raises: a missing
variable raises ValueError naming it, and an unreachable coordinator
raises within the timeout. The port has no hidden fallback, and torch
has no "initialize before the first computation" rule to excuse one.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import threading
import zlib

import torch

from .. import telemetry

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 300.0

_lock = threading.Lock()
_initialized = False
# (rank, host id, card index) of every rank's card, rank-major, and the
# backend
_ranks_cards: list = []
_backend: str | None = None


def multihost_requested() -> bool:
    return bool(os.environ.get("JAX_COORDINATOR_ADDRESS")
                or os.environ.get("JEPSEN_TPU_MULTIHOST"))


def _need(var: str) -> str:
    value = os.environ.get(var)
    if not value:
        raise ValueError(f"multi-host analysis needs {var}, which is not "
                         "set")
    return value


def _int(var: str) -> int:
    value = _need(var)
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{var}={value!r} is not an integer") from None


def rendezvous() -> tuple[str, int, int]:
    """(init_method, world size, rank) from the environment; raises
    ValueError naming a missing variable."""
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord:
        return f"tcp://{coord}", _int("JAX_NUM_PROCESSES"), \
            _int("JAX_PROCESS_ID")
    _need("MASTER_ADDR")
    _need("MASTER_PORT")
    return "env://", _int("WORLD_SIZE"), _int("RANK")


def layout(world: int, rank: int) -> tuple[str, torch.device | None]:
    """(backend, this rank's card or None) by the module docstring's
    rule."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not cards:
        return "gloo", None
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % cards))
    card = torch.device("cuda", local_rank % cards)
    return ("nccl" if local_world <= cards else "gloo"), card


def ensure_initialized() -> bool:
    """Joins the process group once, iff the multi-host environment is
    set, or adopts the group the caller already joined (a test's or a
    launcher's init_process_group). Returns True when this process is a
    rank of a group; raises when joining fails."""
    global _initialized, _backend
    if _initialized:
        return True
    import torch.distributed as tdist

    if not (multihost_requested() or tdist.is_initialized()):
        return False
    with _lock:
        if _initialized:
            return True
        if tdist.is_initialized():
            backend = str(tdist.get_backend())
            card = (torch.device("cuda", torch.cuda.current_device())
                    if backend == "nccl"
                    else layout(tdist.get_world_size(),
                                tdist.get_rank())[1])
        else:
            init_method, world, rank = rendezvous()
            if not 0 <= rank < world:
                raise ValueError(f"rank {rank} outside a world of {world}")
            backend, card = layout(world, rank)
            if card is not None:
                torch.cuda.set_device(card)
            logger.info("joining a %s process group: %s, rank %d of %d",
                        backend, init_method, rank, world)
            tdist.init_process_group(
                backend, init_method=init_method, world_size=world,
                rank=rank,
                timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        _backend = backend
        # every rank's card and host, so that each rank can list the mesh
        mine = torch.tensor([_host_id(), -1 if card is None else card.index],
                            dtype=torch.int32)
        _ranks_cards.clear()
        _ranks_cards.extend((r, int(h), int(i)) for r, (h, i)
                            in enumerate(all_gather(mine)) if int(i) >= 0)
        _initialized = True
        telemetry.gauge("dist.nccl", int(backend == "nccl"))
        telemetry.gauge("dist.world-size", world_size())
        return True


def world_size() -> int:
    import torch.distributed as tdist

    return tdist.get_world_size() if tdist.is_initialized() else 1


def rank() -> int:
    import torch.distributed as tdist

    return tdist.get_rank() if tdist.is_initialized() else 0


def _host_id() -> int:
    """This host's name as an int32, which tells the cards of two hosts
    apart."""
    return zlib.crc32(socket.gethostname().encode()) & 0x7fffffff


def distinct_cards(ranks_cards) -> list:
    """(rank, torch.device) of each distinct (host, card) among the
    (rank, host id, card index) entries, under the first rank that uses
    it, rank-major."""
    seen, out = set(), []
    for r, host, index in ranks_cards:
        if (host, index) not in seen:
            seen.add((host, index))
            out.append((r, torch.device("cuda", index)))
    return out


def cards() -> list:
    """(rank, torch.device) of every distinct card of the group (module
    docstring), rank-major: the cards of this process alone when it is
    no rank of a group."""
    if _initialized:
        return distinct_cards(_ranks_cards)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [(0, torch.device("cuda", i)) for i in range(n)]


def collective_device() -> torch.device:
    """Where this rank's collective buffers live: its card under nccl,
    the host under gloo."""
    if _backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's `t` (same shape and dtype on every rank), in rank
    order, on t's device."""
    import torch.distributed as tdist

    x = t.to(collective_device())
    out = [torch.empty_like(x) for _ in range(world_size())]
    tdist.all_gather(out, x)
    return [o.to(t.device) for o in out]


def all_reduce_(t: torch.Tensor, op: str) -> torch.Tensor:
    """All-reduces `t` in place across the ranks ("sum" or "max")."""
    import torch.distributed as tdist

    red = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}[op]
    x = t.to(collective_device())
    tdist.all_reduce(x, op=red)
    if x is not t:
        t.copy_(x)
    return t


def process_info() -> dict:
    """Rank, size, cards and backend, for logging and sharded store
    paths."""
    local = (sum(1 for r, _h, _i in _ranks_cards if r == rank())
             if _initialized else len(cards()))
    return {"process_index": rank(), "process_count": world_size(),
            "local_devices": local, "global_devices": len(cards()),
            "backend": _backend}
