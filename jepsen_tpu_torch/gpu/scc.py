"""Strongly-connected components on the card (jepsen_tpu/tpu/scc.py,
ported).

Capability reference: elle 0.2.1 runs Tarjan's SCC on the JVM over the
inferred dependency graph (consumed via jepsen/src/jepsen/tests/cycle/
append.clj:6-27). Tarjan is inherently sequential, so the device
formulation is Orzan's colouring algorithm: a forward scatter-max
fixpoint of colours, a backward membership fixpoint inside each colour
class, and peel rounds that retire the components found. The whole loop
is one cooperative CUDA kernel (gpu/kernels/csrc/scc.cu); its plain
PyTorch version runs for device="cpu".

Node ids follow history order, so dependency edges point mostly forward
and the fixpoints converge in a handful of sweeps. Both loops carry the
JAX program's caps; when the algorithm hits one (ok false, adversarial
graphs such as a long decreasing chain) scc() counts it as
`scc.device-nonconverged` and makes the convergence launch on the same
device (where the JAX package goes to scipy): trim to a fixpoint, then
colouring rounds, each sweep and pass driven by a frontier over CSR rows
built on the card, with no caps. A DAG is retired by trim alone; a
decreasing chain of non-trivial cycles still costs O(components x
depth). A kernel that fails to build or launch raises. Graphs under
DEVICE_MIN_EDGES live edges take the host path (scipy's compiled
Tarjan-equivalent) outright, as in the reference's dispatch.

Edge subsets (elle checks cycles over WW, WW+WR, ... cumulative edge
classes) are boolean edge masks over ONE shared edge array: an Edges
object checks and uploads src and dst once for all its launches. The
JAX package's shape-bucket padding is not ported: the port launches at
exact sizes.

The sharded form (jepsen_tpu/tpu/scc.py:172 `_jitted_scc_sharded`):
over a mesh of more than one shard (gpu/spmd.py; the automatic one when
more than one card may be spanned) and at least DEVICE_MIN_EDGES edges,
an Edges object orders its edges into key blocks by `ekey` (the per-edge
key id of elle's edge inference; a stable sort, skipped when they are
already in order), splits them into one contiguous block a shard, and
solves with the colours replicated: the host drives the JAX program's
rounds under its caps, and runs each fixpoint in chunks of sweeps,
reading the fixpoint's device state back once a chunk. A sweep is one
kernels.scc_shard sweep a shard over its block (the first of a
fixpoint compacts the block's live edges, the later ones read only
those), the combine of the shards' results (pmax: on one card the
shards' atomics into one shared accumulator; from other devices an
elementwise max onto the first shard's device, and dist.all_reduce(MAX)
across ranks), then one apply. A round launches nothing of its own:
the first sweep and apply of each fixpoint start it from the active
set (the colours c0, the roots m0), and each backward chunk ends in the
retire, which once the fixpoint is done labels the round's members and
counts the nodes left into the state that chunk reads back. The
combined sweep equals the unsharded scatter-max, so labels, ok, rounds
and sweeps equal scc_kernel's on the same graph. After a cap hit the
convergence launch runs on the first shard's device over the whole
edge list.
"""

from __future__ import annotations

from time import monotonic_ns

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
from . import dist, profiler, spmd
from .kernels import build as kbuild
from .kernels import scc as kernel
from .kernels import scc_shard as kshard

# The JAX program's argument names (tpu/scc.py:155): the partition-rule
# table in gpu/spmd.py lays them out over the mesh, and the lint
# registry traces the sharded sweep with that layout.
SCC_ARGS = ("active", "src", "dst", "edge_on")

# Below this edge count the host path wins on dispatch overhead alone.
# The JAX package's threshold, kept for parity; it was tuned on a TPU.
DEVICE_MIN_EDGES = 20_000


class Edges:
    """One edge array over n nodes: endpoints checked once, and src and
    dst uploaded to the device once, at the first launch, for every
    edge mask solved over it. device: None (the card) or "cpu" (the
    plain version); or mesh: a Mesh, a device list or one device, whose
    shards split the edges when there are more than one (module
    docstring). ekey: per-edge key ids that order the sharded layout."""

    def __init__(self, n: int, src, dst, device=None, ekey=None,
                 mesh=None):
        if mesh is not None and device is not None:
            raise ValueError("pass a device or a mesh, not both")
        self.n = n
        self.src = np.ascontiguousarray(src, dtype=np.int32)
        self.dst = np.ascontiguousarray(dst, dtype=np.int32)
        if self.src.shape != self.dst.shape or self.src.ndim != 1:
            raise ValueError(f"src {self.src.shape} and dst "
                             f"{self.dst.shape} must be [E]")
        if len(self.src) and (min(self.src.min(), self.dst.min()) < 0
                              or max(self.src.max(), self.dst.max()) >= n):
            raise ValueError(f"edge endpoints outside [0, {n})")
        if mesh is None:
            self.dev = resolve_device(device)
            self.mesh = spmd.route(self.dev, len(self.src))
        else:
            self.mesh = spmd.as_mesh(mesh)
            self.dev = self.mesh.home()
        self.sharded = (self.mesh is not None and self.mesh.size > 1
                        and len(self.src) >= DEVICE_MIN_EDGES)
        # this object's edge j is the caller's edge _order[j] once the
        # key-block layout reorders them
        self._order = None
        if self.sharded:
            telemetry.gauge_max("scc.spmd.devices", self.mesh.size)
            if ekey is not None and len(ekey) == len(self.src):
                ekey = np.asarray(ekey)
                if np.any(ekey[:-1] > ekey[1:]):
                    self._order = np.argsort(ekey, kind="stable")
                    self.src = self.src[self._order]
                    self.dst = self.dst[self._order]
                telemetry.count("scc.keyblock-layouts")
        self._on_device = None
        self._blocks = None
        self._solver = None

    def _mask(self, emask) -> np.ndarray:
        if emask is None:
            return np.ones(len(self.src), dtype=bool)
        on = np.ascontiguousarray(emask, dtype=bool)
        return on if self._order is None else on[self._order]

    def labels_device(self, emask=None, to_convergence: bool = False
                      ) -> np.ndarray | None:
        """One kernel launch (see scc_device); with to_convergence, the
        convergence launch, whose labels always come back. Each launch
        makes an `scc` profiler record: nodes, edges, h2d_ns,
        dispatch_ns, compute_ns (the kernel's CUDA-event interval on the
        card, read after the labels' download; the host wait on the CPU)
        and the cost fields."""
        n = self.n
        if n == 0:
            return np.empty(0, dtype=np.int32)
        if self.sharded and not to_convergence:
            out = self.solve_sharded(emask)
            return out[:n] if out[n] else None
        E = len(self.src)
        launch = (kernel.scc_labels_to_convergence if to_convergence
                  else kernel.scc_labels)
        on_card = self.dev.type == "cuda"
        events = ((torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) if on_card
                  else None)
        prof = profiler.get()
        bucket = ("scc-converge" if to_convergence else "scc", n, E,
                  self.dev.type)
        rec = prof.begin("scc", bucket=bucket, nodes=n, edges=E)
        fresh = prof.bucket_fresh("scc", bucket)
        try:
            with telemetry.span("scc:device", device=self.dev.type) as sp:
                t0 = monotonic_ns()
                if self._on_device is None:
                    self._on_device = (
                        torch.from_numpy(self.src).to(self.dev),
                        torch.from_numpy(self.dst).to(self.dev))
                on = torch.from_numpy(self._mask(emask)).to(self.dev)
                rec["h2d_ns"] = monotonic_ns() - t0
                t0 = monotonic_ns()
                out = launch(*self._on_device, on, n, events=events)
                rec["dispatch_ns"] = monotonic_ns() - t0
                compile_ns = kbuild.take_load_ns("scc")
                if compile_ns:
                    rec["compile_ns"] = compile_ns
                t0 = monotonic_ns()
                # one download: labels, ok and the launch's counts
                labels = out.cpu().numpy()
                wait_ns = monotonic_ns() - t0
                # the kernel's time alone, between the events its
                # launcher recorded just around it
                device_ms = (events[0].elapsed_time(events[1]) if on_card
                             else None)
                sp["attrs"] = {"device": self.dev.type,
                               "device_ms": device_ms}
            rec["compute_ns"] = (wait_ns if device_ms is None
                                 else round(device_ms * 1e6))
            scratch = (kernel.scratch_bytes(n, E, to_convergence)
                       if on_card else 0)
            rec.update(prof.bucket_cost(
                bucket, lambda: profiler.scc_cost(n, E, len(labels),
                                                  scratch), fresh))
        except BaseException:
            if fresh:
                # failed first launch: release the claim so the retry
                # records a miss, not a phantom hit
                prof.bucket_unclaim("scc", bucket)
            raise
        finally:
            prof.finish(rec)
        if not labels[n]:
            return None
        return labels[:n]

    def _shard_blocks(self) -> list:
        """(device, src, dst) of each shard this rank launches: the
        edges split into mesh.size contiguous blocks of e_blk, the last
        padded (its padding is never live), each uploaded once."""
        if self._blocks is None:
            k = self.mesh.size
            e_blk = -(-len(self.src) // k)
            self._e_blk = e_blk
            self._blocks = []
            for d in self.mesh.local():
                lo, hi = d * e_blk, min((d + 1) * e_blk, len(self.src))
                dev = self.mesh.devices[d]
                self._blocks.append(tuple(
                    [dev] + [torch.from_numpy(_padded(a[lo:hi], e_blk)).to(dev)
                             for a in (self.src, self.dst)]))
        return self._blocks

    def solve_sharded(self, emask=None) -> np.ndarray:
        """The sharded solve (module docstring) of the masked edges:
        int32 [n + 3], labels, ok, rounds and sweeps, as scc_kernel's.
        Makes an `scc` profiler record with `devices`; its compute_ns is
        the host's wall time of the rounds, which wait for the card once
        a chunk of sweeps. The solver's buffers and
        plans are built at the first solve and serve every mask after."""
        n, mesh = self.n, self.mesh
        on = self._mask(emask)
        prof = profiler.get()
        if self._solver is None:
            self._solver = _ShardedSolve(n, mesh, self.dev,
                                         self._shard_blocks())
        bucket = ("scc-sharded", n, self._e_blk, self.dev.type)
        rec = prof.begin("scc", bucket=bucket, nodes=n, edges=len(on),
                         devices=mesh.size)
        fresh = prof.bucket_fresh("scc", bucket)
        try:
            with telemetry.span("scc:device", device=self.dev.type,
                                devices=mesh.size):
                t0 = monotonic_ns()
                self._solver.upload(_padded(on, mesh.size * self._e_blk))
                rec["h2d_ns"] = monotonic_ns() - t0
                t0 = monotonic_ns()
                out = self._solver.run()
                rec["compute_ns"] = rec["dispatch_ns"] = monotonic_ns() - t0
                compile_ns = kbuild.take_load_ns("scc_shard")
                if compile_ns:
                    rec["compile_ns"] = compile_ns
            rec.update(prof.bucket_cost(
                bucket, lambda: profiler.scc_cost(n, len(on), n + 3), fresh))
        except BaseException:
            if fresh:
                prof.bucket_unclaim("scc", bucket)
            raise
        finally:
            prof.finish(rec)
        return out

    def scc(self, emask=None) -> np.ndarray:
        """SCC labels (component max-id per node) of the masked edges:
        the device kernel, followed by the convergence launch when the
        JAX caps are hit, and the host path outright for small graphs
        (under DEVICE_MIN_EDGES live edges)."""
        n = self.n
        on = self._mask(emask)
        n_live = int(on.sum())
        if n == 0 or n_live == 0:
            return np.arange(n, dtype=np.int32)
        telemetry.count("scc.nodes", n)
        telemetry.count("scc.edges", n_live)
        if n_live >= DEVICE_MIN_EDGES:
            # the caller's mask: labels_device lays it out itself
            labels = self.labels_device(emask)
            if labels is None:
                telemetry.count("scc.device-nonconverged")
                labels = self.labels_device(emask, to_convergence=True)
            telemetry.count("scc.path.device")
            return labels
        telemetry.count("scc.path.host")
        return _scc_host(n, self.src[on], self.dst[on])


def _padded(a: np.ndarray, size: int) -> np.ndarray:
    """`a` padded with zeros (never-live edges: their edge_on is False)
    to `size` entries."""
    if len(a) == size:
        return np.ascontiguousarray(a)
    out = np.zeros(size, dtype=a.dtype)
    out[:len(a)] = a
    return out


class _Nodes:
    """The node arrays a device's shards read (active, the colours c and
    the marks m), the sweep accumulator they share and the fixpoint's
    state, on one device: the home's are the solve's own, another
    device's are copies the host refreshes (active and c at a compacting
    sweep, x at a later one). With them, the edge masks, live lists and
    counts of the device's `shards` blocks of e edges, and the mesh's
    indices of those shards."""

    def __init__(self, n: int, dev: torch.device, shards: list, e: int):
        i32 = dict(dtype=torch.int32, device=dev)
        ints = torch.empty(3 * n + kshard.STATE, **i32)
        self.prop, self.c, self.m = ints[:n], ints[n:2 * n], ints[2 * n:3 * n]
        self.st = ints[3 * n:]
        self.active = torch.empty(n, dtype=torch.bool, device=dev)
        self.shards = shards
        self.on = torch.empty((len(shards), e), dtype=torch.bool, device=dev)
        self.live = torch.empty((len(shards), e, 2), **i32)
        self.cnt = torch.empty((len(shards), 2), **i32)

    def reset(self) -> None:
        """The state a solve starts from."""
        self.prop.fill_(kshard.NEUTRAL)
        self.st.zero_()
        self.cnt.zero_()
        self.active.fill_(True)


def _schedule(head: tuple):
    """Chunk sizes: `head`, then doubling."""
    yield from head
    k = head[-1]
    while True:
        k *= 2
        yield k


def _combine(prop: torch.Tensor, others: list, group: bool) -> None:
    """The combine of a sweep across devices: each other device's
    accumulator maxed onto `prop` (the home's) and reset to NEUTRAL
    there, then the max across ranks. The home's shards need none: they
    accumulate into `prop` itself."""
    for q in others:
        torch.maximum(prop, q.to(prop.device), out=prop)
        q.fill_(kshard.NEUTRAL)
    if group:
        dist.all_reduce_(prop, "max")


class _ShardedSolve:
    """The host-driven Orzan program over a mesh's edge blocks: the JAX
    program's rounds and sweeps (tpu/scc.py:64-146) with its caps. The
    buffers and plans are built, and every tensor checked, once for an
    Edges object; a solve uploads its mask and resets the state.

    Each fixpoint runs in chunks of sweeps, read back once a chunk; a
    sweep or apply past the fixpoint's end changes nothing, so the
    sweeps counted are the JAX program's. The rounds launch nothing of
    their own: the first sweep and apply of a fixpoint compute its
    starting values, and each backward chunk ends in the retire (a
    no-op until the fixpoint is done), so the chunk's one read gives
    the nodes left and the host waits for nothing else until the
    labels' download. The shards on one device are swept by one launch
    and share the device's accumulator, so their atomics are their
    combine. With every shard on the home device and no process group
    (one card), a chunk is one kshard.scc_chunk. Otherwise each sweep is
    a kshard.scc_sweep a device, _combine, and a kshard.scc_apply, the
    node arrays and the state copied to each other device; the chunk's
    retire is one kshard.scc_retire on the home device. After each sweep
    the accumulators hold NEUTRAL again: the apply resets the home's,
    _combine the others'.

    The chunk schedule, from phase 8's Elle twin over 4 shards (16
    fixpoints, 57 sweeps; a forward fixpoint took 1 sweep or 4 to 7, the
    backward one that follows it at most as many): the forward fixpoint
    in chunks of 1, 6, then doubling, the backward one first in a chunk
    of the forward's sweeps (at most 6), then doubling. There it reads
    the state back 21 times and launches 10 sweeps past a fixpoint's
    end, where chunks of 2, 4, 8, ... read back 27 times and launch 23,
    and one read a sweep reads 57 times. A launch past the end costs the
    card a few microseconds and the host the time to enqueue it, a
    read-back a wait for the card and a return to Python: the schedule
    keeps both few."""

    def __init__(self, n, mesh, home, blocks):
        self.n, self.home = n, home
        devs = [dev for dev, _s, _d in blocks]
        e = len(blocks[0][1]) if blocks else 0
        self.nodes = {dev: _Nodes(n, dev, [d for d, dd in zip(
            mesh.local(), devs) if dd == dev], e)
            for dev in dict.fromkeys([home, *devs])}
        me = self.nodes[home]
        self.active, self.c, self.m = me.active, me.c, me.m
        self.prop, self.st = me.prop, me.st
        self.out = torch.empty(n, dtype=torch.int32, device=home)
        self.group = dist.world_size() > 1
        cap = kernel.SWEEP_CAP
        # per pass (forward, backward): each device's shards' sweep plans
        plans: tuple = ({}, {})
        for dev, src, dst in blocks:
            nd = self.nodes[dev]
            j = len(plans[0].setdefault(dev, []))
            for b in (0, 1):
                plans[b].setdefault(dev, []).append(kshard.sweep_plan(
                    src, dst, nd.on[j], nd.active, nd.m if b else nd.c,
                    nd.c, nd.prop, nd.live[j], nd.cnt[j], nd.st,
                    backward=bool(b)))
        self.groups = tuple([kshard.SweepGroup(g) for g in pb.values()]
                            for pb in plans)
        self.applies = tuple(
            kshard.apply_plan(x, self.prop, self.st, self.active, self.c,
                              cap, backward=bool(b))
            for b, x in enumerate((self.c, self.m)))
        self.retire = kshard.retire_plan(self.active, self.c, self.m,
                                         self.out, self.st)
        self.host = kshard.state_buffer(home)
        self.others = [nd for dev, nd in self.nodes.items() if dev != home]
        self.chunks = None
        if not self.group and not self.others and blocks:
            self.chunks = tuple(
                kshard.ChunkPlan(self.groups[b][0], self.applies[b],
                                 self.host, self.retire if b else None)
                for b in (0, 1))

    def upload(self, on: np.ndarray) -> None:
        """The edge mask of a solve, [mesh.size * e] bool: one upload a
        device of its shards' blocks."""
        for nd in self.nodes.values():
            if nd.shards:
                rows = on.reshape(-1, nd.on.shape[1])
                nd.on.copy_(torch.from_numpy(rows[nd.shards]))

    def _sweep(self, b: int, compact: bool) -> None:
        """One sweep launch by launch: the copies to the other devices
        (a compacting sweep reads active and, backward, the colours; a
        later one x), each shard's sweep, the combine, the apply."""
        x = self.m if b else self.c
        for nd in self.others:
            if compact:
                nd.active.copy_(self.active)
                if b:
                    nd.c.copy_(self.c)
            else:
                (nd.m if b else nd.c).copy_(x)
        for group in self.groups[b]:
            kshard.scc_sweep(group, compact)
        _combine(self.prop, [nd.prop for nd in self.others], self.group)
        kshard.scc_apply(self.applies[b], compact)
        for nd in self.others:
            nd.st.copy_(self.st)

    def _launches(self, b: int, k: int, first: bool) -> None:
        """A chunk launch by launch: k sweeps, the retire on the home
        device (backward), and the copy of the state to read back."""
        for i in range(k):
            self._sweep(b, first and i == 0)
        if b:
            kshard.scc_retire(self.retire)
        kshard.fetch_state(self.st, self.host)

    def _fixpoint(self, backward: bool, head: tuple) -> tuple:
        """Sweeps to a fixpoint of x (c forward, m backward), or to
        SWEEP_CAP, in chunks of _schedule(head), the round retired at
        the backward one's end; (converged, sweeps, the active nodes
        left, read with them: meaningful after the backward pass)."""
        b = int(backward)
        first = True
        for k in _schedule(head):
            if self.chunks:
                kshard.scc_chunk(self.chunks[b], k, first)
            else:
                self._launches(b, k, first)
            first = False
            sweeps, done, left = kshard.read_state(self.st, self.host)
            if done != kshard.RUNNING:
                return done == kshard.CONVERGED, sweeps, left

    def run(self) -> np.ndarray:
        """The solve of the mask last uploaded: int32 [n + 3], labels,
        ok, rounds and sweeps."""
        for nd in self.nodes.values():
            nd.reset()
        self.out.fill_(-1)
        ok, rounds, sweeps, left = True, 0, 0, self.n
        while ok and left and rounds < kernel.ROUND_CAP:
            ok_f, it_f, _ = self._fixpoint(False, (1, 6))
            ok_b, it_b, left = self._fixpoint(True, (min(it_f, 6),))
            ok = ok and ok_f and ok_b
            rounds += 1
            sweeps += it_f + it_b
        labels = self.out.cpu().numpy()
        return np.concatenate([labels, np.array(
            [int(ok and not left), rounds, sweeps], dtype=np.int32)])


def scc_device(n: int, src, dst, emask=None, device=None, ekey=None,
               mesh=None) -> np.ndarray | None:
    """SCC labels per node (label = the component's max node id), or
    None when the JAX program's iteration caps were hit. Singleton
    components get their own id, so callers test non-triviality by
    label multiplicity. device: None (the card) or "cpu" (the plain
    version); mesh and ekey: see Edges."""
    return Edges(n, src, dst, device, ekey=ekey,
                 mesh=mesh).labels_device(emask)


def _scc_host(n: int, src, dst) -> np.ndarray:
    """Exact host SCC via scipy (compiled Tarjan-equivalent), with
    labels normalized to the component's max node id so device and
    host paths are interchangeable."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    g = coo_matrix((np.ones(len(src), dtype=np.int8),
                    (np.asarray(src), np.asarray(dst))), shape=(n, n))
    _, comp = connected_components(g, directed=True, connection="strong")
    ids = np.arange(n, dtype=np.int32)
    rep = np.full(int(comp.max()) + 1 if n else 0, -1, dtype=np.int32)
    np.maximum.at(rep, comp, ids)
    return rep[comp]


def scc(n: int, src, dst, emask=None, device=None, ekey=None,
        mesh=None) -> np.ndarray:
    """SCC labels (component max-id per node); see Edges.scc. device:
    None (the card) or "cpu" (the plain version); it is resolved even
    when the graph is small, so the card is never skipped silently.
    mesh and ekey: see Edges."""
    return Edges(n, src, dst, device, ekey=ekey, mesh=mesh).scc(emask)


def nontrivial_from_labels(labels: np.ndarray) -> list[np.ndarray]:
    """Member arrays of every component with >= 2 nodes (self-loops are
    not cycles in dependency graphs: a txn never depends on itself)."""
    uniq, inverse, counts = np.unique(labels, return_inverse=True,
                                      return_counts=True)
    big = counts > 1
    if not big.any():
        return []
    order = np.argsort(inverse, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(counts)])
    groups = [order[bounds[i]:bounds[i + 1]]
              for i in np.flatnonzero(big)]
    telemetry.count("scc.nontrivial-components", len(groups))
    telemetry.gauge_max("scc.largest-component",
                        int(max(len(g) for g in groups)))
    return groups


def nontrivial_sccs(n: int, src, dst, emask=None, device=None, ekey=None,
                    mesh=None) -> list[np.ndarray]:
    if n == 0:
        return []
    return nontrivial_from_labels(scc(n, src, dst, emask, device=device,
                                      ekey=ekey, mesh=mesh))
