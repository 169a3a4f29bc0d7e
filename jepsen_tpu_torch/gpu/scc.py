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
JAX package's sharded form, its key-block edge layout and its
shape-bucket padding are not ported: the port launches on one card at
exact sizes.
"""

from __future__ import annotations

from time import monotonic_ns

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
from . import profiler
from .kernels import build as kbuild
from .kernels import scc as kernel

# Below this edge count the host path wins on dispatch overhead alone.
# The JAX package's threshold, kept for parity; it was tuned on a TPU.
DEVICE_MIN_EDGES = 20_000


class Edges:
    """One edge array over n nodes: endpoints checked once, and src and
    dst uploaded to the device once, at the first launch, for every
    edge mask solved over it. device: None (the card) or "cpu" (the
    plain version)."""

    def __init__(self, n: int, src, dst, device=None):
        self.dev = resolve_device(device)
        self.n = n
        self.src = np.ascontiguousarray(src, dtype=np.int32)
        self.dst = np.ascontiguousarray(dst, dtype=np.int32)
        if self.src.shape != self.dst.shape or self.src.ndim != 1:
            raise ValueError(f"src {self.src.shape} and dst "
                             f"{self.dst.shape} must be [E]")
        if len(self.src) and (min(self.src.min(), self.dst.min()) < 0
                              or max(self.src.max(), self.dst.max()) >= n):
            raise ValueError(f"edge endpoints outside [0, {n})")
        self._on_device = None

    def _mask(self, emask) -> np.ndarray:
        return (np.ones(len(self.src), dtype=bool) if emask is None
                else np.ascontiguousarray(emask, dtype=bool))

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
            labels = self.labels_device(on)
            if labels is None:
                telemetry.count("scc.device-nonconverged")
                labels = self.labels_device(on, to_convergence=True)
            telemetry.count("scc.path.device")
            return labels
        telemetry.count("scc.path.host")
        return _scc_host(n, self.src[on], self.dst[on])


def scc_device(n: int, src, dst, emask=None,
               device=None) -> np.ndarray | None:
    """SCC labels per node (label = the component's max node id), or
    None when the JAX program's iteration caps were hit. Singleton
    components get their own id, so callers test non-triviality by
    label multiplicity. device: None (the card) or "cpu" (the plain
    version)."""
    return Edges(n, src, dst, device).labels_device(emask)


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


def scc(n: int, src, dst, emask=None, device=None) -> np.ndarray:
    """SCC labels (component max-id per node); see Edges.scc. device:
    None (the card) or "cpu" (the plain version); it is resolved even
    when the graph is small, so the card is never skipped silently."""
    return Edges(n, src, dst, device).scc(emask)


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


def nontrivial_sccs(n: int, src, dst, emask=None,
                    device=None) -> list[np.ndarray]:
    if n == 0:
        return []
    return nontrivial_from_labels(scc(n, src, dst, emask, device=device))
