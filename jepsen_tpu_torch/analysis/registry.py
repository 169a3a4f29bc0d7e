"""The launch registry: every hand kernel's launch, traced off its plan
(the port's copy of jepsen_tpu/analysis/registry.py).

Each entry names one launch path of the checker pipeline and knows how
to trace it at a shape bucket: meta tensors of the bucket's shapes
through the kernel wrapper's own launch_plan (gpu/kernels/*.py), the
code the card runs, so the arguments, outputs, scratch and shared
memory are read off the launch itself, not off a parallel description
that can drift. Meta tensors have no storage: tracing needs no card
and no nvcc, and tier-1 runs it on the CPU.

The entries keep the JAX registry's names where a counterpart exists:
`wgl`, `wgl-reach`, `wgl-segmented` and `wgl-slices` are wgl_search
launches through gpu/wgl.py's paths, `wgl-sharded` a shard's launch of
gpu/ensemble.py's mesh form, `scc` the capped scc_kernel. The others are
the port's own: `scc-converge` (scc_converge_kernel, the launch after a
cap hit), `scc-sharded`, `scc-shard-apply` and `scc-shard-retire` (the
sharded colouring's sweep over a shard's edge block, its apply and the
retire that ends a backward chunk, kernels/scc_shard.py) and
`bank_reduce`. `wgl-sharded` and
`scc-sharded` carry the partition that gpu/spmd.py's rule tables give
their launches' arguments and their batch axis, which R4 reads, as in
the JAX registry. The JAX registry's `wgl-single` and `scc-single`
trace the programs its JEPSEN_TPU_SPMD=0 switch selects; in the port
that switch selects launches the other entries already trace, so they
have no entry here.

Default buckets are the JAX registry's, fixed and deterministic (the
committed baseline must not depend on what this process happened to
launch); runtime buckets from profiler.shape_buckets() add the shapes a
live run used. In full mode each trace also asks the built library for
its scratch and shared-memory sizes and raises when the Python numbers
differ.
"""

from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from ..gpu.lint import ArgSpec, LaunchTrace

_PKG = Path(__file__).resolve().parent.parent
_KERNELS = _PKG / "gpu" / "kernels"


class SizingMismatch(ValueError):
    """A launch plan's Python scratch or shared-memory size is not the
    library's."""


def _provenance(fn) -> tuple[str | None, int | None]:
    try:
        f = inspect.unwrap(fn)
        return (inspect.getsourcefile(f),
                inspect.getsourcelines(f)[1])
    except (OSError, TypeError):
        return None, None


def _specs(tensors: dict) -> list[ArgSpec]:
    """The plan's tensors as ArgSpecs. `copied` stays False: a plan
    never copies or casts, since each wrapper's check refuses an input
    of the wrong dtype or layout instead (R3 cannot fire on a plan)."""
    return [ArgSpec(name=name, shape=tuple(t.shape),
                    dtype=str(t.dtype).removeprefix("torch."),
                    nbytes=t.numel() * t.element_size())
            for name, t in tensors.items()]


def _meta(shape, dtype):
    import torch

    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _trace(name: str, bucket: str, plan, site, library: dict,
           carry_outputs: bool, partition: dict | None = None,
           batch_axes: tuple = ()) -> LaunchTrace:
    """A LaunchTrace of one plan. R6's carry is the scratch, plus a
    block's shared memory and the outputs where the frontier lives in
    them (carry_outputs); `library`, in full mode, holds the library's
    sizes, which must equal the plan's. `partition` and `batch_axes`
    are R4's: the mesh layout of a sharded launch's arguments."""
    outputs = _specs(plan.outputs)
    scratch = 0 if plan.scratch is None else plan.scratch.numel()
    mine = {"scratch_bytes": scratch, "smem_bytes": plan.smem_bytes}
    for k, v in library.items():
        if mine[k] != v:
            raise SizingMismatch(f"{name}/{bucket}: {k} {mine[k]} in "
                                 f"Python, {v} in the library")
    carry = scratch + (plan.smem_bytes + sum(o.nbytes for o in outputs)
                       if carry_outputs else 0)
    f, ln = _provenance(site)
    return LaunchTrace(name=name, bucket=bucket,
                       args=_specs(plan.args),
                       outputs=outputs, scratch_bytes=scratch,
                       smem_bytes=plan.smem_bytes, carry_bytes=carry,
                       library=library, partition=partition,
                       batch_axes=list(batch_axes), file=f, line=ln)


@dataclass
class Entry:
    """One registry entry. trace(bucket, full=False) -> LaunchTrace;
    buckets are dicts whose 'label' names the bucket. full=True also
    asks the built library for the launch's sizes (needs the card)."""

    name: str
    trace: Callable[..., LaunchTrace]
    buckets: list = field(default_factory=list)
    doc: str = ""


# ---------------------------------------------------------------------------
# wgl_search (check_batch / check_batch_reach / check_segmented /
# check_slices / a shard of the ensemble's mesh form)
# ---------------------------------------------------------------------------

def _wgl_trace(b: dict, kernel_name: str, full: bool = False
               ) -> LaunchTrace:
    from ..gpu import ensemble, spmd, wgl
    from ..gpu.kernels import wgl_search as ws

    K, M, S, rows = b["K"], b["M"], b["S"], b["rows"]
    packed = (_meta((K, M), "int32"), _meta((K, M), "int32"),
              _meta((K, M, S), "int32"), _meta((K,), "int32"),
              _meta((K, M + 1), "int32"))
    crash_free = b.get("crash_free", False)
    plan = ws.launch_plan(packed, _meta((rows,), "int32"),
                          _meta((rows,), "int32"), b["W"], b["F"],
                          b.get("max_iters", M + 4),
                          reach=b.get("reach", False),
                          crash_free=crash_free)
    library = ({"smem_bytes": ws.library_smem_bytes(b["W"], b["F"],
                                                    crash_free)}
               if full else {})
    site = {"wgl": wgl._launch, "wgl-reach": wgl._launch,
            "wgl-segmented": wgl._resolve_wave,
            "wgl-slices": wgl.check_slices,
            "wgl-sharded": ensemble.sharded_launch}[kernel_name]
    if kernel_name != "wgl-sharded":
        return _trace(kernel_name, b["label"], plan, site, library,
                      carry_outputs=True)
    # every wgl entry point rides this launch when more than one card
    # may be spanned: its layout is what R4 prices
    return _trace(kernel_name, b["label"], plan, site, library,
                  carry_outputs=True,
                  partition=spmd.describe_partition(spmd.WGL_RULES,
                                                    ensemble.SHARD_ARGS),
                  batch_axes=[("row_seg", 0,
                               "independent search rows: one history / "
                               "(segment, start-state) pair per row")])


# ---------------------------------------------------------------------------
# scc_kernel (capped) and scc_converge_kernel (after a cap hit)
# ---------------------------------------------------------------------------

def _scc_trace(b: dict, full: bool = False, kernel_name: str = "scc"
               ) -> LaunchTrace:
    from ..gpu import scc
    from ..gpu.kernels import scc as kscc

    n, E = b["n_pad"], b["e_pad"]
    converge = kernel_name == "scc-converge"
    plan = kscc.launch_plan(_meta((E,), "int32"), _meta((E,), "int32"),
                            _meta((E,), "bool"), n, converge=converge)
    library = ({"scratch_bytes": kscc.scratch_bytes(n, E, converge)}
               if full else {})
    return _trace(kernel_name, b["label"], plan, scc.Edges.labels_device,
                  library, carry_outputs=False)


def _scc_shard_trace(b: dict, full: bool = False,
                     kernel_name: str = "scc-sharded") -> LaunchTrace:
    """A launch of the sharded colouring at a bucket whose e_pad is one
    shard's edge block, off the plans a solve builds: its sweep (the
    compacting backward one, which reads the most: with the partition of
    SCC_RULES over the JAX program's arguments and the edge list's batch
    axis), its apply (the first of the backward pass, which reads the
    most) or its retire. None has scratch or shared
    memory, so the library has no sizing entry point to ask; the
    compacted list and the accumulator are outputs, not carry."""
    from ..gpu import scc, spmd
    from ..gpu.kernels import scc as kscc
    from ..gpu.kernels import scc_shard as kshard

    n, E = b["n_pad"], b["e_pad"]
    node = _meta((n,), "int32")
    st = _meta((kshard.STATE,), "int32")
    if kernel_name == "scc-shard-apply":
        plan = kshard.apply_plan(node, _meta((n,), "int32"), st,
                                 _meta((n,), "bool"), _meta((n,), "int32"),
                                 kscc.SWEEP_CAP, backward=True)
        return _trace(kernel_name, b["label"], plan, kshard.scc_chunk, {},
                      carry_outputs=False)
    if kernel_name == "scc-shard-retire":
        plan = kshard.retire_plan(_meta((n,), "bool"), node,
                                  _meta((n,), "int32"),
                                  _meta((n,), "int32"), st)
        return _trace(kernel_name, b["label"], plan, kshard.scc_chunk, {},
                      carry_outputs=False)
    plan = kshard.sweep_plan(_meta((E,), "int32"), _meta((E,), "int32"),
                             _meta((E,), "bool"), _meta((n,), "bool"),
                             node, _meta((n,), "int32"),
                             _meta((n,), "int32"), _meta((E, 2), "int32"),
                             _meta((2,), "int32"), st, backward=True)
    return _trace(kernel_name, b["label"], plan, scc.Edges.solve_sharded,
                  {}, carry_outputs=False,
                  partition=spmd.describe_partition(spmd.SCC_RULES,
                                                    scc.SCC_ARGS),
                  batch_axes=[("src", 0, "edge list: scatter-max sweeps "
                               "are per-edge data-parallel")])


# ---------------------------------------------------------------------------
# bank_reduce (the bank checker's device branch)
# ---------------------------------------------------------------------------

def _bank_trace(b: dict, full: bool = False) -> LaunchTrace:
    from ..gpu.kernels import bank_reduce as kbank
    from ..workloads import bank

    plan = kbank.launch_plan(_meta((b["reads"], b["accounts"]), "int64"))
    # no scratch and no dynamic shared memory: the library has no sizing
    # entry point to ask
    return _trace("bank_reduce", b["label"], plan, bank.check_fast, {},
                  carry_outputs=False)


# ---------------------------------------------------------------------------
# Default shape buckets (the JAX registry's, deterministic; they mirror
# the bench configs: ensemble batches, segmented long histories, elle
# SCC graphs)
# ---------------------------------------------------------------------------

WGL_BUCKETS = [
    # check_batch over a 64-history bucket (the ensemble chunk shape)
    {"label": "B64xM512xS8", "K": 65, "M": 512, "S": 8, "rows": 64,
     "W": 32, "F": 64, "reach": False, "crash_free": False},
]
WGL_REACH_BUCKETS = [
    {"label": "B64xM512xS8", "K": 65, "M": 512, "S": 8, "rows": 64,
     "W": 32, "F": 32, "reach": True, "crash_free": False},
]
WGL_SEG_BUCKETS = [
    # check_segmented: K segments x S start states of one long history
    {"label": "K8xM8192xS8", "K": 9, "M": 8192, "S": 8, "rows": 128,
     "W": 24, "F": 48, "reach": True, "crash_free": False},
]
SHARDED_BUCKETS = [
    # the 1024-history ensemble bench (BASELINE config 5)
    {"label": "B1024xM512xS8", "K": 1025, "M": 512, "S": 8,
     "rows": 1024, "W": 32, "F": 64, "reach": False},
]
SLICES_BUCKETS = [
    # the fleet's cross-run slice launch (fleet/scheduler.py via
    # wgl.check_slices): ~32 tenant stream segments x a handful of live
    # start states each — short segments, small state spaces, many rows
    {"label": "B32xM512xS8", "K": 33, "M": 512, "S": 8, "rows": 128,
     "W": 24, "F": 48, "reach": True, "crash_free": False},
]
SCC_BUCKETS = [
    # elle dependency graphs at the 100k-txn bench scale
    {"label": "N131072xE262144", "n_pad": 131072, "e_pad": 262144},
]
SCC_SHARD_BUCKETS = [
    # the same graphs over a 4-shard mesh: one shard's edge block
    {"label": "N131072xE65536", "n_pad": 131072, "e_pad": 65536},
]
BANK_BUCKETS = [
    # chip_smoke phase 10's bank_history(500_000, n_accounts=32):
    # ~250,000 reads of 32 balances
    {"label": "R250000xA32", "reads": 250_000, "accounts": 32},
]


def entries() -> list[Entry]:
    return [
        Entry("wgl", functools.partial(_wgl_trace, kernel_name="wgl"),
              WGL_BUCKETS, "check_batch batched frontier search"),
        Entry("wgl-reach",
              functools.partial(_wgl_trace, kernel_name="wgl-reach"),
              WGL_REACH_BUCKETS,
              "check_batch_reach exhaustive reachability"),
        Entry("wgl-segmented",
              functools.partial(_wgl_trace, kernel_name="wgl-segmented"),
              WGL_SEG_BUCKETS, "check_segmented per-segment reach rows"),
        Entry("wgl-sharded",
              functools.partial(_wgl_trace, kernel_name="wgl-sharded"),
              SHARDED_BUCKETS,
              "a shard's launch of the ensemble's mesh form"),
        Entry("wgl-slices",
              functools.partial(_wgl_trace, kernel_name="wgl-slices"),
              SLICES_BUCKETS,
              "check_slices fleet cross-tenant reach rows"),
        Entry("scc", _scc_trace, SCC_BUCKETS,
              "Orzan colouring SCC, capped (elle_device cycle engine)"),
        Entry("scc-converge",
              functools.partial(_scc_trace, kernel_name="scc-converge"),
              SCC_BUCKETS, "the convergence launch after a cap hit"),
        Entry("scc-sharded", _scc_shard_trace, SCC_SHARD_BUCKETS,
              "sharded Orzan colouring, a sweep over a shard's edges"),
        Entry("scc-shard-apply",
              functools.partial(_scc_shard_trace,
                                kernel_name="scc-shard-apply"),
              SCC_SHARD_BUCKETS, "sharded colouring, a sweep's apply"),
        Entry("scc-shard-retire",
              functools.partial(_scc_shard_trace,
                                kernel_name="scc-shard-retire"),
              SCC_SHARD_BUCKETS,
              "sharded colouring, a backward chunk's retire"),
        Entry("bank_reduce", _bank_trace, BANK_BUCKETS,
              "bank checker's row sums and negative flags"),
    ]


def host_feeder_modules() -> list:
    """Modules whose host-side array code feeds the kernels in int32
    house style — the R2 dtype audit targets. elle/elle_device are
    deliberately exempt: their packed (key, value) edge codes need 64
    bits by design, and scc.py narrows them to int32 at the device
    boundary."""
    from ..gpu import encode, ensemble, scc, wgl

    return [encode, wgl, scc, ensemble]


def launch_site_modules() -> list:
    """The modules that launch kernels, which R1 scans for host syncs in
    launch loops."""
    from ..fleet import scheduler
    from ..gpu import ckpt, elle, elle_device, ensemble, scc, wgl
    from ..workloads import bank

    return [wgl, ensemble, scc, elle_device, elle, ckpt, bank, scheduler]


# R1: loops the AST scan flags whose launching call reaches no kernel
# on any device, each with the reason. The scan cannot read the guard:
# the scheduler's host lanes run only when `_host_lanes()` (the CPU,
# where a wrapper runs its plain version), and a quarantined run served
# with probe=False makes no device call at all.
R1_HOST_ONLY = {
    "R1:module:scheduler:Scheduler._quarantined_finals:analysis":
        "the host lane's loop runs only when _host_lanes(), on the CPU",
    "R1:module:scheduler:Scheduler._wgl_finals:analysis":
        "the breaker's host finals: _run_final_group refuses them on the "
        "card and passes host=True only when _host_lanes(), on the CPU",
    "R1:module:scheduler:Scheduler._attribute_final_failure:"
    "_quarantined_finals":
        "probe=False: no device probe, and the host lane only on the CPU",
    "R1:module:scheduler:Scheduler._attribute_slice_failure:"
    "_quarantined_slices":
        "probe=False: no device probe, and the host lane only on the CPU",
}


def kernel_modules() -> list:
    """The kernel wrappers' modules (gpu/kernels/*.py): R1 reads which of
    their functions launch, and R5 their mirrored constants."""
    from ..gpu.kernels import bank_reduce, scc, scc_shard, wgl_search

    return [wgl_search, scc, scc_shard, bank_reduce]


# R5: the values compiled into each kernel that its Python side also
# holds, (kernel source, Python names, CUDA constexpr names).
MIRRORS = [
    ("wgl_search", [("BIG", "kBig"), ("VALID", "kValid"),
                    ("INVALID", "kInvalid"), ("UNKNOWN", "kUnknown"),
                    ("RUNNING", "kRunning"), ("_WARPS", "kWarps"),
                    ("_SERIES", "kSeries")]),
    ("scc", [("PRIO", "kPrio"), ("PRIO_INV", "kPrioInv"),
             ("_PRIO_MASK", "kPrioMask"),
             ("FIRST_ROUND_SWEEPS", "kFirstRoundSweeps"),
             ("_MAX_BLOCKS", "kMaxBlocks"), ("_SLOT", "kSlot")]),
    ("scc_shard", [("LATER", "kLater"), ("FORWARD_FIRST", "kForwardFirst"),
                   ("BACKWARD_FIRST", "kBackwardFirst"),
                   ("CHANGED", "kChanged"), ("TICKET", "kTicket"),
                   ("SWEEPS", "kSweeps"), ("DONE", "kDone"),
                   ("LEFT", "kLeft"), ("TALLY", "kTally"),
                   ("STATE", "kState"),
                   ("RUNNING", "kRunning"), ("CONVERGED", "kConverged"),
                   ("CAPPED", "kCapped"), ("NEUTRAL", "kNeutral"),
                   ("MAX_SHARDS", "kMaxShards")]),
]


def mirror_paths(kernel: str) -> tuple[Path, Path]:
    """(the wrapper's .py, the kernel's .cu) of a MIRRORS entry."""
    return _KERNELS / f"{kernel}.py", _KERNELS / "csrc" / f"{kernel}.cu"


def runtime_wgl_buckets(raw_buckets) -> list[dict]:
    """Translates gpu/wgl.py _compiled_buckets tuples (via
    profiler.shape_buckets()['wgl']) back into traceable bucket dicts,
    each naming its `entry`: `wgl` for _launch's tuples, `wgl-sharded`
    for the ensemble launch's (one shard's shape). Unparseable tuples are
    skipped: runtime buckets only ever ADD traces."""
    out = []
    for t in sorted(raw_buckets, key=repr):
        entry = "wgl"
        if isinstance(t, tuple) and t and t[0] in ("one-device", "mesh"):
            entry = "wgl-sharded"
            t = t[1:2] + t[2:4] + t[5:]   # drop the tag and inv_perm's len
        try:
            (K, M), S, rows, W, F, max_iters, reach, crashed, _dev = t
        except (TypeError, ValueError):
            continue
        if not all(isinstance(x, int)
                   for x in (K, M, S, rows, W, F, max_iters)):
            continue
        out.append({"entry": entry,
                    "label": f"rt-K{K}xB{rows}xM{M}xS{S}xW{W}xF{F}"
                             + ("r" if reach else "")
                             + ("" if crashed else "c"),
                    "K": K, "M": M, "S": S, "rows": rows, "W": W, "F": F,
                    "max_iters": max_iters, "reach": bool(reach),
                    "crash_free": not crashed})
    return out


def runtime_scc_buckets(raw_buckets) -> list[dict]:
    """Translates gpu/scc.py's launch buckets (via
    profiler.shape_buckets()['scc']) into bucket dicts for the `scc`,
    `scc-converge` and `scc-sharded` entries (the sharded solve's bucket
    names one shard's edge block)."""
    out = []
    for t in sorted(raw_buckets, key=repr):
        try:
            entry, n, E, _dev = t
        except (TypeError, ValueError):
            continue
        if entry in ("scc", "scc-converge", "scc-sharded") \
                and isinstance(n, int) \
                and isinstance(E, int):
            out.append({"entry": entry, "label": f"rt-N{n}xE{E}",
                        "n_pad": n, "e_pad": E})
    return out
