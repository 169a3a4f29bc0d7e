"""Strongly connected components by Orzan's colouring: wrappers of the
CUDA kernels (csrc/scc.cu) and their plain PyTorch versions.

scc_labels(), the capped launch, computes what
jepsen_tpu/tpu/scc.py:64 `_scc_program` computes, on exact sizes (no
shape-bucket padding):

  src, dst  int32 [E]  edge endpoints, each in [0, n)
  edge_on   bool  [E]  the edges of this subset
  -> out    int32 [n + 3]: out[:n] the label of each node (the max node
            id of its component), then ok (1 when every fixpoint
            converged within SWEEP_CAP sweeps and every node retired
            within ROUND_CAP rounds), the rounds run, and the sweeps run
            (forward and backward, over all rounds)

Every output is an integer and max is independent of order, so the
kernel, the plain version and the JAX program agree exactly, the counts
included. When ok is 0 the labels are incomplete, and the caps hit on
the same graphs as in the JAX program.

scc_labels_to_convergence() is the launch made after a cap hit (the JAX
package hands such a graph to scipy instead): the same labels on any
graph, ok always 1, no caps. It trims (a node with no live in- or
out-edge is its own component) to a fixpoint before each colouring
round, and its sweeps and trim passes work on frontiers over CSR rows
built on the card, so a DAG such as a decreasing chain is retired by
trim alone. Its first colouring round colours by node id, as the capped
launch does, which retires most components at once where ids follow a
topological order (a wide graph of clusters joined by forward edges:
1 round); if FIRST_ROUND_SWEEPS forward sweeps do not settle it, it
gives up with no member, since a flood by id may then cost a sweep's
frontier per component above (a decreasing chain of k cycles: O(k)
nodes a sweep for ~2k sweeps). Later rounds colour by a fixed
pseudo-random priority of each node, prio(v) = v * PRIO mod 2**31 (a
bijection, PRIO being odd): on a decreasing chain of non-trivial
cycles, which by id would retire one cycle a round, every cycle whose
priority beats those of all the active cycles above it retires in the
same round, and the retired cycles cut the chain, so a chain of k
cycles takes a few rounds (8 for 100 ten-node cycles, 10 for 800)
instead of k. The roots are the nodes whose colour is their own id or
priority; each member's label is the max member id
of its root's component, gathered once at the end, so the labels are
scipy's. Its output is int32 [n + 4]: labels, ok, colouring rounds,
sweeps, trim passes; the passes are level-synchronous, the sweeps Jacobi
sweeps and each round's colours fixed, so the counts are order-free and
its plain version (scc_converge_reference) mirrors them exactly.

Both launch their kernel for CUDA tensors and run the plain version for
CPU tensors; neither runs the plain version on the card. `launches` and
`converge_launches` count kernel launches. Each launch is built by
launch_plan(), which the lint (gpu/lint.py) also calls on meta tensors;
carve_bytes() is the library's scratch size computed in Python, and the
launch keeps asking the library (scratch_bytes()).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import LaunchPlan, build

SWEEP_CAP = 512
ROUND_CAP = 64
# The convergence launch's priority multiplier (odd, so v -> v * PRIO mod
# 2**31 is a bijection of the ids), its inverse mod 2**32, and the forward
# sweeps after which its first round, coloured by id, gives up unsettled;
# csrc/scc.cu holds the same three constants (kPrio, kPrioInv,
# kFirstRoundSweeps), so changing one here alone breaks the mirror.
PRIO = 0x9E3779B1
PRIO_INV = 0x0E8B2F51
_PRIO_MASK = (1 << 31) - 1
FIRST_ROUND_SWEEPS = 64
# Work left (nodes plus CSR entries not yet retired) at which the
# convergence launch goes on in block 0 alone, with __syncthreads in
# place of grid syncs. Measured by chip_smoke.py on the H100 with rounds
# coloured by id: block 0 alone from the start takes a 100,000-node
# decreasing chain or cycle (~300k items) in about half the time of the
# whole grid, but a 100,000-node graph of large components with 600k
# edges (~1.3M items) in 1.6 times its time; the threshold lies between
# the two. Colouring later rounds by priority leaves the chain's and the
# wide graph's counts as they were and adds the first round's 64 sweeps
# to the cycle's (PERF.md). Read at each
# launch: tests set it to -1 (never) or 2**31 - 1 (from the start) to
# reach either schedule on a small graph.
TAIL_WORK = 1 << 19

# csrc/scc.cu's kMaxBlocks and kSlot: carve_bytes() mirrors the library's
# carve_capped and carve_conv, so changing one side alone breaks it
_MAX_BLOCKS = 1024
_SLOT = 8

launches = 0
converge_launches = 0

_lib_lock = threading.Lock()
_lib_cache: list = []


def _lib() -> ctypes.CDLL:
    with _lib_lock:
        if not _lib_cache:
            lib = build.load("scc")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.scc_scratch_bytes.argtypes = [i, i]
            lib.scc_scratch_bytes.restype = ll
            lib.scc_converge_scratch_bytes.argtypes = [i, i]
            lib.scc_converge_scratch_bytes.restype = ll
            lib.scc_launch.argtypes = [p, p, p, i, i, i, i] + [p] * 6
            lib.scc_launch.restype = i
            lib.scc_converge_launch.argtypes = [p, p, p, i, i, i] + [p] * 6
            lib.scc_converge_launch.restype = i
            lib.scc_error_string.argtypes = [i]
            lib.scc_error_string.restype = ctypes.c_char_p
            _lib_cache.append(lib)
        return _lib_cache[0]


def _check(src, dst, edge_on, n, syncs, events=None):
    if src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError(f"src and dst must be int32, got {src.dtype}, "
                        f"{dst.dtype}")
    if edge_on.dtype != torch.bool:
        raise TypeError(f"edge_on must be bool, got {edge_on.dtype}")
    if src.dim() != 1 or dst.shape != src.shape or edge_on.shape != \
            src.shape:
        raise ValueError("src, dst and edge_on must all be [E]: "
                         f"{tuple(src.shape)}, {tuple(dst.shape)}, "
                         f"{tuple(edge_on.shape)}")
    for name, t in (("dst", dst), ("edge_on", edge_on)):
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, src on "
                             f"{src.device}")
    for name, t in (("src", src), ("dst", dst), ("edge_on", edge_on)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 <= n < 2 ** 31 - 4:
        raise ValueError(f"n={n} out of range")
    if src.shape[0] > 2 ** 30:
        raise ValueError(f"E={src.shape[0]} edges: at most 2**30")
    if syncs is not None and (
            syncs.dtype != torch.int32 or syncs.shape != (2,)
            or syncs.device != src.device or src.device.type != "cuda"):
        raise ValueError("syncs must be an int32 [2] tensor on the inputs' "
                         f"CUDA device, got {syncs.dtype} "
                         f"{tuple(syncs.shape)} on {syncs.device} (inputs "
                         f"on {src.device})")
    if src.device.type not in ("cuda", "cpu"):
        raise ValueError(f"scc runs on cuda or cpu, not {src.device}")
    if events is not None and src.device.type != "cuda":
        raise ValueError(f"events time a launch on the card, not on "
                         f"{src.device}")


def scc_labels(src, dst, edge_on, n: int,
               syncs: torch.Tensor | None = None,
               events=None) -> torch.Tensor:
    """Labels, ok, rounds and sweeps in one int32 [n + 3] tensor (see
    the module docstring), with the caps SWEEP_CAP and ROUND_CAP.
    Endpoints must lie in [0, n): the kernel does not check them.

    syncs, an int32 [2] tensor on the inputs' CUDA device, gets the
    launch's grid syncs ([0]) and tail barriers ([1], always 0 here)
    written. It describes the kernel's schedule, not the algorithm, so
    the plain version has no such count: it is refused with CPU
    tensors.

    events, a (start, end) pair of torch.cuda.Event(enable_timing=True),
    are recorded on the stream just before and just after the kernel, so
    that start.elapsed_time(end) is the kernel's time alone. Refused
    with CPU tensors."""
    global launches
    _check(src, dst, edge_on, n, syncs, events)
    if src.device.type == "cpu":
        return _reference(src, dst, edge_on, n, SWEEP_CAP, ROUND_CAP)
    lib = _lib()
    plan = launch_plan(src, dst, edge_on, n,
                       scratch=lib.scc_scratch_bytes(n, src.shape[0]))
    _launch(lib.scc_launch, plan, syncs, events)
    # the checkers of a composed check launch from worker threads
    with _lib_lock:
        launches += 1
    return plan.outputs["out"]


def scc_labels_to_convergence(src, dst, edge_on, n: int,
                              syncs: torch.Tensor | None = None,
                              events=None) -> torch.Tensor:
    """Labels, ok (always 1), colouring rounds, sweeps and trim passes in
    one int32 [n + 4] tensor (see the module docstring). syncs and
    events as for scc_labels(). TAIL_WORK changes the schedule, not the
    result."""
    global converge_launches
    _check(src, dst, edge_on, n, syncs, events)
    if src.device.type == "cpu":
        return _converge(src, dst, edge_on, n)
    lib = _lib()
    plan = launch_plan(src, dst, edge_on, n, converge=True,
                       scratch=lib.scc_converge_scratch_bytes(
                           n, src.shape[0]))
    _launch(lib.scc_converge_launch, plan, syncs, events)
    # the checkers of a composed check launch from worker threads
    with _lib_lock:
        converge_launches += 1
    return plan.outputs["out"]


def scratch_bytes(n: int, E: int, converge: bool = False) -> int:
    """The device scratch one launch over n nodes and E edges takes (the
    capped launch's, or the convergence launch's with converge), as the
    library carves it."""
    lib = _lib()
    fn = lib.scc_converge_scratch_bytes if converge else \
        lib.scc_scratch_bytes
    return int(fn(n, E))


def _take(count: int, itemsize: int) -> int:
    """Bytes of one array carved from the scratch: at least one
    element, rounded up to 16 bytes (the library's Carve::take)."""
    return (max(count, 1) * itemsize + 15) & ~15


def carve_bytes(n: int, E: int, converge: bool = False) -> int:
    """The device scratch one launch over n nodes and E edges takes,
    computed in Python as the library's carve_capped (or, with converge,
    carve_conv) carves it; scratch_bytes() asks the library."""
    if converge:
        # state; c, m, act, fr twice; stamp, top, cnt_out, cnt_in,
        # outdeg, indeg; out_off, in_off; out_adj, in_adj; bsum; ctl
        return (_take(n, 4) + 8 * _take(n, 4) + 6 * _take(n, 4)
                + 2 * _take(n + 1, 4) + 2 * _take(E, 4)
                + _take(2 * _MAX_BLOCKS, 4) + _take(3 * _SLOT, 4))
    # active; c, m, stamp, ls, ld twice; block_flag; ctl
    return (_take(n, 1) + 2 * (3 * _take(n, 4)
                               + 2 * _take(E + _MAX_BLOCKS, 4))
            + _take(_MAX_BLOCKS, 4) + _take(3 * _SLOT, 4))


def launch_plan(src, dst, edge_on, n: int, converge: bool = False,
                scratch: int | None = None) -> LaunchPlan:
    """The launch scc_labels() (or, with converge,
    scc_labels_to_convergence()) makes on CUDA tensors: the output and
    the uninitialised scratch (the kernel sets up its own state) on the
    inputs' device, `scratch` bytes of it (the library's answer on the
    card; carve_bytes() when None), and the call's parameters."""
    dev = src.device
    E = src.shape[0]
    if scratch is None:
        scratch = carve_bytes(n, E, converge)
    params = {"n": n, "E": E}
    if converge:
        params["tail_work"] = max(-1, min(int(TAIL_WORK), 2 ** 31 - 1))
    else:
        params.update(sweep_cap=SWEEP_CAP, round_cap=ROUND_CAP)
    return LaunchPlan(
        args={"src": src, "dst": dst, "edge_on": edge_on},
        outputs={"out": torch.empty(n + (4 if converge else 3),
                                    dtype=torch.int32, device=dev)},
        params=params,
        scratch=torch.empty(scratch, dtype=torch.uint8, device=dev))


def _submit(fn, plan: LaunchPlan, syncs, stream, ev_start, ev_end) -> int:
    """Calls scc_launch or scc_converge_launch (`fn`) with the plan's
    tensors and parameters in the C signature's order; returns its CUDA
    error code."""
    return fn(*(t.data_ptr() for t in plan.args.values()),
              *plan.params.values(), plan.scratch.data_ptr(),
              plan.outputs["out"].data_ptr(),
              None if syncs is None else syncs.data_ptr(), stream,
              ev_start, ev_end)


def _launch(fn, plan: LaunchPlan, syncs, events):
    dev = plan.args["src"].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ev_start, ev_end = build.event_handles(events)
        rc = _submit(fn, plan, syncs, stream, ev_start, ev_end)
    if rc != 0:
        raise RuntimeError(
            f"scc launch failed: CUDA error {rc} "
            f"({_lib().scc_error_string(rc).decode()}); {plan.params}")


def scc_labels_reference(src, dst, edge_on, n: int) -> torch.Tensor:
    """The plain PyTorch version of scc_labels(): the JAX program's
    nested loops, each sweep one scatter_reduce_(..., "amax") over the
    edge list."""
    return _reference(src, dst, edge_on, n, SWEEP_CAP, ROUND_CAP)


def scc_converge_reference(src, dst, edge_on, n: int) -> torch.Tensor:
    """The plain PyTorch version of scc_labels_to_convergence(): trim
    passes and colouring rounds over whole arrays, counted as the kernel
    counts them."""
    return _converge(src, dst, edge_on, n)


def scc_rounds(src, dst, edge_on, n: int) -> list[tuple[int, ...]]:
    """The work of scc_labels() on this graph, from its plain version:
    one (live edges, same-colour edges, forward sweeps, backward sweeps)
    per round, what a count of the kernel's bytes needs."""
    work: list = []
    _reference(src, dst, edge_on, n, SWEEP_CAP, ROUND_CAP, work)
    return work


def _fixpoint(x, frm, to, live, neutral, n, cap=None):
    """Jacobi sweeps of x along the edges frm -> to (those where `live`
    holds, or all of them when it is None) to a fixpoint, or to `cap`
    sweeps; returns (x, converged, sweeps)."""
    it, changed = 0, True
    while changed and (cap is None or it < cap):
        vals = x[frm] if live is None else torch.where(live, x[frm], neutral)
        prop = torch.full((n,), neutral, dtype=torch.int32,
                          device=x.device).scatter_reduce_(0, to, vals,
                                                           "amax")
        nx = torch.maximum(x, prop)
        changed = bool((nx != x).any())
        x, it = nx, it + 1
    return x, not changed, it


def _reference(src, dst, edge_on, n, sweep_cap, round_cap,
               work=None) -> torch.Tensor:
    dev = src.device
    s, d = src.long(), dst.long()
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ok, rounds, sweeps = True, 0, 0
    while ok and bool(active.any()) and rounds < round_cap:
        live = edge_on & active[s] & active[d]
        c, ok_f, it_f = _fixpoint(torch.where(active, ids, -1), s, d, live,
                                  -1, n, sweep_cap)
        same = live & (c[s] == c[d])
        m0 = (active & (c == ids)).to(torch.int32)
        m, ok_b, it_b = _fixpoint(m0, d, s, same, 0, n, sweep_cap)
        if work is not None:
            work.append((int(live.sum()), int(same.sum()), it_f, it_b))
        member = active & (m > 0)
        out = torch.where(member, c, out)
        active = active & ~member
        ok = ok and ok_f and ok_b
        rounds += 1
        sweeps += it_f + it_b
    done = ok and not bool(active.any())
    tail = torch.tensor([int(done), rounds, sweeps], dtype=torch.int32,
                        device=dev)
    return torch.cat([out, tail])


class _Rows:
    """CSR rows of the edges a -> b by a: rows(v) lists every b of v."""

    def __init__(self, a, b, n):
        order = torch.argsort(a, stable=True)
        self.adj = b[order]
        count = torch.bincount(a, minlength=n)
        self.off = torch.cat([count.new_zeros(1), torch.cumsum(count, 0)])

    def of(self, nodes):
        """Every b of every node in `nodes`, with repeats."""
        start, end = self.off[nodes], self.off[nodes + 1]
        count = end - start
        first = torch.cumsum(count, 0) - count
        idx = torch.repeat_interleave(start - first, count) + torch.arange(
            int(count.sum()), device=nodes.device)
        return self.adj[idx]


def _converge(src, dst, edge_on, n) -> torch.Tensor:
    dev = src.device
    # self-loops never join two nodes: the kernel leaves them out of its
    # CSR rows, and so out of the trim's degrees
    keep = edge_on & (src != dst)
    s, d = src[keep].long(), dst[keep].long()
    by_src, by_dst = _Rows(s, d, n), _Rows(d, s, n)
    indeg = torch.bincount(d, minlength=n)
    outdeg = torch.bincount(s, minlength=n)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    prio = _prio(ids.long())
    active = torch.ones(n, dtype=torch.bool, device=dev)
    # the root of each retired node, then (at the end) its label
    out = torch.full((n,), -1, dtype=torch.int32, device=dev)

    def lower(gone):
        """Takes the retired nodes `gone` out of their neighbours'
        degrees; returns the active neighbours left with no live in- or
        out-edge: the next trim pass."""
        w, u = by_src.of(gone), by_dst.of(gone)
        indeg.index_add_(0, w, torch.full_like(w, -1))
        outdeg.index_add_(0, u, torch.full_like(u, -1))
        near = torch.unique(torch.cat([w, u]))
        return near[active[near] & ((indeg[near] == 0) | (outdeg[near] == 0))]

    rounds = sweeps = passes = 0
    by_id = True
    trim = torch.nonzero((indeg == 0) | (outdeg == 0)).flatten()
    while True:
        # trim to a fixpoint: each pass retires, with their own ids, the
        # active nodes left with no live in-edge or no live out-edge
        while trim.numel():
            passes += 1
            out[trim] = trim.to(torch.int32)
            active[trim] = False
            trim = lower(trim)
        if not bool(active.any()):
            break
        # a colouring round over the live edges: colours are ids in the
        # first round and priorities after it, and a root is a node whose
        # colour is its own. The round by id gives up, with no member,
        # when FIRST_ROUND_SWEEPS forward sweeps have not settled it;
        # later rounds have no cap
        live = active[s] & active[d]
        ls, ld = s[live], d[live]
        colour = ids if by_id else prio
        c, ok, it_f = _fixpoint(torch.where(active, colour, -1), ls, ld,
                                None, -1, n,
                                FIRST_ROUND_SWEEPS if by_id else None)
        sweeps += it_f
        if not ok:
            by_id = False
            continue
        same = c[ls] == c[ld]
        m0 = (active & (c == colour)).to(torch.int32)
        m, _ok, it_b = _fixpoint(m0, ld[same], ls[same], None, 0, n)
        member = active & (m > 0)
        out = torch.where(member, c if by_id else _unprio(c), out)
        active = active & ~member
        rounds += 1
        sweeps += it_b
        by_id = False
        trim = lower(torch.nonzero(member).flatten())
    # each component's label is its max member id, gathered through the
    # root every member holds (a trimmed node is its own root)
    top = torch.full((n,), -1, dtype=torch.int32, device=dev)
    top.scatter_reduce_(0, out.long(), torch.arange(n, dtype=torch.int32,
                                                     device=dev), "amax")
    tail = torch.tensor([1, rounds, sweeps, passes], dtype=torch.int32,
                        device=dev)
    return torch.cat([top[out.long()], tail])


def _prio(v):
    """The convergence launch's colour of each node id in int64 `v`: a
    bijection of [0, 2**31), as int32."""
    return ((v * PRIO) & _PRIO_MASK).to(torch.int32)


def _unprio(x):
    """The node id whose priority is x (int32, >= 0)."""
    return ((x.long() * PRIO_INV) & _PRIO_MASK).to(torch.int32)
