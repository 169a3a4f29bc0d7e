"""Strongly connected components by Orzan's colouring: wrapper of the
CUDA kernel (csrc/scc.cu) and its plain PyTorch version.

Both compute what jepsen_tpu/tpu/scc.py:64 `_scc_program` computes, on
exact sizes (no shape-bucket padding):

  src, dst  int32 [E]  edge endpoints, each in [0, n)
  edge_on   bool  [E]  the edges of this subset
  -> out    int32 [n + 3]: out[:n] the label of each node (the max node
            id of its component), then ok (1 when every fixpoint
            converged within SWEEP_CAP sweeps and every node retired
            within ROUND_CAP rounds), the rounds run, and the sweeps run
            (forward and backward, over all rounds)

Every output is an integer and max is independent of order, so the
kernel, the plain version and the JAX program agree exactly, the counts
included. When ok is 0 the labels are incomplete.

scc_labels() runs with the JAX program's caps, so it gives None-cases
(ok 0) on the same graphs. scc_labels_to_convergence() runs with caps of
n, which no graph of n nodes can hit: every fixpoint settles within n
sweeps (a value travels at most n - 1 edges) and every round retires at
least the highest active node. Both launch the kernel for CUDA tensors
and run the plain version for CPU tensors; neither runs the plain
version on the card. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import build

SWEEP_CAP = 512
ROUND_CAP = 64

launches = 0

_lib_lock = threading.Lock()
_lib_cache: list = []


def _lib() -> ctypes.CDLL:
    with _lib_lock:
        if not _lib_cache:
            lib = build.load("scc")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.scc_launch.argtypes = [p, p, p, i, i, i, i] + [p] * 8
            lib.scc_launch.restype = i
            lib.scc_error_string.argtypes = [i]
            lib.scc_error_string.restype = ctypes.c_char_p
            _lib_cache.append(lib)
        return _lib_cache[0]


def _check(src, dst, edge_on, n):
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
    if not 0 <= n < 2 ** 31 - 3:
        raise ValueError(f"n={n} out of range")


def scc_labels(src, dst, edge_on, n: int) -> torch.Tensor:
    """Labels, ok, rounds and sweeps in one int32 [n + 3] tensor (see
    the module docstring), with the caps SWEEP_CAP and ROUND_CAP.
    Endpoints must lie in [0, n): the kernel does not check them."""
    return _run(src, dst, edge_on, n, SWEEP_CAP, ROUND_CAP)


def scc_labels_to_convergence(src, dst, edge_on, n: int) -> torch.Tensor:
    """As scc_labels(), with caps of n: ok is always 1. An adversarial
    graph (a long decreasing chain) costs up to n rounds of up to n
    sweeps each."""
    cap = max(n, 1)
    return _run(src, dst, edge_on, n, cap, cap)


def _run(src, dst, edge_on, n, sweep_cap, round_cap) -> torch.Tensor:
    global launches
    _check(src, dst, edge_on, n)
    dev = src.device
    if dev.type == "cpu":
        return _reference(src, dst, edge_on, n, sweep_cap, round_cap)
    if dev.type != "cuda":
        raise ValueError(f"scc_labels runs on cuda or cpu, not {dev}")
    lib = _lib()
    E = src.shape[0]
    # uninitialised: the kernel sets up its own state
    active = torch.empty(max(n, 1), dtype=torch.uint8, device=dev)
    emask = torch.empty(max(E, 1), dtype=torch.uint8, device=dev)
    scratch = torch.empty((3, max(n, 1)), dtype=torch.int32, device=dev)
    flags = torch.empty(3, dtype=torch.int32, device=dev)
    out = torch.empty(n + 3, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.scc_launch(
            src.data_ptr(), dst.data_ptr(), edge_on.data_ptr(), n, E,
            sweep_cap, round_cap, active.data_ptr(), emask.data_ptr(),
            scratch[0].data_ptr(), scratch[1].data_ptr(),
            scratch[2].data_ptr(), flags.data_ptr(), out.data_ptr(),
            stream)
        if rc != 0:
            raise RuntimeError(
                f"scc launch failed: CUDA error {rc} "
                f"({lib.scc_error_string(rc).decode()}); n={n} E={E}")
    launches += 1
    return out


def scc_labels_reference(src, dst, edge_on, n: int) -> torch.Tensor:
    """The plain PyTorch version of scc_labels(): the JAX program's
    nested loops, each sweep one scatter_reduce_(..., "amax") over the
    edge list."""
    return _reference(src, dst, edge_on, n, SWEEP_CAP, ROUND_CAP)


def scc_rounds(src, dst, edge_on, n: int) -> list[tuple[int, ...]]:
    """The work of scc_labels() on this graph, from its plain version:
    one (live edges, same-colour edges, forward sweeps, backward sweeps)
    per round, what a count of the kernel's bytes needs."""
    work: list = []
    _reference(src, dst, edge_on, n, SWEEP_CAP, ROUND_CAP, work)
    return work


def _reference(src, dst, edge_on, n, sweep_cap, round_cap,
               work=None) -> torch.Tensor:
    dev = src.device
    s, d = src.long(), dst.long()
    ids = torch.arange(n, dtype=torch.int32, device=dev)

    def fixpoint(x, frm, to, live, neutral):
        it, changed = 0, True
        while changed and it < sweep_cap:
            vals = torch.where(live, x[frm], neutral)
            prop = torch.full((n,), neutral, dtype=torch.int32,
                              device=dev).scatter_reduce_(0, to, vals,
                                                          "amax")
            nx = torch.maximum(x, prop)
            changed = bool((nx != x).any())
            x, it = nx, it + 1
        return x, not changed, it

    active = torch.ones(n, dtype=torch.bool, device=dev)
    out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ok, rounds, sweeps = True, 0, 0
    while ok and bool(active.any()) and rounds < round_cap:
        live = edge_on & active[s] & active[d]
        c, ok_f, it_f = fixpoint(torch.where(active, ids, -1), s, d, live,
                                 -1)
        same = live & (c[s] == c[d])
        m0 = (active & (c == ids)).to(torch.int32)
        m, ok_b, it_b = fixpoint(m0, d, s, same, 0)
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
