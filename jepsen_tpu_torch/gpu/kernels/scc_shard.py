"""The sharded Orzan colouring's device steps: wrappers of the CUDA
kernels (csrc/scc_shard.cu) and their plain PyTorch versions.

They replace jepsen_tpu/tpu/scc.py:172 `_jitted_scc_sharded`, whose
sweeps end in a pmax of the colours across the mesh: gpu/scc.py drives
the rounds and sweeps from the host, and calls per sweep one scc_sweep()
per shard over its edge block, the combine, and one scc_apply(); per
round three scc_step()s (see the .cu file for what each computes):

  scc_sweep(src, dst, edge_on, active, x, col, prop, backward)
        prop int32 [n] := neutral (-1 forward, 0 backward), then the
        scatter-max of x along the block's live edges (backward: from
        dst to src, inside colour classes of col)
  scc_apply(x, prop, ctl)       x := max(x, prop); ctl[0] := changed
  scc_step(kind, active, c, m, out, ctl)
        INIT: c := active ? id : -1; ROOTS: m := active & (c == id);
        RETIRE: members retire into out, ctl[1] := active nodes left

Every value is an integer and max is independent of order, so the
kernels and the plain versions agree exactly. Each wrapper launches its
kernel for CUDA tensors and runs the plain version for CPU tensors,
never the plain version on the card; `sweep_launches`,
`apply_launches` and `step_launches` count kernel launches. Each launch
is built by its *_plan() function, which the lint (gpu/lint.py) also
calls on meta tensors.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import LaunchPlan, build

# the step launch's modes; csrc/scc_shard.cu holds the same three
# constants (kInit, kRoots, kRetire)
INIT = 0
ROOTS = 1
RETIRE = 2

sweep_launches = 0
apply_launches = 0
step_launches = 0

_lib_lock = threading.Lock()
_lib_cache: list = []


def _lib() -> ctypes.CDLL:
    with _lib_lock:
        if not _lib_cache:
            lib = build.load("scc_shard")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.scc_shard_sweep_launch.argtypes = [p] * 6 + [i, i, i] + \
                [p] * 4
            lib.scc_shard_sweep_launch.restype = i
            lib.scc_shard_apply_launch.argtypes = [p, p, i] + [p] * 4
            lib.scc_shard_apply_launch.restype = i
            lib.scc_shard_step_launch.argtypes = [i] + [p] * 4 + [i] + \
                [p] * 4
            lib.scc_shard_step_launch.restype = i
            lib.scc_shard_error_string.argtypes = [i]
            lib.scc_shard_error_string.restype = ctypes.c_char_p
            _lib_cache.append(lib)
        return _lib_cache[0]


def _check(tensors: dict, dtypes: dict, events=None) -> torch.device:
    """Every tensor on one device (cuda or cpu), contiguous, of its
    dtype; node arrays [n] and edge arrays [E] alike. Returns the
    device."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"scc_shard runs on cuda or cpu, not {dev}")
    if events is not None and dev.type != "cuda":
        raise ValueError(f"events time a launch on the card, not on {dev}")
    return dev


_I32, _BOOL = torch.int32, torch.bool


def sweep_plan(src, dst, edge_on, active, x, col, prop,
               backward: bool) -> LaunchPlan:
    """The launch scc_sweep() makes: the edge block and the replicated node
    arrays it reads, `prop` it writes."""
    n, E = x.shape[0], src.shape[0]
    for name, t, size in (("dst", dst, E), ("edge_on", edge_on, E),
                          ("active", active, n), ("col", col, n),
                          ("prop", prop, n)):
        if t.shape[0] != size:
            raise ValueError(f"{name} has {t.shape[0]} entries, want {size}")
    if not 0 < n < 2 ** 31 - 1 or E >= 2 ** 31:
        raise ValueError(f"n={n}, E={E} out of range")
    return LaunchPlan(
        args={"src": src, "dst": dst, "edge_on": edge_on, "active": active,
              "x": x, "col": col},
        outputs={"prop": prop},
        params={"n": n, "E": E, "backward": int(backward)})


def scc_sweep(src, dst, edge_on, active, x, col, prop, backward: bool,
              events=None) -> torch.Tensor:
    """One sweep of an edge block into `prop` (see the module
    docstring); returns prop. Endpoints must lie in [0, n): the kernel
    does not check them. events, a (start, end) pair of
    torch.cuda.Event(enable_timing=True), are recorded just around the
    launch's kernels; refused with CPU tensors."""
    global sweep_launches
    dev = _check({"src": src, "dst": dst, "edge_on": edge_on,
                  "active": active, "x": x, "col": col, "prop": prop},
                 {"src": _I32, "dst": _I32, "edge_on": _BOOL,
                  "active": _BOOL, "x": _I32, "col": _I32, "prop": _I32},
                 events)
    plan = sweep_plan(src, dst, edge_on, active, x, col, prop, backward)
    if dev.type == "cpu":
        return sweep_reference(src, dst, edge_on, active, x, col, prop,
                               backward)
    _launch(_lib().scc_shard_sweep_launch, dev, events,
            *(t.data_ptr() for t in plan.args.values()),
            plan.params["n"], plan.params["E"], plan.params["backward"],
            prop.data_ptr())
    with _lib_lock:
        sweep_launches += 1
    return prop


def apply_plan(x, prop, ctl) -> LaunchPlan:
    if prop.shape != x.shape or ctl.shape != (2,):
        raise ValueError(f"x {tuple(x.shape)}, prop {tuple(prop.shape)} "
                         f"and ctl {tuple(ctl.shape)}: want [n], [n], [2]")
    return LaunchPlan(args={"x": x, "prop": prop}, outputs={"ctl": ctl},
                      params={"n": x.shape[0]})


def scc_apply(x, prop, ctl, events=None) -> None:
    """x := max(x, prop) in place; ctl[0] := 1 if any x changed, else 0
    (ctl int32 [2] on x's device)."""
    global apply_launches
    dev = _check({"x": x, "prop": prop, "ctl": ctl},
                 {"x": _I32, "prop": _I32, "ctl": _I32}, events)
    plan = apply_plan(x, prop, ctl)
    if dev.type == "cpu":
        apply_reference(x, prop, ctl)
        return
    _launch(_lib().scc_shard_apply_launch, dev, events, x.data_ptr(),
            prop.data_ptr(), plan.params["n"], ctl.data_ptr())
    with _lib_lock:
        apply_launches += 1


def step_plan(kind: int, active, c, m, out, ctl) -> LaunchPlan:
    if kind not in (INIT, ROOTS, RETIRE):
        raise ValueError(f"step {kind} is none of INIT, ROOTS, RETIRE")
    n = active.shape[0]
    if not (c.shape == m.shape == out.shape == (n,)) or ctl.shape != (2,):
        raise ValueError("active, c, m and out must be [n], ctl [2]")
    return LaunchPlan(args={"active": active, "c": c, "m": m},
                      outputs={"out": out, "ctl": ctl},
                      params={"step": kind, "n": n})


def scc_step(kind: int, active, c, m, out, ctl, events=None) -> None:
    """One of a round's elementwise steps, in place (see the module
    docstring)."""
    global step_launches
    dev = _check({"active": active, "c": c, "m": m, "out": out, "ctl": ctl},
                 {"active": _BOOL, "c": _I32, "m": _I32, "out": _I32,
                  "ctl": _I32}, events)
    plan = step_plan(kind, active, c, m, out, ctl)
    if dev.type == "cpu":
        step_reference(kind, active, c, m, out, ctl)
        return
    _launch(_lib().scc_shard_step_launch, dev, events, kind,
            active.data_ptr(), c.data_ptr(), m.data_ptr(), out.data_ptr(),
            plan.params["n"], ctl.data_ptr())
    with _lib_lock:
        step_launches += 1


def _launch(fn, dev, events, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ev_start, ev_end = build.event_handles(events)
        rc = fn(*args, stream, ev_start, ev_end)
    if rc != 0:
        raise RuntimeError(
            f"scc_shard launch failed: CUDA error {rc} "
            f"({_lib().scc_shard_error_string(rc).decode()})")


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; chip_smoke holds the kernels to them)
# ---------------------------------------------------------------------------

def sweep_reference(src, dst, edge_on, active, x, col, prop,
                    backward: bool) -> torch.Tensor:
    """The plain version of scc_sweep(): one scatter_reduce_(..., "amax")
    over the block's live edges."""
    s, d = src.long(), dst.long()
    live = edge_on & active[s] & active[d]
    if backward:
        live &= col[s] == col[d]
        s, d = d, s
    prop.fill_(0 if backward else -1)
    prop.scatter_reduce_(0, d[live], x[s[live]], "amax")
    return prop


def apply_reference(x, prop, ctl) -> None:
    """The plain version of scc_apply()."""
    ctl[0] = int(bool((prop > x).any()))
    torch.maximum(x, prop, out=x)


def step_reference(kind: int, active, c, m, out, ctl) -> None:
    """The plain version of scc_step()."""
    ids = torch.arange(active.shape[0], dtype=torch.int32,
                       device=active.device)
    if kind == INIT:
        c.copy_(torch.where(active, ids, -1))
    elif kind == ROOTS:
        m.copy_((active & (c == ids)).to(torch.int32))
    else:
        member = active & (m > 0)
        out.copy_(torch.where(member, c, out))
        active &= ~member
        ctl[1] = int(active.sum())
