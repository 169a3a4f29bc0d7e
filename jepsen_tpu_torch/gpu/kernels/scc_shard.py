"""The sharded Orzan colouring's device steps: wrappers of the CUDA
kernels (csrc/scc_shard.cu) and their plain PyTorch versions.

They replace jepsen_tpu/tpu/scc.py:172 `_jitted_scc_sharded`, whose
sweeps end in a pmax of the colours across the mesh: gpu/scc.py drives
the rounds from the host and runs each fixpoint in chunks of sweeps (see
the .cu file for what each kernel computes). A round has no launch of
its own: the fixpoints' first sweeps and applies compute its starting
values, and the retire that ends a backward chunk its labels and the
nodes left. A solve builds its plans once, checking every tensor there,
and launches from them:

  sweep_plan(src, dst, edge_on, active, x, col, prop, live, cnt, st,
             backward)
        one shard's sweep: prop int32 [n] max-accumulates x along the
        block's live edges (backward: from dst to src, inside colour
        classes of col); the first sweep of a fixpoint (compact) lists
        them in live int32 [E, 2], their number in cnt[backward], and
        sweeps the starting values it derives (forward: the source's id;
        backward: col[s] == s) instead of x; the later ones read only
        the list, and x
  apply_plan(x, prop, st, active, c, cap, backward)
        x := max(x0, prop), prop := NEUTRAL, and the fixpoint's state st
        int32 [STATE] (SWEEPS, DONE) updated; x0 is x, or in the first
        apply of the pass the starting values from active (and c):
        FORWARD_FIRST active ? id : -1, BACKWARD_FIRST active & (c == id)
  retire_plan(active, c, m, out, st)
        once the fixpoint in st is done: members (active & m > 0) retire
        into out, and st[LEFT] := active nodes left
  SweepGroup(sweeps)    the sweep plans of the shards on one device,
        swept by one launch (blockIdx.y the shard)
  ChunkPlan(group, apply, host, retire)   the group, the apply and, for
        the backward pass, the retire

  scc_sweep(group, compact), scc_apply(plan, first), scc_retire(plan)
        one launch each (events time it on the card)
  scc_chunk(chunk, k, first)
        k times the shards' sweep and then the apply, then the retire
        where the chunk has one, in one call into the library on the
        card; then (sweeps, done, left) into the pinned `host` buffer,
        which read_state() reads after one wait

A sweep or apply of a done fixpoint (converged, or SWEEP_CAP sweeps
applied) returns at once and changes nothing, so a chunk may outrun the
fixpoint: the sweeps counted are the applies that ran. A retire of a
running fixpoint changes nothing either, so every backward chunk ends
in one and only the chunk that ends the fixpoint retires.

Every value is an integer and max is independent of order, so the
kernels and the plain versions agree exactly, up to the order of the
pairs in `live`. Each wrapper launches its kernel for CUDA tensors and
runs the plain version for CPU tensors, never the plain version on the
card; `sweep_launches` (of them `compact_launches`), `apply_launches`
and `retire_launches` count kernel launches, `state_reads` the reads of
a fixpoint's state. The lint (gpu/lint.py) calls the *_plan() functions
on meta tensors.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import torch

from . import LaunchPlan, build

# the apply's start modes; csrc/scc_shard.cu holds the same three
# constants (kLater, kForwardFirst, kBackwardFirst)
LATER = 0
FORWARD_FIRST = 1
BACKWARD_FIRST = 2
# a fixpoint's device state, int32 [STATE]; csrc/scc_shard.cu holds the
# same slots and values (kChanged ... kNeutral). SWEEPS, DONE and LEFT
# are read back together
CHANGED = 0
TICKET = 1
SWEEPS = 2
DONE = 3
LEFT = 4
TALLY = 5
STATE = 6
RUNNING = 0
CONVERGED = 1
CAPPED = 2
# what prop holds between sweeps: below every colour and mark
NEUTRAL = -1
# the shards one sweep launch covers; csrc/scc_shard.cu holds the same
# (kMaxShards)
MAX_SHARDS = 8

sweep_launches = 0
compact_launches = 0
apply_launches = 0
retire_launches = 0
state_reads = 0

_lib_lock = threading.Lock()
_lib_cache: list = []


def _lib() -> ctypes.CDLL:
    with _lib_lock:
        if not _lib_cache:
            lib = build.load("scc_shard")
            p, i = ctypes.c_void_p, ctypes.c_int
            group = [i] + [p] * 5 + [i] + [p] * 5 + [i, i]
            lib.scc_shard_sweep_launch.argtypes = group + [i] + [p] * 3
            lib.scc_shard_sweep_launch.restype = i
            lib.scc_shard_apply_launch.argtypes = [p, p, p, i, i, i] + \
                [p] * 5
            lib.scc_shard_apply_launch.restype = i
            lib.scc_shard_retire_launch.argtypes = [p] * 5 + [i] + [p] * 3
            lib.scc_shard_retire_launch.restype = i
            lib.scc_shard_chunk_launch.argtypes = group + [i] * 3 + \
                [p] * 5
            lib.scc_shard_chunk_launch.restype = i
            lib.scc_shard_error_string.argtypes = [i]
            lib.scc_shard_error_string.restype = ctypes.c_char_p
            _lib_cache.append(lib)
        return _lib_cache[0]


_I32, _BOOL = torch.int32, torch.bool


def _check(tensors: dict, dtypes: dict) -> torch.device:
    """Every tensor on one device (cuda or cpu, or meta for the lint),
    contiguous, of its dtype. Returns the device."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"scc_shard runs on cuda or cpu, not {dev}")
    return dev


def _shapes(want: dict) -> None:
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, want {shape}")


def sweep_plan(src, dst, edge_on, active, x, col, prop, live, cnt, st,
               backward: bool) -> LaunchPlan:
    """One shard's sweeps (compacting and later alike): the edge block,
    the node arrays it reads, `prop` it accumulates into, its `live`
    list and `cnt`, and the fixpoint's state `st` on its device."""
    _check({"src": src, "dst": dst, "edge_on": edge_on, "active": active,
            "x": x, "col": col, "prop": prop, "live": live, "cnt": cnt,
            "st": st},
           {"src": _I32, "dst": _I32, "edge_on": _BOOL, "active": _BOOL,
            "x": _I32, "col": _I32, "prop": _I32, "live": _I32,
            "cnt": _I32, "st": _I32})
    n, E = x.shape[0], src.shape[0]
    _shapes({"src": (src, (E,)), "dst": (dst, (E,)),
             "edge_on": (edge_on, (E,)), "active": (active, (n,)),
             "x": (x, (n,)), "col": (col, (n,)), "prop": (prop, (n,)),
             "live": (live, (E, 2)), "cnt": (cnt, (2,)),
             "st": (st, (STATE,))})
    if not 0 < n < 2 ** 31 - 1 or not 0 < E < 2 ** 31:
        raise ValueError(f"n={n}, E={E} out of range")
    return LaunchPlan(
        args={"src": src, "dst": dst, "edge_on": edge_on, "active": active,
              "x": x, "col": col, "st": st},
        outputs={"prop": prop, "live": live, "cnt": cnt},
        params={"n": n, "E": E, "backward": int(backward)})


def apply_plan(x, prop, st, active, c, cap: int,
               backward: bool) -> LaunchPlan:
    """The apply of a fixpoint of x over `prop`, into the state `st`,
    done at `cap` sweeps; its first launch (FORWARD_FIRST or
    BACKWARD_FIRST by `backward`) starts from `active` and the colours
    `c` (x itself forward) instead of x."""
    _check({"x": x, "prop": prop, "st": st, "active": active, "c": c},
           {"x": _I32, "prop": _I32, "st": _I32, "active": _BOOL,
            "c": _I32})
    n = x.shape[0]
    _shapes({"x": (x, (n,)), "prop": (prop, (n,)), "st": (st, (STATE,)),
             "active": (active, (n,)), "c": (c, (n,))})
    if not 0 < n < 2 ** 31 - 1 or cap < 1:
        raise ValueError(f"n={n}, cap={cap} out of range")
    return LaunchPlan(args={"x": x, "prop": prop, "active": active, "c": c},
                      outputs={"x": x, "prop": prop, "st": st},
                      params={"n": n, "cap": cap, "backward": int(backward)})


def retire_plan(active, c, m, out, st) -> LaunchPlan:
    """The retire of a round into `out`, once the backward fixpoint of
    the marks `m` in `st` is done."""
    _check({"active": active, "c": c, "m": m, "out": out, "st": st},
           {"active": _BOOL, "c": _I32, "m": _I32, "out": _I32,
            "st": _I32})
    n = active.shape[0]
    _shapes({"active": (active, (n,)), "c": (c, (n,)), "m": (m, (n,)),
             "out": (out, (n,)), "st": (st, (STATE,))})
    if not 0 < n < 2 ** 31 - 1:
        raise ValueError(f"n={n} out of range")
    return LaunchPlan(args={"c": c, "m": m},
                      outputs={"active": active, "out": out, "st": st},
                      params={"n": n})


@dataclass
class SweepGroup:
    """The sweep plans of the shards on one device, swept by one launch
    (MAX_SHARDS a launch): one pass, blocks of one size, and the node
    arrays, the accumulator and the state shared. The library's pointer
    arrays are built once, here."""

    sweeps: list
    _c_args: tuple = ()

    def __post_init__(self):
        if not self.sweeps:
            raise ValueError("a sweep covers at least one shard")
        s0 = self.sweeps[0]
        for p in self.sweeps:
            if any(p.args[t] is not s0.args[t]
                   for t in ("active", "x", "col", "st")) or \
                    p.outputs["prop"] is not s0.outputs["prop"] or \
                    p.params != s0.params:
                raise ValueError("a sweep's shards share their node "
                                 "arrays, accumulator and state, one pass "
                                 "and one block size")
        if s0.args["x"].device.type != "cuda":
            return
        k = len(self.sweeps)

        def ptrs(t):
            return (ctypes.c_void_p * k)(*(
                (p.args | p.outputs)[t].data_ptr() for p in self.sweeps))
        a = s0.args
        self._c_args = (
            k, ptrs("src"), ptrs("dst"), ptrs("edge_on"), ptrs("live"),
            ptrs("cnt"), s0.params["E"], a["active"].data_ptr(),
            a["x"].data_ptr(), a["col"].data_ptr(),
            s0.outputs["prop"].data_ptr(), a["st"].data_ptr(),
            s0.params["n"], s0.params["backward"])

    @property
    def launches(self) -> int:
        """The launches one sweep of the group takes."""
        return -(-len(self.sweeps) // MAX_SHARDS)


@dataclass
class ChunkPlan:
    """A device's sweep group, the apply over its accumulator and state
    and, for the backward pass, the retire that ends each chunk; `host`,
    on the card, the pinned int32 [3] that receives (sweeps, done,
    left)."""

    group: SweepGroup
    apply: LaunchPlan
    host: torch.Tensor | None = None
    retire: LaunchPlan | None = None

    def __post_init__(self):
        s0, a = self.group.sweeps[0], self.apply
        b = s0.params["backward"]
        if s0.outputs["prop"] is not a.outputs["prop"] or \
                s0.args["st"] is not a.outputs["st"] or \
                s0.args["x"] is not a.outputs["x"] or \
                s0.args["active"] is not a.args["active"] or \
                s0.args["col"] is not a.args["c"] or \
                a.params["backward"] != b:
            raise ValueError("a chunk's sweeps share the apply's pass, x, "
                             "prop, state, active and colours")
        r = self.retire
        if (r is not None) != bool(b) or r is not None and (
                r.outputs["active"] is not a.args["active"] or
                r.args["c"] is not a.args["c"] or
                r.args["m"] is not a.outputs["x"] or
                r.outputs["st"] is not a.outputs["st"]):
            raise ValueError("a backward chunk, and only it, ends in the "
                             "retire of its active nodes, colours, marks "
                             "and state")
        if a.outputs["x"].device.type == "cuda" and (
                self.host is None or not self.host.is_pinned() or
                self.host.shape != (3,) or self.host.dtype != _I32):
            raise ValueError("host must be a pinned int32 [3]")


def state_buffer(device) -> torch.Tensor | None:
    """The pinned int32 [3] a fixpoint's (sweeps, done, left) is read
    back through, for a state on `device` (None off the card)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.zeros(3, dtype=_I32, pin_memory=True)


def _device(plan: LaunchPlan, events) -> torch.device:
    dev = next(iter(plan.args.values())).device
    if events is not None and dev.type != "cuda":
        raise ValueError(f"events time a launch on the card, not on {dev}")
    return dev


def scc_sweep(group: SweepGroup, compact: bool, events=None) -> None:
    """One sweep of a device's shards (see the module docstring):
    compacting where `compact`. Endpoints must lie in [0, n): the kernel
    does not check them. events, a (start, end) pair of
    torch.cuda.Event(enable_timing=True), are recorded just around the
    kernels; refused with CPU tensors."""
    global sweep_launches, compact_launches
    dev = _device(group.sweeps[0], events)
    if dev.type == "cpu":
        sweep_reference(group, compact)
        return
    _launch(_lib().scc_shard_sweep_launch, dev, events, *group._c_args,
            int(compact))
    with _lib_lock:
        sweep_launches += group.launches
        compact_launches += group.launches if compact else 0


def apply_mode(plan: LaunchPlan, first: bool) -> int:
    """The start mode of an apply of `plan`: its pass's first mode where
    `first`, LATER otherwise."""
    if not first:
        return LATER
    return BACKWARD_FIRST if plan.params["backward"] else FORWARD_FIRST


def scc_apply(plan: LaunchPlan, first: bool, events=None) -> None:
    """One apply launch of `plan`: the first of its fixpoint where
    `first`."""
    global apply_launches
    dev = _device(plan, events)
    if dev.type == "cpu":
        apply_reference(plan, first)
        return
    a, o, p = plan.args, plan.outputs, plan.params
    _launch(_lib().scc_shard_apply_launch, dev, events, o["x"].data_ptr(),
            o["prop"].data_ptr(), o["st"].data_ptr(), p["n"],
            apply_mode(plan, first), p["cap"], a["active"].data_ptr(),
            a["c"].data_ptr())
    with _lib_lock:
        apply_launches += 1


def scc_retire(plan: LaunchPlan, events=None) -> None:
    """One retire launch of `plan` (a no-op while its fixpoint runs)."""
    global retire_launches
    dev = _device(plan, events)
    if dev.type == "cpu":
        retire_reference(plan)
        return
    a, o = plan.args, plan.outputs
    _launch(_lib().scc_shard_retire_launch, dev, events,
            o["active"].data_ptr(), a["c"].data_ptr(), a["m"].data_ptr(),
            o["out"].data_ptr(), o["st"].data_ptr(), plan.params["n"])
    with _lib_lock:
        retire_launches += 1


def scc_chunk(chunk: ChunkPlan, k: int, first: bool, events=None) -> None:
    """k sweeps of a fixpoint: k times the sweep of the device's shards
    (compacting the first time where `first`) and then the apply, then
    the chunk's retire where it has one, with no wait; on the card one
    call into the library, which also copies (sweeps, done, left) into
    chunk.host. events are recorded just around the chunk's kernels."""
    global sweep_launches, compact_launches, apply_launches, retire_launches
    if k < 1:
        raise ValueError(f"a chunk of {k} sweeps")
    group, retire = chunk.group, chunk.retire
    dev = _device(chunk.apply, events)
    if dev.type == "cpu":
        for i in range(k):
            fresh = first and i == 0
            sweep_reference(group, fresh)
            apply_reference(chunk.apply, fresh)
        if retire is not None:
            retire_reference(retire)
        return
    _launch(_lib().scc_shard_chunk_launch, dev, events, *group._c_args, k,
            int(first), chunk.apply.params["cap"],
            retire.outputs["out"].data_ptr() if retire is not None else None,
            chunk.host.data_ptr())
    with _lib_lock:
        sweep_launches += k * group.launches
        compact_launches += group.launches if first else 0
        apply_launches += k
        retire_launches += retire is not None


def fetch_state(st: torch.Tensor, host: torch.Tensor | None) -> None:
    """Enqueues the copy of st's (sweeps, done, left) into `host`, as
    scc_chunk does, for a fixpoint run launch by launch (nothing off the
    card)."""
    if host is not None:
        host.copy_(st[SWEEPS:LEFT + 1], non_blocking=True)


def read_state(st: torch.Tensor, host: torch.Tensor | None
               ) -> tuple[int, int, int]:
    """(sweeps, done, left) of a fixpoint's state (left: the active
    nodes after the last retire): on the card from `host`, filled by
    scc_chunk or fetch_state, after one wait for the stream; on the CPU
    from st itself."""
    global state_reads
    with _lib_lock:
        state_reads += 1
    if host is None:
        return tuple(st[SWEEPS:LEFT + 1].tolist())
    torch.cuda.current_stream(st.device).synchronize()
    return tuple(host.tolist())


def _launch(fn, dev, events, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream, *build.event_handles(events))
    if rc != 0:
        raise RuntimeError(
            f"scc_shard launch failed: CUDA error {rc} "
            f"({_lib().scc_shard_error_string(rc).decode()})")


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; chip_smoke holds the kernels to them)
# ---------------------------------------------------------------------------

def compact_values(plan: LaunchPlan, s: torch.Tensor) -> torch.Tensor:
    """The values a compacting sweep of `plan` sends along live edges
    from the sources `s` (int64, after the backward swap): the
    fixpoint's starting values, s itself forward (c0 = id on an active
    node), col[s] == s backward (m0 on an active node)."""
    if plan.params["backward"]:
        return (plan.args["col"][s] == s).to(_I32)
    return s.to(_I32)


def sweep_reference(group: SweepGroup, compact: bool) -> None:
    """The plain version of scc_sweep(), shard by shard: the live edges
    found by the predicate (compacting: appended to live in edge order,
    cnt[backward] grown by their number and the other pass's cnt zeroed,
    the values compact_values()) or read from live (later, the values
    x; nothing once the fixpoint is done), then one
    scatter_reduce_(..., "amax") into prop."""
    for plan in group.sweeps:
        a, o = plan.args, plan.outputs
        b, E = plan.params["backward"], plan.params["E"]
        live, cnt = o["live"], o["cnt"]
        if compact:
            s, d = a["src"].long(), a["dst"].long()
            on = a["edge_on"] & a["active"][s] & a["active"][d]
            if b:
                on &= a["col"][s] == a["col"][d]
                s, d = d, s
            s, d = s[on], d[on]
            at = int(cnt[b])
            fit = max(0, min(len(s), E - at))
            live[at:at + fit, 0] = s[:fit].to(_I32)
            live[at:at + fit, 1] = d[:fit].to(_I32)
            cnt[b] = at + len(s)
            cnt[1 - b] = 0
            vals = compact_values(plan, s)
        else:
            if int(a["st"][DONE]) != RUNNING:
                return
            k = min(int(cnt[b]), E)
            s, d = live[:k, 0].long(), live[:k, 1].long()
            vals = a["x"][s]
        o["prop"].scatter_reduce_(0, d, vals, "amax")


def start_values(plan: LaunchPlan, mode: int) -> torch.Tensor:
    """x0 of an apply of `plan` in `mode`: x itself (LATER, a view), or
    the pass's starting values, c0 = active ? id : -1 (FORWARD_FIRST)
    or m0 = active & (c == id) (BACKWARD_FIRST)."""
    a, x = plan.args, plan.outputs["x"]
    if mode == LATER:
        return x
    ids = torch.arange(x.shape[0], dtype=_I32, device=x.device)
    if mode == FORWARD_FIRST:
        return torch.where(a["active"], ids, -1).to(_I32)
    return (a["active"] & (a["c"] == ids)).to(_I32)


def apply_reference(plan: LaunchPlan, first: bool) -> None:
    """The plain version of scc_apply()."""
    o = plan.outputs
    x, prop, st = o["x"], o["prop"], o["st"]
    if not first and int(st[DONE]) != RUNNING:
        return
    x0 = start_values(plan, apply_mode(plan, first))
    changed = bool((prop > x0).any())
    torch.maximum(x0, prop, out=x)
    prop.fill_(NEUTRAL)
    sweeps = (0 if first else int(st[SWEEPS])) + 1
    st[CHANGED] = 0
    st[TICKET] = 0
    st[SWEEPS] = sweeps
    st[DONE] = (CONVERGED if not changed else
                CAPPED if sweeps >= plan.params["cap"] else RUNNING)


def retire_reference(plan: LaunchPlan) -> None:
    """The plain version of scc_retire()."""
    a, o = plan.args, plan.outputs
    active, out, st = o["active"], o["out"], o["st"]
    if int(st[DONE]) == RUNNING:
        return
    member = active & (a["m"] > 0)
    out.copy_(torch.where(member, a["c"], out))
    active &= ~member
    st[LEFT] = int(active.sum())
