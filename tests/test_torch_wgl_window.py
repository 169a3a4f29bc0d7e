"""The invariant the CUDA kernel's shared-memory ring rests on, checked
on the port's plain WGL search.

A level linearizes one more entry in every live configuration and the
key is normalized (the trailing ones of the new mask shift into p), so
every configuration live at level `it` has p + popcount(mask) == it and
it - W + 1 <= p <= it. All the table reads of a level (the window
[p, p+W) and the tail entry p+W) then fall in [it-W+1, it+W], a range
that moves one entry a level whatever the data: csrc/wgl_search.cu
streams each row's tables through a ring in shared memory on that
ground. And a configuration at level it has linearized it entries of
its segment's m, so it has reached the end (p == m) exactly when
it == m: the configurations a level keeps are all live (p < m) or all
done, which lets the kernel's warp path keep them unsorted. The plain
version's per-level callback shows every frontier as kept;
the same runs are held against the JAX package's `_kernel` on the same
seeded inputs, output for output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.checker import models as jmodels
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu.tpu import wgl as jwgl
from jepsen_tpu.tpu.encode import encode as jencode
from jepsen_tpu_torch.gpu import carry
from jepsen_tpu_torch.gpu.kernels import wgl_search as ws

torch.set_num_threads(1)

# (n_ops -> M bucket 64 / 128, crash_p, W, F), as in
# test_torch_wgl_kernel.py: W=32 crash-free makes a full window (no hole
# left in the mask), crashes double the successors, W=F=4 overflows
CASES = [
    (30, 0.0, 32, 64),
    (30, 0.15, 32, 64),
    (60, 0.0, 24, 48),
    (60, 0.15, 24, 48),
    (60, 0.0, 4, 4),
    (60, 0.15, 4, 4),
]


def _popcount(x: torch.Tensor) -> torch.Tensor:
    return sum((x >> b) & 1 for b in range(32))


class _Window:
    """on_level callback: checks the invariants at every level and counts
    the configurations it saw, and those that reached their segment's
    end. m holds each row's segment length."""

    def __init__(self, W: int, m: torch.Tensor):
        self.W = W
        self.m = m
        self.levels = 0
        self.configs = 0
        self.done = 0

    def __call__(self, it, p, mask, live):
        self.levels += 1
        if not bool(live.any()):
            return
        pl, ml = p[live], mask[live]
        mr = self.m[:, None].expand_as(p)[live]
        self.configs += int(pl.numel())
        assert torch.equal(pl + _popcount(ml), torch.full_like(pl, it)), it
        assert int(pl.min()) >= it - self.W + 1, it
        assert int(pl.max()) <= it, it
        assert not bool((ml & 1).any()), it  # bit 0 of a stored mask
        assert int(ml.max()) < (1 << self.W), it
        # all live or all done: p == m exactly when it == m
        assert bool((pl <= mr).all()), it
        assert torch.equal(pl == mr, mr == it), it
        self.done += int((pl == mr).sum())


def _run(pb, rows, W, F, reach):
    row_seg, st0 = pb.rows(rows)
    kw = dict(W=W, F=F, max_iters=pb.M + 4, reach=reach,
              crash_free=not pb.has_crashed)
    ref = jwgl._jitted_kernel()(
        jnp.asarray(pb.inv_t), jnp.asarray(pb.ret_t), jnp.asarray(pb.trans),
        jnp.asarray(pb.m), jnp.asarray(pb.sufmin), jnp.asarray(row_seg),
        jnp.asarray(st0), **kw)
    packed, rs, s0 = carry.packed_from_reference(
        pb.inv_t, pb.ret_t, pb.trans, pb.m, pb.sufmin, row_seg, st0, "cpu")
    window = _Window(W, torch.as_tensor(pb.m, dtype=torch.int64)[rs.long()])
    got = ws.wgl_search_reference(packed, rs, s0, on_level=window, **kw)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    assert window.levels == int(got[-4]) + 1
    assert window.configs > 0
    return window


@pytest.mark.parametrize("reach", [False, True], ids=["verdict", "reach"])
@pytest.mark.parametrize("n_ops,crash_p,W,F", CASES)
def test_frontier_stays_in_the_ring_window(n_ops, crash_p, W, F, reach):
    m = jmodels.cas_register()
    hs = [jsynth.register_history(n_ops, n_procs=4, seed=s, crash_p=crash_p)
          for s in range(5)]
    hs += [jsynth.corrupt_register_history(h, at_frac=0.5)[0]
           for h in hs[:2]]
    encs = [jencode(m, h) for h in hs]
    pb = jwgl.PackedBatch(encs)
    _run(pb, [(i, e.init_state) for i, e in enumerate(encs)], W, F, reach)


@pytest.mark.parametrize("crash_p", [0.0, 0.1])
def test_frontier_stays_in_the_ring_window_segment_rows(crash_p):
    """check_segmented's launch shape: segments of one corrupted history
    from every start state, and an empty segment (m == 0), whose rows
    start VALID with mask 1 << st0 and never run a level."""
    hist = jsynth.register_history(300, n_procs=5, seed=11, crash_p=crash_p)
    enc = jencode(jmodels.cas_register(),
                  jsynth.corrupt_register_history(hist, at_frac=0.6)[0])
    cuts = [0, enc.m // 4, enc.m // 2, 3 * enc.m // 4, enc.m]
    segs = [enc.segment(cuts[k], cuts[k + 1]) for k in range(4)]
    segs.append(enc.segment(cuts[1], cuts[1]))
    pb = jwgl.PackedBatch(segs)
    rows = [(k, s) for k in range(len(segs)) for s in range(enc.n_states)]
    assert _run(pb, rows, 24, 48, reach=True).done > 0


def test_path_levels_refused_with_cpu_tensors():
    """The warp/block level counts belong to the kernel's schedule: the
    plain version has none, and is not asked for them."""
    encs = [jencode(jmodels.cas_register(),
                    jsynth.register_history(30, n_procs=4, seed=s))
            for s in range(2)]
    pb = jwgl.PackedBatch(encs)
    row_seg, st0 = pb.rows([(0, 0), (1, 0)])
    packed, rs, s0 = carry.packed_from_reference(
        pb.inv_t, pb.ret_t, pb.trans, pb.m, pb.sufmin, row_seg, st0, "cpu")
    with pytest.raises(ValueError):
        ws.wgl_search(packed, rs, s0, W=24, F=48, max_iters=pb.M + 4,
                      path_levels=torch.zeros(3, dtype=torch.int32))
