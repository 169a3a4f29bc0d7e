"""Kernel-level parity of the port's WGL frontier search with the JAX
package's `_kernel`.

The same JAX-built PackedBatch (from seeded register histories, valid,
corrupted and with crashes) goes through `jepsen_tpu.tpu.wgl._jitted_kernel`
(the single-device jit) and, carried across byte for byte by
`carry.packed_from_reference`, through the port's `wgl_search` on CPU
tensors, which runs its plain PyTorch version. Every output is an
integer, so every comparison is exact: results / reach masks, unknown
flags, the iteration count and the three per-level series.

The CUDA kernel itself runs only on a card: its comparison with the
plain version is the last test here, skipped without CUDA, and
chip_smoke.py makes the same comparison at full size on the card.
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

# The plain kernel runs many small tensor ops per BFS level: one
# intra-op thread per test process keeps parallel test workers from
# oversubscribing the cores (it is no slower at these sizes).
torch.set_num_threads(1)


def _encs(n_ops, crash_p, seeds=range(5)):
    m = jmodels.cas_register()
    hs = [jsynth.register_history(n_ops, n_procs=4, seed=s, crash_p=crash_p)
          for s in seeds]
    hs += [jsynth.corrupt_register_history(h, at_frac=0.5)[0]
           for h in hs[:2]]
    return [jencode(m, h) for h in hs]


def _compare(pb, rows, W, F, reach):
    row_seg, st0 = pb.rows(rows)
    kw = dict(W=W, F=F, max_iters=pb.M + 4, reach=reach,
              crash_free=not pb.has_crashed)
    ref = jwgl._jitted_kernel()(
        jnp.asarray(pb.inv_t), jnp.asarray(pb.ret_t), jnp.asarray(pb.trans),
        jnp.asarray(pb.m), jnp.asarray(pb.sufmin), jnp.asarray(row_seg),
        jnp.asarray(st0), **kw)
    packed, rs, s0 = carry.packed_from_reference(
        pb.inv_t, pb.ret_t, pb.trans, pb.m, pb.sufmin, row_seg, st0, "cpu")
    got = ws.wgl_search(packed, rs, s0, **kw)
    assert len(got) == len(ref)
    for name, a, b in zip(("out", "unknown", "it", "live", "new", "dup")
                          if reach else ("result", "it", "live", "new",
                                         "dup"), ref, got):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    return [np.asarray(x) for x in ref]


# (n_ops -> M bucket 64 / 128, crash_p, W, F); crash_p > 0 makes the
# batch non-crash-free (the discard action), W=F=4 forces window and
# frontier overflow so rows come back UNKNOWN
CASES = [
    (30, 0.0, 32, 64),
    (30, 0.15, 32, 64),
    (60, 0.0, 24, 48),
    (60, 0.15, 24, 48),
    (60, 0.0, 4, 4),
    (60, 0.15, 4, 4),
]


@pytest.mark.parametrize("reach", [False, True], ids=["verdict", "reach"])
@pytest.mark.parametrize("n_ops,crash_p,W,F", CASES)
def test_plain_matches_jax_kernel(n_ops, crash_p, W, F, reach):
    encs = _encs(n_ops, crash_p)
    pb = jwgl.PackedBatch(encs)
    rows = [(i, e.init_state) for i, e in enumerate(encs)]
    ref = _compare(pb, rows, W, F, reach)
    if W == 4:
        unknown = ref[1] if reach else ref[0] == jwgl.UNKNOWN
        assert unknown[:len(rows)].any(), "overflow case decided every row"
    elif not reach:
        assert (ref[0][:len(rows)] == jwgl.VALID).any()
        assert (ref[0][:len(rows)] == jwgl.INVALID).any()


@pytest.mark.parametrize("crash_p", [0.0, 0.1])
def test_plain_matches_jax_kernel_segment_rows(crash_p):
    """check_segmented's launch shape: segments of one (corrupted)
    history, each searched from every start state, plus an empty
    segment (a row that starts VALID with mask 1 << st0)."""
    hist = jsynth.register_history(300, n_procs=5, seed=11, crash_p=crash_p)
    enc = jencode(jmodels.cas_register(),
                  jsynth.corrupt_register_history(hist, at_frac=0.6)[0])
    cuts = [0, enc.m // 4, enc.m // 2, 3 * enc.m // 4, enc.m]
    segs = [enc.segment(cuts[k], cuts[k + 1]) for k in range(4)]
    segs.append(enc.segment(cuts[1], cuts[1]))
    pb = jwgl.PackedBatch(segs)
    rows = [(k, s) for k in range(len(segs)) for s in range(enc.n_states)]
    ref = _compare(pb, rows, 24, 48, reach=True)
    out = ref[0][:len(rows)]
    assert (out == 0).any() and (out != 0).any()


def test_wrapper_rejects_bad_inputs():
    encs = _encs(30, 0.0, seeds=range(2))
    pb = jwgl.PackedBatch(encs)
    row_seg, st0 = pb.rows([(0, 0), (1, 0)])
    packed, rs, s0 = carry.packed_from_reference(
        pb.inv_t, pb.ret_t, pb.trans, pb.m, pb.sufmin, row_seg, st0, "cpu")
    kw = dict(W=24, F=48, max_iters=pb.M + 4)
    with pytest.raises(TypeError):
        ws.wgl_search((packed[0].long(),) + packed[1:], rs, s0, **kw)
    with pytest.raises(ValueError):
        ws.wgl_search(packed, rs, s0[:1], **kw)
    with pytest.raises(ValueError):
        ws.wgl_search(packed, rs, s0, W=33, F=48, max_iters=pb.M + 4)
    # a device that is neither the card nor the CPU is refused, never
    # routed to the plain version
    meta = tuple(t.to("meta") for t in packed)
    with pytest.raises(ValueError):
        ws.wgl_search(meta, rs.to("meta"), s0.to("meta"), **kw)


def test_plain_version_does_not_count_launches():
    encs = _encs(30, 0.0, seeds=range(2))
    pb = jwgl.PackedBatch(encs)
    row_seg, st0 = pb.rows([(0, 0), (1, 0)])
    packed, rs, s0 = carry.packed_from_reference(
        pb.inv_t, pb.ret_t, pb.trans, pb.m, pb.sufmin, row_seg, st0, "cpu")
    before = ws.launches
    ws.wgl_search(packed, rs, s0, W=24, F=48, max_iters=pb.M + 4)
    assert ws.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("reach", [False, True], ids=["verdict", "reach"])
def test_cuda_kernel_matches_plain(cuda_device, reach):
    for n_ops, crash_p, W, F in CASES:
        encs = _encs(n_ops, crash_p)
        pb = jwgl.PackedBatch(encs)
        row_seg, st0 = pb.rows([(i, e.init_state)
                                for i, e in enumerate(encs)])
        packed, rs, s0 = carry.packed_from_reference(
            pb.inv_t, pb.ret_t, pb.trans, pb.m, pb.sufmin, row_seg, st0,
            cuda_device)
        kw = dict(W=W, F=F, max_iters=pb.M + 4, reach=reach,
                  crash_free=not pb.has_crashed)
        before = ws.launches
        got = ws.wgl_search(packed, rs, s0, **kw)
        assert ws.launches == before + 1
        want = ws.wgl_search_reference(packed, rs, s0, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu())
