"""Parity of the port's host-side inputs with the JAX package's: the
seeded history generators, encode(), and the packed kernel tables."""

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import models as jmodels
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu.tpu import wgl as jwgl
from jepsen_tpu.tpu.encode import encode as jencode
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.gpu import carry
from jepsen_tpu_torch.gpu import synth as psynth
from jepsen_tpu_torch.gpu import wgl as pwgl
from jepsen_tpu_torch.gpu.encode import encode as pencode

HISTS = [
    dict(n_ops=300, n_procs=5, seed=1, crash_p=0.0),
    dict(n_ops=300, n_procs=4, seed=2, crash_p=0.15),
    dict(n_ops=2000, n_procs=5, seed=42, crash_p=0.0),
]


def _pair(kw, corrupt=False):
    jh = jsynth.register_history(**kw)
    ph = psynth.register_history(**kw)
    if corrupt:
        jh, ji = jsynth.corrupt_register_history(jh, at_frac=0.7)
        ph, pi = psynth.corrupt_register_history(ph, at_frac=0.7)
        assert ji == pi
    return jh, ph


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("kw", HISTS)
def test_synth_matches(kw, corrupt):
    jh, ph = _pair(kw, corrupt)
    assert len(jh) == len(ph)
    assert [o.to_dict() for o in jh] == [o.to_dict() for o in ph]


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("kw", HISTS)
def test_encode_matches(kw, corrupt):
    jh, ph = _pair(kw, corrupt)
    je = jencode(jmodels.cas_register(), jh)
    pe = pencode(pmodels.cas_register(), ph)
    for f in ("inv_t", "ret_t", "crashed", "trans"):
        a, b = getattr(je, f), getattr(pe, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (pe.m, pe.n_states, pe.init_state) == (je.m, je.n_states,
                                                  je.init_state)
    assert [repr(s) for s in pe.states] == [repr(s) for s in je.states]
    assert [o.index for o in pe.entry_ops] == [o.index for o in je.entry_ops]
    np.testing.assert_array_equal(pe.suffix_min_ret(), je.suffix_min_ret())
    np.testing.assert_array_equal(pwgl.valid_cut_points(pe),
                                  jwgl.valid_cut_points(je))
    assert pwgl.segment_cuts(pe, 128) == jwgl.segment_cuts(je, 128)


@pytest.mark.parametrize("kw", HISTS)
def test_packed_batch_matches(kw):
    jh, ph = _pair(kw)
    jbad, pbad = _pair(kw, corrupt=True)
    jencs = [jencode(jmodels.cas_register(), h) for h in (jh, jbad)]
    pencs = [pencode(pmodels.cas_register(), h) for h in (ph, pbad)]
    # a segment and an empty segment, as check_segmented packs them
    jencs += [jencs[0].segment(10, 90), jencs[0].segment(5, 5)]
    pencs += [pencs[0].segment(10, 90), pencs[0].segment(5, 5)]
    jpb, ppb = jwgl.PackedBatch(jencs), pwgl.PackedBatch(pencs)
    for f in ("inv_t", "ret_t", "trans", "m", "sufmin"):
        a, b = getattr(jpb, f), getattr(ppb, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (ppb.M, ppb.S, ppb.B, ppb.has_crashed) == (
        jpb.M, jpb.S, jpb.B, jpb.has_crashed)
    rows = [(k, s) for k in range(len(pencs)) for s in range(3)]
    for a, b in zip(jpb.rows(rows), ppb.rows(rows)):
        np.testing.assert_array_equal(b, a)
    # the one-copy device layout holds the same tables
    packed, rs, s0 = ppb.tensors(*ppb.rows(rows), torch.device("cpu"))
    for t, f in zip(packed, ("inv_t", "ret_t", "trans", "m", "sufmin")):
        np.testing.assert_array_equal(t.numpy(), getattr(jpb, f))
    np.testing.assert_array_equal(rs.numpy(), jpb.rows(rows)[0])
    np.testing.assert_array_equal(s0.numpy(), jpb.rows(rows)[1])


def test_encoded_from_reference_packs_identically():
    jh, _ = _pair(HISTS[1])
    je = jencode(jmodels.cas_register(), jh)
    pe = carry.encoded_from_reference(je.inv_t, je.ret_t, je.crashed,
                                      je.trans, je.states, je.entry_ops,
                                      je.init_state)
    jpb, ppb = jwgl.PackedBatch([je]), pwgl.PackedBatch([pe])
    for f in ("inv_t", "ret_t", "trans", "m", "sufmin"):
        np.testing.assert_array_equal(getattr(ppb, f), getattr(jpb, f))


def test_packed_batch_range_error():
    pe = pencode(pmodels.cas_register(),
                 psynth.register_history(50, n_procs=3, seed=5))
    big = carry.encoded_from_reference(
        np.arange(1 << 20, dtype=np.int32),
        np.arange(1, (1 << 20) + 1, dtype=np.int32),
        np.zeros(1 << 20, dtype=bool),
        np.zeros((1 << 20, pe.n_states), dtype=np.int32), pe.states,
        [None] * (1 << 20))
    with pytest.raises(pwgl.RangeError):
        pwgl.PackedBatch([big])
