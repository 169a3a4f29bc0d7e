"""Slice-level parity of the port's wgl entry points with the JAX
package's on the CPU: check_batch codes, check_batch_reach masks and
unknown flags, and check_segmented result dicts (segments, failed
segment and range, search chain, witness fields), with early exit on and
off. The port runs its kernel's plain PyTorch version (device="cpu");
the JAX side runs as its own tests run it on the CPU. Histories come from
the same seeded generator on both sides."""

import functools

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import models as jmodels
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu.tpu import wgl as jwgl
from jepsen_tpu.tpu.encode import encode as jencode
from jepsen_tpu_torch import telemetry as ptel
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.gpu import synth as psynth
from jepsen_tpu_torch.gpu import wgl as pwgl
from jepsen_tpu_torch.gpu.encode import encode as pencode

# The plain kernel runs many small tensor ops per BFS level: one
# intra-op thread per test process keeps parallel test workers from
# oversubscribing the cores (it is no slower at these sizes).
torch.set_num_threads(1)


def _norm(x):
    """Compares results across the two packages: ops and model states
    are different classes on each side, so they compare as dicts and
    reprs."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if hasattr(x, "to_dict") and hasattr(x, "index"):
        return {"op": _norm(x.to_dict())}
    if type(x).__module__.endswith(".models"):
        return {"model": repr(x)}
    if isinstance(x, np.integer):
        return int(x)
    return x


def _small_pairs(crash_p):
    """(jax encodes, port encodes): short valid and corrupted histories."""
    jencs, pencs = [], []
    for seed in range(6):
        kw = dict(n_ops=40, n_procs=4, seed=seed, crash_p=crash_p)
        jh, ph = jsynth.register_history(**kw), psynth.register_history(**kw)
        if seed % 3 == 2:
            jh = jsynth.corrupt_register_history(jh, at_frac=0.4)[0]
            ph = psynth.corrupt_register_history(ph, at_frac=0.4)[0]
        jencs.append(jencode(jmodels.cas_register(), jh))
        pencs.append(pencode(pmodels.cas_register(), ph))
    return jencs, pencs


@pytest.mark.parametrize("W,F", [(32, 64), (4, 4)])
@pytest.mark.parametrize("crash_p", [0.0, 0.15])
def test_check_batch_matches(crash_p, W, F):
    jencs, pencs = _small_pairs(crash_p)
    want = jwgl.check_batch(jencs, W=W, F=F)
    got = pwgl.check_batch(pencs, W=W, F=F, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    if W == 4:
        assert (got == pwgl.UNKNOWN).any()


@pytest.mark.parametrize("W,F", [(32, 32), (4, 4)])
@pytest.mark.parametrize("crash_p", [0.0, 0.15])
def test_check_batch_reach_matches(crash_p, W, F):
    jencs, pencs = _small_pairs(crash_p)
    jout, junk = jwgl.check_batch_reach(jencs, W=W, F=F)
    pout, punk = pwgl.check_batch_reach(pencs, W=W, F=F, device="cpu")
    np.testing.assert_array_equal(pout, jout)
    np.testing.assert_array_equal(punk, junk)
    assert pout.dtype == jout.dtype and punk.dtype == junk.dtype


# name -> (generator kwargs, corrupt at_frac or None, target_len)
SEGMENTED = {
    "valid": (dict(n_ops=8000, n_procs=5, seed=1), None, None),
    "invalid": (dict(n_ops=8000, n_procs=5, seed=2), 0.3, None),
    # one crashed entry: the cut schedule stops there, so the last
    # segment is not crash-free (the discard action)
    "crashes": (dict(n_ops=2500, n_procs=5, seed=15, crash_p=0.0008), None,
                256),
    # crashes everywhere: no valid cut, the history does not segment
    "unsegmentable": (dict(n_ops=2500, n_procs=5, seed=3, crash_p=0.15),
                      None, 256),
}


def _segmented_hist(name, synth):
    kw, at_frac, _ = SEGMENTED[name]
    hist = synth.register_history(**kw)
    if at_frac is not None:
        hist = synth.corrupt_register_history(hist, at_frac=at_frac)[0]
    return hist


@functools.lru_cache(maxsize=None)
def _jax_segmented(name):
    enc = jencode(jmodels.cas_register(), _segmented_hist(name, jsynth))
    return jwgl.check_segmented(enc, target_len=SEGMENTED[name][2],
                                witness=True)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("name", sorted(SEGMENTED))
def test_check_segmented_matches(name, early_exit):
    want = _jax_segmented(name)
    enc = pencode(pmodels.cas_register(), _segmented_hist(name, psynth))
    ptel.reset()
    got = pwgl.check_segmented(enc, target_len=SEGMENTED[name][2],
                               witness=True, early_exit=early_exit,
                               device="cpu")
    assert _norm(got) == _norm(want)
    if name == "unsegmentable":
        assert got is None
        return
    assert got["valid?"] is (name != "invalid")
    assert got.get("segments", 2) >= 2
    counters = ptel.get().counters()
    assert counters["wgl.kernel.launches"] >= 2
    if name == "invalid" and early_exit:
        assert counters.get("wgl.segmented.early-exit") == 1
