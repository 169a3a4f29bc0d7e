"""Parity of the port's analysis() and linearizable checker with the JAX
package's on the CPU, certificates included: every certificate the port
makes must pass the port's own validator and the JAX package's."""

import functools

import numpy as np
import pytest
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu.checker import models as jmodels
from jepsen_tpu.tpu import certify as jcertify
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu.tpu import wgl as jwgl
from jepsen_tpu_torch import checker as pchecker
from jepsen_tpu_torch import telemetry as ptel
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.gpu import certify as pcertify
from jepsen_tpu_torch.gpu import synth as psynth
from jepsen_tpu_torch.gpu import wgl as pwgl

# The plain kernel runs many small tensor ops per BFS level: one
# intra-op thread per test process keeps parallel test workers from
# oversubscribing the cores (it is no slower at these sizes).
torch.set_num_threads(1)


def _norm(x):
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


def _as_jax(result):
    """The JAX result with its analyzer name mapped onto the port's
    (tpu -> gpu)."""
    out = _norm(result)
    if isinstance(out.get("analyzer"), str):
        out["analyzer"] = out["analyzer"].replace("tpu", "gpu")
    return out


# name -> (generator kwargs, corrupt at_frac or None, analysis kwargs)
CASES = {
    # m >= SEGMENT_MIN_M: the segmented path
    "long-valid": (dict(n_ops=5500, n_procs=5, seed=7), None, {}),
    "long-invalid": (dict(n_ops=5500, n_procs=5, seed=8), 0.6, {}),
    # short: the whole-history kernel, valid / invalid / crashes
    "short-valid": (dict(n_ops=300, n_procs=4, seed=1), None, {}),
    "short-invalid": (dict(n_ops=300, n_procs=4, seed=2), 0.5, {}),
    "short-crashes": (dict(n_ops=300, n_procs=4, seed=3, crash_p=0.15),
                      None, {}),
    # a window too narrow to decide: UNKNOWN, then the host search
    "host-fallback": (dict(n_ops=200, n_procs=5, seed=4), None,
                      dict(W=4, F=4)),
}


def _hist(name, synth):
    kw, at_frac, _ = CASES[name]
    hist = synth.register_history(**kw)
    if at_frac is not None:
        hist = synth.corrupt_register_history(hist, at_frac=at_frac)[0]
    return hist


@functools.lru_cache(maxsize=None)
def _jax_analysis(name):
    jh = _hist(name, jsynth)
    return jh, jwgl.analysis(jmodels.cas_register(), jh, certify=True,
                             **CASES[name][2])


@pytest.mark.parametrize("name", list(CASES))
def test_analysis_matches_and_certifies(name):
    jh, want = _jax_analysis(name)
    ph = _hist(name, psynth)
    ptel.reset()
    got = pwgl.analysis(pmodels.cas_register(), ph, certify=True,
                        device="cpu", **CASES[name][2])
    assert _norm(got) == _as_jax(want)
    assert got["analyzer"] == {
        "long-valid": "gpu-segmented", "long-invalid": "gpu-segmented",
        "host-fallback": "gpu+host-fallback"}.get(name, "gpu")
    cert = got["certificate"]
    assert "absent" not in cert
    pcertify.validate(ph, cert)
    jcertify.validate(jh, cert)
    if name == "host-fallback":
        assert ptel.get().counters()["wgl.host-resolved-rows"] >= 1


def test_forged_certificate_is_rejected_by_both_validators():
    jh, _ = _jax_analysis("short-valid")
    ph = _hist("short-valid", psynth)
    got = pwgl.analysis(pmodels.cas_register(), ph, certify=True,
                        device="cpu")
    cert = got["certificate"]
    order = cert["segments"][0]["order"]
    order[0], order[1] = order[1], order[0]
    with pytest.raises(pcertify.CertificateError):
        pcertify.validate(ph, cert)
    with pytest.raises(jcertify.CertificateError):
        jcertify.validate(jh, cert)


@pytest.mark.parametrize("algorithm", ["wgl", "model"])
def test_host_algorithms_match(algorithm):
    jh = _hist("short-invalid", jsynth)
    ph = _hist("short-invalid", psynth)
    want = jwgl.analysis(jmodels.cas_register(), jh, algorithm=algorithm)
    got = pwgl.analysis(pmodels.cas_register(), ph, algorithm=algorithm,
                        device="cpu")
    assert _norm(got) == _norm(want)


@pytest.mark.parametrize("name", ["short-valid", "short-invalid",
                                  "long-invalid"])
def test_linearizable_checker_matches(name):
    jh = _hist(name, jsynth)
    ph = _hist(name, psynth)
    want = jchecker.linearizable({"model": jmodels.cas_register()}).check(
        {}, jh)
    got = pchecker.linearizable({"model": pmodels.cas_register(),
                                 "device": "cpu"}).check({}, ph)
    assert _norm(got) == _as_jax(want)
    assert got["anomaly-classes"] == {
        "nonlinearizable": "witnessed" if "invalid" in name else "clean"}
    pcertify.validate(ph, got["certificate"])


def test_linearizable_checker_requires_a_model():
    with pytest.raises(ValueError):
        pchecker.linearizable({})
