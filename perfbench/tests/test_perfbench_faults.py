"""A run's comparison against faults: the harness's run, with its look
for a card skipped (on the CPU, at small sizes), over the program with
its timed path broken underneath, has to come out not correct; the
sound program, and only it, correct. The control, the program with its
certificates switched off (JEPSEN_TPU_CERTIFY=0), breaks the
configuration's guarantee of a certificate on every verdict."""

import time

import pytest
from harness import cell

from jepsen_tpu_torch.gpu import certify, wgl

SEED = 2**31 + 101


def small(name: str) -> dict:
    spec = cell.resolve(name)
    h = spec["config"]["history"]
    if "keys" in h:
        h.update(keys=8, ops=60)
    else:
        h.update(ops=400)
    return spec


def run(name: str, trace: bool = False, seconds: float = 2.0) -> dict:
    """A run of the cell at small sizes on the CPU. A sound run needs a
    check done inside the window: `seconds` leaves room for checks that
    slow down while other tests share the CPU."""
    return cell.run(small(name), SEED, seconds, trace, "cpu",
                    time.monotonic())


def flip_verdict(mp):
    orig = wgl.analysis

    def analysis(*a, **kw):
        out = orig(*a, **kw)
        out["valid?"] = not out["valid?"]
        return out
    mp.setattr(wgl, "analysis", analysis)


def flip_batch(mp):
    orig = wgl.analysis_batch

    def analysis_batch(*a, **kw):
        out = orig(*a, **kw)
        out[-1]["valid?"] = not out[-1]["valid?"]
        return out
    mp.setattr(wgl, "analysis_batch", analysis_batch)


def tamper_certificate(mp):
    orig = certify.wgl_certificate

    def wgl_certificate(*a, **kw):
        cert = orig(*a, **kw)
        order = cert["segments"][0]["order"]
        order[1], order[2] = order[2], order[1]
        return cert
    mp.setattr(certify, "wgl_certificate", wgl_certificate)


def stale_answer(mp):
    orig = wgl.analysis
    first: list = []

    def analysis(*a, **kw):
        if not first:
            first.append(orig(*a, **kw))
        return first[0]
    mp.setattr(wgl, "analysis", analysis)


def half_the_batch(mp):
    orig = wgl.analysis_batch

    def analysis_batch(model, hists, *a, **kw):
        half = orig(model, hists[:len(hists) // 2], *a, **kw)
        return [half[i % len(half)] for i in range(len(hists))]
    mp.setattr(wgl, "analysis_batch", analysis_batch)


def stale_batch(mp):
    orig = wgl.analysis_batch
    first: list = []

    def analysis_batch(*a, **kw):
        if not first:
            first.append(orig(*a, **kw))
        return first[0]
    mp.setattr(wgl, "analysis_batch", analysis_batch)


def certificates_off(mp):
    mp.setenv("JEPSEN_TPU_CERTIFY", "0")


FAULTS = [
    ("register-1m.valid", flip_verdict, "verdicts_wrong"),
    ("register-1m.valid", tamper_certificate, "certificates_rejected"),
    ("register-1m.valid", stale_answer, "certificates_rejected"),
    ("register-1m.valid", certificates_off, "certificates_absent"),
    ("independent-1024.valid", flip_batch, "verdicts_wrong"),
    ("independent-1024.valid", half_the_batch, "certificates_rejected"),
    ("independent-1024.valid", stale_batch, "certificates_rejected"),
    ("independent-1024.valid", tamper_certificate,
     "certificates_rejected"),
    ("independent-1024.valid", certificates_off, "certificates_absent"),
]


@pytest.mark.parametrize("name", ["register-1m.valid",
                                  "independent-1024.valid"])
def test_the_sound_program_is_correct(name):
    out = run(name, seconds=8.0)
    assert out["correct"] is True, out
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    assert all(c["value"] == 0 for c in out["compared"].values())


@pytest.mark.parametrize("name,fault,number", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f, _ in FAULTS])
def test_a_fault_is_not_correct(monkeypatch, name, fault, number):
    fault(monkeypatch)
    out = run(name)
    assert out["correct"] is False
    assert out["compared"][number]["value"] > 0, out["compared"]


def test_a_check_that_raises_is_counted(monkeypatch):
    orig = wgl.analysis
    calls: list = []

    def analysis(*a, **kw):
        calls.append(1)
        if len(calls) > 1:            # the warm-up check passes
            raise RuntimeError("launch failed")
        return orig(*a, **kw)
    monkeypatch.setattr(wgl, "analysis", analysis)
    out = run("register-1m.valid")
    assert out["correct"] is False and out["failed"] >= 1
    assert out["compared"]["checks_failed"]["value"] == out["failed"]


def test_a_failing_warm_up_gives_no_result(monkeypatch):
    def analysis(*a, **kw):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(wgl, "analysis", analysis)
    with pytest.raises(RuntimeError):
        run("register-1m.valid")


def test_a_traced_run_reads_its_per_layer_metrics():
    out = run("independent-1024.valid", trace=True, seconds=8.0)
    assert out["correct"] is True
    names = set(out["metrics"])
    assert {"split_ms", "encode_ms", "certify_ms",
            "launches_per_check", "wgl_search_ms"} <= names
    assert out["metrics"]["launches_per_check"]["value"] == 1.0
    assert "breakdown" in out and "busy_s" in out["device"]
