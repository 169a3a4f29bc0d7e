"""The port's checkpoint-and-extend layer (gpu/ckpt.py, store/format.py,
the resumable check_segmented, check_extend / analysis_extend,
StreamingElle and the checker's extend? / checkpoint? keys) against the
JAX package's on the CPU.

A checkpoint is only a speedup: a torn, stale or wrong-history record
is detected and discarded, and the caller pays for a full check, never
for a wrong verdict. A resumed check composes the exact masks a fresh
check would, so verdicts and certificates are identical. The records,
the frontier log and their digests are the JAX package's byte for byte:
a store written by one package is resumed by the other.
"""

import json
import struct
import zlib

import numpy as np
import pytest
import torch

from jepsen_tpu import chaos as jchaos
from jepsen_tpu import checker as jchecker
from jepsen_tpu import telemetry as jtel
from jepsen_tpu.checker import models as jmodels
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import op as jop
from jepsen_tpu.store import format as jfmt
from jepsen_tpu.tpu import certify as jcertify
from jepsen_tpu.tpu import ckpt as jckpt
from jepsen_tpu.tpu import elle as jelle
from jepsen_tpu.tpu import encode as jencode
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu.tpu import wgl as jwgl
from jepsen_tpu_torch import checker as pchecker
from jepsen_tpu_torch import telemetry as ptel
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.gpu import certify as pcertify
from jepsen_tpu_torch.gpu import ckpt as pckpt
from jepsen_tpu_torch.gpu import elle as pelle
from jepsen_tpu_torch.gpu import encode as pencode
from jepsen_tpu_torch.gpu import synth as psynth
from jepsen_tpu_torch.gpu import wgl as pwgl
from jepsen_tpu_torch.gpu.kernels import wgl_search as kws
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import op as pop
from jepsen_tpu_torch.store import format as pfmt

torch.set_num_threads(1)


def _norm(x):
    """A result with ops as dicts and models as reprs, so the two
    packages' results compare as plain data."""
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


def _hists(seed, n, corrupt=False):
    """The same seeded register history from both packages' generators
    (they agree op for op), corrupted alike when asked."""
    jh = jsynth.register_history(n, seed=seed)
    ph = psynth.register_history(n, seed=seed)
    if corrupt:
        jh, _ = jsynth.corrupt_register_history(jh)
        ph, _ = psynth.corrupt_register_history(ph)
    return list(jh), list(ph)


def _pcounters():
    return ptel.get().counters()


def _cert_bytes(out):
    return json.dumps(pfmt.jsonable(out["certificate"]), sort_keys=True)


def _stream_wgl_rec(ops, checked=10, mask=1):
    return {"v": pckpt.VERSION, "kind": "stream-wgl",
            "model": "cas-register", "checked": checked, "mask": mask,
            "n_ops": len(ops), "digest": pckpt.ops_digest(ops)}


# ---------------------------------------------------------------------------
# the store: framing, schema, corruption, durability faults
# ---------------------------------------------------------------------------

def test_store_round_trip_each_kind(tmp_path):
    _, ops = _hists(1, 40)
    d64 = pckpt.ops_digest(ops)
    recs = [
        _stream_wgl_rec(ops),
        {"v": pckpt.VERSION, "kind": "wgl-extend", "n_ops": 40,
         "digest": d64, "stride": 64, "model_fp": 123,
         "cuts": [0, 10, 20], "digests": [d64, d64, d64],
         "states": ["Register(None)"], "masks": {"0:0": 3}},
        {"v": pckpt.VERSION, "kind": "elle", "n_ops": 40,
         "digest": d64, "family": "list-append", "n_closed": 7,
         "versions": {"x": [1, 2]},
         "frontier": {"state": "streaming", "edges": []}},
    ]
    for i, rec in enumerate(recs):
        p = tmp_path / f"r{i}.ckpt"
        pckpt.write(p, rec)
        assert pckpt.read(p) == rec
        # the tmp file is renamed over the record: none survives
        assert not p.with_suffix(".tmp").exists()
        # the JAX package reads the port's file, byte for byte its own
        assert jckpt.read(p) == rec
        q = tmp_path / f"j{i}.ckpt"
        jckpt.write(q, rec)
        assert q.read_bytes() == p.read_bytes()


@pytest.mark.parametrize("mutate", [
    lambda r: r.pop("digest"), lambda r: r.update(v=99),
    lambda r: r.update(kind="mystery"), lambda r: r.update(n_ops=-1),
    lambda r: r.update(checked=True), lambda r: r.update(digest="short")],
    ids=["no-digest", "version", "kind", "n_ops", "bool-count",
         "short-digest"])
def test_schema_rejects_invalid(tmp_path, mutate):
    _, ops = _hists(1, 20)
    rec = _stream_wgl_rec(ops)
    mutate(rec)
    for validate in (pckpt.validate_record, jckpt.validate_record):
        with pytest.raises(ValueError):
            validate(rec)
    with pytest.raises(ValueError):
        pckpt.write(tmp_path / "x.ckpt", rec)
    assert not (tmp_path / "x.ckpt").exists()


@pytest.mark.parametrize("mode", ["torn", "garbage", "magic"])
def test_corruption_detected_and_discarded(tmp_path, mode):
    ptel.reset()
    p = tmp_path / "c.ckpt"
    _, ops = _hists(2, 40)
    pckpt.write(p, _stream_wgl_rec(ops))
    jchaos.corrupt_checkpoint(p, mode)
    assert pckpt.read(p) is None
    assert _pcounters().get("ckpt.torn", 0) == 1


def test_truncated_header_counted_torn(tmp_path):
    ptel.reset()
    p = tmp_path / "h.ckpt"
    p.write_bytes(pckpt.CKPT_MAGIC + b"\x01\x02")
    assert pckpt.read(p) is None
    assert _pcounters().get("ckpt.torn", 0) == 1


def test_schema_invalid_payload_counted(tmp_path):
    # valid framing around a schema-violating record: read() treats it
    # like a torn file
    ptel.reset()
    p = tmp_path / "bad.ckpt"
    payload = json.dumps({"v": pckpt.VERSION, "kind": "mystery"}).encode()
    p.write_bytes(pckpt.CKPT_MAGIC
                  + struct.pack("<II", len(payload), zlib.crc32(payload))
                  + payload)
    assert pckpt.read(p) is None
    assert _pcounters().get("ckpt.invalid", 0) == 1


def test_load_screens_kind_digest_nops(tmp_path):
    ptel.reset()
    _, ops = _hists(3, 60)
    p = tmp_path / "s.ckpt"
    pckpt.write(p, _stream_wgl_rec(ops))
    assert pckpt.load(p, "elle") is None
    assert _pcounters().get("ckpt.stale", 0) == 0  # wrong kind only
    # a record of MORE ops than the history at hand is stale
    assert pckpt.load(p, "stream-wgl", n_ops=len(ops) - 10) is None
    # a digest of another history's prefix is stale
    other = pckpt.ops_digest(_hists(4, 60)[1])
    assert pckpt.load(p, "stream-wgl", digest=other) is None
    assert _pcounters().get("ckpt.stale", 0) == 2
    rec = pckpt.load(p, "stream-wgl", digest=pckpt.ops_digest(ops))
    assert rec is not None and rec["n_ops"] == len(ops)
    assert pckpt.read(tmp_path / "nope.ckpt") is None
    assert pckpt.load(tmp_path / "nope.ckpt", "elle") is None


def test_try_write_sheds_on_durability_fault(tmp_path):
    ptel.reset()
    _, ops = _hists(5, 40)
    p = tmp_path / "d.ckpt"
    first = _stream_wgl_rec(ops, checked=5)
    pckpt.write(p, first)

    def hook(path, data):
        raise OSError(28, "injected ENOSPC")

    pckpt.set_fault_hook(hook)
    try:
        assert pckpt.try_write(p, _stream_wgl_rec(ops, checked=9)) is False
        with pytest.raises(OSError):
            pckpt.write(p, _stream_wgl_rec(ops, checked=9))
    finally:
        pckpt.set_fault_hook(None)
    assert _pcounters().get("ckpt.write-error", 0) == 2
    # the previous record survives the failed writes
    assert pckpt.read(p) == first


def test_digests_and_codec_equal_jax():
    """ops_digest, the codec bytes of every op and the entry digest chain
    of the encoded history are the JAX package's."""
    jops, pops = _hists(6, 300, corrupt=True)
    assert [pfmt.encode_op(o) for o in pops] == \
        [jfmt.encode_op(o) for o in jops]
    assert pckpt.ops_digest(pops) == jckpt.ops_digest(jops)
    assert pckpt.ops_digest(pops, 77) == jckpt.ops_digest(jops, 77)
    penc = pencode.encode(pmodels.cas_register(), PHistory(pops))
    jenc = jencode.encode(jmodels.cas_register(), JHistory(jops))
    cuts = pwgl.segment_cuts(penc, 64)
    assert cuts == jwgl.segment_cuts(jenc, 64)
    assert pckpt.entry_digest_chain(penc, cuts) == \
        jckpt.entry_digest_chain(jenc, cuts)
    assert pwgl._extend_fingerprint(penc) == jwgl._extend_fingerprint(jenc)
    assert pwgl._SegmentCheckpoint.fingerprint_of(penc, cuts) == \
        jwgl._SegmentCheckpoint("/dev/null", jenc, cuts).fingerprint
    assert pckpt.run_dir_path("d", "x") == jckpt.run_dir_path("d", "x")


# ---------------------------------------------------------------------------
# checkpointed against from scratch, and against the JAX package
# ---------------------------------------------------------------------------

def _prefix(ops, frac):
    cut = int(len(ops) * frac)
    return ops[:cut - cut % 2]  # invoke/complete pairs stay aligned


@pytest.mark.parametrize("corrupt", [False, True],
                         ids=["valid", "invalid"])
def test_resume_identical_to_from_scratch(tmp_path, corrupt):
    """A check resumed from a prefix record reaches the same verdict and
    the same certificate bytes as a fresh check of the grown history,
    and its result equals the JAX package's analysis_extend; both
    validators accept the certificate."""
    jops, pops = _hists(11, 600, corrupt=corrupt)
    model = pmodels.cas_register()
    p = tmp_path / "run.ckpt"
    pwgl.analysis_extend(model, _prefix(pops, 0.7), store_path=p,
                         stride=64, device="cpu")
    assert pckpt.read(p) is not None
    scratch = pwgl.analysis_extend(model, pops, stride=64, certify=True,
                                   device="cpu")
    ptel.reset()
    resumed = pwgl.analysis_extend(model, pops, store_path=p, stride=64,
                                   certify=True, device="cpu")
    c = _pcounters()
    assert c.get("ckpt.extend.resumed") == 1
    assert c.get("ckpt.extend.reused-masks", 0) >= 1
    assert resumed == scratch
    assert _cert_bytes(resumed) == _cert_bytes(scratch)
    assert resumed["analyzer"] == "gpu-extend"
    want = jwgl.analysis_extend(jmodels.cas_register(), jops, stride=64,
                                certify=True)
    assert _norm(resumed) == _as_jax(want)
    pcertify.validate(PHistory(pops), resumed["certificate"])
    jcertify.validate(JHistory(jops), resumed["certificate"])
    # and the plain analysis agrees on the verdict
    plain = pwgl.analysis(model, pops, device="cpu")
    assert resumed["valid?"] == plain["valid?"] is (not corrupt)


def test_stale_record_full_recheck(tmp_path):
    """A record of a DIFFERENT history costs a full check (counted),
    never a wrong verdict."""
    model = pmodels.cas_register()
    _, ops = _hists(21, 400)
    p = tmp_path / "run.ckpt"
    pwgl.analysis_extend(model, _hists(22, 400)[1], store_path=p,
                         stride=64, device="cpu")
    ptel.reset()
    out = pwgl.analysis_extend(model, ops, store_path=p, stride=64,
                               device="cpu")
    assert out["valid?"] == pwgl.analysis(model, ops, device="cpu")[
        "valid?"]
    c = _pcounters()
    assert c.get("ckpt.stale", 0) == 1
    assert "ckpt.extend.reused-masks" not in c


def test_torn_record_full_recheck_then_replaced(tmp_path):
    model = pmodels.cas_register()
    _, ops = _hists(23, 600)
    p = tmp_path / "run.ckpt"
    pwgl.analysis_extend(model, ops[:400], store_path=p, stride=64,
                         device="cpu")
    prefix_rec = pckpt.read(p)
    assert prefix_rec is not None
    jchaos.corrupt_checkpoint(p, "torn")
    ptel.reset()
    out = pwgl.analysis_extend(model, ops, store_path=p, stride=64,
                               device="cpu")
    assert out["valid?"] == pwgl.analysis(model, ops, device="cpu")[
        "valid?"]
    assert _pcounters().get("ckpt.torn", 0) == 1
    # the full check wrote a fresh record of the grown history
    rec = pckpt.read(p)
    assert rec is not None and rec["kind"] == "wgl-extend"
    assert rec["n_ops"] > prefix_rec["n_ops"]
    assert rec["digest"] == rec["digests"][-1]


def test_short_history_falls_through_to_plain(tmp_path):
    ptel.reset()
    model = pmodels.cas_register()
    jops, ops = _hists(24, 30)
    out = pwgl.analysis_extend(model, ops, store_path=tmp_path / "x.ckpt",
                               device="cpu")
    assert out == pwgl.analysis(model, ops, device="cpu")
    assert _pcounters().get("ckpt.extend.fallback", 0) == 1
    assert _norm(out) == _as_jax(jwgl.analysis(jmodels.cas_register(),
                                               jops))


# ---------------------------------------------------------------------------
# stores written by one package, resumed by the other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corrupt", [False, True],
                         ids=["valid", "invalid"])
def test_extend_records_cross_packages(tmp_path, corrupt):
    """The port's wgl-extend record equals JAX's as a dict (and as
    bytes); each package resumes the other's record with the same
    reused-mask count and the same verdict."""
    jops, pops = _hists(12, 600, corrupt=corrupt)
    jp, pp = tmp_path / "jax.ckpt", tmp_path / "port.ckpt"
    jwgl.analysis_extend(jmodels.cas_register(), _prefix(jops, 0.7),
                         store_path=jp, stride=64)
    pwgl.analysis_extend(pmodels.cas_register(), _prefix(pops, 0.7),
                         store_path=pp, stride=64, device="cpu")
    assert pckpt.read(pp) == jckpt.read(jp)
    assert pp.read_bytes() == jp.read_bytes()

    ptel.reset()
    by_port = pwgl.analysis_extend(pmodels.cas_register(), pops,
                                   store_path=jp, stride=64, certify=True,
                                   device="cpu")
    port_reused = _pcounters().get("ckpt.extend.reused-masks")
    jtel.reset()
    by_jax = jwgl.analysis_extend(jmodels.cas_register(), jops,
                                  store_path=pp, stride=64, certify=True)
    jax_reused = jtel.get().counters().get("ckpt.extend.reused-masks")
    assert port_reused == jax_reused and port_reused >= 1
    assert _norm(by_port) == _as_jax(by_jax)
    assert by_port["valid?"] is (not corrupt)
    # each wrote the grown record back over the other's: still equal
    assert pckpt.read(jp) == jckpt.read(pp)


def test_frontier_log_cross_packages(tmp_path):
    """A frontier log (check_segmented's checkpoint_path) written by JAX
    is loaded whole by the port, which then launches nothing, and the
    other way round; both logs are the same bytes."""
    jops, pops = _hists(13, 3000)
    jenc = jencode.encode(jmodels.cas_register(), JHistory(jops))
    penc = pencode.encode(pmodels.cas_register(), PHistory(pops))
    jp, pp = tmp_path / "jax.jlog", tmp_path / "port.jlog"
    want = jwgl.check_segmented(jenc, target_len=256, checkpoint_path=jp)
    got = pwgl.check_segmented(penc, target_len=256, checkpoint_path=pp,
                               device="cpu")
    assert _norm(got) == _norm(want)
    assert pp.read_bytes() == jp.read_bytes()
    saved = sum(1 for _ in pfmt._scan_path(pp))
    ptel.reset()
    again = pwgl.check_segmented(penc, target_len=256, checkpoint_path=jp,
                                 device="cpu")
    c = _pcounters()
    assert again == got
    assert c.get("wgl.checkpoint.loaded") == saved
    assert "wgl.kernel.launches" not in c
    jtel.reset()
    jagain = jwgl.check_segmented(jenc, target_len=256, checkpoint_path=pp)
    assert _norm(jagain) == _norm(want)
    assert jtel.get().counters().get("wgl.checkpoint.loaded") == saved


# ---------------------------------------------------------------------------
# the resumable segmented check
# ---------------------------------------------------------------------------

def _counting_launches(monkeypatch):
    calls = []
    real = pwgl._launch

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(pwgl, "_launch", counted)
    return calls


@pytest.mark.parametrize("where", ["checkpoint_path", "checkpoint_dir"])
@pytest.mark.parametrize("corrupt", [False, True],
                         ids=["valid", "invalid"])
def test_second_checkpointed_run_launches_nothing(tmp_path, monkeypatch,
                                                  where, corrupt):
    """The second run loads every mask the first saved and makes no
    launch (of the wrapper or of the kernel); the results are equal, and
    equal to an unchecked run's. checkpoint_dir names the file by the
    fingerprint, as JAX does."""
    _, pops = _hists(14, 1500, corrupt=corrupt)
    enc = pencode.encode(pmodels.cas_register(), PHistory(pops))
    arg = (tmp_path / "f.jlog" if where == "checkpoint_path"
           else tmp_path / "frontier")
    plain = pwgl.check_segmented(enc, target_len=128, device="cpu")
    calls = _counting_launches(monkeypatch)
    ptel.reset()
    first = pwgl.check_segmented(enc, target_len=128, device="cpu",
                                 **{where: arg})
    saved = _pcounters().get("wgl.checkpoint.saved", 0)
    assert first == plain and calls and saved >= 1
    if where == "checkpoint_dir":
        cuts = pwgl.segment_cuts(enc, 128)
        fp = pwgl._SegmentCheckpoint.fingerprint_of(enc, cuts)
        assert [p.name for p in arg.iterdir()] == [
            f"frontier-{fp & 0xffffffff:08x}.jlog"]
    calls.clear()
    before = kws.launches
    ptel.reset()
    second = pwgl.check_segmented(enc, target_len=128, device="cpu",
                                  **{where: arg})
    c = _pcounters()
    assert second == first
    assert calls == [] and kws.launches == before
    assert c.get("wgl.checkpoint.loaded") == saved
    assert "wgl.checkpoint.saved" not in c


def test_frontier_log_of_other_data_is_restarted(tmp_path):
    """A log of another history is ignored (its fingerprint differs)
    and rewritten; a torn tail is truncated before the next append."""
    _, a = _hists(15, 1500)
    _, b = _hists(16, 1500)
    ea = pencode.encode(pmodels.cas_register(), PHistory(a))
    eb = pencode.encode(pmodels.cas_register(), PHistory(b))
    p = tmp_path / "f.jlog"
    pwgl.check_segmented(ea, target_len=128, device="cpu",
                         checkpoint_path=p)
    ptel.reset()
    out = pwgl.check_segmented(eb, target_len=128, device="cpu",
                               checkpoint_path=p)
    assert out == pwgl.check_segmented(eb, target_len=128, device="cpu")
    assert "wgl.checkpoint.loaded" not in _pcounters()
    saved = sum(1 for _ in pfmt._scan_path(p))
    assert saved == _pcounters()["wgl.checkpoint.saved"]
    # tear the last record: the intact ones still load, and the next
    # check appends after them
    data = p.read_bytes()
    p.write_bytes(data[:-3])
    ptel.reset()
    again = pwgl.check_segmented(eb, target_len=128, device="cpu",
                                 checkpoint_path=p)
    assert again == out
    assert _pcounters()["wgl.checkpoint.loaded"] == saved - 1
    assert sum(1 for _ in pfmt._scan_path(p)) == saved


def test_analysis_checkpoint_dir_matches_jax(tmp_path):
    jops, pops = _hists(17, 5500, corrupt=True)
    got = pwgl.analysis(pmodels.cas_register(), pops, certify=True,
                        device="cpu", checkpoint_dir=tmp_path / "p")
    want = jwgl.analysis(jmodels.cas_register(), jops, certify=True,
                         checkpoint_dir=tmp_path / "j")
    assert _norm(got) == _as_jax(want)
    assert sorted(x.name for x in (tmp_path / "p").iterdir()) == \
        sorted(x.name for x in (tmp_path / "j").iterdir())
    ptel.reset()
    again = pwgl.analysis(pmodels.cas_register(), pops, certify=True,
                          device="cpu", checkpoint_dir=tmp_path / "j")
    assert again == got
    assert _pcounters().get("wgl.checkpoint.loaded", 0) >= 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_cuda_resumed_segmented_check_launches_no_kernel(cuda_device,
                                                         tmp_path):
    _, pops = _hists(14, 3000)
    enc = pencode.encode(pmodels.cas_register(), PHistory(pops))
    first = pwgl.check_segmented(enc, target_len=256, device=cuda_device,
                                 checkpoint_dir=tmp_path)
    before = kws.launches
    assert pwgl.check_segmented(enc, target_len=256, device=cuda_device,
                                checkpoint_dir=tmp_path) == first
    assert kws.launches == before


# ---------------------------------------------------------------------------
# StreamingElle
# ---------------------------------------------------------------------------

def _la_ops(make, *pairs):
    """Sequential invoke/ok list-append txn pairs."""
    out = []
    for p, inv, okv in pairs:
        out.append(make(index=len(out), time=len(out), type="invoke",
                        process=p, f="txn", value=inv))
        out.append(make(index=len(out), time=len(out), type="ok",
                        process=p, f="txn", value=okv))
    return out


def _settled(stream, timeout_s=60.0):
    import time

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with stream._lock:
            if not stream._inflight:
                return
        time.sleep(0.01)
    raise AssertionError("stream never settled")


def _drive(cls, make, family, *batches, sink=None):
    se = cls(family, "t", "r")
    se.ckpt_sink = sink
    for pairs in batches:
        se.add_ops(_la_ops(make, *pairs))
        se.step()
        _settled(se)
    return se


VALID_STREAM = (
    (0, [["append", "x", 1]], [["append", "x", 1]]),
    (1, [["r", "x", None]], [["r", "x", [1]]]),
    (0, [["append", "x", 2]], [["append", "x", 2]]),
    (1, [["r", "x", None]], [["r", "x", [1, 2]]]))


def test_streaming_elle_checkpoints_and_reseeds():
    """The port's stream emits the JAX stream's elle record, and a
    stream seeded from it (of either package) resumes; a record of
    another stream is stale."""
    ptel.reset()
    precs, jrecs = [], []
    se = _drive(pelle.StreamingElle, pop, "list-append", VALID_STREAM,
                sink=precs.append)
    _drive(jelle.StreamingElle, jop, "list-append", VALID_STREAM,
           sink=jrecs.append)
    assert se.status()["state"] == "streaming"
    assert precs and precs == jrecs
    rec = precs[-1]
    pckpt.validate_record(rec)
    assert rec["kind"] == "elle" and rec["n_closed"] == 4
    ops = _la_ops(pop, *VALID_STREAM)
    se2 = pelle.StreamingElle("list-append", "t", "r2")
    assert se2.seed(ops, rec) is True
    assert se2._n_closed == 4
    assert _pcounters().get("ckpt.resumed") == 1
    je = jelle.StreamingElle("list-append", "t", "r2")
    assert je.seed(_la_ops(jop, *VALID_STREAM), rec) is True
    se3 = pelle.StreamingElle("list-append", "t", "r3")
    assert se3.seed(ops, dict(rec, digest="0" * 64)) is False
    assert se3._n_closed == 0
    assert _pcounters().get("ckpt.stale") == 1


def test_streaming_elle_anomaly_tightens_to_tentative_invalid():
    # G0: opposite append orders observed on x and y
    g0 = ((0, [["append", "x", 1], ["append", "y", 1]],
           [["append", "x", 1], ["append", "y", 1]]),
          (1, [["append", "x", 2], ["append", "y", 2]],
           [["append", "x", 2], ["append", "y", 2]]),
          (2, [["r", "x", None], ["r", "y", None]],
           [["r", "x", [1, 2]], ["r", "y", [2, 1]]]))
    se = _drive(pelle.StreamingElle, pop, "list-append", g0)
    assert se.status()["state"] == "tentative-invalid"
    je = _drive(jelle.StreamingElle, jop, "list-append", g0)
    assert se.status() == je.status()


def test_streaming_elle_spine_reorder_reports_unknown():
    """A longer read that rewrites an already-consumed version order:
    the stream stops tightening and says so."""
    first = ((0, [["append", "x", 1]], [["append", "x", 1]]),
             (1, [["r", "x", None]], [["r", "x", [1]]]))
    second = ((0, [["append", "x", 2]], [["append", "x", 2]]),
              (1, [["r", "x", None]], [["r", "x", [2, 1]]]))
    se = _drive(pelle.StreamingElle, pop, "list-append", first)
    assert se.status()["state"] == "streaming"
    se.add_ops(_la_ops(pop, *second))
    se.step()
    _settled(se)
    assert se.status()["state"] == "unknown"


def test_streaming_elle_other_families_degrade_honestly():
    se = pelle.StreamingElle("rw-register", "t", "r")
    assert se.status()["state"] == "unsupported"
    rec = {"v": pckpt.VERSION, "kind": "elle", "n_ops": 0,
           "digest": "0" * 64, "family": "rw-register", "n_closed": 0,
           "versions": {}, "frontier": {}}
    assert se.seed([], rec) is False
    assert se.status() == jelle.StreamingElle("rw-register").status()


# ---------------------------------------------------------------------------
# the checker's extend? and checkpoint? keys
# ---------------------------------------------------------------------------

def test_linearizable_check_extend_matches_jax(tmp_path):
    """extend? checks through analysis_extend, under the JAX package's
    file name for this run and model; checking the grown run again
    reuses the stored frontier."""
    jops, pops = _hists(31, 3000)
    pc = pchecker.linearizable({"model": pmodels.cas_register(),
                                "device": "cpu"})
    jc = jchecker.linearizable({"model": jmodels.cas_register()})
    ptest = {"store_dir": str(tmp_path / "p"), "extend?": True}
    jtest = {"store_dir": str(tmp_path / "j"), "extend?": True}
    pc.check(ptest, PHistory(_prefix(pops, 0.8)))
    jc.check(jtest, JHistory(_prefix(jops, 0.8)))
    assert sorted(x.name for x in (tmp_path / "p" / "ckpt").iterdir()) \
        == sorted(x.name for x in (tmp_path / "j" / "ckpt").iterdir())
    ptel.reset()
    got = pc.check(ptest, PHistory(pops))
    assert _pcounters().get("ckpt.extend.resumed") == 1
    want = jc.check(jtest, JHistory(jops))
    assert got["analyzer"] == "gpu-extend"
    assert _norm(got) == _as_jax(want)
    pcertify.validate(PHistory(pops), got["certificate"])


def test_linearizable_check_checkpoint_matches_jax(tmp_path):
    jops, pops = _hists(32, 5500)
    pc = pchecker.linearizable({"model": pmodels.cas_register(),
                                "device": "cpu"})
    jc = jchecker.linearizable({"model": jmodels.cas_register()})
    ptest = {"store_dir": str(tmp_path / "p"), "checkpoint?": True}
    got = pc.check(ptest, PHistory(pops))
    want = jc.check({"store_dir": str(tmp_path / "j"),
                     "checkpoint?": True}, JHistory(jops))
    assert _norm(got) == _as_jax(want)
    frontier = tmp_path / "p" / "checker-frontier"
    assert sorted(x.name for x in frontier.iterdir()) == sorted(
        x.name for x in (tmp_path / "j" / "checker-frontier").iterdir())
    ptel.reset()
    assert pc.check(ptest, PHistory(pops)) == got
    assert _pcounters().get("wgl.checkpoint.loaded", 0) >= 1
    # without a store directory the keys change nothing
    assert pc.check({"extend?": True, "checkpoint?": True},
                    PHistory(pops)) == got
