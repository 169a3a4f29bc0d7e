"""The port's fleet flight recorder (fleet/flightrec.py) against the JAX
package's.

- Each package's validators accept the other's latency blocks, records
  and Prometheus text, and reject the same malformed ones.
- The same hook calls give the same snapshots, records and Prometheus
  exposition; a snapshot saved by either package folds into the other.
- kernel_phases: the JAX package reads the profiler's `kernel:` spans,
  which the port does not write (its profiler is ROADMAP A5). The
  port's copy prices device time from its kernels' own telemetry: the
  device_ms of each `wgl:drain` and `scc:device` span (the kernel's
  time between the CUDA events its launcher records), of the calling
  thread only. On the CPU no CUDA event exists, so the device share of
  a real CPU launch is 0, as the JAX function's is with no device
  record in the window.
"""

from __future__ import annotations

import importlib
import threading
import time

import pytest

ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")


def fr(root):
    return importlib.import_module(f"{root}.fleet.flightrec")


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


J, T = fr("jepsen_tpu"), fr("jepsen_tpu_torch")


class _Item:
    def __init__(self, tenant):
        self.tenant = tenant


def test_schema_constants_equal():
    for name in ("LATENCY_KEYS", "REASONS", "CLASSES", "RECORD_KINDS",
                 "QUARANTINE_ACTIONS", "QS", "SNAPSHOT_FILE",
                 "MAX_RECORDS"):
        assert getattr(J, name) == getattr(T, name), name


BLOCKS = [
    {},
    {"ingest_wait_ms": 5.0, "wal_fsync_ms": 1.0, "queue_wait_ms": 2.0,
     "batching_delay_ms": 0.5, "encode_ms": 3.0, "device_ms": 10.0,
     "certify_ms": 1.5, "serialize_ms": 0.25},
    {"encode_ms": -0.4, "device_ms": 1.0004},
    {"replay": True},
]


@pytest.mark.parametrize("kw", BLOCKS, ids=range(len(BLOCKS)))
def test_latency_blocks_equal_and_validated_across(kw):
    a, b = J.latency_block(**kw), T.latency_block(**kw)
    assert a == b
    J.validate_latency(b)
    T.validate_latency(a)
    assert J.dominant_slice(a) == T.dominant_slice(b)
    assert J.replay_block() == T.replay_block()


BAD_BLOCKS = [
    None, {}, {"extra": 1.0}, {"device": -1.0}, {"device": "1"},
    {"replay": False}, {"total_ms": True},
]


@pytest.mark.parametrize("i", range(len(BAD_BLOCKS)))
def test_validate_latency_rejects_the_same(i):
    bad = BAD_BLOCKS[i]
    if isinstance(bad, dict) and bad:
        bad = dict(J.latency_block(), **bad)
    for m in (J, T):
        with pytest.raises(ValueError):
            m.validate_latency(bad)


def drive(m):
    """The same hook calls on one package's recorder."""
    rec = m.FlightRecorder()
    ms = 1_000_000
    t0 = m.now()
    rec.chunk("a", "r", 1, t0, t0 + 2 * ms, ms, 10, client_t=t0 - ms,
              trace="abc")
    rec.chunk("a", "r", 2, t0, t0 + ms, 500, 10, client_t=1)
    rec.chunk("b", "r", 1, t0, t0 + 3 * ms, 2 * ms, 7)
    rec.launch("slice", "full", 0, 10 * ms, 64, 64, [_Item("a")])
    rec.launch("slice", "timeout", 25 * ms, 30 * ms, 8, 64,
               [_Item("a"), _Item("b")], device_ms=1.25)
    rec.launch("final", "drain", 40 * ms, 50 * ms, 3, 64,
               [_Item("a"), _Item("a"), _Item("b")], certify_ms=2.0)
    rec.launch("final", "quarantine", 60 * ms, 70 * ms, 1, 64,
               [_Item("b")])
    rec.quarantine("b", "r", "quarantined", "RuntimeError('x')")
    rec.quarantine("b", "r", "released", "")
    for i in range(12):
        rec.verdict("a" if i % 3 else "b", f"r{i}", 0, (i + 1) * ms,
                    m.latency_block(device_ms=i))
    return rec


def strip_times(recs):
    """Records without their clock stamps (now() differs between the two
    runs) and the quarantine events' t0/t1."""
    return [{k: v for k, v in r.items() if k not in ("t0", "t1")}
            for r in recs]


def test_recorder_snapshots_and_records_equal_and_validated_across():
    a, b = drive(J), drive(T)
    assert a.snapshot() == b.snapshot()
    assert strip_times(a.records()) == strip_times(b.records())
    assert J.validate_records(b.records()) == T.validate_records(
        a.records()) == len(a.records())
    off = [m.FlightRecorder(enabled=False) for m in (J, T)]
    for r in off:
        r.chunk("t", "r", 1, 0, 10, 5, 3)
        r.verdict("t", "r", 0, 10, T.latency_block())
    assert [r.snapshot() for r in off] == [{"enabled": False}] * 2


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J)],
                         ids=["jax-saved", "port-saved"])
def test_snapshot_file_folds_across(tmp_path, writer, reader):
    p = tmp_path / writer.SNAPSHOT_FILE
    src = drive(writer)
    src.save(p)
    dst = reader.FlightRecorder()
    assert dst.load(p) is True
    assert dst.snapshot() == src.snapshot()
    dst.load(p)
    assert dst.snapshot()["verdicts"] == 2 * src.snapshot()["verdicts"]
    torn = tmp_path / "torn.json"
    torn.write_text('{"verdicts": 3, "verdict_ms": {"co')
    assert reader.FlightRecorder().load(torn) is False


BAD_RECORDS = [
    {"kind": "nope", "t0": 0, "t1": 1},
    {"kind": "chunk", "tenant": "t", "run": "r", "seq": 0, "t0": 0,
     "t1": 1, "wal_ms": 0, "ack_ms": 0},
    {"kind": "chunk", "tenant": "t", "run": "r", "seq": 1, "t0": 5,
     "t1": 4, "wal_ms": 0, "ack_ms": 0},
    {"kind": "launch", "cls": "warmup", "reason": "full", "t0": 0,
     "t1": 1, "rows": 1, "capacity": 1, "occupancy": 1, "tenants": []},
    {"kind": "launch", "cls": "final", "reason": "full", "t0": 0,
     "t1": 1, "rows": 1, "capacity": 1, "occupancy": 1.5, "tenants": []},
    {"kind": "verdict", "tenant": "t", "run": "r", "t0": 0, "t1": 1,
     "latency": None},
    {"kind": "quarantine", "tenant": "t", "run": "r", "error": "",
     "action": "maybe", "t0": 0, "t1": 0},
]


@pytest.mark.parametrize("i", range(len(BAD_RECORDS)))
def test_validate_records_rejects_the_same(i):
    for m in (J, T):
        with pytest.raises(ValueError):
            m.validate_records([BAD_RECORDS[i]])
    dup = [{"kind": "chunk", "tenant": "t", "run": "r", "seq": 3,
            "t0": 0, "t1": 1, "wal_ms": 0, "ack_ms": 0}] * 2
    for m in (J, T):
        with pytest.raises(ValueError, match="duplicate chunk"):
            m.validate_records(dup)


def stats_fixture(m):
    rec = drive(m)
    return {"accepted": 3, "rejected": 1, "chunks": 3, "ops": 27,
            "verdicts": 12, "recovered": 0, "frame_errors": 0,
            "runs": 2, "active_streams": 1, "wal_sheds": 0,
            "tenants": {"a": {"streams": 1, "chunks": 2, "ops": 20,
                              "verdicts": 8, "rejected": 0},
                        "b": {"streams": 1, "chunks": 1, "ops": 7,
                              "verdicts": 4, "rejected": 1}},
            "scheduler": {"launches": 4, "slice_launches": 2,
                          "final_launches": 2, "items": 9,
                          "slice_rows": 72, "final_hists": 4,
                          "cross_tenant_launches": 2, "pending": 0,
                          "quarantine_items": 1, "bisect_launches": 2,
                          "quarantine": [{"tenant": "b", "run": "r"}]},
            "flightrec": rec.snapshot()}


def test_prometheus_text_equal_and_validated_across():
    a = mod("jepsen_tpu", "fleet.server").prometheus_from_stats(
        stats_fixture(J))
    b = mod("jepsen_tpu_torch", "fleet.server").prometheus_from_stats(
        stats_fixture(T))
    assert a == b
    assert J.validate_prometheus(b) == T.validate_prometheus(a) > 20
    assert 'jepsen_fleet_tenant_ops{tenant="a"} 20' in b
    for m in (J, T):
        with pytest.raises(ValueError):
            m.validate_prometheus("jepsen bad line\n")
        with pytest.raises(ValueError):
            m.validate_prometheus("jepsen_fleet_x{tenant=unquoted} 1\n")


# ---------------------------------------------------------------------------
# kernel_phases: the port's device share
# ---------------------------------------------------------------------------

def test_kernel_phases_reads_the_ports_kernel_telemetry():
    telemetry = mod("jepsen_tpu_torch", "telemetry")
    util = mod("jepsen_tpu_torch", "util")
    telemetry.reset()
    try:
        r0 = util.relative_time_nanos()
        # a drained wgl launch with its CUDA-event kernel time, one on
        # the CPU (device_ms None), scc launches on the card and on
        # the CPU, a certificate, a span the recorder ignores, and
        # another thread's launches in the same window
        with telemetry.span("wgl:drain") as rec:
            rec["attrs"] = {"rows": 4, "device_ms": 1.5}
        with telemetry.span("wgl:drain") as rec:
            rec["attrs"] = {"rows": 4, "device_ms": None}
        with telemetry.span("scc:device") as rec:
            rec["attrs"] = {"device": "cuda", "device_ms": 0.25}
        with telemetry.span("scc:device") as rec:
            rec["attrs"] = {"device": "cpu", "device_ms": None}
        with telemetry.span("certify.attach"):
            pass
        with telemetry.span("kernel:from-the-jax-profiler"):
            pass

        def other():
            for name in ("wgl:drain", "scc:device"):
                with telemetry.span(name) as rec:
                    rec["attrs"] = {"device_ms": 100.0}
            with telemetry.span("certify.attach"):
                time.sleep(0.01)

        t = threading.Thread(target=other, name="another-launcher")
        t.start()
        t.join()
        r1 = util.relative_time_nanos()
        device, cert = T.kernel_phases(r0, r1)
        assert device == pytest.approx(1.75)
        assert 0 < cert < 10
        assert T.kernel_phases(r1 + 10, r1 + 20) == (0.0, 0.0)
    finally:
        telemetry.reset()


def test_kernel_phases_of_a_cpu_launch_is_host_time():
    """A real check_slices launch on the CPU, and a scc() over enough
    edges to take the device path with its plain version: no CUDA event,
    so the whole launch stays in the encode (host) share."""
    telemetry = mod("jepsen_tpu_torch", "telemetry")
    util = mod("jepsen_tpu_torch", "util")
    synth = mod("jepsen_tpu_torch", "gpu.synth")
    wgl = mod("jepsen_tpu_torch", "gpu.wgl")
    scc = mod("jepsen_tpu_torch", "gpu.scc")
    models = mod("jepsen_tpu_torch", "checker.models")
    encode = mod("jepsen_tpu_torch", "gpu.encode").encode
    import numpy as np

    telemetry.reset()
    try:
        enc = encode(models.cas_register(),
                     synth.register_history(100, seed=3))
        r0 = util.relative_time_nanos()
        wgl.check_slices([(enc, s) for s in range(enc.n_states)],
                         device="cpu")
        n = scc.DEVICE_MIN_EDGES + 10
        src = np.arange(n, dtype=np.int32)
        scc.scc(n, src, (src + 1) % n, device="cpu")
        r1 = util.relative_time_nanos()
        names = {s["name"] for s in telemetry.get().events()}
        assert {"wgl:drain", "scc:device"} <= names
        assert T.kernel_phases(r0, r1) == (0.0, 0.0)
    finally:
        telemetry.reset()


def test_kernel_timing_events_are_refused_on_the_cpu():
    """The wrappers' `events` (recorded by the launcher just around the
    kernel, which kernel_phases reads) time a launch on the card only."""
    import torch

    ws = mod("jepsen_tpu_torch", "gpu.kernels.wgl_search")
    kscc = mod("jepsen_tpu_torch", "gpu.kernels.scc")
    wgl = mod("jepsen_tpu_torch", "gpu.wgl")
    synth = mod("jepsen_tpu_torch", "gpu.synth")
    models = mod("jepsen_tpu_torch", "checker.models")
    encode = mod("jepsen_tpu_torch", "gpu.encode").encode
    pb = wgl.PackedBatch([encode(models.cas_register(),
                                 synth.register_history(20, seed=1))])
    packed, rs, s0 = pb.tensors(*pb.rows([(0, 0)]), torch.device("cpu"))
    with pytest.raises(ValueError, match="events time a launch"):
        ws.wgl_search(packed, rs, s0, W=8, F=8, max_iters=pb.M + 4,
                      events=(object(), object()))
    src = torch.tensor([0, 1], dtype=torch.int32)
    on = torch.ones(2, dtype=torch.bool)
    for fn in (kscc.scc_labels, kscc.scc_labels_to_convergence):
        with pytest.raises(ValueError, match="events time a launch"):
            fn(src, src.flip(0).contiguous(), on, 2,
               events=(object(), object()))


def test_scheduler_stamps_the_launch_split_on_the_cpu():
    """The scheduler's per-item stamp sheet on a CPU launch: the device
    share is 0 and the launch wall is the encode share."""
    fs = mod("jepsen_tpu_torch", "fleet.scheduler")
    synth = mod("jepsen_tpu_torch", "gpu.synth")
    rec = T.FlightRecorder()
    s = fs.Scheduler(flightrec=rec, device="cpu")
    items = [s.submit("final", t, "r", {"engine": "wgl",
                                        "model": "cas-register",
                                        "history": synth.register_history(
                                            80, seed=i)})
             for i, t in enumerate(("a", "b"))]
    with s._lock:
        batch = s._drain_fair_locked()
    s._run_batch(batch)
    for i in items:
        assert i.result["valid?"] is True
        assert i.times["device_ms"] == 0.0
        assert i.times["encode_ms"] > 0
    launch = [r for r in rec.records() if r["kind"] == "launch"]
    assert [(r["cls"], r["tenants"], r["device_ms"]) for r in launch] == \
        [("final", ["a", "b"], 0.0)]
    J.validate_records(rec.records())
