"""The port's fleet (fleet/) against the JAX package's.

- Wire frames are byte-equal and each package decodes the other's.
- WAL records are byte-equal; each package replays, compacts and scans
  the other's journals.
- The same valid and corrupted runs through both servers leave verdict
  files equal byte for byte but for one key: `analyzer`, where the JAX
  package names its device "tpu" and the port "gpu" (the earlier
  slices' tests read the JAX names the same way). Each package's
  certify.validate accepts the other's certificates.
- The scheduler's fair drain, its breaker and its quarantine
  attribution under an injected check_slices / analysis_batch_streamed
  failure, the streaming masks chunk for chunk, the quota rejections, a
  kill() and restart, a JAX server's WAL directory recovered by the
  port's server, seeded chaos transports and core.run's fleet stream
  behave as the JAX package's.
- On the card the port answers no failed launch by a host search: a
  quarantined run's items and the open breaker's finals finish with an
  error (the JAX package, and the port on the CPU, search them on the
  host). Those tests give a port scheduler the card as its device and
  fake its launches on the CPU.
- chip_smoke's phase 22 passes every check on the CPU at a small size.

The port runs with device="cpu" throughout, but for those card-lane
tests (the kernels' plain versions); both packages' net._ip_cache are
cleared around each test.
"""

from __future__ import annotations

import importlib
import json
import os
import random
import re
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")
PORT = "jepsen_tpu_torch"


class Pkg:
    """One package's modules by their shared names (`g` maps the JAX
    package's tpu/ to the port's gpu/)."""

    def __init__(self, root: str):
        self.root = root
        self.port = root == PORT
        # the port's entry points run on the card unless told otherwise
        self.dev = {"device": "cpu"} if self.port else {}

    def m(self, name: str):
        return importlib.import_module(f"{self.root}.{name}")

    def g(self, name: str):
        return self.m(("gpu." if self.port else "tpu.") + name)

    def server(self, base, **kw):
        return self.m("fleet.server").FleetServer(base, **kw, **self.dev)

    def scheduler(self, **kw):
        return self.m("fleet.scheduler").Scheduler(**kw, **self.dev)

    def hist(self, seed, n=300, corrupt=False, at_frac=0.85):
        synth = self.g("synth")
        h = synth.register_history(n, seed=seed)
        if corrupt:
            h, _ = synth.corrupt_register_history(h, at_frac=at_frac)
        return h


JAX, TORCH = Pkg("jepsen_tpu"), Pkg(PORT)
PKGS = (JAX, TORCH)


@pytest.fixture(autouse=True)
def clear_ip_caches():
    """core.run resolves node addresses through each package's net
    module, which memoizes them at module level: clear both caches
    before and after every test."""
    for p in PKGS:
        p.m("net").clear_ip_cache()
    yield
    for p in PKGS:
        p.m("net").clear_ip_cache()


_ANALYZER = re.compile(rb'"analyzer":"tpu')


def port_names(b: bytes) -> bytes:
    """A JAX verdict file's bytes with its analyzer names in the port's
    terms ("tpu..." -> "gpu...")."""
    return _ANALYZER.sub(b'"analyzer":"gpu', b)


def stream(p: Pkg, addr, tenant, run, hist, chunk=50, transport=None,
           io_timeout_s=3.0, deadline_s=120.0, model="cas-register"):
    """Streams a history and returns the verdict envelope, retrying whole
    chunks across server restarts."""
    fc = p.m("fleet.client")
    c = fc.FleetClient(addr, tenant, run, model=model,
                       transport=transport, io_timeout_s=io_timeout_s)
    ops = list(hist)
    deadline = time.monotonic() + deadline_s
    i = 0
    while i < len(ops):
        try:
            c.send_chunk(ops[i:i + chunk])
            i += chunk
        except fc.FleetError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    env = c.finish(timeout_s=deadline_s)
    c.close()
    return env


def cert_bytes(p: Pkg, cert) -> bytes:
    return json.dumps(p.m("store.format").jsonable(cert),
                      sort_keys=True).encode()


def validate_both(hist_j, hist_t, cert) -> None:
    """Both packages' validators accept the certificate, each against its
    own package's copy of the history."""
    JAX.g("certify").validate(hist_j, cert)
    TORCH.g("certify").validate(hist_t, cert)


def solo(p: Pkg, h):
    return p.g("wgl").analysis(p.m("checker.models").cas_register(), h,
                               certify=True, **p.dev)


# ---------------------------------------------------------------------------
# wire.py
# ---------------------------------------------------------------------------

MSGS = [
    {"type": "hello", "tenant": "t", "run": "r", "model": "cas-register",
     "weight": 1.0},
    {"type": "hello", "tenant": "t", "run": "r", "model": "register",
     "weight": 2, "initial": 0},
    {"type": "chunk", "seq": 3, "ops": [{"f": "read", "value": None}],
     "tc": {"t": 123456789}},
    {"type": "fin", "chunks": 9},
    {"type": "ack", "seq": 4, "resync": True},
    {"type": "reject", "reason": "tenant quota saturated (8 tenants)",
     "retry_after": 2.0},
    {"type": "verdict", "result": {"valid?": True, "n": [1, 2, 3]}},
    {"type": "status"}, {"type": "claim"},
]


@pytest.mark.parametrize("msg", MSGS, ids=lambda m: m["type"])
def test_wire_frames_byte_equal(msg):
    jw, tw = JAX.m("fleet.wire"), TORCH.m("fleet.wire")
    assert jw.frame_msg(msg) == tw.frame_msg(msg)
    assert (jw.MAGIC, jw.MAX_FRAME) == (tw.MAGIC, tw.MAX_FRAME)


@pytest.mark.parametrize("sender,receiver", [(JAX, TORCH), (TORCH, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_wire_decoded_across(sender, receiver):
    a, b = socket.socketpair()
    try:
        sender.m("fleet.wire").send_magic(a)
        receiver.m("fleet.wire").recv_magic(b)
        for msg in MSGS:
            sender.m("fleet.wire").send_msg(a, msg)
            assert receiver.m("fleet.wire").recv_msg(b) == msg
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("p", PKGS, ids=ROOTS)
def test_wire_errors(p):
    wire = p.m("fleet.wire")
    a, b = socket.socketpair()
    try:
        buf = bytearray(wire.frame_msg({"type": "fin"}))
        buf[-1] ^= 0xFF
        a.sendall(bytes(buf))
        with pytest.raises(wire.FrameError, match="CRC"):
            wire.recv_msg(b)
        whole = wire.frame_msg({"type": "fin", "chunks": 9})
        a.sendall(whole[:len(whole) // 2])
        a.close()
        with pytest.raises(wire.FrameError, match="closed mid-frame"):
            wire.recv_msg(b)
    finally:
        b.close()
    with pytest.raises(ValueError, match="lower chunk_ops"):
        wire.frame_msg({"type": "chunk", "ops": "x" * (wire.MAX_FRAME + 1)})


def test_ops_wire_equal_and_read_across():
    hj, ht = JAX.hist(11, 120), TORCH.hist(11, 120)
    wj = JAX.m("fleet.wire").ops_to_wire(list(hj))
    wt = TORCH.m("fleet.wire").ops_to_wire(list(ht))
    assert json.dumps(wj) == json.dumps(wt)
    back_t = TORCH.m("fleet.wire").ops_from_wire(wj)
    back_j = JAX.m("fleet.wire").ops_from_wire(wt)
    assert [o.to_dict() for o in back_t] == [o.to_dict() for o in ht]
    assert [o.to_dict() for o in back_j] == [o.to_dict() for o in hj]


# ---------------------------------------------------------------------------
# wal.py
# ---------------------------------------------------------------------------

def write_wal(p: Pkg, path, ops_wire, chunk=40, fin=True, dup=None,
              gap=False):
    w = p.m("fleet.wal").RunWAL(path)
    w.append({"t": "hello", "tenant": "t", "run": "r",
              "model": "cas-register", "weight": 1.0})
    chunks = [ops_wire[i:i + chunk] for i in range(0, len(ops_wire),
                                                   chunk)]
    for seq, ch in enumerate(chunks, 1):
        if gap and seq == 3:
            continue
        w.append({"t": "chunk", "seq": seq, "ops": ch})
        if dup == seq:
            w.append({"t": "chunk", "seq": seq, "ops": ch[:1]})
    if fin:
        w.append({"t": "fin", "chunks": len(chunks)})
    w.close()
    return len(chunks)


def test_wal_records_byte_equal(tmp_path):
    ops = TORCH.m("fleet.wire").ops_to_wire(list(TORCH.hist(5, 150)))
    for p in PKGS:
        write_wal(p, tmp_path / p.root / "r.wal", ops, dup=2)
    assert (tmp_path / "jepsen_tpu" / "r.wal").read_bytes() == \
        (tmp_path / PORT / "r.wal").read_bytes()


@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)],
                         ids=["jax-written", "port-written"])
@pytest.mark.parametrize("shape", ["clean", "dup", "gap", "torn",
                                   "no-fin"])
def test_wal_replay_compact_scan_across(tmp_path, writer, reader, shape):
    ops = writer.m("fleet.wire").ops_to_wire(list(writer.hist(6, 150)))
    base = tmp_path / "base"
    path = writer.m("fleet.wal").wal_path(base, "t", "r")
    write_wal(writer, path, ops, dup=2 if shape == "dup" else None,
              gap=shape == "gap", fin=shape != "no-fin")
    if shape == "torn":
        buf = path.read_bytes()
        path.write_bytes(buf[:-7])
    rw, ww = reader.m("fleet.wal"), writer.m("fleet.wal")
    got, want = rw.replay(path), ww.replay(path)
    assert got == want
    assert [o.to_dict() for o in rw.replay_ops(got)] == \
        [o.to_dict() for o in ww.replay_ops(want)]
    assert rw.scan_runs(base) == ww.scan_runs(base)
    # compaction: the reader compacts the writer's journal, and the
    # writer's compaction of a copy gives the same bytes
    copy = tmp_path / "copy.wal"
    copy.write_bytes(path.read_bytes())
    through = max(want["last_seq"] - 1, 0)
    assert rw.compact(path, through) == ww.compact(copy, through)
    assert path.read_bytes() == copy.read_bytes()
    assert ww.replay_ops(ww.replay(path)) and [
        o.to_dict() for o in ww.replay_ops(ww.replay(path))] == [
        o.to_dict() for o in rw.replay_ops(got)]


def test_wal_names_and_verdict_bytes():
    names = ["t", "a.b-c_d", "", ".hidden", "../evil", "x" * 128,
             "x" * 129, "sp ace", 7, "ok9"]
    assert [JAX.m("fleet.wal").safe_name(n) for n in names] == \
        [TORCH.m("fleet.wal").safe_name(n) for n in names]
    v = {"tenant": "t", "run": "r", "model": "cas-register", "n_ops": 3,
         "result": {"valid?": True, "z": [3, 1], "a": {"b": None}}}
    assert JAX.m("fleet.wal").verdict_bytes(v) == \
        TORCH.m("fleet.wal").verdict_bytes(v)
    s = {"valid?": False, "set": {3, 1, 2}, "t": (1, 2)}
    assert JAX.m("fleet.wal").json_safe(s) == \
        TORCH.m("fleet.wal").json_safe(s)


def test_wal_fault_hook_sheds(tmp_path):
    """An injected ENOSPC on the WAL sheds the chunk with retry-after in
    both packages: nothing is acked that was not journaled."""
    out = []
    for p in PKGS:
        wal = p.m("fleet.wal")
        fc = p.m("fleet.client")
        srv = p.server(tmp_path / p.root, stream_checks=False).start()
        try:
            c = fc.FleetClient(srv.addr, "t", "r", io_timeout_s=3)
            ops = list(p.hist(8, 60))
            c.send_chunk(ops[:40])

            def hook(path, rec):
                raise OSError(28, "injected ENOSPC")

            wal.set_fault_hook(hook)
            try:
                with pytest.raises(fc.FleetRejected) as ei:
                    c.send_chunk(ops[40:])
            finally:
                wal.set_fault_hook(None)
            out.append((ei.value.retry_after is not None,
                        srv.stats()["wal_sheds"],
                        wal.replay(wal.wal_path(tmp_path / p.root, "t",
                                                "r"))["last_seq"]))
            c.close()
        finally:
            srv.stop()
    assert out[0] == out[1] == (True, 1, 1)


# ---------------------------------------------------------------------------
# verdict files through both servers
# ---------------------------------------------------------------------------

def test_verdict_files_byte_equal_and_certificates_cross_validate(
        tmp_path):
    files = {}
    envs = {}
    hists = {}
    for p in PKGS:
        srv = p.server(tmp_path / p.root).start()
        try:
            for name, corrupt in (("valid", False), ("bad", True)):
                h = p.hist(4242, 300, corrupt=corrupt)
                hists[(p.root, name)] = h
                envs[(p.root, name)] = stream(p, srv.addr, "t1",
                                              f"r-{name}", h)
        finally:
            srv.stop()
        for name in ("valid", "bad"):
            files[(p.root, name)] = p.m("fleet.wal").verdict_path(
                tmp_path / p.root, "t1", f"r-{name}").read_bytes()
    for name, valid in (("valid", True), ("bad", False)):
        assert port_names(files[("jepsen_tpu", name)]) == \
            files[(PORT, name)]
        for root in ROOTS:
            res = envs[(root, name)]["result"]
            assert res["valid?"] is valid
            validate_both(hists[("jepsen_tpu", name)],
                          hists[(PORT, name)], res["certificate"])
        # a valid run's certificate is the solo check's byte for byte
        if valid:
            assert json.dumps(envs[(PORT, name)]["result"]["certificate"],
                              sort_keys=True).encode() == cert_bytes(
                TORCH, solo(TORCH, hists[(PORT, name)])["certificate"])


def test_model_initial_value_and_elle_verdicts_equal(tmp_path):
    """The register model's initial value rides the hello; an Elle model
    checks through the family's check on the scheduler's device."""
    out = {}
    for p in PKGS:
        mk = p.m("history").op
        ops = [mk(index=i, time=i, type=t, process=pr, f=f, value=v)
               for i, (t, pr, f, v) in enumerate((
                   ("invoke", 0, "read", None), ("ok", 0, "read", 0),
                   ("invoke", 1, "write", 3), ("ok", 1, "write", 3),
                   ("invoke", 0, "read", None), ("ok", 0, "read", 3)))]
        la = p.g("synth").list_append_history(300, seed=3)
        fc = p.m("fleet.client")
        srv = p.server(tmp_path / p.root).start()
        try:
            got = []
            for run, initial in (("no-initial", None), ("seeded", 0)):
                c = fc.FleetClient(srv.addr, "t", run, model="register",
                                   initial=initial)
                c.send_chunk(ops)
                got.append(c.finish()["result"]["valid?"])
                c.close()
            env = stream(p, srv.addr, "t", "la", la, chunk=200,
                         model="list-append")
            got.append((env["result"]["valid?"],
                        env["result"]["anomaly-types"]))
            out[p.root] = got
        finally:
            srv.stop()
        files = sorted((tmp_path / p.root / "verdicts" / "t").iterdir())
        out[p.root + "-files"] = [f.name for f in files]
    assert out["jepsen_tpu"] == out[PORT] == [False, True, (True, [])]
    assert out["jepsen_tpu-files"] == out[PORT + "-files"]
    for run in ("seeded", "la"):
        assert port_names(JAX.m("fleet.wal").verdict_path(
            tmp_path / "jepsen_tpu", "t", run).read_bytes()) == \
            TORCH.m("fleet.wal").verdict_path(tmp_path / PORT, "t",
                                              run).read_bytes()


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def drain_order(p: Pkg):
    s = p.scheduler(max_batch=12)
    s.set_weight("heavy", 2.0)
    s.set_weight("light", 1.0)
    s.set_weight("idle", 10.0)
    for i in range(20):
        s.submit("slice", "heavy", "r", i)
        s.submit("slice", "light", "r", i)
        if i % 3 == 0:
            s.submit("slice", "third", "r", i)
    rounds = []
    while True:
        with s._lock:
            batch = s._drain_fair_locked()
        if not batch:
            break
        rounds.append([(i.tenant, i.payload) for i in batch])
    return rounds


def test_fair_drain_order_equal():
    got = drain_order(TORCH)
    assert got == drain_order(JAX)
    first = got[0]
    assert sum(1 for t, _ in first if t == "heavy") == \
        2 * sum(1 for t, _ in first if t == "light")


def _final(p, run, h, tenant="t"):
    return ("final", tenant, run, {"engine": "wgl", "model": "cas-register",
                                   "history": h})


def _run_round(s):
    with s._lock:
        batch = s._drain_fair_locked()
    s._run_batch(batch)


def counters(p, prefix="fleet."):
    return {k: v for k, v in p.m("telemetry").get().counters().items()
            if k.startswith(prefix)}


def breaker_scenario(p: Pkg, monkeypatch):
    """Every run of every batch dies on the device: the fleet breaker
    opens after BREAKER_THRESHOLD batches, no run is quarantined, and
    the next final is answered on the host lane."""
    fs, wgl = p.m("fleet.scheduler"), p.g("wgl")
    p.m("telemetry").reset()
    s = p.scheduler()
    s._breaker.cooldown_s = 3600
    monkeypatch.setattr(wgl, "analysis_batch_streamed",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("device dead")))
    h = p.hist(2, 60)
    seen = []
    for i in range(fs.BREAKER_THRESHOLD):
        items = [s.submit(*_final(p, f"r{i}{j}", h)) for j in range(2)]
        _run_round(s)
        seen.append([(it.result["valid?"], it.result["error"])
                     for it in items])
        seen.append((s._breaker.failures, s._breaker.opened_at is not None))
    item = s.submit(*_final(p, "rz", h))
    _run_round(s)
    st = s.stats()
    monkeypatch.undo()
    return seen, item.result["valid?"], item.result["analyzer"], {
        k: st[k] for k in ("host_floor", "quarantine", "quarantine_items",
                           "bisect_launches", "final_launches",
                           "breaker_open")}, counters(p)


def test_breaker_transitions_equal(monkeypatch):
    j = breaker_scenario(JAX, monkeypatch)
    t = breaker_scenario(TORCH, monkeypatch)
    assert j[:2] == t[:2] and j[3:] == t[3:]
    assert (j[2], t[2]) == ("wgl", "wgl")
    assert t[0][-1] == (fs_threshold(), True)
    # the host-lane final succeeded, which closes the breaker again
    assert t[3]["host_floor"] == 1 and t[3]["breaker_open"] is False
    assert t[4]["fleet.breaker.opened"] == t[4]["fleet.breaker.closed"] == 1


def fs_threshold():
    return TORCH.m("fleet.scheduler").BREAKER_THRESHOLD


def poison_scenario(p: Pkg, monkeypatch):
    """ONE run's history kills the shared final launch: attribution
    quarantines it to the host lane, the others keep their device
    verdicts, the fleet breaker stays closed."""
    wgl = p.g("wgl")
    p.m("telemetry").reset()
    s = p.scheduler()
    poison = p.hist(3, 60)
    real = wgl.analysis_batch_streamed

    def selective(model, hists, **kw):
        if any(h is poison for h in hists):
            raise RuntimeError("device dead")
        return real(model, hists, **kw)

    monkeypatch.setattr(wgl, "analysis_batch_streamed", selective)
    items = [s.submit(*_final(p, f"r{j}", p.hist(10 + j, 60)))
             for j in range(2)]
    bad = s.submit(*_final(p, "rbad", poison))
    _run_round(s)
    bad2 = s.submit(*_final(p, "rbad", poison))
    _run_round(s)
    st = s.stats()
    monkeypatch.undo()
    return ([(i.result["valid?"], i.result["analyzer"].replace("tpu", "gpu"))
             for i in items + [bad, bad2]],
            [q["run"] for q in st["quarantine"]],
            {k: st[k] for k in ("host_floor", "quarantine_items",
                                "bisect_launches", "final_launches",
                                "breaker_open")},
            counters(p))


def test_poison_final_quarantine_equal(monkeypatch):
    j = poison_scenario(JAX, monkeypatch)
    t = poison_scenario(TORCH, monkeypatch)
    assert j == t
    assert t[1] == ["rbad"] and t[2]["quarantine_items"] == 2
    assert t[3]["fleet.quarantine.added"] == 1


def slice_scenario(p: Pkg, monkeypatch):
    """One run's slices kill the shared check_slices launch: bisection
    along run boundaries finds it, its slices get exact host masks,
    every other run's masks come from the (solo) device retry."""
    wgl = p.g("wgl")
    enc_mod = p.g("encode")
    p.m("telemetry").reset()
    model = p.m("checker.models").cas_register()
    encs = {r: enc_mod.encode(model, p.hist(30 + k, 40))
            for k, r in enumerate(("a", "b", "poison", "c"))}
    real = wgl.check_slices

    def selective(pairs, *a, **k):
        if any(e is encs["poison"] for e, _s in pairs):
            raise RuntimeError("launch died")
        return real(pairs, *a, **k)

    monkeypatch.setattr(wgl, "check_slices", selective)
    s = p.scheduler()
    items = [s.submit("slice", "t", r, (e, st))
             for r, e in encs.items() for st in range(min(e.n_states, 3))]
    while s.pending():  # a round drains QUANTUM items of one tenant
        _run_round(s)
    st = s.stats()
    monkeypatch.undo()
    return ([(i.run, i.result) for i in items],
            [q["run"] for q in st["quarantine"]],
            {k: st[k] for k in ("quarantine_items", "bisect_launches",
                                "slice_launches", "breaker_open")},
            counters(p))


def test_slice_failure_attribution_equal(monkeypatch):
    j = slice_scenario(JAX, monkeypatch)
    t = slice_scenario(TORCH, monkeypatch)
    assert j == t
    assert t[1] == ["poison"]
    assert all("error" not in r for _run, r in t[0])


def card_scheduler(monkeypatch, fail):
    """A port scheduler whose device is the card, without one: its
    check_slices and analysis_batch_streamed are fakes that raise for
    the histories `fail` picks and otherwise compute on the CPU, and a
    host search from the scheduler fails the test."""
    import torch

    wgl = TORCH.g("wgl")
    TORCH.m("telemetry").reset()
    real_slices, real_finals = wgl.check_slices, wgl.analysis_batch_streamed

    def slices(pairs, *a, **k):
        if any(fail(e) for e, _s in pairs):
            raise RuntimeError("launch died")
        return real_slices(pairs, *a, **dict(k, device="cpu"))

    def finals(model, hists, **k):
        if any(fail(h) for h in hists):
            raise RuntimeError("launch died")
        return real_finals(model, hists, **dict(k, device="cpu"))

    def host(*a, **k):
        raise AssertionError("a host search on the card")

    monkeypatch.setattr(wgl, "check_slices", slices)
    monkeypatch.setattr(wgl, "analysis_batch_streamed", finals)
    monkeypatch.setattr(wgl, "search_host_reach", host)
    monkeypatch.setattr(wgl, "analysis", host)
    s = TORCH.scheduler()
    s.device = torch.device("cuda")
    return s


def test_card_breaker_refuses_finals_without_a_host_search(monkeypatch):
    """On the card the open breaker turns finals away with an error: no
    host search, counted in host_floor, and the breaker stays open (the
    JAX package and the port on the CPU answer them on the host, which
    closes it: test_breaker_transitions_equal)."""
    s = card_scheduler(monkeypatch, lambda h: True)
    s._breaker.cooldown_s = 3600
    h = TORCH.hist(2, 60)
    for i in range(fs_threshold()):
        items = [s.submit(*_final(TORCH, f"r{i}{j}", h)) for j in range(2)]
        _run_round(s)
        assert all(it.result == {"valid?": "unknown",
                                 "error": "RuntimeError('launch died')"}
                   for it in items)
    item = s.submit(*_final(TORCH, "rz", h))
    _run_round(s)
    assert item.result == {"valid?": "unknown",
                           "error": "fleet device breaker open"}
    st = s.stats()
    assert st["host_floor"] == 1 and st["breaker_open"] is True
    assert st["quarantine"] == [] and st["final_launches"] == 0
    c = counters(TORCH)
    assert c["fleet.breaker.opened"] == 1
    assert c["fleet.breaker.error-finals"] == 1
    assert "fleet.breaker.closed" not in c
    assert "fleet.breaker.host-finals" not in c


def test_card_poison_final_finishes_with_an_error(monkeypatch):
    """On the card a run whose final kills the launch alone is
    quarantined and its finals finish with the launch's error; the
    other runs keep their device verdicts, equal to the JAX package's
    (poison_scenario)."""
    poison = TORCH.hist(3, 60)
    s = card_scheduler(monkeypatch, lambda h: h is poison)
    items = [s.submit(*_final(TORCH, f"r{j}", TORCH.hist(10 + j, 60)))
             for j in range(2)]
    bad = s.submit(*_final(TORCH, "rbad", poison))
    _run_round(s)
    bad2 = s.submit(*_final(TORCH, "rbad", poison))
    _run_round(s)
    monkeypatch.undo()
    j = poison_scenario(JAX, monkeypatch)
    assert [(i.result["valid?"], i.result["analyzer"]) for i in items] == \
        j[0][:2]
    for b in (bad, bad2):
        assert b.result == {"valid?": "unknown",
                            "error": "RuntimeError('launch died')"}
    st = s.stats()
    assert [q["run"] for q in st["quarantine"]] == ["rbad"]
    assert st["quarantine_items"] == 2 and st["host_floor"] == 0
    assert st["breaker_open"] is False
    c = counters(TORCH)
    assert c["fleet.quarantine.added"] == 1
    assert c["fleet.quarantine.error-items"] == 2
    assert "fleet.quarantine.host-items" not in c


def test_card_poison_slices_finish_with_an_error(monkeypatch):
    """On the card the run whose slices kill the shared launch is found
    by bisection and quarantined, and its slices finish with the
    launch's error (mask 0, unknown); the other runs' masks are the
    JAX package's (slice_scenario), and the failure shows in
    bisect_launches and fleet.quarantine.attributions."""
    model = TORCH.m("checker.models").cas_register()
    enc_mod = TORCH.g("encode")
    encs = {r: enc_mod.encode(model, TORCH.hist(30 + k, 40))
            for k, r in enumerate(("a", "b", "poison", "c"))}
    s = card_scheduler(monkeypatch, lambda e: e is encs["poison"])
    items = [s.submit("slice", "t", r, (e, st))
             for r, e in encs.items() for st in range(min(e.n_states, 3))]
    while s.pending():
        _run_round(s)
    st = s.stats()
    c = counters(TORCH)
    monkeypatch.undo()
    j = slice_scenario(JAX, monkeypatch)
    for (run, want), i in zip(j[0], items):
        assert i.run == run
        if run == "poison":
            assert i.result == {"mask": 0, "unknown": True,
                                "error": "RuntimeError('launch died')"}
        else:
            assert i.result == want
    assert [q["run"] for q in st["quarantine"]] == ["poison"]
    assert st["bisect_launches"] == j[2]["bisect_launches"] > 0
    assert st["quarantine_items"] == j[2]["quarantine_items"]
    assert c["fleet.quarantine.attributions"] \
        == j[3]["fleet.quarantine.attributions"] > 0
    assert c["fleet.quarantine.error-items"] == j[2]["quarantine_items"]
    assert "fleet.quarantine.host-items" not in c


@pytest.mark.parametrize("p", PKGS, ids=ROOTS)
def test_stop_resolves_leftovers_and_failures_never_wedge(p, monkeypatch):
    s = p.scheduler()
    item = s.submit("final", "t", "r", {"engine": "wgl",
                                        "model": "cas-register",
                                        "history": p.m("history").History(
                                            [])})
    s.stop()
    assert item.done.wait(timeout=5)
    assert item.result == {"valid?": "unknown",
                           "error": "fleet scheduler stopped"}


def streaming_masks(p: Pkg, hist, chunk=100):
    """The StreamingRun's state after each chunk: every step finishes
    before the next chunk arrives, so the prefixes checked are the same
    in both packages."""
    fs = p.m("fleet.scheduler")
    sched = p.scheduler(window_s=0.01).start()
    out = []
    try:
        sr = fs.StreamingRun("cas-register", sched, "t", "r")
        ops = list(hist)
        for i in range(0, len(ops), chunk):
            sr.add_ops(ops[i:i + chunk])
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                with sr._lock:
                    if not sr._inflight:
                        break
                time.sleep(0.01)
            with sr._lock:
                out.append((sr._state, sr._checked, sr._mask,
                            round(sr._frac, 6)))
    finally:
        sched.stop()
    return out


@pytest.mark.parametrize("corrupt", [False, True], ids=["valid", "corrupt"])
def test_streaming_run_masks_equal(corrupt):
    j = streaming_masks(JAX, JAX.hist(21, 500, corrupt, at_frac=0.3))
    t = streaming_masks(TORCH, TORCH.hist(21, 500, corrupt, at_frac=0.3))
    assert j == t
    assert t[-1][1] > 0
    assert t[-1][0] == ("tentative-invalid" if corrupt else "streaming")


def _quiesce(name: str, timeout_s: float = 60.0) -> None:
    """Waits until no thread named `name` is alive."""
    deadline = time.monotonic() + timeout_s
    while any(t.name == name for t in threading.enumerate()):
        assert time.monotonic() < deadline, f"{name} still running"
        time.sleep(0.01)


def test_stream_checkpoint_records_equal(tmp_path):
    """The stream-wgl checkpoint a streamed run leaves is the JAX
    package's byte for byte."""
    for p in PKGS:
        srv = p.server(tmp_path / p.root).start()
        path = p.g("ckpt").fleet_path(tmp_path / p.root, "t", "r")
        try:
            c = p.m("fleet.client").FleetClient(srv.addr, "t", "r",
                                                io_timeout_s=3)
            ops = list(p.hist(9, 400))
            for i in range(0, len(ops), 150):
                c.send_chunk(ops[i:i + 150])
                # each chunk's stream step ends before the next chunk
                # arrives, so both packages check the same prefixes and
                # leave the same last record. The step's thread clears
                # _inflight before it writes the record through the
                # sink and re-kicks for ops that came meanwhile (a
                # re-kick starts the next step's thread first), so the
                # wait is for the thread, not for the flag: a record
                # written late would overwrite the next step's.
                _quiesce("fleet-stream-t-r")
                sr = srv._runs[("t", "r")].stream
                with sr._lock:
                    assert not sr._inflight
                    checked = sr._checked
                if checked:
                    assert p.g("ckpt").load(path, "stream-wgl")[
                        "checked"] == checked
            c.finish()
            c.close()
            # the verdict thread compacts the WAL after finish() returns
            _quiesce("fleet-verdict-t-r")
        finally:
            srv.stop()
    want = JAX.g("ckpt").fleet_path(tmp_path / "jepsen_tpu", "t", "r")
    got = TORCH.g("ckpt").fleet_path(tmp_path / PORT, "t", "r")
    assert got.relative_to(tmp_path / PORT) == want.relative_to(
        tmp_path / "jepsen_tpu")
    assert got.read_bytes() == want.read_bytes()
    # each package's loader accepts the other's record
    assert TORCH.g("ckpt").load(want, "stream-wgl") == JAX.g("ckpt").load(
        got, "stream-wgl") is not None
    # the post-verdict compaction left hello + base + fin in both
    for p in PKGS:
        folded = p.m("fleet.wal").replay(p.m("fleet.wal").wal_path(
            tmp_path / p.root, "t", "r"))
        assert folded["base"] is not None and folded["fin"] is not None


# ---------------------------------------------------------------------------
# admission, crash schedules, recovery across packages
# ---------------------------------------------------------------------------

def quota_scenario(p: Pkg, tmp_path):
    fs, fc = p.m("fleet.server"), p.m("fleet.client")
    srv = p.server(tmp_path / p.root,
                   quotas=fs.Quotas(max_tenants=2, max_total_streams=3,
                                    max_streams_per_tenant=1,
                                    max_ops_per_run=150)).start()
    out = []
    try:
        h = list(p.hist(100, 200))
        clients = []
        for t in ("t0", "t1"):
            c = fc.FleetClient(srv.addr, t, "r", io_timeout_s=3)
            c.send_chunk(h[:50])
            clients.append(c)
        for tenant, run in (("t-late", "r"), ("t0", "r2"),
                            ("../evil", "r")):
            try:
                fc.FleetClient(srv.addr, tenant, run,
                               io_timeout_s=3).send_chunk(h[:10])
                out.append("admitted")
            except fc.FleetRejected as e:
                out.append((e.reason, e.retry_after))
        try:
            clients[0].send_chunk(h[50:200])
        except fc.FleetRejected as e:
            out.append((e.reason, e.retry_after))
        st = srv.stats()
        out.append((st["rejected"], st["accepted"],
                    {t: s["rejected"] for t, s in st["tenants"].items()}))
        for c in clients:
            c.close()
    finally:
        srv.stop()
    return out


def test_quota_rejections_equal(tmp_path):
    j = quota_scenario(JAX, tmp_path / "j")
    t = quota_scenario(TORCH, tmp_path / "t")
    assert j == t
    assert t[0][0].startswith("tenant quota saturated")
    assert t[1][0].startswith("per-tenant stream quota")
    assert t[2] == ("bad tenant/run name", None)
    assert t[3] == ("run op quota exceeded", None)


def kill_restart(p: Pkg, tmp_path):
    h = p.hist(4242, 400)
    ops = list(h)
    chunks = [ops[i:i + 50] for i in range(0, len(ops), 50)]
    fc = p.m("fleet.client")
    ref_base = tmp_path / "ref"
    srv = p.server(ref_base).start()
    c = fc.FleetClient(srv.addr, "t1", "r1", io_timeout_s=3)
    for ch in chunks:
        c.send_chunk(ch)
    c.finish()
    c.close()
    srv.stop()
    ref = p.m("fleet.wal").verdict_path(ref_base, "t1", "r1").read_bytes()
    base = tmp_path / "crash"
    srv = p.server(base).start()
    c = fc.FleetClient(srv.addr, "t1", "r1", io_timeout_s=2)
    for ch in chunks[:4]:
        c.send_chunk(ch)
    port = srv.addr[1]
    srv.kill()
    srv2 = p.server(base, port=port).start()
    try:
        for ch in chunks[4:]:
            c.send_chunk(ch)
        env = c.finish()
        c.close()
    finally:
        srv2.stop()
    got = p.m("fleet.wal").verdict_path(base, "t1", "r1").read_bytes()
    assert env["result"]["valid?"] is True
    return ref, got


def test_kill_restart_verdict_byte_identical(tmp_path):
    jref, jgot = kill_restart(JAX, tmp_path / "j")
    tref, tgot = kill_restart(TORCH, tmp_path / "t")
    assert tgot == tref
    assert port_names(jgot) == port_names(jref) == tgot


def test_killed_port_server_ends_a_blocked_clients_connection(tmp_path):
    """ROADMAP C6: kill() shuts each connection down before closing it.
    Here the client has sent half of a chunk's frame and waits for its
    ack while the server's connection thread is blocked in recv() for
    the rest; after kill() the client must see the connection end at
    once, well inside its io_timeout_s. (A bare close() from another
    thread leaves that recv() blocked holding the socket open, and the
    client waits out its whole io_timeout_s.)"""
    fc = TORCH.m("fleet.client")
    wire = TORCH.m("fleet.wire")
    io_timeout_s = 30.0

    class HalfFrame(fc.Transport):
        """Sends the first half of the next chunk frame only, and stamps
        when a receive first sees the connection end."""
        half = False
        ended_at = None
        waiting = threading.Event()

        def send(self, sock, msg):
            if self.half and msg.get("type") == "chunk":
                self.half = False
                b = wire.frame_msg(msg)
                sock.sendall(b[:len(b) // 2])
                return
            super().send(sock, msg)

        def recv(self, sock):
            self.waiting.set()
            try:
                return super().recv(sock)
            except Exception:
                if self.ended_at is None:
                    self.ended_at = time.monotonic()
                raise

    srv = TORCH.server(tmp_path / "fleet", stream_checks=False).start()
    ops = list(TORCH.hist(8, 60))
    tr = HalfFrame()
    c = fc.FleetClient(srv.addr, "t", "r", io_timeout_s=io_timeout_s,
                       transport=tr, connect_timeout_s=1.0)
    c.send_chunk(ops[:30])
    tr.half = True
    tr.waiting.clear()
    errors = []

    def blocked():
        try:
            c.send_chunk(ops[30:])
        except Exception as e:  # noqa: BLE001 — what the client raised
            errors.append(e)

    th = threading.Thread(target=blocked, daemon=True)
    try:
        th.start()
        assert tr.waiting.wait(10), "the client never waited for its ack"
        time.sleep(0.3)  # both ends now blocked in recv()
        assert th.is_alive()
        t_kill = time.monotonic()
        srv.kill()
        th.join(2 * io_timeout_s)
    finally:
        c.close()
    assert not th.is_alive()
    assert tr.ended_at is not None
    assert tr.ended_at - t_kill < 2.0, tr.ended_at - t_kill
    # the client then gives up on the dead address: no ack came
    assert errors and isinstance(errors[0], fc.FleetError)


def freeze_at_fin(p: Pkg, base, h):
    """Streams h, freezes the scheduler so the fin's final never runs,
    and kills the server: a WAL directory with a fin and no verdict."""
    fc = p.m("fleet.client")
    sched = p.scheduler()
    srv = p.server(base, scheduler=sched).start()
    c = fc.FleetClient(srv.addr, "t1", "r1", io_timeout_s=1)
    ops = list(h)
    for i in range(0, len(ops), 50):
        c.send_chunk(ops[i:i + 50])
    sched._stop.set()
    time.sleep(0.4)
    with pytest.raises(fc.FleetError):
        c.finish(timeout_s=2)
    c.close()
    srv.kill()


@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)],
                         ids=["jax-wal-port-server", "port-wal-jax-server"])
def test_wal_directory_recovered_across(tmp_path, writer, reader):
    base = tmp_path / "fleet"
    freeze_at_fin(writer, base, writer.hist(4242, 300))
    srv = reader.server(base).start()
    try:
        assert srv.stats()["recovered"] == 1
        env = reader.m("fleet.client").FleetClient(
            srv.addr, "t1", "r1", io_timeout_s=3).claim()
        assert env["latency"]["replay"] is True
    finally:
        srv.stop()
    got = reader.m("fleet.wal").verdict_path(base, "t1", "r1").read_bytes()
    # the clean run's verdict file, written by the reading package
    srv = reader.server(tmp_path / "clean").start()
    try:
        stream(reader, srv.addr, "t1", "r1", reader.hist(4242, 300))
    finally:
        srv.stop()
    want = reader.m("fleet.wal").verdict_path(tmp_path / "clean", "t1",
                                              "r1").read_bytes()
    assert port_names(got) == port_names(want)
    assert json.loads(got)["result"]["valid?"] is True


def test_port_resumes_a_jax_stream_mid_run(tmp_path):
    """A JAX server killed mid-stream; the port's server takes over its
    WAL directory, the client resumes from the journaled seq, and the
    verdict equals the port's clean run."""
    base = tmp_path / "fleet"
    ops_j, ops_t = list(JAX.hist(77, 300)), list(TORCH.hist(77, 300))
    srv = JAX.server(base).start()
    c = JAX.m("fleet.client").FleetClient(srv.addr, "t", "r",
                                          io_timeout_s=2)
    for i in range(0, 150, 50):
        c.send_chunk(ops_j[i:i + 50])
    c.close()
    srv.kill()
    srv = TORCH.server(base).start()
    try:
        c = TORCH.m("fleet.client").FleetClient(srv.addr, "t", "r",
                                                io_timeout_s=3)
        c._chunks = [TORCH.m("fleet.wire").ops_to_wire(ops_t[i:i + 50])
                     for i in range(0, 150, 50)]
        c._acked = 0
        for i in range(150, len(ops_t), 50):
            c.send_chunk(ops_t[i:i + 50])
        env = c.finish()
        c.close()
    finally:
        srv.stop()
    assert env["result"]["valid?"] is True
    clean = tmp_path / "clean"
    srv = TORCH.server(clean).start()
    try:
        stream(TORCH, srv.addr, "t", "r", ops_t)
    finally:
        srv.stop()
    assert TORCH.m("fleet.wal").verdict_path(base, "t", "r").read_bytes() \
        == TORCH.m("fleet.wal").verdict_path(clean, "t", "r").read_bytes()


# ---------------------------------------------------------------------------
# the flight recorder in the server
# ---------------------------------------------------------------------------

def test_recorder_off_keeps_verdict_bytes_and_drops_latency(tmp_path):
    h = TORCH.hist(4242, 200)
    envs = {}
    for name, on in (("on", True), ("off", False)):
        srv = TORCH.server(tmp_path / name, flightrec=on).start()
        try:
            envs[name] = stream(TORCH, srv.addr, "t", "r", h)
        finally:
            srv.stop()
    wal = TORCH.m("fleet.wal")
    assert wal.verdict_path(tmp_path / "on", "t", "r").read_bytes() == \
        wal.verdict_path(tmp_path / "off", "t", "r").read_bytes()
    TORCH.m("fleet.flightrec").validate_latency(envs["on"]["latency"])
    assert "latency" not in envs["off"]
    assert envs["on"]["result"] == envs["off"]["result"]


def final_parked(sched, tenant: str) -> bool:
    """Whether the scheduler holds a final of the tenant in its queue."""
    with sched._lock:
        q = sched._queues.get(tenant)
        return q is not None and any(i.kind == "final" for i in q.items)


def drain_and_fold(p: Pkg, tmp_path):
    """A graceful stop flushes a final parked in a long batching window
    as a `drain` launch; a kill()ed server's successor folds its saved
    SLO histograms. The stop waits until the fin has reached the
    scheduler: on a loaded host the server can take longer than any
    fixed pause to get it there, and a stop before it drains nothing."""
    fc = p.m("fleet.client")
    sched = p.scheduler(window_s=30.0)
    srv = p.server(tmp_path / "drain", scheduler=sched).start()
    c = fc.FleetClient(srv.addr, "t", "r", io_timeout_s=3)
    ops = list(p.hist(4242, 120))
    for i in range(0, 120, 40):
        c.send_chunk(ops[i:i + 40])

    def fin():
        try:
            c.finish(timeout_s=3)
        except fc.FleetError:
            pass

    ft = threading.Thread(target=fin, daemon=True)
    ft.start()
    deadline = time.monotonic() + 30
    while not final_parked(sched, "t") and time.monotonic() < deadline:
        time.sleep(0.01)
    assert final_parked(sched, "t"), "the fin never reached the scheduler"
    srv.stop()
    ft.join(timeout=10)
    snap = srv.flightrec.snapshot()
    base = tmp_path / "fold"
    srv = p.server(base).start()
    stream(p, srv.addr, "t", "r1", p.hist(4242, 150))
    before = srv.flightrec.snapshot()["verdict_ms"]["n"]
    srv.kill()
    srv2 = p.server(base).start()
    try:
        after = srv2.flightrec.snapshot()
    finally:
        srv2.stop()
    return (snap["decisions"], snap["launches"],
            before, after["verdict_ms"]["n"],
            after["tenants"]["t"]["verdict_ms"]["n"])


def test_graceful_drain_and_snapshot_fold_equal(tmp_path):
    j = drain_and_fold(JAX, tmp_path / "j")
    t = drain_and_fold(TORCH, tmp_path / "t")
    assert j == t
    assert t[0]["drain"] >= 1 and sum(t[0].values()) == t[1]
    assert t[2] == t[3] == t[4] == 1


# ---------------------------------------------------------------------------
# chaos transports
# ---------------------------------------------------------------------------

def test_fleet_chaos_schedule_equal():
    """The same seed rolls the same faults in both packages' fleet
    transport, connection by connection."""
    def rolls(p):
        tr = p.m("chaos").ChaosFleetTransport(seed=4242)
        out = []
        for conn in (object(), object(), object()):
            inj = tr._injector(conn)
            out.append([inj.roll() for _ in range(60)])
        return out, dict(tr.tally)

    assert rolls(JAX) == rolls(TORCH)


def test_chaos_transport_runs_identical_to_solo(tmp_path):
    chaos = TORCH.m("chaos")
    hists = {f"t{i}": TORCH.hist(700 + i, 200, corrupt=(i == 1))
             for i in range(3)}
    transports = {t: chaos.ChaosFleetTransport(seed=4242 + i)
                  for i, t in enumerate(hists)}
    srv = TORCH.server(tmp_path / "fleet").start()
    out, errs = {}, []

    def one(t, h):
        try:
            out[t] = stream(TORCH, srv.addr, t, "r", h, chunk=40,
                            transport=transports[t], io_timeout_s=1.0)
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append((t, e))

    try:
        threads = [threading.Thread(target=one, args=(t, h))
                   for t, h in hists.items()]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=240)
    finally:
        srv.stop()
    assert not errs, errs
    assert sum(sum(tr.tally.values()) for tr in transports.values()) > 0
    jhists = {f"t{i}": JAX.hist(700 + i, 200, corrupt=(i == 1))
              for i in range(3)}
    for t, h in hists.items():
        res = out[t]["result"]
        want = solo(TORCH, h)
        assert res["valid?"] == want["valid?"] == solo(JAX,
                                                       jhists[t])["valid?"]
        validate_both(jhists[t], h, res["certificate"])
        if want["valid?"] is True:
            assert json.dumps(res["certificate"], sort_keys=True).encode() \
                == cert_bytes(TORCH, want["certificate"])
    TORCH.m("fleet.flightrec").validate_records(srv.flightrec.records())


# ---------------------------------------------------------------------------
# core.run's fleet stream
# ---------------------------------------------------------------------------

def hook_test(p: Pkg, tmp_path, name, addr):
    testing = p.m("testing")
    gen = p.m("generator")
    state = testing.AtomState()
    test = testing.noop_test()
    rng = random.Random(5)

    def one():
        if rng.random() < 0.5:
            return {"f": "read"}
        return {"f": "write", "value": rng.randrange(5)}

    test.update(name=name, store_base=str(tmp_path / "store"),
                nodes=["n1", "n2"], concurrency=2,
                client=testing.AtomClient(state, latency_s=0.0002),
                generator=gen.clients(gen.limit(120, one)),
                fleet={"addr": addr, "tenant": "hook",
                       "model": "cas-register", "chunk_ops": 32})
    if p.port:
        test["checker"] = p.m("checker").linearizable(
            {"model": p.m("checker.models").cas_register(),
             "device": "cpu"})
    return test


def test_core_run_streams_to_the_fleet(tmp_path):
    srv = TORCH.server(tmp_path / "fleet").start()
    try:
        host, port = srv.addr
        t = TORCH.m("core").run(hook_test(TORCH, tmp_path, "fleet-hook",
                                          f"{host}:{port}"))
        fl = t["results"]["fleet"]
        assert "verdict" in fl, fl
        res = fl["verdict"]["result"]
        assert res["valid?"] is t["results"]["valid?"] is True
        TORCH.g("certify").validate(t["history"], res["certificate"])
        assert json.dumps(res["certificate"], sort_keys=True).encode() == \
            cert_bytes(TORCH, t["results"]["certificate"])
        assert srv.stats()["tenants"]["hook"]["ops"] == len(t["history"])
        TORCH.m("fleet.flightrec").validate_latency(
            fl["verdict"]["latency"])
    finally:
        srv.stop()


def test_core_run_unavailable_marker_equal(tmp_path):
    """An unreachable fleet and an unnamed test (no history writer) give
    the same honest marker in both packages."""
    out = {}
    for p in PKGS:
        t = p.m("core").run(hook_test(p, tmp_path / p.root,
                                      "fleet-fallback", "127.0.0.1:9"))
        fl = t["results"]["fleet"]
        assert t["results"]["valid?"] is True
        out[p.root] = [sorted(fl), fl["unavailable"].split(":")[0]]
        unnamed = hook_test(p, tmp_path / p.root, None, "127.0.0.1:9")
        t = p.m("core").run(unnamed)
        out[p.root].append(t["results"]["fleet"])
    assert out["jepsen_tpu"] == out[PORT]
    assert out[PORT][0] == ["unavailable"]
    assert out[PORT][2] == {"unavailable":
                            "no history writer (unnamed test: no store)"}


# ---------------------------------------------------------------------------
# hygiene, the card by default, phase 22 on the CPU
# ---------------------------------------------------------------------------

def test_fleet_entry_points_refuse_the_cpu_by_default(monkeypatch,
                                                      tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fs = TORCH.m("fleet.scheduler")
    srv = TORCH.m("fleet.server")
    for fn in (lambda: fs.Scheduler(),
               lambda: srv.FleetServer(tmp_path / "a"),
               lambda: srv.FleetServer(tmp_path / "b", device=None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    # a scheduler passed in brings its device; `device` only builds the
    # default one
    cpu = fs.Scheduler(device="cpu")
    assert srv.FleetServer(tmp_path / "c",
                           scheduler=cpu).scheduler.device.type == "cpu"
    assert srv.FleetServer(tmp_path / "d",
                           device="cpu").scheduler.device.type == "cpu"


def test_fleet_without_loading_jax(tmp_path):
    code = f"""
import sys
from jepsen_tpu_torch import chaos
from jepsen_tpu_torch.fleet import client, server, wal
from jepsen_tpu_torch.gpu import synth
srv = server.FleetServer({str(tmp_path)!r}, device="cpu").start()
c = client.FleetClient(srv.addr, "t", "r",
                       transport=chaos.ChaosFleetTransport(seed=1),
                       io_timeout_s=2)
ops = list(synth.register_history(150, seed=2))
for i in range(0, len(ops), 50):
    while True:
        try:
            c.send_chunk(ops[i:i + 50])
            break
        except client.FleetError:
            pass
env = c.finish()
srv.stop()
assert env["result"]["valid?"] is True, env
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LOADED", loaded)
assert not loaded, loaded
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_chip_smoke_phase_22_on_the_cpu():
    """chip_smoke's fleet phase at a small size on the CPU: every check
    of the phase runs (verdicts against the solo checks on the device
    and the CPU, certificates, cross-tenant slice and final launches,
    the slice launches against the plain version, no host lane, the
    kill() and restart byte-identical, core.run's fleet verdict); the
    card-only launch counts are skipped by the phase itself."""
    import torch

    import chip_smoke

    got = chip_smoke.fleet_path(torch.device("cpu"), False, {
        "register_tenants": 4, "register_ops": 300, "chunk": 64,
        "corrupt": (1,), "elle_txns": 4000, "core_run_ops": 200,
        "nemesis_ops": 4})
    assert got["wgl_search"]["fleet"] >= 2
    assert got["wgl_search"]["fleet-core-run"] >= 1
    assert got["scc"]["fleet"] >= 1
