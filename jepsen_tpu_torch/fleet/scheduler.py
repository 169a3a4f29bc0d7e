"""Continuous cross-run batching: the fleet's shared-device scheduler
(the port's copy of jepsen_tpu/fleet/scheduler.py).

Inference serving stays viable under load by continuously batching
heterogeneous requests into shared device launches; the fleet applies
the same discipline to checker work. Tenants submit two kinds of work:

  final   a complete streamed history -> a full wgl/elle verdict with
          its certificate (the authoritative answer, identical to what
          a solo run computes)
  slice   one (encoded segment, start state) reach row of a LIVE
          stream's prefix — the streaming check that tightens a
          tenant's verdict while chunks are still arriving

The batch loop drains per-tenant queues by deficit-weighted round
robin (a tenant with weight 2 gets twice the rows of a weight-1
tenant when both are backlogged; an idle tenant's unused share is
redistributed, not wasted), then packs everything it drained into as
few device launches as possible: slices from ALL tenants go into ONE
`wgl.check_slices` launch; finals group per model and go through
`wgl.analysis_batch_streamed` (P-compositionality, arXiv:1504.00204,
justifies slicing; certificates make the shared pool trustworthy —
the tenant validates the proof, not the pool).

Failure discipline: a work item's `done` event is ALWAYS set (try/
finally), so no crash in a batch can wedge a queue. A kernel's build or
launch failure raises out of the launch and is attributed by run: a
run whose work fails alone is quarantined (`fleet.quarantine.*`); if
whole batches keep dying, a circuit breaker (closed/open/half-open, the
control/health.py discipline) turns finals away from the device until a
half-open probe succeeds (`fleet.breaker.*`). Each such item is counted
(`host_floor`, `quarantine_items`).

Every check the scheduler makes runs on its `device` (None: the card;
"cpu": the kernels' plain versions). Where it is the CPU, a quarantined
run and the finals the open breaker turns away are answered by the
host searches, as in the JAX package. On the card no failed launch is
answered by a host search (the port steps down to no other path): those
items finish with an `error` and an unknown verdict or mask.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any

from .. import telemetry, util
from ..device import resolve_device
from ..history import History
from . import flightrec as frec

logger = logging.getLogger(__name__)


def _ckpt_mod():
    from ..gpu import ckpt

    return ckpt


MAX_BATCH = 64          # items drained per batch round
WINDOW_S = 0.02         # how long the loop waits to accumulate work
QUANTUM = 8.0           # deficit credit per round per unit weight
BREAKER_THRESHOLD = 3   # consecutive dead batches before opening
BREAKER_COOLDOWN_S = 5.0
QUARANTINE_COOLDOWN_S = 30.0  # per-run breaker: solo device probe due


class WorkItem:
    """One unit of checker work. `done` is set exactly once, after
    `result` (never both unset across an exception path). `times` is
    the flight recorder's stamp sheet (submit/drain/launch0/launch1
    in frec.now() ns, plus the launch's per-item encode/device/
    certify ms shares) — written only by the submitting thread and
    the batch loop, read after `done`."""

    __slots__ = ("kind", "tenant", "run", "payload", "result", "done",
                 "times")

    def __init__(self, kind: str, tenant: str, run: str, payload):
        self.kind = kind          # 'final' | 'slice'
        self.tenant = tenant
        self.run = run
        self.payload = payload
        self.result: Any = None
        self.done = threading.Event()
        self.times: dict = {"submit": frec.now()}

    def finish(self, result) -> None:
        self.result = result
        self.done.set()


class _TenantQueue:
    __slots__ = ("items", "weight", "deficit")

    def __init__(self, weight: float = 1.0):
        self.items: deque[WorkItem] = deque()
        self.weight = max(float(weight), 0.1)
        self.deficit = 0.0


class _DeviceBreaker:
    """Fleet-level device circuit: opens after consecutive WHOLE-batch
    failures (per-run attribution already isolates one poison run),
    half-opens after a cooldown to probe with one batch. Called only
    from the batch thread — no lock needed."""

    def __init__(self, threshold: int = BREAKER_THRESHOLD,
                 cooldown_s: float = BREAKER_COOLDOWN_S):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.failures = 0
        self.opened_at: float | None = None

    def allow_device(self) -> bool:
        if self.opened_at is None:
            return True
        if time.monotonic() - self.opened_at >= self.cooldown_s:
            return True  # half-open probe
        return False

    def record(self, ok: bool) -> None:
        if ok:
            if self.opened_at is not None:
                telemetry.count("fleet.breaker.closed")
            self.failures = 0
            self.opened_at = None
            return
        self.failures += 1
        if self.failures >= self.threshold and self.opened_at is None:
            self.opened_at = time.monotonic()
            telemetry.count("fleet.breaker.opened")
            logger.warning("fleet device breaker OPEN after %d "
                           "consecutive batch failures", self.failures)
        elif self.opened_at is not None:
            self.opened_at = time.monotonic()  # failed probe re-arms


class Quarantine:
    """Poison-run isolation (doc/robustness.md): when ONE run's
    history reliably kills shared device launches, quarantining it to
    a solo lane keeps every other tenant device-batched — instead
    of three dead batches opening the FLEET breaker and turning the
    whole pool away from the device. Each quarantined run carries its own
    tiny breaker: after a cooldown the next visit probes the device
    SOLO (never inside a shared launch), releasing on success,
    re-arming on failure. The fleet-wide _DeviceBreaker still owns
    genuinely systemic failure — it trips only when attribution shows
    EVERY run in a dead batch failing solo.

    add/probe/release run on the batch thread; snapshot() serves
    /fleet, prometheus and stats() from other threads — hence the
    lock."""

    _guarded_by_lock = {"_lock": ("_runs",)}

    def __init__(self, cooldown_s: float = QUARANTINE_COOLDOWN_S):
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        # (tenant, run) -> {"since", "error", "probes", "probe_at"}
        self._runs: dict[tuple[str, str], dict] = {}

    def add(self, tenant: str, run: str, error: str) -> bool:
        """Quarantines a run; True when newly quarantined."""
        with self._lock:
            if (tenant, run) in self._runs:
                return False
            self._runs[(tenant, run)] = {
                "since": time.time(), "error": error, "probes": 0,
                "probe_at": time.monotonic() + self.cooldown_s}
        telemetry.count("fleet.quarantine.added")
        logger.warning("fleet quarantine: %s/%s -> solo lane (%s)",
                       tenant, run, error)
        return True

    def is_quarantined(self, tenant: str, run: str) -> bool:
        with self._lock:
            return (tenant, run) in self._runs

    def error(self, tenant: str, run: str) -> str:
        """The launch failure that quarantined a run ("" if it is not
        quarantined)."""
        with self._lock:
            st = self._runs.get((tenant, run))
            return "" if st is None else st["error"]

    def probe_due(self, tenant: str, run: str) -> bool:
        with self._lock:
            st = self._runs.get((tenant, run))
            return st is not None and \
                time.monotonic() >= st["probe_at"]

    def record_probe(self, tenant: str, run: str, ok: bool) -> None:
        """A solo device probe's outcome: success releases the run
        back to shared launches; failure re-arms its cooldown."""
        with self._lock:
            st = self._runs.get((tenant, run))
            if st is None:
                return
            st["probes"] += 1
            if ok:
                del self._runs[(tenant, run)]
            else:
                st["probe_at"] = time.monotonic() + self.cooldown_s
        if ok:
            telemetry.count("fleet.quarantine.released")
            logger.info("fleet quarantine: %s/%s released after "
                        "device probe", tenant, run)
        else:
            telemetry.count("fleet.quarantine.probe-failed")

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [{"tenant": t, "run": r,
                     "since": st["since"], "error": st["error"],
                     "probes": st["probes"]}
                    for (t, r), st in sorted(self._runs.items())]


class Scheduler:
    """The batch loop + per-tenant weighted-fair queues."""

    _guarded_by_lock = {"_lock": ("_queues", "_order", "_pending",
                                  "_stats")}

    def __init__(self, max_batch: int = MAX_BATCH,
                 window_s: float = WINDOW_S,
                 quantum: float = QUANTUM,
                 flightrec: "frec.FlightRecorder | None" = None,
                 device=None):
        self.max_batch = max_batch
        # where every check of the batch loop runs (resolved now: a
        # scheduler for the card raises at once without one)
        self.device = resolve_device(device)
        self.window_s = window_s
        self.quantum = quantum
        # the flight recorder is attached once, before start() (the
        # server shares its own) — a lifecycle attr, not shared state
        self.flightrec = flightrec
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: dict[str, _TenantQueue] = {}
        self._order: deque[str] = deque()  # round-robin ring
        self._pending = 0
        self._stats = {"launches": 0, "slice_launches": 0,
                       "final_launches": 0, "items": 0,
                       "slice_rows": 0, "final_hists": 0,
                       "cross_tenant_launches": 0,
                       "max_tenants_in_launch": 0, "host_floor": 0,
                       "quarantine_items": 0, "bisect_launches": 0}
        self._breaker = _DeviceBreaker()
        self.quarantine = Quarantine()
        self._stop = threading.Event()
        self._drain_req = threading.Event()
        self._thread: threading.Thread | None = None

    def _host_lanes(self) -> bool:
        """Whether quarantined runs and the open breaker's finals go to
        the host searches: on the CPU only."""
        return self.device.type == "cpu"

    # -- submission ------------------------------------------------------

    def set_weight(self, tenant: str, weight: float) -> None:
        with self._lock:
            self._tq_locked(tenant).weight = max(float(weight), 0.1)

    def _tq_locked(self, tenant: str) -> _TenantQueue:
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = _TenantQueue()
            self._order.append(tenant)
        return q

    def submit(self, kind: str, tenant: str, run: str,
               payload) -> WorkItem:
        item = WorkItem(kind, tenant, run, payload)
        with self._lock:
            self._tq_locked(tenant).items.append(item)
            self._pending += 1
            self._work.notify()
        telemetry.count(f"fleet.submit.{kind}")
        return item

    def pending(self, tenant: str | None = None) -> int:
        with self._lock:
            if tenant is None:
                return self._pending
            q = self._queues.get(tenant)
            return len(q.items) if q is not None else 0

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["pending"] = self._pending
        out["breaker_open"] = self._breaker.opened_at is not None
        out["quarantine"] = self.quarantine.snapshot()
        return out

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Scheduler":
        self._stop.clear()
        self._drain_req.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-scheduler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        # graceful stop FLUSHES: the loop drains what is already
        # queued into final launches (decision-log reason "drain")
        # before exiting. kill() sets _stop alone — a SIGKILL
        # abandons in-flight work, it doesn't flush it.
        self._drain_req.set()
        self._stop.set()
        with self._lock:
            self._work.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=30)
        # no wedged queues, even at shutdown: whatever is still queued
        # resolves 'unknown' instead of blocking its waiter forever
        with self._lock:
            leftovers = [i for q in self._queues.values()
                         for i in q.items]
            for q in self._queues.values():
                q.items.clear()
            self._pending = 0
        for i in leftovers:
            i.finish({"valid?": "unknown",
                      "error": "fleet scheduler stopped"})

    # -- the batch loop --------------------------------------------------

    def _drain_fair_locked(self) -> list[WorkItem]:
        """Deficit-weighted round robin over the tenant ring, up to
        max_batch items. Caller holds the lock."""
        batch: list[WorkItem] = []
        if not self._pending:
            return batch
        ring = [t for t in self._order if self._queues[t].items]
        for t in ring:
            self._queues[t].deficit += self.quantum * \
                self._queues[t].weight
        # rotate the ring so no tenant is always first
        self._order.rotate(-1)
        progress = True
        while len(batch) < self.max_batch and progress:
            progress = False
            for t in ring:
                q = self._queues[t]
                # interleaved sweeps, ~weight items per visit: the
                # weight ratio holds WITHIN a batch (not just across
                # batches), so one backlogged tenant can never starve
                # another out of a launch
                take = max(1, int(round(q.weight)))
                while (take > 0 and q.items and q.deficit >= 1.0
                       and len(batch) < self.max_batch):
                    batch.append(q.items.popleft())
                    self._pending -= 1
                    q.deficit -= 1.0
                    take -= 1
                    progress = True
        for t in ring:  # an emptied queue carries no credit forward
            q = self._queues[t]
            if not q.items:
                q.deficit = 0.0
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                if not self._pending:
                    self._work.wait(timeout=0.2)
                    if not self._pending:
                        continue
                # a short accumulation window so concurrent tenants'
                # submissions land in ONE launch (continuous batching)
            # the window wait is interruptible: a graceful stop
            # mid-window falls through to the drain flush below
            # instead of sleeping the window out while stop() times
            # out and resolves the queued work "unknown"
            if self._stop.wait(timeout=self.window_s):
                break
            with self._lock:
                batch = self._drain_fair_locked()
            if batch:
                # the decision log's why: a full batch fired on size,
                # a partial one on window expiry
                reason = "full" if len(batch) >= self.max_batch \
                    else "timeout"
                self._run_batch(batch, reason)
        # graceful stop (stop(), never kill()): flush what is already
        # queued so accepted work gets real verdicts, not "unknown"
        while self._drain_req.is_set():
            with self._lock:
                batch = self._drain_fair_locked()
            if not batch:
                break
            self._run_batch(batch, "drain")

    def _run_batch(self, batch: list[WorkItem],
                   reason: str = "timeout") -> None:
        t_drain = frec.now()
        for i in batch:
            i.times["drain"] = t_drain
        tenants = {i.tenant for i in batch}
        with self._lock:
            st = self._stats
            st["items"] += len(batch)
            if len(tenants) > 1:
                st["cross_tenant_launches"] += 1
            st["max_tenants_in_launch"] = max(
                st["max_tenants_in_launch"], len(tenants))
        telemetry.count("fleet.batch.rounds")
        telemetry.count("fleet.batch.items", len(batch))
        telemetry.gauge_max("fleet.batch.tenants", len(tenants))
        slices = [i for i in batch if i.kind == "slice"]
        finals = [i for i in batch if i.kind == "final"]
        try:
            if slices:
                self._run_slices(slices, reason)
        finally:
            # finals still run if the slice pass died; and every item
            # resolves no matter what (finish() below is uncond.)
            if finals:
                self._run_finals(finals, reason)

    def _stamp_launch(self, items: list[WorkItem], t0: int, t1: int,
                      device_ms: float, certify_ms: float) -> None:
        """Per-item stamp of the shared launch: the group's measured
        phase totals split evenly across its items (a batched launch
        has no truer per-item attribution than its fair share)."""
        n = max(len(items), 1)
        wall_ms = (t1 - t0) / 1e6
        encode_ms = max(wall_ms - device_ms - certify_ms, 0.0)
        for i in items:
            i.times.update(
                launch0=t0, launch1=t1,
                encode_ms=encode_ms / n, device_ms=device_ms / n,
                certify_ms=certify_ms / n)

    def _run_slices(self, items: list[WorkItem],
                    reason: str) -> None:
        # already-quarantined runs never enter the shared launch:
        # their items go straight to the solo lane (with a
        # cooldown-gated device probe), so one poison history can't
        # keep killing everyone else's batches
        shared: list[WorkItem] = []
        solo: dict[tuple[str, str], list[WorkItem]] = {}
        for i in items:
            if self.quarantine.is_quarantined(i.tenant, i.run):
                solo.setdefault((i.tenant, i.run), []).append(i)
            else:
                shared.append(i)
        if shared:
            self._launch_slices(shared, reason)
        for (tenant, run), group in solo.items():
            self._quarantined_slices(tenant, run, group)

    def _launch_slices(self, items: list[WorkItem],
                       reason: str) -> None:
        from ..gpu import wgl

        pairs = [i.payload for i in items]  # (Encoded, start_state)
        try:
            t0, r0 = frec.now(), util.relative_time_nanos()
            out, unk = wgl.check_slices(pairs, device=self.device)
            t1, r1 = frec.now(), util.relative_time_nanos()
            device_ms, certify_ms = frec.kernel_phases(r0, r1)
            self._stamp_launch(items, t0, t1, device_ms, certify_ms)
            with self._lock:
                self._stats["launches"] += 1
                self._stats["slice_launches"] += 1
                self._stats["slice_rows"] += len(pairs)
            if self.flightrec is not None:
                self.flightrec.launch(
                    "slice", reason, t0, t1, rows=len(pairs),
                    capacity=self.max_batch, items=items,
                    device_ms=device_ms, certify_ms=certify_ms)
            self._breaker.record(True)
            for i, mask, u in zip(items, out, unk):
                i.finish({"mask": int(mask), "unknown": bool(u)})
        except Exception as e:  # noqa: BLE001 — never wedge a queue
            logger.exception("fleet slice batch failed")
            self._attribute_slice_failure(items, repr(e))

    def _attribute_slice_failure(self, items: list[WorkItem],
                                 error: str) -> None:
        """A dead shared launch: find WHICH run poisoned it by
        bisecting the batch along run boundaries. Runs whose slices
        succeed solo get their real masks; a run that fails alone is
        the poison — quarantine it and serve it from the solo lane.
        Only when EVERY run fails solo is the failure systemic, and
        only then does the fleet breaker see it."""
        from ..gpu import wgl

        groups: dict[tuple[str, str], list[WorkItem]] = {}
        for i in items:
            groups.setdefault((i.tenant, i.run), []).append(i)
        keys = list(groups)
        ok_runs: list[tuple[str, str]] = []
        bad_runs: list[tuple[str, str]] = []

        def bisect(ks: list[tuple[str, str]]) -> None:
            sub = [i for k in ks for i in groups[k]]
            try:
                with self._lock:
                    self._stats["bisect_launches"] += 1
                out, unk = wgl.check_slices([i.payload for i in sub],
                                            device=self.device)
            except Exception:  # noqa: BLE001 — attribution probe
                if len(ks) == 1:
                    bad_runs.append(ks[0])
                    return
                mid = len(ks) // 2
                bisect(ks[:mid])
                bisect(ks[mid:])
                return
            ok_runs.extend(ks)
            for i, mask, u in zip(sub, out, unk):
                i.finish({"mask": int(mask), "unknown": bool(u)})

        if len(keys) == 1:
            bad_runs.append(keys[0])
        else:
            bisect(keys)
        telemetry.count("fleet.quarantine.attributions")
        if not ok_runs and len(keys) > 1:
            # every run fails solo: the DEVICE is sick, not a history
            # — this is what the fleet breaker is for
            self._breaker.record(False)
            for k in keys:
                for i in groups[k]:
                    if not i.done.is_set():
                        i.finish({"mask": 0, "unknown": True,
                                  "error": error})
            return
        if ok_runs:
            self._breaker.record(True)  # attributed: device is fine
        for k in bad_runs:
            self._quarantine_run(k[0], k[1], error)
            self._quarantined_slices(k[0], k[1], groups[k],
                                     probe=False)

    def _quarantine_run(self, tenant: str, run: str,
                        error: str) -> None:
        if self.quarantine.add(tenant, run, error) \
                and self.flightrec is not None:
            self.flightrec.quarantine(tenant, run, "quarantined",
                                      error)

    def _quarantined_slices(self, tenant: str, run: str,
                            items: list[WorkItem],
                            probe: bool = True) -> None:
        """The solo lane for a quarantined run's slices: a
        cooldown-gated SOLO device probe first (success releases the
        run), then, on the CPU, the host reach search — exact masks,
        never wrong, just not sharing anyone's launch. On the card the
        items finish with the launch's error instead."""
        from ..gpu import wgl

        t0 = frec.now()
        if probe and self.quarantine.probe_due(tenant, run):
            try:
                out, unk = wgl.check_slices(
                    [i.payload for i in items], device=self.device)
                self.quarantine.record_probe(tenant, run, True)
                if self.flightrec is not None:
                    self.flightrec.quarantine(tenant, run,
                                              "released", "")
                for i, mask, u in zip(items, out, unk):
                    i.finish({"mask": int(mask), "unknown": bool(u)})
                return
            except Exception:  # noqa: BLE001 — probe failure re-arms
                self.quarantine.record_probe(tenant, run, False)
        host = self._host_lanes()
        for i in items:
            if not host:
                i.finish({"mask": 0, "unknown": True,
                          "error": self.quarantine.error(tenant, run)})
                continue
            try:
                enc, s = i.payload
                mask = int(wgl.search_host_reach(enc.with_init(s)))
                i.finish({"mask": mask, "unknown": False})
            except Exception as e:  # noqa: BLE001 — never wedge
                i.finish({"mask": 0, "unknown": True,
                          "error": repr(e)})
        t1 = frec.now()
        self._stamp_launch(items, t0, t1, 0.0, 0.0)
        with self._lock:
            self._stats["quarantine_items"] += len(items)
        telemetry.count("fleet.quarantine.host-items" if host
                        else "fleet.quarantine.error-items", len(items))
        if self.flightrec is not None:
            self.flightrec.launch(
                "slice", "quarantine", t0, t1, rows=len(items),
                capacity=self.max_batch, items=items,
                device_ms=0.0, certify_ms=0.0)

    def _run_finals(self, items: list[WorkItem],
                    reason: str) -> None:
        """Finals grouped per model spec -> one batched launch per
        group. payload: {'engine': 'wgl'|'elle', 'model': name,
        'history': History}."""
        groups: dict[tuple, list[WorkItem]] = {}
        for i in items:
            # the initial value is part of the model spec: different
            # initials can't share one batched launch
            key = (i.payload["model"], i.payload.get("initial"))
            groups.setdefault(key, []).append(i)
        for (model_name, initial), group in groups.items():
            self._run_final_group(model_name, initial, group, reason)

    def _run_final_group(self, model_name: str, initial,
                         group: list[WorkItem],
                         reason: str) -> None:
        from . import build_model, elle_checks

        engine = group[0].payload["engine"]
        # quarantined runs' finals go to the solo lane too (with
        # the same cooldown-gated probe), so one poison history can't
        # kill the whole model group's batched launch
        if engine == "wgl":
            solo = [g for g in group
                    if self.quarantine.is_quarantined(g.tenant,
                                                      g.run)]
            if solo:
                group = [g for g in group if g not in solo]
                runs: dict[tuple[str, str], list[WorkItem]] = {}
                for g in solo:
                    runs.setdefault((g.tenant, g.run), []).append(g)
                for (tenant, run), sub in runs.items():
                    self._quarantined_finals(model_name, initial,
                                             tenant, run, sub)
            if not group:
                return
        hists = [g.payload["history"] for g in group]
        # the breaker decision is made HERE, once per group, so the
        # decision log can attribute the launch to it
        host = engine == "wgl" and not self._breaker.allow_device()
        if host:
            reason = "breaker"
            if not self._host_lanes():
                self._refuse_finals(group)
                return
        try:
            t0, r0 = frec.now(), util.relative_time_nanos()
            if engine == "wgl":
                results = self._wgl_finals(
                    build_model(model_name, initial), hists, host)
            else:
                check = elle_checks()[model_name]
                results = [check(h, {"certify": True,
                                      "device": self.device})
                           for h in hists]
            t1, r1 = frec.now(), util.relative_time_nanos()
            device_ms, certify_ms = frec.kernel_phases(r0, r1)
            self._stamp_launch(group, t0, t1, device_ms, certify_ms)
            with self._lock:
                self._stats["launches"] += 1
                self._stats["final_launches"] += 1
                self._stats["final_hists"] += len(hists)
            if self.flightrec is not None:
                self.flightrec.launch(
                    "final", reason, t0, t1, rows=len(hists),
                    capacity=self.max_batch, items=group,
                    device_ms=device_ms, certify_ms=certify_ms)
            self._breaker.record(True)
            for g, r in zip(group, results):
                g.finish(r)
        except Exception as e:  # noqa: BLE001 — never wedge a queue
            logger.exception("fleet final batch failed (%s)",
                             model_name)
            if engine == "wgl" and not host:
                self._attribute_final_failure(model_name, initial,
                                              group, repr(e))
            else:
                self._breaker.record(False)
                for g in group:
                    if not g.done.is_set():
                        g.finish({"valid?": "unknown",
                                  "error": repr(e)})

    def _attribute_final_failure(self, model_name: str, initial,
                                 group: list[WorkItem],
                                 error: str) -> None:
        """Per-run attribution for a dead finals launch, mirroring
        _attribute_slice_failure: solo device retries per run; the run
        that still dies alone is quarantined and served by the solo
        lane; all runs dying solo is systemic and goes to the
        fleet breaker."""
        from . import build_model

        groups: dict[tuple[str, str], list[WorkItem]] = {}
        for g in group:
            groups.setdefault((g.tenant, g.run), []).append(g)
        keys = list(groups)
        ok_runs: list[tuple[str, str]] = []
        bad_runs: list[tuple[str, str]] = []
        for k in keys:
            sub = [g for g in groups[k] if not g.done.is_set()]
            if not sub:
                ok_runs.append(k)
                continue
            try:
                with self._lock:
                    self._stats["bisect_launches"] += 1
                results = self._wgl_finals(
                    build_model(model_name, initial),
                    [g.payload["history"] for g in sub], False)
                for g, r in zip(sub, results):
                    g.finish(r)
                ok_runs.append(k)
            except Exception:  # noqa: BLE001 — attribution probe
                bad_runs.append(k)
        telemetry.count("fleet.quarantine.attributions")
        if not ok_runs and len(keys) > 1:
            self._breaker.record(False)
            for k in keys:
                for g in groups[k]:
                    if not g.done.is_set():
                        g.finish({"valid?": "unknown",
                                  "error": error})
            return
        if ok_runs:
            self._breaker.record(True)
        else:
            # a single-run batch that died solo: quarantine serves it
            # from the solo lane; its own probe decides when it may
            # rejoin the shared pool
            self._breaker.record(False)
        for k in bad_runs:
            self._quarantine_run(k[0], k[1], error)
            self._quarantined_finals(model_name, initial, k[0], k[1],
                                     groups[k], probe=False)

    def _quarantined_finals(self, model_name: str, initial,
                            tenant: str, run: str,
                            group: list[WorkItem],
                            probe: bool = True) -> None:
        """Solo lane for a quarantined run's finals: cooldown-gated
        device probe, then, on the CPU, the pure-host algorithm — the
        same slower-never-wrong floor the fleet breaker uses, but
        scoped to ONE run. On the card the items finish with the
        launch's error instead."""
        from . import build_model
        from ..gpu import wgl

        group = [g for g in group if not g.done.is_set()]
        if not group:
            return
        model = build_model(model_name, initial)
        hists = [g.payload["history"] for g in group]
        t0 = frec.now()
        if probe and self.quarantine.probe_due(tenant, run):
            try:
                results = self._wgl_finals(model, hists, False)
                self.quarantine.record_probe(tenant, run, True)
                if self.flightrec is not None:
                    self.flightrec.quarantine(tenant, run,
                                              "released", "")
                for g, r in zip(group, results):
                    g.finish(r)
                return
            except Exception:  # noqa: BLE001 — probe failure re-arms
                self.quarantine.record_probe(tenant, run, False)
        host = self._host_lanes()
        for g, h in zip(group, hists):
            if not host:
                g.finish({"valid?": "unknown",
                          "error": self.quarantine.error(tenant, run)})
                continue
            try:
                g.finish(wgl.analysis(model, h, algorithm="wgl",
                                      certify=True, device=self.device))
            except Exception as e:  # noqa: BLE001 — never wedge
                g.finish({"valid?": "unknown", "error": repr(e)})
        t1 = frec.now()
        self._stamp_launch(group, t0, t1, 0.0, 0.0)
        with self._lock:
            self._stats["quarantine_items"] += len(group)
        telemetry.count("fleet.quarantine.host-items" if host
                        else "fleet.quarantine.error-items", len(group))
        if self.flightrec is not None:
            self.flightrec.launch(
                "final", "quarantine", t0, t1, rows=len(group),
                capacity=self.max_batch, items=group,
                device_ms=0.0, certify_ms=0.0)

    def _refuse_finals(self, group: list[WorkItem]) -> None:
        """The open breaker on the card: the group's finals finish with
        an error (no host search), counted as the host lane's would
        be; the breaker is left as it is."""
        t0 = frec.now()
        with self._lock:
            self._stats["host_floor"] += len(group)
        telemetry.count("fleet.breaker.error-finals", len(group))
        for g in group:
            g.finish({"valid?": "unknown",
                      "error": "fleet device breaker open"})
        t1 = frec.now()
        self._stamp_launch(group, t0, t1, 0.0, 0.0)
        if self.flightrec is not None:
            self.flightrec.launch(
                "final", "breaker", t0, t1, rows=len(group),
                capacity=self.max_batch, items=group,
                device_ms=0.0, certify_ms=0.0)

    def _wgl_finals(self, model, hists,
                    host: bool = False) -> list[dict]:
        from ..gpu import wgl

        if host:
            # breaker open: the pure-host reference search — the fleet
            # degrades to slower, never to wrong or wedged
            with self._lock:
                self._stats["host_floor"] += len(hists)
            telemetry.count("fleet.breaker.host-finals", len(hists))
            return [wgl.analysis(model, h, algorithm="wgl",
                                 certify=True, device=self.device)
                    for h in hists]
        return wgl.analysis_batch_streamed(model, hists, certify=True,
                                           device=self.device)


# ---------------------------------------------------------------------------
# Streaming checks: verdicts tighten as chunks arrive
# ---------------------------------------------------------------------------

class StreamingRun:
    """The online watchdog generalized into streaming wgl: as a
    tenant's chunks arrive, the accumulated prefix is encoded, cut at
    real-time-safe points, and each new segment is submitted as reach
    slices (one row per live start state) that the scheduler packs
    ACROSS tenants into shared launches. The live state-mask chain
    tightens the verdict mid-run: mask 0 at any cut proves the full
    history cannot linearize (tentative-invalid, minutes before fin);
    a surviving chain reports how much of the stream is already
    certified-reachable.

    Soundness: a cut is taken only where the PREFIX's real-time order
    forces all earlier entries before all later ones AND no streamed
    op is still open (an open invocation encodes as crashed ret=INF,
    which valid_cut_points already treats as forbidding later cuts).
    Ops not yet streamed invoke later in history order than everything
    already cut, so prefix cuts remain cuts of the final history.

    add_ops is called under the server's per-run ingest lock (so
    reconnect races can't reorder chunks) and is CHEAP — it appends
    and, at most, spawns the step worker. All encode/cut work runs on
    that worker thread, never on the chunk-ack path; slice results
    return on the scheduler thread. Shared state advances under
    `_lock`. (The worker re-encodes the whole prefix each step — fine
    at streaming-chunk cadence; incremental encoding is the known
    scaling lever when streams reach millions of ops.)
    """

    _guarded_by_lock = {"_lock": ("_ops", "_since", "_mask",
                                  "_checked", "_state", "_inflight",
                                  "_frac")}

    STREAM_EVERY = 128  # re-encode the prefix every N new ops
    MAX_SEG = 2048      # preferred segment length (soundness first:
    # a further-out cut is taken when no valid cut lands within it)

    def __init__(self, model_name: str, scheduler: Scheduler,
                 tenant: str, run: str, initial=None):
        from . import build_model, wgl_models

        self.tenant = tenant
        self.run = run
        self.scheduler = scheduler
        self.model_name = model_name
        self._model = build_model(model_name, initial) \
            if model_name in wgl_models() else None
        self._ops: list = []
        self._since = 0
        self._lock = threading.Lock()
        self._mask: int | None = None  # None until first segment
        self._checked = 0              # entries certified so far
        self._frac = 0.0
        self._state = "streaming" if self._model is not None \
            else "unsupported"
        self._inflight = False
        # set once at attach time (before streaming starts): called
        # with each stream-wgl checkpoint record after a segment's
        # mask lands — the server persists it and compacts the WAL
        self.ckpt_sink = None

    def add_ops(self, ops: list) -> None:
        with self._lock:
            self._ops.extend(ops)
            self._since += len(ops)
            # the due-credit is NOT reset here: step() consumes it
            # only when a worker actually launches, so ops arriving
            # while a segment is in flight keep their claim and the
            # finishing _collect re-kicks for them
            due = self._since >= self.STREAM_EVERY
        if due:
            self.step()

    def status(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "checked-frac": round(self._frac, 4),
                    "ops": len(self._ops)}

    def seed(self, ops: list, rec: dict | None) -> bool:
        """Restart recovery: adopts the replayed ops AND, when the
        checkpoint record proves it describes a prefix of them
        (kind/model match + ops_digest over the first n_ops), resumes
        the certified frontier — checked entries, live state mask —
        so the stream re-checks only the suffix instead of replaying
        from entry 0. A stale/mismatched record is ignored (counted),
        never trusted: the stream falls back to a full re-check."""
        from ..gpu import ckpt

        resumed = False
        if rec is not None and self._model is not None:
            ok = (rec.get("kind") == "stream-wgl"
                  and rec.get("model") == self.model_name
                  and rec.get("n_ops", 0) <= len(ops)
                  and ckpt.ops_digest(ops, rec["n_ops"])
                  == rec.get("digest"))
            if ok:
                resumed = True
                telemetry.count("ckpt.resumed")
            else:
                telemetry.count("ckpt.stale")
        with self._lock:
            self._ops = list(ops)
            if resumed:
                self._checked = int(rec["checked"])
                self._mask = int(rec["mask"])
                if self._mask == 0 and self._state == "streaming":
                    self._state = "tentative-invalid"
            # everything past the checkpoint is due immediately
            self._since = max(len(ops), self.STREAM_EVERY)
        return resumed

    # -- the streaming step ---------------------------------------------

    def step(self) -> None:
        """Kicks the step worker (if the run is streaming and no
        segment is already in flight). The worker encodes the prefix
        snapshot and submits the next unchecked segment's reach slices
        — one segment in flight per run: its result chains into the
        next segment's start states, while OTHER runs' slices fill the
        same launch."""
        with self._lock:
            if self._state != "streaming" or self._inflight:
                return
            self._inflight = True
            self._since = 0  # the worker now owns the due-credit
        threading.Thread(
            target=self._step_work,
            name=f"fleet-stream-{self.tenant}-{self.run}",
            daemon=True).start()

    def _step_work(self) -> None:
        from ..gpu import encode as enc_mod
        from ..gpu import wgl

        def settle(state: str | None = None) -> None:
            """Early exit WITHOUT launching: the due-credit step()
            consumed goes back (add_ops documents that credit is only
            spent on a real launch), so the ops that earned it get
            their check as soon as the next chunk — or _collect's
            re-kick — fires."""
            with self._lock:
                self._inflight = False
                if state is not None:
                    self._state = state
                elif self._since < self.STREAM_EVERY:
                    self._since = self.STREAM_EVERY

        try:
            with self._lock:
                snapshot = list(self._ops)
                lo = self._checked
                mask = self._mask
            try:
                enc = enc_mod.encode(self._model, History(snapshot))
            except enc_mod.EncodingError:
                return settle("unsupported")
            if enc.n_states > 32:
                return settle("unsupported")
            if mask is None:
                mask = 1 << enc.init_state
            cuts = [int(c) for c in wgl.valid_cut_points(enc)
                    if c > lo]
            if not cuts:
                return settle()
            # furthest valid cut within the preferred segment length;
            # when none lands inside it, the NEAREST cut beyond wins —
            # never a non-cut boundary, which would let ops span the
            # segment edge and fabricate a tentative-invalid
            within = [c for c in cuts if c <= lo + self.MAX_SEG]
            hi = within[-1] if within else cuts[0]
            if hi - lo < self.STREAM_EVERY // 2 and hi < enc.m:
                return settle()  # too little new work to launch for
            seg = enc.segment(lo, hi)
            states = [s for s in range(enc.n_states)
                      if (mask >> s) & 1]
            if not states:
                return settle()
            # ONE Encoded shared across the start-state rows:
            # check_slices dedupes by identity, so the segment's
            # tensors are packed once however many states are live
            # (the row carries s)
            items = [self.scheduler.submit(
                "slice", self.tenant, self.run, (seg, s))
                for s in states]
            # the checkpoint cut in RAW-op coordinates: every entry
            # below a valid cut completed, so the furthest completion
            # position bounds the raw prefix the cut certifies
            raw_cut = int(enc.ret_t[:hi].max()) + 1 if hi > 0 else 0
            ck = {"n_ops": raw_cut,
                  "digest": _ckpt_mod().ops_digest(snapshot, raw_cut)}
        except Exception:  # noqa: BLE001 — streaming is advisory
            logger.exception("streaming step failed")
            return settle("unknown")
        self._collect(items, lo, hi, enc.m, ck)

    def _collect(self, items: list[WorkItem], lo: int, hi: int,
                 total_m: int, ck: dict | None = None) -> None:
        new_mask = 0
        unknown = False
        for i in items:
            i.done.wait(timeout=120)
            r = i.result or {}
            if not i.done.is_set() or r.get("unknown"):
                unknown = True
            new_mask |= int(r.get("mask") or 0)
        with self._lock:
            self._inflight = False
            if self._state != "streaming":
                return
            if unknown:
                # the device couldn't decide this segment: streaming
                # stops tightening; the final check stays authoritative
                self._state = "unknown"
                return
            self._mask = new_mask
            self._checked = hi
            self._frac = hi / max(total_m, 1)
            if new_mask == 0:
                # no state survives the prefix: the full history can
                # never linearize — the verdict tightened to invalid
                # BEFORE the stream even finished
                self._state = "tentative-invalid"
                telemetry.count("fleet.stream.tentative-invalid")
        telemetry.count("fleet.stream.segments")
        sink = self.ckpt_sink
        if sink is not None and ck is not None:
            # checkpoint OUTSIDE the lock: the sink does file I/O
            # (atomic ckpt write + WAL compaction) and must never
            # block add_ops/status
            try:
                ckpt = _ckpt_mod()
                sink({"v": ckpt.VERSION, "kind": "stream-wgl",
                      "model": self.model_name, "checked": hi,
                      "mask": new_mask, "n_ops": ck["n_ops"],
                      "digest": ck["digest"]})
            except Exception:  # noqa: BLE001 — checkpoints are
                logger.exception("stream checkpoint sink failed")
                # advisory: a failed write degrades resume, not verdicts
        with self._lock:
            pending = (self._state == "streaming"
                       and self._since >= self.STREAM_EVERY)
        if pending:
            # ops that arrived while this segment was in flight kept
            # their due-credit: check them now, don't wait for more
            self.step()
