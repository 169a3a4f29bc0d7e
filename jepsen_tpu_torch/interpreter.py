"""The execution engine (the port's copy of jepsen_tpu/interpreter.py):
interprets operations from a pure generator, spawning one worker thread
per logical thread, applying ops through clients/nemeses, and journaling
invocations + completions to a history.

Capability reference: jepsen/src/jepsen/generator/interpreter.clj (Worker
protocol 22-34, ClientWorker 36-70, spawn-worker 102-167, run! 184-337).
The hot-loop structure is preserved: poll completions first (they're
latency-sensitive), then ask the generator, dispatch with a 1-slot
inbound queue per worker, crash-to-:info conversion, process
reincarnation on :info, and incremental history writes.

The live monitor (monitor.Monitor: on_dispatch/on_complete/on_stall)
and the online watchdog (watchdog.Watchdog: observe/tripped/
early_abort) are optional: core.run builds them from the test map and
puts them under test["monitor"] and test["watchdog"], and the main loop
calls their hooks when they are there.
"""

from __future__ import annotations

import logging
import queue
import threading
import traceback

from . import client as jclient
from . import generator as gen
from . import telemetry
from . import tracing
from . import util
from .generator.context import NEMESIS
from .history import History, Op

logger = logging.getLogger(__name__)

# When the generator is :pending, the max interval before re-checking (µs)
# (interpreter.clj:169-173).
MAX_PENDING_INTERVAL_US = 1000


def goes_in_history(op: Op) -> bool:
    """:sleep and :log ops are not journaled (interpreter.clj:175-182)."""
    return op.type not in ("sleep", "log")


class Worker:
    """Stateful per-thread op executor; all calls on one thread
    (interpreter.clj:22-34)."""

    def open(self, test, wid) -> "Worker":
        return self

    def invoke(self, test, op: Op) -> Op:
        raise NotImplementedError

    def close(self, test) -> None:
        pass


class ClientWorker(Worker):
    """Wraps a client, reopening it whenever the process changes and the
    client isn't reusable (interpreter.clj:36-70)."""

    def __init__(self, node):
        self.node = node
        self.process = None
        self.client = None

    def invoke(self, test, op):
        while True:
            if (self.process != op.process
                    and not jclient.is_reusable(self.client, test)):
                self.close(test)
                try:
                    c = jclient.validate(test["client"])
                    if jclient.should_trace(test):
                        # the traced_client wrapper (dgraph trace.clj
                        # analog): each client call becomes a child
                        # span of the op's trace context
                        c = jclient.Traced(c)
                    self.client = c.open(test, self.node)
                    self.process = op.process
                except Exception as e:  # noqa: BLE001
                    logger.warning("Error opening client: %s", e)
                    self.client = None
                    return op.copy(type="fail",
                                   error=["no-client", str(e)])
                continue
            return self.client.invoke(test, op)

    def close(self, test):
        if self.client is not None:
            self.client.close(test)
            self.client = None


class NemesisWorker(Worker):
    def invoke(self, test, op):
        return test["nemesis"].invoke(test, op)


class ClientNemesisWorker(Worker):
    """Spawns client workers for integer ids, a nemesis worker otherwise
    (interpreter.clj:81-95)."""

    def open(self, test, wid):
        if isinstance(wid, int):
            nodes = list(test.get("nodes") or [None])
            return ClientWorker(nodes[wid % len(nodes)])
        return NemesisWorker()


def spawn_worker(test, out: queue.Queue, worker: Worker, wid):
    """One thread + 1-slot inbound queue per worker
    (interpreter.clj:102-167). Returns {'id','thread','in'}."""
    inq: queue.Queue = queue.Queue(maxsize=1)

    def run():
        import time as _t

        w = worker.open(test, wid)
        # per-op stats accumulate locally and flush once at exit: the
        # hot loop must not contend on the recorder's lock across all
        # worker threads
        tel = telemetry.get()
        tracer = tracing.get()
        epoch0 = tel.epoch
        invoke_ns = 0
        type_counts: dict = {}
        crashes = 0
        try:
            while True:
                op = inq.get()
                t0 = None
                try:
                    if op.type == "exit":
                        return
                    if op.type == "sleep":
                        _t.sleep(op.value)
                        out.put(op)
                    elif op.type == "log":
                        logger.info("%s", op.value)
                        out.put(op)
                    else:
                        t0 = _t.monotonic_ns()
                        if tracer.enabled:
                            # mint the op's trace context: trace id =
                            # the invocation's op index, so client/
                            # remote child spans join the history
                            with tracer.op_span(op) as trec:
                                op2 = w.invoke(test, op)
                                if trec is not None:
                                    trec["status"] = op2.type
                        else:
                            op2 = w.invoke(test, op)
                        invoke_ns += _t.monotonic_ns() - t0
                        t0 = None
                        type_counts[op2.type] = type_counts.get(
                            op2.type, 0) + 1
                        out.put(op2)
                except Exception as e:  # noqa: BLE001 - crash becomes :info
                    if t0 is not None:
                        # crashed invokes still spent client time (a
                        # 30s timeout-then-raise is exactly the kind
                        # of wait this counter exists to expose)
                        invoke_ns += _t.monotonic_ns() - t0
                    logger.warning("Process %s crashed: %s", op.process, e)
                    crashes += 1
                    out.put(op.copy(
                        type="info",
                        exception=traceback.format_exc(),
                        error=f"indeterminate: {e}"))
        finally:
            # abnormal interpreter exits signal workers but don't join
            # them, so this finally may fire after a LATER run reset
            # the recorder — the epoch check keeps a straggler's tallies
            # out of that run's metrics (the crashed run's artifacts
            # simply miss this worker's counts, which is best-effort)
            if tel.epoch == epoch0:
                if invoke_ns:
                    tel.count("interpreter.invoke_ns", invoke_ns)
                for ty, n in type_counts.items():
                    tel.count(f"interpreter.ops.{ty}", n)
                if crashes:
                    tel.count("interpreter.worker-crashes", crashes)
            try:
                w.close(test)
            except Exception:  # noqa: BLE001
                logger.exception("Error closing worker %s", wid)

    t = threading.Thread(target=run, name=f"jepsen-worker-{wid}", daemon=True)
    t.start()
    return {"id": wid, "thread": t, "in": inq}


class MemoryHistoryWriter:
    """In-memory history sink (the disk-backed writer is
    store.format.HistoryWriter, which store.start_test attaches)."""

    def __init__(self):
        self.ops: list[Op] = []

    def append(self, op: Op) -> None:
        self.ops.append(op)

    def close(self) -> None:
        pass

    def read_back(self) -> History:
        return History(self.ops, assign_indices=False)


def run(test: dict) -> dict:
    """Runs (:generator test) against (:client test)/(:nemesis test),
    returning the test with a completed :history (interpreter.clj:184-337).
    """
    writer = test.get("history_writer") or MemoryHistoryWriter()
    ctx = gen.context(test)
    worker_ids = ctx.all_thread_names()
    completions: queue.Queue = queue.Queue(maxsize=len(worker_ids))
    workers = [spawn_worker(test, completions, ClientNemesisWorker(), wid)
               for wid in worker_ids]
    invocations = {w["id"]: w["in"] for w in workers}
    g = gen.validate(gen.friendly_exceptions(test.get("generator")))
    test = dict(test)
    test.pop("generator", None)

    # live-observability hooks (both optional): the monitor samples
    # rates/in-flight/latencies, the watchdog checks safety online.
    # Their calls are a few dict updates each.
    mon = test.get("monitor")
    wd = test.get("watchdog")
    if wd is not None and not hasattr(wd, "observe"):
        wd = None  # an unbuilt spec (core.run builds the object)

    op_index = 0
    outstanding = 0
    poll_timeout_us = 0
    # local tallies, flushed once below — no recorder locking in the
    # hot loop (same rule as the worker threads)
    dispatched = 0
    stalls = 0

    def finish():
        """Drains workers, closes the writer, reads the history back."""
        for q in invocations.values():
            q.put(Op(type="exit"))
        for w in workers:
            w["thread"].join()
        writer.close()
        test["history"] = writer.read_back()
        return test

    try:
        while True:
            op2 = None
            if poll_timeout_us > 0:
                try:
                    op2 = completions.get(timeout=poll_timeout_us / 1e6)
                except queue.Empty:
                    op2 = None
            else:
                try:
                    op2 = completions.get_nowait()
                except queue.Empty:
                    op2 = None

            if op2 is not None:
                # Completion path (interpreter.clj:228-256).
                thread = ctx.process_to_thread_name(op2.process)
                now = util.relative_time_nanos()
                op2 = op2.copy(index=op_index, time=now)
                ctx = ctx.free_thread(now, thread)
                g = gen.update(g, test, ctx, op2)
                if thread != NEMESIS and (op2.type == "info"
                                          or op2.get("end_process?")):
                    ctx = ctx.with_next_process(thread)
                if goes_in_history(op2):
                    writer.append(op2)
                    op_index += 1
                    if mon is not None:
                        mon.on_complete(op2, thread, now)
                    if wd is not None:
                        wd.observe(op2)
                        if wd.tripped and wd.early_abort:
                            # safety already lost: stop generating,
                            # keep what we have (the full checkers
                            # still run over it)
                            logger.warning(
                                "watchdog tripped; aborting run early")
                            test["aborted"] = "watchdog"
                            return finish()
                outstanding -= 1
                poll_timeout_us = 0
                continue

            # Ask the generator (interpreter.clj:258-318).
            now = util.relative_time_nanos()
            ctx = ctx.with_time(now)
            res = gen.op(g, test, ctx)
            if res is None:
                if outstanding > 0:
                    poll_timeout_us = MAX_PENDING_INTERVAL_US
                    continue
                # Done: drain workers, close writer, read history back.
                return finish()

            op_, g2 = res
            if op_ is gen.PENDING:
                # Keep the pre-call generator state, like the reference
                # (interpreter.clj:290-291).
                stalls += 1
                if mon is not None:
                    mon.on_stall()
                poll_timeout_us = MAX_PENDING_INTERVAL_US
                continue

            if now < op_.time:
                # Not due yet: leave g unconsumed and re-ask once the op
                # is due or a completion changes circumstances
                # (interpreter.clj:294-300).
                poll_timeout_us = max(1, (op_.time - now) // 1000)
                continue

            # Dispatch (interpreter.clj:302-318).
            thread = ctx.process_to_thread_name(op_.process)
            op_ = op_.copy(index=op_index)
            if goes_in_history(op_):
                writer.append(op_)
                op_index += 1
                if mon is not None:
                    mon.on_dispatch(op_, thread, now)
                if wd is not None:
                    wd.observe(op_)
            invocations[thread].put(op_)
            dispatched += 1
            ctx = ctx.busy_thread(op_.time, thread)
            g = gen.update(g2, test, ctx, op_)
            outstanding += 1
            poll_timeout_us = 0
    except BaseException:
        logger.info("Shutting down workers after abnormal exit")
        for w in workers:
            if w["thread"].is_alive():
                try:
                    w["in"].put_nowait(Op(type="exit"))
                except queue.Full:
                    pass
        raise
    finally:
        tel = telemetry.get()
        if dispatched:
            tel.count("interpreter.dispatched", dispatched)
        if stalls:
            tel.count("interpreter.generator-stalls", stalls)
