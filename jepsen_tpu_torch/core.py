"""Test lifecycle orchestration (the port's copy of jepsen_tpu/core.py).

A test is a plain dict. `run(test)` opens control sessions, sets up
OS/DB, spawns clients and nemesis, drives the generator through the
interpreter, tears everything down, checks the history, and returns the
test with :history and :results.

Capability reference: jepsen/src/jepsen/core.clj (run! 322-412,
prepare-test 302-320, with-resources 69-90, with-os 92-99, with-db
164-173, client+nemesis setup/teardown 175-206, run-case! 208-213,
analyze! 215-228, snarf-logs! 101-162, synchronize 43-56).

The analysis runs on the card through the checkers' own device switch
(each workload's checker takes opts["device"]; None is the card). Four
switches of the JAX package's run are not ported, and each raises
NotImplementedError naming its ROADMAP item instead of being ignored:
multi-host initialization (JAX_COORDINATOR_ADDRESS / JEPSEN_TPU_MULTIHOST,
A6), a profiled analysis (profile?, xla-trace?, profile_dir: A5,
torch.profiler), the fleet stream (fleet: A4) and the quarantine breakers
(quarantine?: A3c).
"""

from __future__ import annotations

import datetime
import logging
import os
import threading
from pathlib import Path

from . import client as jclient
from . import control
from . import coverage as jcoverage
from . import db as jdb
from . import interpreter
from . import monitor as jmonitor
from . import nemesis as jnemesis
from . import telemetry
from . import tracing
from . import util
from . import watchdog as jwatchdog

logger = logging.getLogger(__name__)

NO_BARRIER = "::no-barrier"


def synchronize(test: dict, timeout_s: float = 60.0) -> None:
    """Blocks until all nodes arrive at the same point (core.clj:43-56)."""
    barrier = test.get("barrier")
    if barrier == NO_BARRIER or barrier is None:
        return
    barrier.wait(timeout=timeout_s)


def primary(test: dict):
    return test["nodes"][0]


def prepare_test(test: dict) -> dict:
    """Fills in :start-time, :concurrency, :barrier (core.clj:302-320)."""
    test = dict(test)
    if not test.get("start_time"):
        test["start_time"] = datetime.datetime.now()
    if not test.get("concurrency"):
        test["concurrency"] = len(test.get("nodes") or [])
    if not test.get("barrier"):
        n = len(test.get("nodes") or [])
        test["barrier"] = threading.Barrier(n) if n > 0 else NO_BARRIER
    return test


def _setup_os(test: dict) -> None:
    os_ = test.get("os")
    if os_ is not None:
        control.on_nodes(test, lambda t, n: os_.setup(t, n))


def _teardown_os(test: dict) -> None:
    os_ = test.get("os")
    if os_ is not None:
        _teardown_tolerantly(test, "os",
                             lambda t, n: os_.teardown(t, n))


def _teardown_tolerantly(test: dict, what: str, node_fn) -> None:
    """Runs a per-node teardown phase on all nodes. Every node's
    teardown is attempted (a bare on_nodes call would surface only the
    FIRST node's failure, letting one node mask a teardown bug on
    another); the failures raise together. (The JAX package lets a
    quarantined node's transport failure degrade instead; quarantine
    is ROADMAP A3c.)"""
    errs: dict = {}

    def one(t, n):
        try:
            node_fn(t, n)
        except Exception as e:  # noqa: BLE001 — classified below
            errs[n] = e  # distinct keys per node: no lock needed

    control.on_nodes(test, one)
    if not errs:
        return
    failures = [errs[n] for n in sorted(errs, key=str)]
    if len(failures) == 1:
        raise failures[0]
    raise util.RealPmapError(failures)


def _db_cycle(test: dict) -> None:
    """Tears down then sets up the DB on all nodes, with primary setup
    (db.clj cycle!)."""
    db = test.get("db")
    if db is None:
        return

    def once():
        control.on_nodes(test, lambda t, n: db.teardown(t, n))
        if db.supports_primaries:
            db.setup_primary(test, primary(test))
        control.on_nodes(test, lambda t, n: db.setup(t, n))

    util.with_retry(once, retries=2, backoff=1.0)


def _teardown_db(test: dict) -> None:
    db = test.get("db")
    if db is not None and not test.get("leave_db_running?"):
        _teardown_tolerantly(test, "db",
                             lambda t, n: db.teardown(t, n))


def snarf_logs(test: dict) -> None:
    """Downloads DB log files into the store directory
    (core.clj:101-128)."""
    db = test.get("db")
    if db is None:
        return
    try:
        from . import store as jstore
    except ImportError:
        return
    if not test.get("name") or not test.get("start_time"):
        return

    def snarf(t, node):
        files = jdb.log_files_map(db, t, node)
        for remote, local in files.items():
            try:
                dest = jstore.path(t, str(node), local.lstrip("/"))
                dest.parent.mkdir(parents=True, exist_ok=True)
                control.download([remote], dest)
            except Exception as e:  # noqa: BLE001
                logger.info("couldn't download %s: %s", remote, e)

    try:
        control.on_nodes(test, snarf)
    except Exception:  # noqa: BLE001
        logger.exception("Error snarfing logs")


# Bound on the daemon nemesis-teardown join: a nemesis hung in
# teardown must not stall the run forever, but a silently leaked
# partition is worse — the timeout is surfaced via telemetry + log,
# and the final heal below still runs.
NEMESIS_TEARDOWN_TIMEOUT_S = 60.0


def final_heal(test: dict) -> None:
    """Last-resort cleanup after a case: heal the network and (when the
    test opted in via restore_clocks?) reset node clocks — even if the
    nemesis or its teardown thread died. The reference brackets its
    whole run in teardown forms (core.clj:322-387); without this, a
    partition opened by a crashed nemesis outlives the test and poisons
    the next one. Best-effort: failures are logged, never raised."""
    if not test.get("sessions"):
        return
    net = test.get("net")
    if net is not None:
        try:
            with telemetry.span("final-heal"):
                net.heal(test)
        except Exception:  # noqa: BLE001 — heal must not sink teardown
            telemetry.count("core.final-heal-failures")
            logger.exception("final net heal failed")
    if test.get("restore_clocks?"):
        from .nemesis import time as ntime

        try:
            with telemetry.span("final-clock-restore"):
                control.on_nodes(test, lambda t, n: ntime._meh_reset())
        except Exception:  # noqa: BLE001
            telemetry.count("core.final-heal-failures")
            logger.exception("final clock restore failed")


def run_case(test: dict) -> dict:
    """Sets up clients + nemesis, runs the generator via the interpreter,
    tears them down (core.clj:175-213). A final heal (net + clocks) is
    registered around the whole case so it fires even when the nemesis
    thread died mid-fault."""
    client = test["client"]
    nem = jnemesis.validate(test.get("nemesis") or jnemesis.noop)

    nem_box: dict = {}

    def setup_nemesis():
        try:
            nem_box["nem"] = nem.setup(test)
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller
            nem_box["error"] = e

    nem_thread = threading.Thread(target=setup_nemesis, daemon=True)
    nem_thread.start()

    def open_one(node):
        c = jclient.validate(client).open(test, node)
        c.setup(test)
        return c

    clients = util.real_pmap(open_one, test.get("nodes") or [])
    nem_thread.join()
    if "error" in nem_box:
        raise nem_box["error"]
    nemesis_up = nem_box["nem"]
    test = dict(test)
    test["nemesis"] = nemesis_up
    try:
        return interpreter.run(test)
    finally:
        def teardown_nem():
            try:
                nemesis_up.teardown(test)
            except Exception:  # noqa: BLE001 — teardown is best-effort;
                # the final heal below still clears partitions
                telemetry.count("core.nemesis-teardown-failures")
                logger.exception("nemesis teardown failed")

        nt = threading.Thread(target=teardown_nem, daemon=True)
        nt.start()

        def close_one(c):
            try:
                c.teardown(test)
            finally:
                c.close(test)

        try:
            util.real_pmap(close_one, clients)
        finally:
            nt.join(NEMESIS_TEARDOWN_TIMEOUT_S)
            if nt.is_alive():
                # the daemon thread is abandoned; whatever faults it
                # failed to undo are surfaced (and the final heal
                # below still clears partitions)
                telemetry.count("core.nemesis-teardown-timeouts")
                logger.warning(
                    "nemesis teardown still running after %.0fs; "
                    "abandoning it (possible leaked faults — final "
                    "heal will clear network partitions)",
                    NEMESIS_TEARDOWN_TIMEOUT_S)
            final_heal(test)


def analyze(test: dict, store_ctx=None, extra_opts: dict | None = None
            ) -> dict:
    """Runs the checker over the history (core.clj:215-228). With a
    store, composed checkers stream each sub-result to a partial-
    results log as they finish, so a crash mid-analysis leaves the
    completed results readable (store/format.clj PartialMap).
    extra_opts merge into the checker opts (the resume path passes
    recovered partial results through here)."""
    from . import checker as jchecker

    _refuse_profiling(test)
    logger.info("Analyzing...")
    checker = test.get("checker")
    if checker is None:
        checker = jchecker.unbridled_optimism()
    test = dict(test)
    opts = dict(extra_opts or {})
    partial = None
    if store_ctx is not None:
        try:
            from .store import format as sformat
            partial = sformat.PartialResultsWriter(
                store_ctx.path(test, "results.partial.jlog"))
            opts["partial_results"] = partial
        except Exception:  # noqa: BLE001 — partials are best-effort
            logger.exception("opening partial-results log failed")
    # a hung non-composed checker gets the same wall-clock bound the
    # Compose applies per sub-checker; composed checkers are bounded
    # individually inside (one outer bound would cap the whole set)
    timeout_s = None
    if not isinstance(checker, jchecker.Compose):
        timeout_s = jchecker.checker_timeout_s(test, opts)
    try:
        with telemetry.span("analyze"):
            test["results"] = jchecker.check_safe(
                checker, test, test["history"], opts,
                timeout_s=timeout_s)
    finally:
        if partial is not None:
            partial.close()
    # per-checker timings + phase/kernel counters ride in the results
    # (and therefore results.json) next to the verdict they explain
    if isinstance(test.get("results"), dict):
        # verdict certificates: every wgl/elle result carrying a proof
        # is independently re-validated against the raw history and
        # stamped `certified` / `certificate-error` — live here, and
        # offline too (analyze --resume re-enters this path), so a
        # device-kernel regression fails by proof, not by luck
        # (gpu/certify.py)
        try:
            from .gpu import certify as jcertify

            counts = jcertify.stamp_results(test["results"],
                                            test.get("history") or [])
            if any(counts.values()):
                logger.info(
                    "certificates: %d validated, %d failed, %d absent",
                    counts["certified"], counts["errors"],
                    counts["absent"])
        except Exception:  # noqa: BLE001 — stamping is best-effort
            logger.exception("certificate validation failed")
        test["results"]["telemetry"] = telemetry.get().summary()
        # the online watchdog's violations ride alongside too —
        # informational only, never folded into the checkers' valid?
        wd = test.get("watchdog")
        if wd is not None and hasattr(wd, "results"):
            test["results"]["watchdog"] = wd.results()
            if test.get("aborted"):
                test["results"]["watchdog"]["aborted"] = test["aborted"]
        # realtime-order verdicts (wgl linearizability, elle strict
        # variants) carry the clock skew actually measured during the
        # run: the node probe's per-tick offsets merged with the
        # history's check-offsets observations (nodeprobe.py).
        # Works offline too — `analyze` re-reads nodes.jsonl.
        try:
            from . import nodeprobe as jnodeprobe

            nprobe = test.get("nodeprobe")
            recs = (nprobe.records() if nprobe is not None
                    else jnodeprobe.load_records(test.get("store_dir")))
            bound = jnodeprobe.clock_skew_bound(recs,
                                                test.get("history"))
            if bound is not None:
                n = jnodeprobe.stamp_results(test["results"], bound)
                test["results"]["clock-skew-bound"] = bound
                logger.info("clock-skew-bound %.3fs stamped on %d "
                            "realtime verdict(s)", bound, n)
        except Exception:  # noqa: BLE001 — stamping is best-effort
            logger.exception("stamping clock-skew-bound failed")
    logger.info("Analysis complete")
    return test


def log_results(test: dict) -> dict:
    results = test.get("results") or {}
    valid = results.get("valid?")
    if valid is True:
        logger.info("Everything looks good! (results valid)")
    elif valid == "unknown":
        logger.info("Errors during analysis, but no anomalies found.")
    else:
        logger.info("Analysis invalid!")
    return test


def _refuse_profiling(test: dict) -> None:
    for key in ("profile?", "xla-trace?", "profile_dir"):
        if test.get(key):
            raise NotImplementedError(
                f"test[{key!r}]: a profiled analysis is not ported "
                "(ROADMAP A5, torch.profiler)")


def _refuse_unported(test: dict) -> None:
    """Raises for a switch of the JAX package's run that the port does
    not have, before anything of the run starts."""
    if (os.environ.get("JAX_COORDINATOR_ADDRESS")
            or os.environ.get("JEPSEN_TPU_MULTIHOST")):
        raise NotImplementedError(
            "multi-host analysis is not ported: one process, one card "
            "(ROADMAP A6)")
    _refuse_profiling(test)
    if test.get("fleet"):
        raise NotImplementedError(
            "test['fleet']: the fleet stream is not ported (ROADMAP A4)")
    if test.get("quarantine?"):
        raise NotImplementedError(
            "test['quarantine?']: the quarantine breakers "
            "(control/health.py) are not ported (ROADMAP A3c)")


def run(test: dict) -> dict:
    """Full lifecycle (core.clj:322-412)."""
    _refuse_unported(test)
    test = prepare_test(test)

    store_ctx = None
    if test.get("name"):
        try:
            from . import store as jstore
            store_ctx = jstore
            test = jstore.start_test(test)
        except ImportError:
            store_ctx = None

    try:
        # analyze runs INSIDE the relative-time scope so its telemetry
        # spans share the run's clock origin (and line up with op
        # times); nothing in analysis reads the ambient origin itself.
        with util.with_relative_time():
            telemetry.reset()
            # fault-activation coverage is scoped per run like the
            # telemetry it rides next to (coverage.py)
            jcoverage.reset()
            # per-op causal tracing is opt-in (test["trace?"]); when a
            # store exists the recorder streams optrace.jsonl into it
            # as spans complete (crash-tolerant like telemetry.jsonl)
            tracer = tracing.get()
            tracer.reset(enabled=bool(test.get("trace?")))
            if tracer.enabled and test.get("store_dir"):
                tracer.open(Path(test["store_dir"]) / tracing.TRACE_FILE)
            # the live monitor + online watchdog span the whole run:
            # the sampler sees setup, the case, AND analysis (device
            # occupancy gauges appear mid-analyze), streaming points
            # into timeseries.jsonl, which a reader may tail
            mon = jmonitor.Monitor(test)
            test["monitor"] = mon
            wd = jwatchdog.from_test(test)
            if wd is not None:
                test["watchdog"] = wd
            mon.start(Path(test["store_dir"]) / jmonitor.TIMESERIES_FILE
                      if test.get("store_dir") else None)
            try:
                with telemetry.span("run", test=test.get("name")):
                    test = control.open_sessions(test)
                    # the node observability plane: a per-node
                    # resource/clock-skew/DB-log sampler over its own
                    # control sessions, appending nodes.jsonl
                    # (nodeprobe.py; opt-in via test["nodeprobe?"])
                    nprobe = None
                    if test.get("nodeprobe?") and test.get("store_dir"):
                        try:
                            from . import nodeprobe as jnodeprobe
                            nprobe = jnodeprobe.NodeProbe(test)
                            test["nodeprobe"] = nprobe
                            nprobe.start(Path(test["store_dir"])
                                         / jnodeprobe.NODES_FILE)
                        except Exception:  # noqa: BLE001 — never
                            # sink the run for observability
                            logger.exception("starting node probe "
                                             "failed")
                            nprobe = None
                    try:
                        with telemetry.span("os-setup"):
                            _setup_os(test)
                        try:
                            with telemetry.span("db-cycle"):
                                _db_cycle(test)
                            try:
                                with telemetry.span("case"):
                                    test = run_case(test)
                                if store_ctx:
                                    store_ctx.save_history(test)
                                with telemetry.span("snarf-logs"):
                                    snarf_logs(test)
                            finally:
                                with telemetry.span("teardown-db"):
                                    _teardown_db(test)
                        finally:
                            with telemetry.span("teardown-os"):
                                _teardown_os(test)
                    finally:
                        # the probe's final offsets/events land before
                        # analysis so the skew bound sees the full run
                        if nprobe is not None:
                            try:
                                nprobe.stop()
                            except Exception:  # noqa: BLE001
                                logger.exception("stopping node probe "
                                                 "failed")
                        control.close_sessions(test)

                # checkers read optrace.jsonl (timeline hover, trace
                # excerpts): push any buffered records out first
                tracer.flush()
                # one guaranteed case-phase sample: the perf checker's
                # monitor graph reads timeseries.jsonl during analyze,
                # and a short run may not have crossed the sampler's
                # first interval yet
                mon.flush_point()
                test = analyze(test, store_ctx)
                # final monitor point BEFORE results.json: tailers
                # treat results.json as the end-of-run marker and must
                # not miss the last sample
                mon.stop()
                if store_ctx:
                    store_ctx.save_results(test)
                # the run's coverage record (fault × workload ×
                # anomaly cells) + its atlas
                # line; best-effort — coverage must never sink a run
                if store_ctx and test.get("store_dir"):
                    try:
                        rec = jcoverage.write_record(test)
                        if rec is not None:
                            jcoverage.append_run(
                                store_ctx.base_dir(test), rec)
                    except Exception:  # noqa: BLE001
                        logger.exception("writing coverage record "
                                         "failed")
            finally:
                try:
                    mon.stop()
                except Exception:  # noqa: BLE001 — best-effort
                    logger.exception("stopping monitor failed")
                # even a crashed run leaves its trace behind
                if store_ctx and test.get("store_dir"):
                    try:
                        telemetry.save(test["store_dir"])
                    except Exception:  # noqa: BLE001 — best-effort
                        logger.exception("saving telemetry failed")
                # the op-trace stream is already on disk; close it so
                # the tail is flushed even when the run crashed
                try:
                    tracer.close()
                except Exception:  # noqa: BLE001 — best-effort
                    logger.exception("closing optrace failed")
    finally:
        # a crashed lifecycle must not leak the per-test log handler
        if store_ctx:
            store_ctx.stop(test)
    return log_results(test)
