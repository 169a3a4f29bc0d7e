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
(each workload's checker takes opts["device"]; None is the card). The
quarantine breakers (test["quarantine?"], control/health.py) and the
fleet stream (test["fleet"], fleet/client.py) run as in the JAX package.
A profiled analysis (test["profile?"], test["xla-trace?"] or
test["profile_dir"]) runs the checkers under a torch.profiler trace
(util.profile_trace) written into the store directory's `xprof` or
`xla-trace` directory, or into profile_dir; each run starts the device
profiler's per-launch records afresh (gpu/profiler.py). Multi-host
analysis (JAX_COORDINATOR_ADDRESS / JEPSEN_TPU_MULTIHOST) joins its
process group at lifecycle entry (gpu/dist.py), and a failed join
raises where the JAX package would go on single-host.
"""

from __future__ import annotations

import datetime
import errno
import logging
import socket
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
from .gpu import profiler as jprofiler

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


def _transport_failure(e: BaseException) -> bool:
    """Couldn't REACH the node: SSH transport errors, refused/reset
    connections, DNS failures, and the network-errno family of raw
    OSErrors (EHOSTUNREACH etc., which Python does NOT map onto
    ConnectionError). Local misconfiguration — FileNotFoundError for a
    missing binary, TypeError from a client bug — is never transport."""
    from .control.core import TransportError

    if isinstance(e, (TransportError, ConnectionError, TimeoutError,
                      socket.gaierror)):
        return True
    return (isinstance(e, OSError) and not isinstance(e, socket.herror)
            and e.errno in (errno.EHOSTUNREACH, errno.ENETUNREACH,
                            errno.ENETDOWN, errno.EHOSTDOWN,
                            errno.ETIMEDOUT))


def _teardown_tolerantly(test: dict, what: str, node_fn) -> None:
    """Runs a per-node teardown phase on all nodes; with quarantine
    active, a dead node's transport failure degrades (logged + counted)
    instead of aborting the run between history capture and analysis —
    the history is already safe on disk and is worth analyzing. Every
    node's teardown is attempted (a bare on_nodes call would surface
    only the FIRST node's failure, letting a dead node mask a genuine
    teardown bug on a live one); non-transport failures still raise,
    carrying all of them."""
    errs: dict = {}

    def one(t, n):
        try:
            node_fn(t, n)
        except Exception as e:  # noqa: BLE001 — classified below
            errs[n] = e  # distinct keys per node: no lock needed

    control.on_nodes(test, one)
    if not errs:
        return
    if (test.get("health") is None
            or not all(_transport_failure(x) for x in errs.values())):
        failures = [errs[n] for n in sorted(errs, key=str)]
        if len(failures) == 1:
            raise failures[0]
        raise util.RealPmapError(failures)
    telemetry.count("core.degraded-teardowns")
    logger.warning("%s teardown failed on unreachable node(s) %s; "
                   "continuing :degraded", what,
                   sorted(map(str, errs)))


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
    # a quarantined node can't be healed and must not abort healing
    # the nodes that ARE reachable
    hr = test.get("health")
    if hr is not None and hr.quarantined():
        test = dict(test)
        dead = set(hr.quarantined())
        test["nodes"] = [n for n in (test.get("nodes") or [])
                         if n not in dead]
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
        c = None
        try:
            c = jclient.validate(client).open(test, node)
            c.setup(test)
            return c
        except Exception as e:  # noqa: BLE001 — classified below
            # couldn't REACH the node (_transport_failure: ssh
            # transport, connect/timeout, DNS, network errnos) —
            # degradable under quarantine; a client bug or local
            # misconfiguration (TypeError, FileNotFoundError for a
            # missing client binary) still raises and fails the run
            if test.get("health") is None or not _transport_failure(e):
                raise
            if c is not None:
                # open() succeeded, setup() died: close the half-open
                # client instead of leaking its connection for the
                # rest of the (continuing) run
                try:
                    c.close(test)
                except Exception:  # noqa: BLE001 — best-effort
                    pass
            # the node's worker will retry opens per-op (ClientWorker
            # fails ops "no-client" until then); the run continues
            telemetry.count("core.degraded-client-opens")
            logger.warning("client open/setup failed on %s; continuing "
                           ":degraded (quarantine active)", node)
            return None

    clients = [c for c in util.real_pmap(open_one,
                                         test.get("nodes") or [])
               if c is not None]
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
    trace_dir = test.get("profile_dir")
    if trace_dir is None and store_ctx is not None and test.get(
            "profile?"):
        trace_dir = store_ctx.path(test, "xprof")
    if trace_dir is None and store_ctx is not None and test.get(
            "xla-trace?"):
        # the JAX package's --xla-trace switch: a profiler trace of the
        # analysis phase (every kernel launch) lands in the store dir
        trace_dir = store_ctx.path(test, "xla-trace")
    # a hung non-composed checker gets the same wall-clock bound the
    # Compose applies per sub-checker; composed checkers are bounded
    # individually inside (one outer bound would cap the whole set)
    timeout_s = None
    if not isinstance(checker, jchecker.Compose):
        timeout_s = jchecker.checker_timeout_s(test, opts)
    try:
        with telemetry.span("analyze"):
            with util.profile_trace(trace_dir):
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
        # quarantined-node runs finish with a :degraded marker instead
        # of aborting: the verdict stands, but readers see which nodes
        # the control plane gave up on (control/health.py)
        hr = test.get("health")
        if hr is not None and hr.ever_quarantined():
            test["results"]["degraded"] = {
                "quarantined-nodes": sorted(
                    map(str, hr.ever_quarantined())),
                "still-quarantined": sorted(
                    map(str, hr.quarantined()))}
        # the fleet's verdict (with its certificate) rides next to the
        # local one — informational: a tenant compares, it never
        # replaces local checking (fleet/)
        streamer = test.get("_fleet_streamer")
        if streamer is not None:
            try:
                test["results"]["fleet"] = streamer.result_summary()
            except Exception:  # noqa: BLE001 — best-effort
                logger.exception("collecting fleet verdict failed")
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


def run(test: dict) -> dict:
    """Full lifecycle (core.clj:322-412)."""
    # multi-host analysis: the process group forms at lifecycle entry,
    # before any launch; a failure raises (gpu/dist.py)
    from .gpu import dist

    dist.ensure_initialized()
    test = prepare_test(test)

    store_ctx = None
    if test.get("name"):
        try:
            from . import store as jstore
            store_ctx = jstore
            test = jstore.start_test(test)
        except ImportError:
            store_ctx = None

    if test.get("fleet"):
        # checking-as-a-service (fleet/): mirror the op log
        # to the fleet mid-run; its verdict+certificate ride in the
        # results as results['fleet'] NEXT to the authoritative local
        # checkers. Best-effort — but never silent: a fleet that was
        # requested and couldn't attach still yields an honest
        # results['fleet'] = {'unavailable': reason}.
        try:
            from .fleet import client as jfleet_client
            if test.get("history_writer") is None:
                test["_fleet_streamer"] = jfleet_client.NoStream(
                    "no history writer (unnamed test: no store)")
            else:
                writer, streamer = jfleet_client.attach(test)
                test["history_writer"] = writer
                test["_fleet_streamer"] = streamer
        except Exception as e:  # noqa: BLE001 — never sink a run
            logger.exception("attaching fleet streamer failed")
            try:
                from .fleet import client as jfleet_client
                test["_fleet_streamer"] = jfleet_client.NoStream(
                    f"attach failed: {e!r}"[:200])
            except Exception:  # noqa: BLE001
                pass

    try:
        # analyze runs INSIDE the relative-time scope so its telemetry
        # spans share the run's clock origin (and line up with op
        # times); nothing in analysis reads the ambient origin itself.
        with util.with_relative_time():
            telemetry.reset()
            # fault-activation coverage is scoped per run like the
            # telemetry it rides next to (coverage.py)
            jcoverage.reset()
            # per-launch device-profile records are scoped per run
            # like the telemetry they mirror into
            jprofiler.reset()
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
                    if test.get("quarantine?"):
                        # per-node circuit breakers: a persistently
                        # dead node is quarantined (its ops crash fast
                        # to :info) and the run continues :degraded
                        # instead of aborting (control/health.py)
                        from .control import health as jhealth
                        test["health"] = jhealth.HealthRegistry.from_test(
                            test)
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
