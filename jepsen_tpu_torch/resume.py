"""Resumable analysis: recover a crashed run's history and re-check it
(the port's copy of jepsen_tpu/resume.py).

A control-process crash (OOM-killed, SIGKILL, power loss) mid-run used
to forfeit the whole test. The store already journals everything needed
to finish the job — the CRC-framed op log survives with at most a torn
tail (store/format.py), wgl segment checkpoints persist per-(segment,
state) search results, and the partial-results log holds every checker
that completed before the crash. This module stitches those together:

  python -m jepsen_tpu_torch analyze <run-dir> [--resume] [--device cpu]

  1. recovers the valid history prefix from history.jlog (torn tail
     dropped — the same recovery rule the writer uses on reopen);
  2. rebuilds the checker stack from the run's spec.json (a
     reconstructible test spec serialized at run start — store.save_spec);
  3. re-runs analysis; with --resume, checkers that already landed in
     results.partial.jlog are reused verbatim and the wgl segmented
     search reloads its frontier checkpoints (test["checkpoint?"]);
  4. writes results.json exactly as an uninterrupted run would.

So a kill -9 mid-run loses seconds of work, not the run.

The analysis runs on the card unless the caller asks for the CPU: the
device is resolved before anything is read (no CUDA and no
device="cpu" raises), and it goes into the rebuilt spec's opts as
opts["device"], whatever device the stored spec names, so every
workload checker of the rebuilt stack checks there. The store, the
partial-results log and the WGL segment checkpoints are the port's own
(store/, store/format.py, gpu/ckpt.py), byte for byte the JAX package's:
either package analyzes and resumes the other's runs.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

from . import telemetry, util

logger = logging.getLogger(__name__)

# live/lifecycle objects a rebuilt spec test may carry that offline
# analysis must not touch (no cluster exists anymore)
_LIFECYCLE_KEYS = ("client", "generator", "final_generator", "nemesis",
                   "db", "os", "remote", "sessions", "barrier",
                   "history_writer", "monitor", "watchdog", "net",
                   "nodeprobe", "_fleet_streamer", "fleet")


def recover_history(d):
    """The valid history prefix from <d>/history.jlog: intact CRC
    records only, torn/corrupt tail dropped (store.format crash
    recovery). Returns (History, ops_recovered)."""
    from .store import format as fmt

    p = Path(d) / "history.jlog"
    hist = fmt.read_history(p)
    return hist, len(hist)


def _fallback_checker():
    """When a run predates spec.json: generic checkers that apply to
    any history. The verdict degrades honestly — stats/exceptions say
    what happened, nothing claims workload-level validity."""
    from . import checker as chk

    return chk.compose({"stats": chk.stats(),
                        "exceptions": chk.unhandled_exceptions()})


def rebuild_test(d, test_fn=None, device=None) -> dict:
    """A test map for offline analysis of stored run `d`: the stored
    scalars (test.json) plus a checker stack rebuilt from spec.json via
    test_fn (default: __main__.make_test, the bundled workloads).
    `device` ("cuda" or "cpu"; None leaves the spec's) replaces the
    spec's opts["device"]."""
    from . import store as jstore

    d = Path(d)
    with open(d / "test.json") as f:
        stored = json.load(f)
    spec = jstore.load_spec(d)
    test: dict = {}
    if spec and isinstance(spec.get("opts"), dict):
        try:
            if test_fn is None:
                from .__main__ import make_test as test_fn  # noqa: PLC0415
            opts = dict(spec["opts"])
            if spec.get("workload"):
                opts.setdefault("workload", spec["workload"])
            if device is not None:
                opts["device"] = device
            test = dict(test_fn(opts))
            for k in _LIFECYCLE_KEYS:
                test.pop(k, None)
        except (Exception, SystemExit) as e:  # noqa: BLE001 —
            # SystemExit included: CLI test functions sys.exit on an
            # unknown workload. A spec this analyzer can't rebuild
            # (suite-only workload, schema drift) must still yield
            # results, just generic ones.
            logger.warning(
                "couldn't rebuild the checker stack from %s's spec.json "
                "(%s); falling back to generic stats/exception checkers",
                d, e)
            test = {"checker": _fallback_checker(),
                    "rebuilt-from": "fallback"}
    else:
        logger.warning(
            "%s has no spec.json (run predates resumable analysis?); "
            "falling back to generic stats/exception checkers", d)
        test["checker"] = _fallback_checker()
        test["rebuilt-from"] = "fallback"
    # stored scalars win: name/start_time must address THIS run dir
    for k, v in stored.items():
        if k not in ("results", "history") and k not in _LIFECYCLE_KEYS:
            test[k] = v
    test["store_dir"] = str(d)
    return test


def analyze_run(d, resume: bool = False, test_fn=None,
                checker_timeout_s: float | None = None,
                device=None) -> dict:
    """Recovers `d`'s history and (re)runs analysis over it, writing
    results.json. With resume=True, completed checkers are reused from
    the crash-surviving partial-results log and the wgl segmented
    search reloads its per-segment checkpoints. device: None (the card)
    or "cpu"; resolved first, so a missing card raises before anything
    of the run is read."""
    from . import core
    from . import store as jstore
    from .device import resolve_device
    from .store import format as fmt

    dev = resolve_device(device)
    d = Path(d)
    test = rebuild_test(d, test_fn=test_fn, device=dev.type)
    hist, n_ops = recover_history(d)
    test["history"] = hist
    if checker_timeout_s:
        test["checker_timeout_s"] = checker_timeout_s

    extra_opts: dict = {}
    resumed_names: list = []
    if resume:
        # reuse the crashed analysis's completed checkers — read the
        # partial log BEFORE core.analyze truncates it for this pass
        partial_p = d / "results.partial.jlog"
        if partial_p.exists():
            got = fmt.read_partial_results(partial_p)
            # a checker that degraded to 'unknown' (timeout, hung, or
            # crashed) is re-run, not reused: resuming with a larger
            # --checker-timeout must be able to improve on it
            got = {k: v for k, v in got.items()
                   if not (isinstance(v, dict)
                           and v.get("valid?") == "unknown")}
            if got:
                extra_opts["resume_results"] = got
                resumed_names = sorted(got)
        # the segmented wgl search reloads its frontier checkpoints
        # (checker-frontier/*.jlog, keyed by history fingerprint)
        test["checkpoint?"] = True
        # checkpoint-and-extend (gpu/ckpt.py): linearizable
        # checkers reuse the run-dir's ckpt/ store, so re-checking a
        # GROWN run costs O(suffix) — a stale record (the history
        # changed under the digest) falls back to the full check
        test["extend?"] = True

    # degraded/watchdog sections can't be recomputed offline (no live
    # health registry or watchdog survives the crash) — carry them over
    # from the original results.json before this pass overwrites it
    prev_results: dict = {}
    try:
        with open(d / "results.json") as f:
            prev_results = json.load(f)
    except (OSError, ValueError):
        pass  # crashed before analysis, or torn write: nothing to keep

    telemetry.reset()
    with util.with_relative_time():
        with telemetry.span("analyze-offline", run=str(d)):
            test = core.analyze(test, store_ctx=jstore,
                                extra_opts=extra_opts)
    if isinstance(test.get("results"), dict):
        res = test["results"]
        # a completed checker whose name the rebuilt stack doesn't
        # carry (fallback path, renamed checker) is still the verdict
        # --resume exists to preserve: merge it in rather than
        # silently dropping it while claiming it was reused
        orphans = {k: v
                   for k, v in extra_opts.get("resume_results",
                                              {}).items()
                   if k not in res}
        if orphans:
            from . import checker as chk

            res.update(orphans)
            res["valid?"] = chk.merge_valid(
                [res.get("valid?")]
                + [(v or {}).get("valid?") for v in orphans.values()
                   if isinstance(v, dict)])
            # orphans were merged AFTER core.analyze's certificate
            # stamping pass — validate their proofs too, or a resumed
            # run's reused verdict would ride unvalidated
            try:
                from .gpu import certify as jcertify

                jcertify.stamp_results(
                    {k: v for k, v in orphans.items()
                     if isinstance(v, dict)}, hist)
            except Exception:  # noqa: BLE001 — best-effort
                logger.exception("stamping orphaned certificates "
                                 "failed")
        if isinstance(prev_results, dict):
            for k in ("degraded", "watchdog"):
                if k in prev_results and k not in res:
                    res[k] = prev_results[k]
        test["results"]["analysis"] = {
            "offline?": True,
            "resumed?": bool(resume),
            "recovered-ops": n_ops,
            "resumed-checkers": resumed_names,
        }
        # verdict-certificate outcomes (stamped inside core.analyze
        # against the recovered history) summarized for the offline
        # reader: a crashed run whose re-analysis carries validated
        # proofs is as trustworthy as an uninterrupted one
        try:
            from .gpu import certify as jcertify

            counts = {"certified": 0, "errors": 0, "absent": 0}
            for _path, r in jcertify.iter_certificates(res):
                if "absent" in (r.get("certificate") or {}):
                    counts["absent"] += 1
                elif r.get("certificate-error"):
                    counts["errors"] += 1
                elif r.get("certified"):
                    counts["certified"] += 1
            if any(counts.values()):
                test["results"]["analysis"]["certificates"] = counts
        except Exception:  # noqa: BLE001 — summary is best-effort
            logger.exception("summarizing certificates failed")
    # results.json only: save_results would retire the store-wide
    # `current` symlink (owned by whichever run is live right now) and
    # clobber the run's original test.json with the rebuilt map
    jstore.save_results_only(test)
    _refresh_coverage(d, test)
    core.log_results(test)
    return test


def _refresh_coverage(d: Path, test: dict) -> None:
    """Regenerates the run's coverage.json after offline re-analysis
    and re-appends its atlas entry. The live run's fault activations
    (recorded by the nemesis Validate wrapper with nemesis-declared
    kinds) are carried over when present — the offline fallback only
    knows the generic f→kind registry — so an unchanged run re-appends
    an identical digest and the atlas merge is a no-op: cell counts
    cannot double under --resume."""
    from . import coverage as jcoverage

    try:
        prev = jcoverage.load_record(d)
        # a fresh recorder: offline analysis has no live nemesis, so
        # faults derive from the history (or carry over from `prev`) —
        # never from whatever run the process-global recorder last saw
        rec = jcoverage.build_record(test,
                                     recorder=jcoverage.Recorder())
        if prev and prev.get("faults"):
            rec["faults"] = prev["faults"]
        jcoverage.validate_record(rec)
        with open(d / jcoverage.RECORD_FILE, "w") as f:
            json.dump(rec, f, indent=1)
        jcoverage.append_run(d.parent.parent, rec)
    except Exception:  # noqa: BLE001 — coverage must not sink analyze
        logger.exception("refreshing coverage record failed")
