"""Test result storage: store/<name>/<timestamp>/ directories (the
port's copy of jepsen_tpu/store/__init__.py).

Capability reference: jepsen/src/jepsen/store.clj: per-test directories
with `latest`/`current` symlinks (40-76, 320-358), three-phase saves so
partial results survive crashes (save-0!/1!/2!, 426-466), per-test
jepsen.log (468-512), load (108-134) and delete! GC (514-531).

Layout:
  store/<name>/<YYYYMMDDTHHMMSS.ffff>/
    test.json      save-0: the test map, minus the history/results
    spec.json      save-0: reconstructible test spec (test["spec"])
    history.jlog   incremental CRC-framed op log (store/format.py)
    results.json   save-2: checker results
    results.partial.jlog  each checker's result as it completes
    jepsen.log     per-test log output
    telemetry.jsonl  span trace (telemetry.py)
    metrics.json   aggregated span/counter/gauge metrics
    timeseries.jsonl  live-monitor sample points (monitor.py),
                   appended while the run executes
    optrace.jsonl  per-op causal trace (tracing.py, when test["trace?"])
    coverage.json  per-run fault × workload × anomaly coverage record
                   (coverage.py)
    nodes.jsonl    node observability plane: per-node resource samples,
                   clock offsets, tagged DB-log events, honest gap
                   markers (nodeprobe.py, when test["nodeprobe?"])
    <node>/...     downloaded node logs (core.snarf_logs)
  store/<name>/latest  -> most recent run   store/latest -> same
  store/current        -> run in progress
  store/coverage_atlas.jsonl  cross-run coverage journal (one line per
                   analyzed run, newest-per-run wins; coverage.py)

Every file is the JAX package's format: a run stored by one package
loads in the other. test.json holds repr() of the objects in the test
map (clients, generators, ...), which name each package's own classes.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import shutil
from pathlib import Path
from typing import Iterator

from . import format as fmt

logger = logging.getLogger(__name__)

BASE = Path("store")

_SKIP_KEYS = {"history", "results", "barrier", "db", "client", "nemesis",
              "checker", "generator", "os", "remote", "sessions",
              "history_writer", "store_dir", "_log_handler",
              "monitor", "watchdog", "monitor_probes", "health",
              "nodeprobe", "_fleet_streamer"}


def base_dir(test: dict | None = None) -> Path:
    if test and test.get("store_base"):
        return Path(test["store_base"])
    return BASE


def dir_name(test: dict) -> str:
    t = test.get("start_time") or datetime.datetime.now()
    if isinstance(t, str):
        return t
    return t.strftime("%Y%m%dT%H%M%S.%f")[:-2]


def test_dir(test: dict) -> Path:
    return base_dir(test) / str(test.get("name", "noname")) / dir_name(test)


def path(test: dict, *parts) -> Path:
    """A path inside the test's store directory (creating parents is the
    caller's business)."""
    d = test.get("store_dir") or test_dir(test)
    return Path(d).joinpath(*[str(p) for p in parts])


def _symlink(link: Path, target: Path) -> None:
    try:
        if link.is_symlink() or link.exists():
            link.unlink()
        link.symlink_to(target.resolve())
    except OSError:  # e.g. filesystems without symlink support
        pass


def save_test_map(test: dict) -> None:
    d = Path(test["store_dir"])
    view = {k: fmt.jsonable(v) for k, v in test.items()
            if k not in _SKIP_KEYS}
    with open(d / "test.json", "w") as f:
        json.dump(view, f, indent=1, default=repr)


def save_spec(test: dict) -> None:
    """Writes the reconstructible test spec (test["spec"]) as
    spec.json, so a crashed run's analysis can rebuild its checker
    stack without the original process (the CLI's `analyze`, ROADMAP A9)."""
    spec = test.get("spec")
    if not spec:
        return
    d = Path(test["store_dir"])
    with open(d / "spec.json", "w") as f:
        json.dump(fmt.jsonable(spec), f, indent=1, default=repr)


def load_spec(d) -> dict | None:
    """The reconstructible test spec a run saved at start, or None for
    runs that predate (or never carried) one."""
    p = Path(d) / "spec.json"
    if not p.exists():
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def start_test(test: dict) -> dict:
    """save-0: creates the store dir, symlinks, log file, initial test
    map + spec, and attaches an incremental history writer."""
    test = dict(test)
    d = test_dir(test)
    d.mkdir(parents=True, exist_ok=True)
    test["store_dir"] = str(d)
    _symlink(d.parent / "latest", d)
    _symlink(base_dir(test) / "latest", d)
    _symlink(base_dir(test) / "current", d)
    save_test_map(test)
    save_spec(test)
    # liveness marker: as long as this pid is alive, the run is live
    # (a quiet checker phase does not make it recoverable)
    try:
        (d / "run.pid").write_text(str(os.getpid()))
    except OSError:
        pass
    test["history_writer"] = fmt.HistoryWriter(d / "history.jlog")
    _start_logging(test)
    return test


def save_history(test: dict) -> dict:
    """save-1: the op log is already on disk (written incrementally by
    the interpreter); refresh the test map."""
    save_test_map(test)
    return test


def stop(test: dict) -> None:
    """Releases per-test resources (log handler, writer); safe to call
    repeatedly. core.run calls this in a finally block so a crashed
    lifecycle doesn't leak the root-logger handler."""
    _stop_logging(test)
    w = test.get("history_writer")
    if w is not None:
        w.close()


def save_results_only(test: dict) -> None:
    """results.json alone — offline re-analysis (`analyze` over a
    stored run) must not retire the store's `current` symlink (it
    belongs to whichever run is LIVE) or overwrite the run's original
    test.json with the rebuilt map."""
    d = Path(test["store_dir"])
    with open(d / "results.json", "w") as f:
        json.dump(fmt.jsonable(test.get("results")), f, indent=1,
                  default=repr)


def save_results(test: dict) -> dict:
    """save-2: writes checker results."""
    save_results_only(test)
    save_test_map(test)
    cur = base_dir(test) / "current"
    if cur.is_symlink():
        cur.unlink()
    _stop_logging(test)
    return test


def _start_logging(test: dict) -> None:
    handler = logging.FileHandler(path(test, "jepsen.log"))
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s [%(name)s] %(message)s"))
    logging.getLogger().addHandler(handler)
    test["_log_handler"] = handler


def _stop_logging(test: dict) -> None:
    handler = test.pop("_log_handler", None)
    if handler is not None:
        logging.getLogger().removeHandler(handler)
        handler.close()


# ---------------------------------------------------------------------------
# Loading / browsing
# ---------------------------------------------------------------------------

def load_results(d) -> dict | None:
    """Final results; when only the crash-surviving partial log exists
    (the checker died mid-analysis), its completed entries come back
    with valid? 'unknown' (store/format.clj PartialMap)."""
    p = Path(d) / "results.json"
    if p.exists():
        with open(p) as f:
            return json.load(f)
    partial = Path(d) / "results.partial.jlog"
    if partial.exists():
        from . import format as fmt

        got = fmt.read_partial_results(partial)
        if got:
            got["valid?"] = "unknown"
            got["partial?"] = True
            return got
    return None


def load_telemetry(d) -> tuple[list, dict | None]:
    """(span events, metrics) from a stored test dir's telemetry
    artifacts (telemetry.jsonl / metrics.json); ([], None) when the
    run predates the telemetry layer."""
    from .. import telemetry as tel

    d = Path(d)
    events = list(tel.read_events(d / tel.TRACE_FILE))
    metrics = tel.read_metrics(d / tel.METRICS_FILE)
    return events, metrics


def load_optrace(d) -> list[dict]:
    """Per-op trace records from a stored test dir's optrace.jsonl
    (tracing.py); [] when the run didn't opt into tracing."""
    from .. import tracing

    return list(tracing.read_records(Path(d) / tracing.TRACE_FILE))


def load_nodes(d) -> list[dict]:
    """Node-plane records (samples, gaps, log events, breaker
    transitions) from a stored test dir's nodes.jsonl
    (nodeprobe.py); [] when the run predates (or disabled) the
    probe."""
    from .. import nodeprobe

    return nodeprobe.load_records(d)


def load_timeseries(d) -> list[dict]:
    """Live-monitor sample points from a stored test dir's
    timeseries.jsonl; [] when the run predates (or disabled) the
    monitor."""
    from .. import monitor

    return list(monitor.read_points(Path(d) / monitor.TIMESERIES_FILE))


def load(name_or_dir, timestamp: str = "latest",
         base: Path | None = None) -> dict:
    """Loads a stored test: test map + history + results
    (store.clj:108-134)."""
    d = Path(name_or_dir)
    if not d.exists():
        d = (base or BASE) / str(name_or_dir) / timestamp
    d = d.resolve()
    with open(d / "test.json") as f:
        test = json.load(f)
    hpath = d / "history.jlog"
    if hpath.exists():
        test["history"] = fmt.read_history(hpath)
    res = load_results(d)
    if res is not None:
        test["results"] = res
    test["store_dir"] = str(d)
    return test


def tests(name: str | None = None, base: Path | None = None
          ) -> Iterator[Path]:
    """Yields all stored test dirs, newest first."""
    b = base or BASE
    if not b.exists():
        return
    names = [b / name] if name else sorted(b.iterdir())
    for nd in names:
        if not nd.is_dir() or nd.name in ("latest", "current"):
            continue
        for td in sorted(nd.iterdir(), reverse=True):
            if td.is_dir() and not td.is_symlink():
                yield td


def delete(name: str | None = None, base: Path | None = None) -> int:
    """Deletes stored tests (store.clj:514-531). Returns count."""
    n = 0
    for td in list(tests(name, base)):
        shutil.rmtree(td, ignore_errors=True)
        n += 1
    b = base or BASE
    for link in ([b / "latest", b / "current"]
                 + ([b / name / "latest"] if name else [])):
        if link.is_symlink() and not link.resolve().exists():
            link.unlink()
    return n
