"""Coverage record: fault × workload × anomaly cells of a run (the
port's copy of the recorder half of jepsen_tpu/coverage.py).

  *Taxonomy + per-run record.* Every nemesis declares structured fault
  kinds for the op fs it speaks (`Nemesis.fault_kinds`, threaded through
  nemesis/core.py, combined.py and time.py) and every checker verdict
  carries `anomaly-classes`: one outcome per class it CHECKS, with
  explicit negative results ("fault fired, anomaly class checked, none
  found" is a `clean` cell, not a missing one). core.run writes a
  schema-validated `coverage.json` per run: fault activations with time
  windows, the workload signature, generator-schedule features, and
  anomaly outcomes with op-index provenance.

  *Cross-run atlas.* `store/coverage_atlas.jsonl` accumulates one line
  per analyzed run (append order; a torn tail is tolerated). Lines are
  keyed by run id and the LAST line per run wins, so a re-analysis
  replaces a run's contribution instead of double-counting it, and
  concurrent runs append distinct ids.

The records and the atlas are the JAX package's byte for byte: either
package reads the other's. The readers behind the CLI and the web UI
(`aggregate`, `matrix_text`, `gaps`, `suggest`, `coverage_text`,
`prometheus_lines`) are ROADMAP A9.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from pathlib import Path
from typing import Iterable

logger = logging.getLogger(__name__)

SCHEMA = 1
RECORD_FILE = "coverage.json"
ATLAS_FILE = "coverage_atlas.jsonl"

# Outcomes an anomaly class can take in one run's verdict.
OUTCOMES = ("witnessed", "clean", "unknown")

# The canonical fault-kind taxonomy. Nemeses may declare kinds beyond
# this list (they still aggregate); these are the axes the gap report
# reasons about. "none" is the implicit baseline cell for runs without
# any fault activation.
FAULT_KINDS = (
    "partition", "packet", "db-kill", "db-pause", "process-pause",
    "clock-bump", "clock-strobe", "clock-reset", "file-bitflip",
    "file-truncate", "file-lost-writes", "membership",
)

# Offline fallback: op f -> (kind, phase) for histories whose live
# activations were lost (run predates coverage, crashed before the
# record landed). Bare start/stop is the tutorial-grade partitioner
# cycle (nemesis.start_stop_cycle): the one ambiguity (the db package's
# start ends a kill). Live recording via Validate resolves it precisely
# from the nemesis's own declaration.
F_KINDS = {
    "start": ("partition", "begin"),
    "stop": ("partition", "end"),
    "start-partition": ("partition", "begin"),
    "stop-partition": ("partition", "end"),
    "start-packet": ("packet", "begin"),
    "stop-packet": ("packet", "end"),
    "kill": ("db-kill", "begin"),
    "pause": ("db-pause", "begin"),
    "resume": ("db-pause", "end"),
    "bitflip": ("file-bitflip", "pulse"),
    "truncate": ("file-truncate", "pulse"),
    "lose-unfsynced-writes": ("file-lost-writes", "pulse"),
    "bump": ("clock-bump", "pulse"),
    "bump-clock": ("clock-bump", "pulse"),
    "strobe": ("clock-strobe", "pulse"),
    "strobe-clock": ("clock-strobe", "pulse"),
    "reset": ("clock-reset", "pulse"),
    "reset-clock": ("clock-reset", "pulse"),
}


def default_kinds(fs: Iterable) -> dict:
    """{f: (kind, phase)} for the fs a nemesis declares, from the
    fallback registry — the default Nemesis.fault_kinds() body, so any
    custom nemesis speaking the standard fs is covered automatically."""
    out = {}
    for f in fs:
        k = F_KINDS.get(f)
        if k is not None:
            out[f] = k
    return out


# ---------------------------------------------------------------------------
# Run-scoped activation recorder
# ---------------------------------------------------------------------------

class Recorder:
    """Collects fault activations for the run in progress. Thread-safe;
    reset by core.run alongside telemetry (same per-run scoping)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._acts: list[dict] = []
        self._harness: dict[str, int] = {}

    def record(self, kind: str, f, phase: str, t0: int,
               t1: int | None = None) -> None:
        if kind is None:
            return
        rec = {"kind": str(kind), "f": f, "phase": phase,
               "t0": int(t0)}
        if t1 is not None:
            rec["t1"] = int(t1)
        with self._lock:
            self._acts.append(rec)

    def record_harness(self, kind: str, n: int = 1) -> None:
        """Harness chaos faults (the JAX package's chaos.py) have no op
        window: they count per injection under a `harness-` kind."""
        name = f"harness-{kind}"
        with self._lock:
            self._harness[name] = self._harness.get(name, 0) + int(n)

    def activations(self) -> list[dict]:
        with self._lock:
            return list(self._acts)

    def harness_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._harness)

    def reset(self) -> None:
        with self._lock:
            self._acts = []
            self._harness = {}


_global = Recorder()


def get() -> Recorder:
    return _global


def record_fault(kind, f, phase, t0, t1=None) -> None:
    _global.record(kind, f, phase, t0, t1)


def record_harness(kind, n: int = 1) -> None:
    _global.record_harness(kind, n)


def reset() -> None:
    _global.reset()


# ---------------------------------------------------------------------------
# Fault folding: activations -> per-kind counts + windows
# ---------------------------------------------------------------------------

def fold_faults(activations: Iterable[dict],
                harness: dict | None = None) -> list[dict]:
    """[{kind, count, windows}] from raw activations, kind-sorted.
    Windows pair begin/end activations per kind ([t_begin, t_end]);
    a pulse is a degenerate window; a begin never closed stays open
    ([t, None] — the fault outlived the op log)."""
    by_kind: dict[str, dict] = {}
    for a in sorted(activations, key=lambda a: a.get("t0", 0)):
        kind = a.get("kind")
        if not kind:
            continue
        st = by_kind.setdefault(kind, {"count": 0, "windows": [],
                                       "open": None})
        phase = a.get("phase", "pulse")
        t0 = a.get("t0", 0)
        t1 = a.get("t1", t0)
        if phase == "begin":
            st["count"] += 1
            if st["open"] is None:
                st["open"] = t0
        elif phase == "end":
            if st["open"] is not None:
                st["windows"].append([st["open"], t1])
                st["open"] = None
        else:  # pulse
            st["count"] += 1
            st["windows"].append([t0, t1])
    out = []
    for kind in sorted(by_kind):
        st = by_kind[kind]
        if st["open"] is not None:
            st["windows"].append([st["open"], None])
        out.append({"kind": kind, "count": st["count"],
                    "windows": st["windows"]})
    for kind in sorted(harness or {}):
        out.append({"kind": kind, "count": int(harness[kind]),
                    "windows": []})
    return out


def faults_from_history(hist) -> list[dict]:
    """Offline fallback: fault activations derived from a history's
    nemesis ops via the F_KINDS registry (`:info` ops on non-integer
    processes). Less precise than live recording — Validate knows the
    nemesis's own kind declaration — but good enough to re-cover a run
    whose live record was lost.

    The interpreter journals each nemesis op TWICE (the dispatch
    invocation and its completion, both type info on the same process
    with the same f): the toggle below records only the first of each
    pair, so counts match the live recorder's one-per-activation. An
    unmatched invocation (the nemesis died mid-fault) still counts."""
    acts = []
    open_pairs: set = set()
    for op in hist or []:
        proc = getattr(op, "process", None)
        if isinstance(proc, int):
            continue
        f = getattr(op, "f", None)
        got = F_KINDS.get(f)
        if got is None:
            continue
        key = (proc, f)
        if key in open_pairs:
            open_pairs.discard(key)  # the pair's completion
            continue
        open_pairs.add(key)
        kind, phase = got
        acts.append({"kind": kind, "f": f, "phase": phase,
                     "t0": getattr(op, "time", 0) or 0})
    return fold_faults(acts)


# ---------------------------------------------------------------------------
# Anomaly outcomes: results -> per-class outcomes with provenance
# ---------------------------------------------------------------------------

def _merge_outcome(a: str, b: str) -> str:
    """witnessed dominates, then unknown, else clean — the merge_valid
    analog for a class reported by several checkers in one run."""
    if "witnessed" in (a, b):
        return "witnessed"
    if "unknown" in (a, b):
        return "unknown"
    return "clean"


def _class_indices(res: dict, cls: str) -> list[int]:
    """Best-effort op-index provenance for one witnessed class out of a
    checker result: elle anomalies[cls] records, the wgl
    counterexample's op-indices, or set-full's lost-op-indices."""
    idxs: set[int] = set()
    recs = (res.get("anomalies") or {}).get(cls)
    for rec in recs or []:
        if isinstance(rec, dict):
            idxs.update(int(i) for i in rec.get("op-indices") or [])
    if not idxs and res.get("op-indices"):
        idxs.update(int(i) for i in res["op-indices"])
    lost = res.get("lost-op-indices")
    if not idxs and isinstance(lost, dict):
        idxs.update(int(i) for v in lost.values() for i in v)
    return sorted(idxs)[:64]


def anomaly_outcomes(results, checker: str = "",
                     depth: int = 0) -> list[dict]:
    """[{class, checker, outcome, op-indices?}] for every anomaly class
    a results map reports having checked (the `anomaly-classes` entries
    the checkers attach — including explicit negatives), one entry per
    class with outcomes merged across checkers of the same class."""
    found: dict[str, dict] = {}

    def walk(res, path, depth):
        if not isinstance(res, dict) or depth > 5:
            return
        classes = res.get("anomaly-classes")
        if isinstance(classes, dict):
            for cls, outcome in classes.items():
                if outcome not in OUTCOMES:
                    outcome = "unknown"
                cur = found.get(cls)
                if cur is None:
                    cur = found[cls] = {"class": cls, "checker": path,
                                        "outcome": outcome}
                else:
                    cur["outcome"] = _merge_outcome(cur["outcome"],
                                                    outcome)
                if outcome == "witnessed":
                    cur["checker"] = path
                    idxs = _class_indices(res, cls)
                    if idxs:
                        cur["op-indices"] = idxs
                    # where in the history the anomaly localized
                    # (the wgl/elle search explorer's witness
                    # percentile): the earliest-localization signal
                    # `coverage --suggest` and ROADMAP-3's early-exit
                    # rank configs by
                    s = res.get("search")
                    frac = (s or {}).get("witness-position") \
                        if isinstance(s, dict) else None
                    if isinstance(frac, (int, float)):
                        prev = cur.get("witness-frac")
                        cur["witness-frac"] = (
                            float(frac) if prev is None
                            else min(prev, float(frac)))
        for k, v in res.items():
            if isinstance(v, dict) and k != "anomalies":
                walk(v, f"{path}/{k}" if path else str(k), depth + 1)

    walk(results if isinstance(results, dict) else {}, checker, depth)
    # the online watchdog rides next to the checker verdicts and is a
    # checked class of its own (its hits are mid-run witnesses)
    wd = (results or {}).get("watchdog") if isinstance(results, dict) \
        else None
    if isinstance(wd, dict) and "count" in wd:
        found["watchdog"] = {
            "class": "watchdog", "checker": "watchdog",
            "outcome": "witnessed" if wd.get("count") else "clean"}
    return [found[c] for c in sorted(found)]


def outcome(witnessed: bool, valid=None) -> str:
    """The per-class outcome for a checker that just ran: `witnessed`
    when it found instances of the class, `unknown` when the check
    itself was indeterminate, else the explicit negative `clean`."""
    if witnessed:
        return "witnessed"
    if valid == "unknown":
        return "unknown"
    return "clean"


# ---------------------------------------------------------------------------
# Per-run record
# ---------------------------------------------------------------------------

def _run_id(test: dict) -> str:
    d = test.get("store_dir")
    if d:
        p = Path(d)
        return f"{p.parent.name}/{p.name}"
    return str(test.get("name") or "unnamed")


def _workload_name(test: dict) -> str:
    spec = test.get("spec")
    if isinstance(spec, dict) and spec.get("workload"):
        return str(spec["workload"])
    return str(test.get("workload") or test.get("name") or "unknown")


def _schedule_features(test: dict, hist) -> dict:
    """Generator-schedule features worth comparing across runs: op and
    nemesis-op volume, concurrency, and the coarse knobs the spec
    carries (rate/time-limit/ops)."""
    n_client = n_nem = 0
    t_last = 0
    open_nem: set = set()  # invoke/completion pairs count once
    for op in hist or []:
        proc = getattr(op, "process", None)
        if not isinstance(proc, int):
            key = (proc, getattr(op, "f", None))
            if key in open_nem:
                open_nem.discard(key)
            else:
                open_nem.add(key)
                n_nem += 1
        elif getattr(op, "type", None) == "invoke":
            n_client += 1
        t = getattr(op, "time", None)
        if isinstance(t, int):
            t_last = max(t_last, t)
    feats = {"client-ops": n_client, "nemesis-ops": n_nem,
             "duration-ns": t_last,
             "concurrency": test.get("concurrency")}
    spec_opts = (test.get("spec") or {}).get("opts") \
        if isinstance(test.get("spec"), dict) else None
    for k in ("rate", "time_limit", "ops", "nemesis"):
        v = (spec_opts or {}).get(k, test.get(k))
        if isinstance(v, (int, float, str)):
            feats[k] = v
    return feats


def build_record(test: dict, recorder: Recorder | None = None) -> dict:
    """The per-run coverage record: fault activations (live recorder
    first, history fallback), workload signature, and anomaly outcomes
    from the analyzed results."""
    rec = recorder if recorder is not None else _global
    hist = test.get("history")
    faults = fold_faults(rec.activations(), rec.harness_counts())
    if not faults:
        faults = faults_from_history(hist)
    results = test.get("results") if isinstance(test.get("results"),
                                                dict) else {}
    return {
        "schema": SCHEMA,
        "run": _run_id(test),
        "ts": round(time.time(), 3),
        "workload": _workload_name(test),
        "signature": _schedule_features(test, hist),
        "faults": faults,
        "anomalies": anomaly_outcomes(results),
        "valid": results.get("valid?", "unknown"),
    }


def validate_record(rec) -> int:
    """Schema check for a coverage.json document: required keys,
    fault entries with non-negative counts and 2-element windows,
    anomaly entries with known outcomes. Returns fault + anomaly entry
    count; raises ValueError on the first violation."""
    if not isinstance(rec, dict):
        raise ValueError("coverage record must be a dict")
    for key in ("schema", "run", "ts", "workload", "faults",
                "anomalies", "valid"):
        if key not in rec:
            raise ValueError(f"coverage record missing {key!r}")
    if rec["schema"] != SCHEMA:
        raise ValueError(f"unknown schema {rec['schema']!r}")
    if not isinstance(rec["run"], str) or not rec["run"]:
        raise ValueError(f"bad run id {rec['run']!r}")
    if not isinstance(rec["ts"], (int, float)) or rec["ts"] < 0:
        raise ValueError(f"bad ts {rec['ts']!r}")
    n = 0
    if not isinstance(rec["faults"], list):
        raise ValueError("faults must be a list")
    for i, f in enumerate(rec["faults"]):
        if not isinstance(f, dict) or not f.get("kind"):
            raise ValueError(f"fault {i}: missing kind: {f!r}")
        if not isinstance(f.get("count"), int) or f["count"] < 0:
            raise ValueError(f"fault {i}: bad count: {f!r}")
        for w in f.get("windows", []):
            if (not isinstance(w, list) or len(w) != 2
                    or not isinstance(w[0], int)
                    or not (w[1] is None or isinstance(w[1], int))):
                raise ValueError(f"fault {i}: bad window {w!r}")
        n += 1
    if not isinstance(rec["anomalies"], list):
        raise ValueError("anomalies must be a list")
    for i, a in enumerate(rec["anomalies"]):
        if not isinstance(a, dict) or not a.get("class"):
            raise ValueError(f"anomaly {i}: missing class: {a!r}")
        if a.get("outcome") not in OUTCOMES:
            raise ValueError(f"anomaly {i}: bad outcome: {a!r}")
        idxs = a.get("op-indices")
        if idxs is not None and not (
                isinstance(idxs, list)
                and all(isinstance(x, int) for x in idxs)):
            raise ValueError(f"anomaly {i}: bad op-indices: {a!r}")
        frac = a.get("witness-frac")
        if frac is not None and not (
                isinstance(frac, (int, float)) and 0 <= frac <= 1):
            raise ValueError(f"anomaly {i}: bad witness-frac: {a!r}")
        n += 1
    return n


def write_record(test: dict, recorder: Recorder | None = None
                 ) -> dict | None:
    """Builds, validates, and writes <run>/coverage.json; returns the
    record (None without a store dir)."""
    d = test.get("store_dir")
    if not d:
        return None
    rec = build_record(test, recorder)
    validate_record(rec)
    with open(Path(d) / RECORD_FILE, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def load_record(d) -> dict | None:
    p = Path(d) / RECORD_FILE
    if not p.exists():
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# Atlas: the cross-run journal + aggregation
# ---------------------------------------------------------------------------

def _digest(entry: dict) -> str:
    """Content fingerprint of an atlas entry's cell contribution —
    identical re-analysis appends nothing."""
    view = {k: entry[k] for k in ("run", "workload", "faults",
                                  "anomalies", "valid")
            if k in entry}
    return hashlib.sha1(
        json.dumps(view, sort_keys=True).encode()).hexdigest()[:16]


def atlas_entry(rec: dict) -> dict:
    """One atlas line from a per-run record: the compact per-run cell
    contribution (fault kinds + anomaly outcomes; windows dropped)."""
    entry = {
        "run": rec["run"],
        "ts": rec["ts"],
        "workload": rec["workload"],
        "faults": {f["kind"]: f["count"] for f in rec["faults"]},
        "anomalies": {a["class"]: a["outcome"]
                      for a in rec["anomalies"]},
        "valid": rec.get("valid"),
    }
    fracs = {a["class"]: a["witness-frac"] for a in rec["anomalies"]
             if isinstance(a.get("witness-frac"), (int, float))}
    if fracs:
        # witness-position percentiles per witnessed class (not part
        # of the digest view: they're a deterministic function of the
        # same results the digested outcomes come from)
        entry["witness-frac"] = fracs
    entry["digest"] = _digest(entry)
    return entry


def read_atlas(path) -> list[dict]:
    """Atlas entries in append order; torn trailing line dropped."""
    p = Path(path)
    if not p.exists():
        return []
    out = []
    with open(p) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except ValueError:
                break
            if isinstance(e, dict) and e.get("run"):
                out.append(e)
    return out


def dedup_entries(entries: Iterable[dict]) -> dict[str, dict]:
    """{run id: newest entry} — the atlas merge rule. Appending a
    re-analysis of the same run REPLACES its contribution; cell counts
    cannot double."""
    out: dict[str, dict] = {}
    for e in entries:
        out[str(e.get("run"))] = e
    return out


def _append_if_new(path: Path, have: dict, entry: dict) -> bool:
    """The one merge rule: append `entry` unless the newest entry for
    its run already carries the same digest (then it IS the atlas
    state and re-appending would only bloat the journal). `have` is
    the preloaded newest-per-run index, updated in place."""
    latest = have.get(entry["run"])
    if latest is not None and latest.get("digest") == entry["digest"]:
        return False
    path.parent.mkdir(parents=True, exist_ok=True)
    # one os.write on an O_APPEND fd (ledger.atomic_append_line):
    # concurrent runs appending to the shared atlas can interleave
    # LINES but never bytes — newest-line-wins stays sound because no
    # reader can ever see a spliced line
    from . import ledger

    ledger.atomic_append_line(path, json.dumps(entry))
    have[entry["run"]] = entry
    return True


def append_run(base, rec: dict) -> dict | None:
    """Appends a run's atlas entry under store base `base`, skipping
    the write when the newest entry for that run already carries the
    same digest (analyze --resume over an unchanged run is a no-op).
    Returns the entry (written or matched)."""
    path = Path(base) / ATLAS_FILE
    entry = atlas_entry(rec)
    have = dedup_entries(read_atlas(path))
    if not _append_if_new(path, have, entry):
        return have[entry["run"]]
    return entry


def sync_store(base) -> int:
    """Folds every stored run's coverage.json into the atlas (runs
    whose live append was missed — crashed before it landed, analyzed
    elsewhere, copied in). Returns the number of entries appended."""
    from . import store as jstore

    base = Path(base)
    n = 0
    path = base / ATLAS_FILE
    have = dedup_entries(read_atlas(path))
    for td in jstore.tests(base=base):
        rec = load_record(td)
        if rec is None:
            continue
        try:
            validate_record(rec)
        except ValueError as e:
            logger.warning("skipping invalid coverage record %s: %s",
                           td, e)
            continue
        if _append_if_new(path, have, atlas_entry(rec)):
            n += 1
    return n


def validate_atlas(entries) -> int:
    """Schema check for atlas entries (tier-1): run/ts/workload/
    faults/anomalies/digest shapes. Returns the entry count."""
    n = 0
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise ValueError(f"entry {i}: not a dict")
        for key in ("run", "ts", "workload", "faults", "anomalies",
                    "digest"):
            if key not in e:
                raise ValueError(f"entry {i} missing {key!r}")
        if not isinstance(e["faults"], dict) or not all(
                isinstance(v, int) for v in e["faults"].values()):
            raise ValueError(f"entry {i}: bad faults {e['faults']!r}")
        if not isinstance(e["anomalies"], dict) or not all(
                v in OUTCOMES for v in e["anomalies"].values()):
            raise ValueError(
                f"entry {i}: bad anomalies {e['anomalies']!r}")
        wf = e.get("witness-frac")
        if wf is not None and (not isinstance(wf, dict) or not all(
                isinstance(v, (int, float)) and 0 <= v <= 1
                for v in wf.values())):
            raise ValueError(
                f"entry {i}: bad witness-frac {wf!r}")
        n += 1
    return n
