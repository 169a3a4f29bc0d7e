"""Checkers: verify that a history is consistent with a model (the
port's copy of jepsen_tpu/checker).

Capability reference: jepsen/src/jepsen/checker.clj (Checker protocol
57-72, check-safe 79-90, compose 92-104, concurrency-limit 106-121,
unhandled-exceptions 129-157, stats 159-200, linearizable 202-233, queue
235-255, set 257-317, set-full 320-612, total-queue 648-708, unique-ids
710-747, counter 749-819, log-file-pattern 863-905; checker/perf.clj and
checker/clock.clj for perf and clock_plot). The O(n) checkers
fold directly on the host (with numpy where it pays); the linearizable
checker runs the WGL search on the card (gpu/wgl.py), the cycle checkers
(cycle.py) the SCC kernel, the bank checker (workloads/bank.py) the
balance reduction. An invalid result with a test["store_dir"] leaves its
reports there (reports/explain.py), as the JAX package's does.

The latency, rate and clock plots (perf, clock_plot; reports/perf.py,
reports/clock.py) draw with matplotlib, imported when a figure is drawn:
without it their checkers raise ImportError, which check_safe reports as
valid? "unknown", as in the JAX package.
"""

from __future__ import annotations

import hashlib
import logging
import re
import threading
import traceback
from collections import Counter
from pathlib import Path
from typing import Any

from .. import history as h
from .. import telemetry, util
from ..history import History
from . import models as model

logger = logging.getLogger(__name__)


class Checker:
    def check(self, test, history: History, opts: dict | None = None) -> dict:
        """Returns at least {'valid?': True|False|'unknown'}. opts may
        include 'subdirectory' for output files."""
        raise NotImplementedError


def _as_history(hist) -> History:
    if isinstance(hist, History):
        return hist
    return History(hist)


def check(checker: Checker, test, hist, opts=None) -> dict:
    return checker.check(test, _as_history(hist), opts or {})


_TIMED_OUT = object()


def checker_timeout_s(test, opts=None) -> float | None:
    """The per-checker wall-clock bound, from opts or the test map
    (test["checker_timeout_s"]); None = unbounded."""
    for src in (opts or {}, test if isinstance(test, dict) else {}):
        v = src.get("checker_timeout_s")
        if v:
            return float(v)
    return None


def check_safe(checker: Checker, test, hist, opts=None,
               timeout_s: float | None = None) -> dict:
    """check, but exceptions degrade to valid? 'unknown'
    (checker.clj:79-90). With timeout_s, a hung checker degrades the
    same way after that many wall-clock seconds — the worker thread is
    abandoned, not interrupted (util.timeout), so analysis proceeds to
    the remaining checkers instead of stalling the whole run."""
    def body():
        try:
            return check(checker, test, hist, opts)
        except Exception:  # noqa: BLE001
            logger.exception("Error while checking history:")
            return {"valid?": "unknown", "error": traceback.format_exc()}

    if not timeout_s:
        return body()
    res = util.timeout(timeout_s, body, default=_TIMED_OUT)
    if res is _TIMED_OUT:
        telemetry.count("checker.timeouts")
        logger.warning("checker %s timed out after %.1fs; degrading to "
                       "valid? unknown", type(checker).__name__,
                       timeout_s)
        return {"valid?": "unknown",
                "error": f"checker timed out after {timeout_s}s"}
    return res


def op_indices(hist: History | None, *ops) -> list[int]:
    """Participating op (invocation) indices for a group of ops —
    anomaly provenance. Completion ops resolve to their invocation when
    the history is given."""
    idxs = set()
    for o in ops:
        if o is None:
            continue
        idx = getattr(o, "index", None)
        if idx is None and isinstance(o, dict):
            idx = o.get("index")
        if not isinstance(idx, int) or idx < 0:
            continue
        ty = getattr(o, "type", None) or (
            o.get("type") if isinstance(o, dict) else None)
        if hist is not None and ty is not None and ty != "invoke":
            try:
                inv = hist.invocation(o)
                if inv is not None:
                    idx = inv.index
            except (KeyError, TypeError, AttributeError):
                pass
        idxs.add(idx)
    return sorted(idxs)


def merge_valid(valids) -> Any:
    """false dominates, then unknown, else true."""
    out: Any = True
    for v in valids:
        if v is False:
            return False
        if v == "unknown":
            out = "unknown"
    return out


def anomaly_classes(result: dict, **classes) -> dict:
    """Attaches the coverage taxonomy tag to a checker result:
    `anomaly-classes` maps each class this checker CHECKED to
    'witnessed' (found), 'clean' (checked, none found), or 'unknown'
    (the check was indeterminate). Values may be bools (witnessed?) —
    resolved against the result's valid? — or literal outcome
    strings."""
    resolved = {}
    indeterminate = result.get("valid?") == "unknown"
    for cls, v in classes.items():
        cls = cls.replace("_", "-")
        if isinstance(v, str):
            resolved[cls] = v
        elif v:
            resolved[cls] = "witnessed"
        else:
            resolved[cls] = "unknown" if indeterminate else "clean"
    result["anomaly-classes"] = resolved
    return result


class _Fn(Checker):
    def __init__(self, fn):
        self.fn = fn

    def check(self, test, hist, opts=None):
        return self.fn(test, hist, opts or {})


def checker(fn) -> Checker:
    """Wraps fn(test, history, opts) -> result as a Checker."""
    return _Fn(fn)


def noop() -> Checker:
    return _Fn(lambda test, hist, opts: None)


def unbridled_optimism() -> Checker:
    """Everything is awesome."""
    return _Fn(lambda test, hist, opts: {"valid?": True})


class Compose(Checker):
    """Runs named checkers in parallel; valid? is the merge of all
    (checker.clj:92-104)."""

    def __init__(self, checker_map: dict):
        self.checker_map = dict(checker_map)

    def check(self, test, hist, opts=None):
        opts = opts or {}
        partial = opts.get("partial_results")  # crash-surviving sink
        # per-checker wall-clock bound: one hung checker degrades to
        # valid? 'unknown' instead of stalling the whole analysis
        timeout_s = checker_timeout_s(test, opts)
        # results recovered from a crashed analysis's partial log
        # (analyze --resume): completed checkers are not re-run
        resumed = opts.get("resume_results") or {}
        # sub-checkers must NOT inherit the sink: a nested compose
        # would write its inner results flat with colliding keys (two
        # 'stats' entries, workload results hoisted to top level)
        sub_opts = {k: v for k, v in opts.items()
                    if k not in ("partial_results", "resume_results")}

        def one(kv):
            name, c = kv
            if name in resumed:
                telemetry.count("checker.resumed")
                r = resumed[name]
            else:
                # per-checker timing: the checker:<name> spans feed the
                # :telemetry summary core.analyze attaches to results
                with telemetry.span(f"checker:{name}"):
                    r = check_safe(c, test, hist, sub_opts,
                                   timeout_s=timeout_s)
            if partial is not None:
                try:
                    partial.put(name, r)
                except Exception:  # noqa: BLE001 — never sink the check
                    logger.exception("writing partial result failed")
            return name, r

        outs = util.bounded_pmap(one, list(self.checker_map.items()),
                                 limit=8)
        results = dict(outs)
        results["valid?"] = merge_valid(
            (r or {}).get("valid?") for r in results.values()
            if isinstance(r, dict))
        return results


def compose(checker_map: dict) -> Checker:
    return Compose(checker_map)


class ConcurrencyLimit(Checker):
    """Bounds concurrent executions of a checker (checker.clj:106-121)."""

    def __init__(self, limit: int, inner: Checker):
        self.sem = threading.Semaphore(limit)
        self.inner = inner

    def check(self, test, hist, opts=None):
        with self.sem:
            return self.inner.check(test, hist, opts)


def concurrency_limit(limit: int, inner: Checker) -> Checker:
    return ConcurrencyLimit(limit, inner)


# ---------------------------------------------------------------------------
# Stats + exceptions
# ---------------------------------------------------------------------------

def stats() -> Checker:
    """Success/failure rates, overall and by :f; valid only if every :f has
    some ok ops (checker.clj:159-200). Single counting pass — no
    per-f op lists (SURVEY P4: O(n) folds stay O(1) in memory)."""

    def run(test, hist, opts):
        by: dict = {}
        for o in hist:
            t = o.type
            if t == "invoke" or not h.is_client_op(o):
                continue
            d = by.get(o.f)
            if d is None:
                d = by[o.f] = [0, 0, 0]  # ok, info, fail
            if t == "ok":
                d[0] += 1
            elif t == "info":
                d[1] += 1
            elif t == "fail":
                d[2] += 1

        def fold(oks, infos, fails):
            return {"valid?": oks > 0, "count": oks + infos + fails,
                    "ok-count": oks, "fail-count": fails,
                    "info-count": infos}

        by_f = {f: fold(*c) for f, c in sorted(
            by.items(), key=lambda kv: str(kv[0]))}
        out = fold(sum(c[0] for c in by.values()),
                   sum(c[1] for c in by.values()),
                   sum(c[2] for c in by.values()))
        out["by-f"] = by_f
        out["valid?"] = merge_valid(r["valid?"] for r in by_f.values())
        return out

    return _Fn(run)


def unhandled_exceptions() -> Checker:
    """Frequency table of exceptions recorded in :info ops
    (checker.clj:129-157)."""

    def run(test, hist, opts):
        by_class: dict = {}
        for o in hist:
            if o.type == "info" and o.get("exception"):
                cls = str(o.get("exception")).strip().splitlines()[-1][:120]
                by_class.setdefault(cls, []).append(o)
        exes = [{"count": len(ops), "class": cls, "example": ops[0]}
                for cls, ops in sorted(by_class.items(),
                                       key=lambda kv: -len(kv[1]))]
        out = {"valid?": True}
        if exes:
            out["exceptions"] = exes
        return out

    return _Fn(run)


# ---------------------------------------------------------------------------
# Linearizability
# ---------------------------------------------------------------------------

class Linearizable(Checker):
    """Validates linearizability. opts: {'model': Model, 'algorithm':
    'gpu' (default) | 'wgl' | 'model', 'certify': bool (default True),
    'device': None (the CUDA card) | 'cpu' | a torch device}. 'wgl' is
    the pure-host reference search; 'gpu' is the batched frontier
    kernel."""

    def __init__(self, opts: dict):
        self.model = opts.get("model")
        if self.model is None:
            raise ValueError("the linearizable checker requires a model")
        self.algorithm = opts.get("algorithm", "gpu")
        # checker-driven verdicts carry a machine-checkable proof by
        # default (gpu/certify.py)
        self.certify = bool(opts.get("certify", True))
        self.device = opts.get("device")

    @staticmethod
    def _trim(a: dict) -> dict:
        a["final-paths"] = a.get("final-paths", [])[:10]
        a["configs"] = a.get("configs", [])[:10]
        return a

    def check(self, test, hist, opts=None):
        """With test["store_dir"] set: test["extend?"] checks through
        analysis_extend, reusing the frontier stored for this run and
        model (a grown run costs O(suffix)); test["checkpoint?"] keeps
        the segmented check's masks in store_dir/checker-frontier, so an
        interrupted check resumes; an invalid result leaves its
        counterexample there (_explain)."""
        from ..gpu import wgl

        store_dir = test.get("store_dir") if isinstance(test, dict) \
            else None
        if store_dir and test.get("extend?") and self.algorithm == "gpu":
            out = self._trim(wgl.analysis_extend(
                self.model, hist,
                store_path=self._extend_path(store_dir, hist),
                certify=self.certify, device=self.device))
            return self._explain(test, out)
        ckpt_dir = None
        if store_dir and test.get("checkpoint?"):
            # a DIRECTORY: each check derives a per-fingerprint file, so
            # concurrent per-key or composed checkers never collide
            ckpt_dir = Path(store_dir) / "checker-frontier"
        out = self._trim(wgl.analysis(self.model, hist,
                                      algorithm=self.algorithm,
                                      certify=self.certify,
                                      device=self.device,
                                      checkpoint_dir=ckpt_dir))
        return self._explain(test, out)

    def _extend_path(self, store_dir, hist) -> Path:
        """The store file of this (model, history identity) under the
        run directory's ckpt/: keyed by the model's repr and the FIRST
        op (stable as the run grows by appending), so concurrent per-key
        checks never share one record. The JAX package's name for the
        same run and model."""
        from ..gpu import ckpt
        from ..store import format as fmt

        digest = hashlib.sha256(repr(self.model).encode())
        first = next(iter(hist), None)
        if first is not None:
            digest.update(fmt.encode_op(first))
        return ckpt.run_dir_path(store_dir,
                                 f"wgl-{digest.hexdigest()[:16]}")

    @staticmethod
    def _explain(test, out: dict) -> dict:
        """Tags the coverage class this checker decides and, for an
        invalid result with a store dir, renders the counterexample SVG
        (the reference's knossos render-analysis! hook,
        checker.clj:222-229) and its trace excerpt. The file names carry
        a content fingerprint, so concurrent per-key checks sharing one
        store dir never clobber each other's renders. Rendering is best
        effort: an exception is logged, and the result has no
        `counterexample-svg`."""
        anomaly_classes(out,
                        nonlinearizable=out.get("valid?") is False)
        store_dir = isinstance(test, dict) and test.get("store_dir")
        if store_dir and out.get("valid?") is False:
            try:
                from ..reports import explain

                fp = explain._fingerprint(
                    (repr(out.get("op")), repr(out.get("previous-ok")),
                     repr(out.get("configs"))))
                p = explain.render_linear_svg(
                    out, Path(store_dir)
                    / f"linear-counterexample-{fp}.svg")
                if p:
                    out["counterexample-svg"] = p
                # provenance: the counterexample's op-indices resolve
                # to per-op trace excerpts when the run was traced
                p2 = explain.write_linear_trace_excerpt(store_dir, out)
                if p2:
                    out["trace-excerpt"] = p2
            except Exception:  # noqa: BLE001 — rendering is best-effort
                logger.exception("rendering linear counterexample failed")
        return out

    def check_batch(self, test, hists, opts=None) -> list[dict]:
        """check over many histories: with algorithm 'gpu', one batched
        search on the device for all of them (analysis_batch); other
        algorithms check each history on its own. A device failure
        raises."""
        from ..gpu import wgl

        if self.algorithm != "gpu":
            return [self._explain(test, self._trim(wgl.analysis(
                        self.model, hh, algorithm=self.algorithm,
                        certify=self.certify, device=self.device)))
                    for hh in hists]
        return [self._explain(test, self._trim(a)) for a in
                wgl.analysis_batch(self.model, hists, certify=self.certify,
                                   device=self.device)]


def linearizable(opts: dict) -> Checker:
    return Linearizable(opts)


# ---------------------------------------------------------------------------
# Queue / set / counter families
# ---------------------------------------------------------------------------

def queue(m: model.Model) -> Checker:
    """Assume every non-failing enqueue succeeded and only ok dequeues
    happened; fold the model over that (checker.clj:235-255)."""

    def run(test, hist, opts):
        final = m
        for o in hist:
            if o.f == "enqueue" and o.type == "invoke":
                final = model.step(final, o)
            elif o.f == "dequeue" and o.type == "ok":
                final = model.step(final, o)
        if model.is_inconsistent(final):
            return {"valid?": False, "error": final.msg}
        return {"valid?": True, "final-queue": final}

    return _Fn(run)


def set_checker() -> Checker:
    """Adds followed by a final read: every ok add must be read; only
    attempted adds may appear (checker.clj:257-317)."""

    def run(test, hist, opts):
        attempts = {o.value for o in hist
                    if o.type == "invoke" and o.f == "add"}
        adds = {o.value for o in hist if o.type == "ok" and o.f == "add"}
        final_read = None
        for o in hist:
            if o.f == "read" and o.type == "ok":
                final_read = o.value
        if final_read is None:
            return anomaly_classes(
                {"valid?": "unknown", "error": "Set was never read"},
                set_lost=False, set_unexpected=False)
        final = set(final_read)
        ok = final & attempts
        unexpected = final - attempts
        lost = adds - final
        recovered = ok - adds
        return anomaly_classes({
            "valid?": not lost and not unexpected,
            "attempt-count": len(attempts),
            "acknowledged-count": len(adds),
            "ok-count": len(ok),
            "lost-count": len(lost),
            "recovered-count": len(recovered),
            "unexpected-count": len(unexpected),
            "ok": util.integer_interval_set_str(ok)
            if _all_ints(ok) else sorted(ok, key=str),
            "lost": util.integer_interval_set_str(lost)
            if _all_ints(lost) else sorted(lost, key=str),
            "unexpected": util.integer_interval_set_str(unexpected)
            if _all_ints(unexpected) else sorted(unexpected, key=str),
            "recovered": util.integer_interval_set_str(recovered)
            if _all_ints(recovered) else sorted(recovered, key=str),
        }, set_lost=bool(lost), set_unexpected=bool(unexpected))

    return _Fn(run)


def _all_ints(xs) -> bool:
    return all(isinstance(x, int) for x in xs)


class _SetFullElement:
    """Per-element lifecycle state (checker.clj SetFullElement,
    330-433)."""

    __slots__ = ("element", "known", "last_present", "last_absent")

    def __init__(self, element):
        self.element = element
        self.known = None          # completion op confirming existence
        self.last_present = None   # latest read invocation observing it
        self.last_absent = None    # latest read invocation missing it

    def add_ok(self, op):
        if self.known is None:
            self.known = op

    def read_present(self, inv, op):
        if self.known is None:
            self.known = op
        if self.last_present is None or self.last_present.index < inv.index:
            self.last_present = inv

    def read_absent(self, inv, op):
        if self.last_absent is None or self.last_absent.index < inv.index:
            self.last_absent = inv

    def results(self) -> dict:
        lp = self.last_present.index if self.last_present else -1
        la = self.last_absent.index if self.last_absent else -1
        stable = bool(self.last_present and la < lp)
        lost = bool(self.known and self.last_absent and lp < la
                    and self.known.index < la)
        stable_time = ((self.last_absent.time + 1 if self.last_absent else 0)
                       if stable else None)
        lost_time = ((self.last_present.time + 1 if self.last_present else 0)
                     if lost else None)
        known_time = self.known.time if self.known else 0
        stable_latency = (max(0, stable_time - known_time) // 1_000_000
                          if stable else None)
        lost_latency = (max(0, lost_time - known_time) // 1_000_000
                        if lost else None)
        return {"element": self.element,
                "outcome": ("stable" if stable
                            else "lost" if lost else "never-read"),
                "stable-latency": stable_latency,
                "lost-latency": lost_latency,
                "known": self.known,
                "last-absent": self.last_absent}


def _frequency_distribution(points, values):
    values = sorted(values)
    if not values:
        return None
    n = len(values)
    return {p: values[min(n - 1, int(n * p))] for p in points}


def _set_full_results_slow(hist) -> tuple[list, dict]:
    """Object-model per-element lifecycle fold (the correctness
    reference; O(reads x elements))."""
    elements: dict = {}
    dups: dict = {}
    for op in hist:
        if not h.is_client_op(op):
            continue
        if op.f == "add":
            if op.type == "invoke":
                elements[op.value] = _SetFullElement(op.value)
            elif op.type == "ok" and op.value in elements:
                elements[op.value].add_ok(op)
        elif op.f == "read" and op.type == "ok":
            inv = hist.invocation(op)
            if inv is None:
                continue
            vals = op.value or []
            for k, n in Counter(vals).items():
                if n > 1:
                    dups[k] = max(dups.get(k, 0), n)
            vset = set(vals)
            for element, state in elements.items():
                if element in vset:
                    state.read_present(inv, op)
                else:
                    state.read_absent(inv, op)
    rs = [e.results() for _k, e in sorted(elements.items(),
                                          key=lambda kv: str(kv[0]))]
    return rs, dups


def _set_full_results_fast(hist) -> tuple[list, dict] | None:
    """Array formulation of the same fold (SURVEY P4): per-element
    last-present/last-absent/known reduce to segment max/min over
    (element, read) membership pairs, so cost is O(total read volume)
    in C instead of O(reads x elements) in Python. Returns None when
    the history isn't int-valued (caller falls back).

    last_absent needs the highest read (in invocation order) NOT
    containing an element: with reads ranked 0..R-1, that is
    R-1-k where k is the element's trailing run of consecutive
    present ranks ending at R-1 (k=0 when absent from the last read).
    """
    import numpy as np

    seen_add: set = set()       # elements with an add invocation
    add_ok: dict = {}           # element -> first add-ok op
    reads: list = []            # (inv_index, inv_time, comp_index,
    #                              comp_time, comp_pos, values)
    for pos, op in enumerate(hist):
        f = op.f
        if f == "add":
            if not h.is_client_op(op):
                continue
            if type(op.value) is not int:
                return None
            ty = op.type
            if ty == "invoke":
                seen_add.add(op.value)
            elif ty == "ok" and op.value in seen_add:
                add_ok.setdefault(op.value, op)
        elif f == "read" and op.type == "ok":
            if not h.is_client_op(op):
                continue
            inv = hist.invocation(op)
            if inv is None:
                continue
            reads.append((inv.index, inv.time or 0, op.index,
                          op.time or 0, inv, op, op.value or []))
    elements = sorted(seen_add)  # numeric order for array ops
    E, R = len(elements), len(reads)
    elem_arr = np.asarray(elements, dtype=np.int64)
    reads.sort(key=lambda r: r[0])  # rank = invocation order
    inv_idx = np.asarray([r[0] for r in reads], dtype=np.int64)
    inv_time = np.asarray([r[1] for r in reads], dtype=np.int64)
    inv_ops = [r[4] for r in reads]   # invocation Op per rank
    comp_ops = [r[5] for r in reads]  # completion Op per rank

    # One vectorized pass per read, in invocation-rank order: updates
    # last-present ranks, first-present completion (for known), the
    # trailing consecutive-present run (for last_absent), and
    # duplicate counts — O(read volume + reads * E), no global sort.
    BIG = np.iinfo(np.int64).max
    comp_idx = np.asarray([r[2] for r in reads], dtype=np.int64)
    comp_time = np.asarray([r[3] for r in reads], dtype=np.int64)
    last_present = np.full(E, -1, dtype=np.int64)
    first_pres_comp = np.full(E, BIG, dtype=np.int64)
    first_pres_comp_time = np.zeros(E, dtype=np.int64)
    first_pres_rank = np.full(E, -1, dtype=np.int64)
    run = np.zeros(E, dtype=np.int64)
    dups: dict = {}
    for rank in range(R):
        try:
            vals = np.asarray(reads[rank][6], dtype=np.int64)
        except (TypeError, ValueError, OverflowError):
            return None
        if vals.size:
            uniq, counts = np.unique(vals, return_counts=True)
            for j in np.flatnonzero(counts > 1):
                k = int(uniq[j])
                dups[k] = max(dups.get(k, 0), int(counts[j]))
            # keep only elements that were actually added
            p = np.searchsorted(elem_arr, uniq)
            p = np.clip(p, 0, max(E - 1, 0))
            ok = (elem_arr[p] == uniq) if E else np.zeros(
                len(uniq), dtype=bool)
            ids = p[ok]
        else:
            ids = np.empty(0, dtype=np.int64)
        last_present[ids] = rank  # ranks ascend: assignment == max
        ci, ct = int(comp_idx[rank]), int(comp_time[rank])
        upd = ids[first_pres_comp[ids] > ci]
        first_pres_comp[upd] = ci
        first_pres_comp_time[upd] = ct
        first_pres_rank[upd] = rank
        # elements absent from this read restart their run at 0
        nrun = np.zeros(E, dtype=np.int64)
        nrun[ids] = run[ids] + 1
        run = nrun
    # last_absent = highest rank NOT containing the element: R-1 minus
    # the trailing consecutive-present run (-1 when no reads at all)
    last_absent = ((R - 1) - run if R
                   else np.full(E, -1, dtype=np.int64))

    # known = first confirming event in history order: add-ok or
    # present-read completion, whichever completes first
    add_ok_idx = np.full(E, BIG, dtype=np.int64)
    for i, e in enumerate(elements):
        o = add_ok.get(e)
        if o is not None:
            add_ok_idx[i] = o.index
    known_idx = np.minimum(add_ok_idx, first_pres_comp)
    has_known = known_idx < BIG

    lp, la = last_present, last_absent
    has_p = lp >= 0
    has_a = la >= 0
    if R:
        lp_idx = np.where(has_p, inv_idx[np.clip(lp, 0, None)], -1)
        la_idx = np.where(has_a, inv_idx[np.clip(la, 0, None)], -1)
        la_time = np.where(has_a, inv_time[np.clip(la, 0, None)], -1)
        lp_time = np.where(has_p, inv_time[np.clip(lp, 0, None)], -1)
    else:  # no successful reads at all: everything is never-read
        lp_idx = la_idx = np.full(E, -1, dtype=np.int64)
        la_time = lp_time = np.full(E, -1, dtype=np.int64)
    stable = has_p & (la < lp)
    lost = has_known & has_a & (lp < la) & (known_idx < la_idx)

    # times + latencies (checker.clj results, 435-470)
    add_ok_time = np.zeros(E, dtype=np.int64)
    for i, e in enumerate(elements):
        o = add_ok.get(e)
        if o is not None:
            add_ok_time[i] = o.time or 0
    by_add = add_ok_idx <= first_pres_comp
    known_time = np.where(by_add, add_ok_time, first_pres_comp_time)

    stable_time = np.where(has_a, la_time + 1, 0)
    lost_time = np.where(has_p, lp_time + 1, 0)
    stable_lat = np.maximum(0, stable_time - known_time) // 1_000_000
    lost_lat = np.maximum(0, lost_time - known_time) // 1_000_000

    # rows in str(element) order, matching the object path exactly;
    # plain-list views keep the row loop free of numpy scalar overhead
    stable_l = stable.tolist()
    lost_l = lost.tolist()
    sl_l = stable_lat.tolist()
    ll_l = lost_lat.tolist()
    hk_l = has_known.tolist()
    ha_l = has_a.tolist()
    la_l = la.tolist()
    by_add_l = by_add.tolist()
    fpr_l = first_pres_rank.tolist()
    idx_of = {e: i for i, e in enumerate(elements)}
    rs = []
    for e in sorted(elements, key=str):
        i = idx_of[e]
        outcome = ("stable" if stable_l[i]
                   else "lost" if lost_l[i] else "never-read")
        if not hk_l[i]:
            known = None
        elif by_add_l[i]:
            known = add_ok.get(e)
        else:  # existence proven by a read's completion (slow-path op)
            known = comp_ops[fpr_l[i]]
        rs.append({
            "element": e,
            "outcome": outcome,
            "stable-latency": sl_l[i] if stable_l[i] else None,
            "lost-latency": ll_l[i] if lost_l[i] else None,
            "known": known,
            "last-absent": (inv_ops[la_l[i]] if ha_l[i] else None),
        })
    return rs, dups


def set_full(checker_opts: dict | None = None) -> Checker:
    """Rigorous per-element set analysis: stable/lost/never-read outcomes
    with stable/lost latencies (checker.clj:320-612)."""
    copts = {"linearizable?": False}
    copts.update(checker_opts or {})

    def run(test, hist, opts):
        fast = _set_full_results_fast(hist)
        rs, dups = (fast if fast is not None
                    else _set_full_results_slow(hist))
        outcomes: dict = {}
        for r in rs:
            outcomes.setdefault(r["outcome"], []).append(r)
        stale = [r for r in outcomes.get("stable", [])
                 if r["stable-latency"] and r["stable-latency"] > 0]
        stable_lat = [r["stable-latency"] for r in rs
                      if r["stable-latency"] is not None]
        lost_lat = [r["lost-latency"] for r in rs
                    if r["lost-latency"] is not None]
        lost_n = len(outcomes.get("lost", []))
        stable_n = len(outcomes.get("stable", []))
        valid: Any = True
        if lost_n > 0:
            valid = False
        elif stable_n == 0:
            valid = "unknown"
        elif copts.get("linearizable?") and stale:
            valid = False
        out = {
            "valid?": (False if dups else valid),
            "attempt-count": len(rs),
            "stable-count": stable_n,
            "lost-count": lost_n,
            "lost": sorted((r["element"] for r in outcomes.get("lost", [])),
                           key=str),
            "never-read-count": len(outcomes.get("never-read", [])),
            "never-read": sorted((r["element"]
                                  for r in outcomes.get("never-read", [])),
                                 key=str),
            "stale-count": len(stale),
            "stale": sorted((r["element"] for r in stale), key=str),
            "worst-stale": sorted(stale, key=lambda r: -r["stable-latency"]
                                  )[:8],
            "duplicated-count": len(dups),
            "duplicated": dups,
        }
        if lost_n:
            # provenance for lost elements: the op indices proving
            # existence (known) and loss (last-absent), joinable to
            # the per-op trace and timeline
            out["lost-op-indices"] = {
                r["element"]: op_indices(hist, r["known"],
                                         r["last-absent"])
                for r in outcomes.get("lost", [])}
        points = [0, 0.5, 0.95, 0.99, 1]
        if stable_lat:
            out["stable-latencies"] = _frequency_distribution(
                points, stable_lat)
        if lost_lat:
            out["lost-latencies"] = _frequency_distribution(points, lost_lat)
        return anomaly_classes(out, set_lost=bool(lost_n),
                               set_stale=bool(stale),
                               set_duplicated=bool(dups))

    return _Fn(run)


def _expand_drains(hist: History) -> tuple:
    """Expands :drain ops into dequeue invoke/ok pairs
    (checker.clj:614-646). An :info drain (aborted mid-loop, e.g. the
    broker went away) still contributes its fetched values — ack'd
    messages are really gone — but is counted as aborted, so the
    conservation verdict can degrade to unknown instead of reporting
    still-enqueued messages as lost. Returns (ops, aborted_drains)."""
    out, aborted = [], 0
    for op in hist:
        if op.f != "drain":
            out.append(op)
        elif op.type in ("invoke", "fail"):
            continue
        else:
            if op.type == "info":
                aborted += 1
            for element in op.value or []:
                out.append(op.copy(index=-1, type="invoke", f="dequeue",
                                   value=None))
                out.append(op.copy(index=-1, type="ok", f="dequeue",
                                   value=element))
    return out, aborted


def total_queue() -> Checker:
    """What goes in must come out; requires a fully drained queue
    (checker.clj:648-708)."""

    def run(test, hist, opts):
        ops, aborted_drains = _expand_drains(hist)
        attempts = Counter(o.value for o in ops
                           if o.f == "enqueue" and o.type == "invoke")
        enqueues = Counter(o.value for o in ops
                           if o.f == "enqueue" and o.type == "ok")
        dequeues = Counter(o.value for o in ops
                           if o.f == "dequeue" and o.type == "ok")
        ok = dequeues & attempts
        unexpected = Counter({k: n for k, n in dequeues.items()
                              if k not in attempts})
        duplicated = dequeues - attempts - unexpected
        lost = enqueues - dequeues
        recovered = ok - enqueues
        if unexpected:
            valid = False
        elif lost:
            # if a drain aborted, "lost" messages may simply still sit
            # in the queue nobody finished draining: indeterminate
            valid = "unknown" if aborted_drains else False
        else:
            valid = True
        # a "lost" count under an aborted drain is indeterminate, not
        # a witness — the messages may still sit in the queue
        lost_outcome = ("clean" if not lost
                        else "unknown" if aborted_drains
                        else "witnessed")
        return anomaly_classes({
            "valid?": valid,
            "aborted-drain-count": aborted_drains,
            "attempt-count": sum(attempts.values()),
            "acknowledged-count": sum(enqueues.values()),
            "ok-count": sum(ok.values()),
            "unexpected-count": sum(unexpected.values()),
            "duplicated-count": sum(duplicated.values()),
            "lost-count": sum(lost.values()),
            "recovered-count": sum(recovered.values()),
            "lost": dict(lost),
            "unexpected": dict(unexpected),
            "duplicated": dict(duplicated),
            "recovered": dict(recovered),
        }, queue_lost=lost_outcome,
           queue_unexpected=bool(unexpected),
           queue_duplicated=bool(duplicated))

    return _Fn(run)


def unique_ids() -> Checker:
    """A unique-id generator must emit unique ids (checker.clj:710-747)."""

    def run(test, hist, opts):
        attempted = sum(1 for o in hist
                        if o.f == "generate" and o.type == "invoke")
        acks = [o.value for o in hist
                if o.f == "generate" and o.type == "ok"]
        freqs = Counter(acks)
        dups = {k: n for k, n in freqs.items() if n > 1}
        rng = [min(acks), max(acks)] if acks else None
        return anomaly_classes({
            "valid?": not dups,
            "attempted-count": attempted,
            "acknowledged-count": len(acks),
            "duplicated-count": len(dups),
            "duplicated": dict(sorted(dups.items(),
                                      key=lambda kv: -kv[1])[:48]),
            "range": rng,
        }, duplicate_ids=bool(dups))

    return _Fn(run)


def counter() -> Checker:
    """At each read, value must lie between the sum of ok increments and
    the sum of attempted increments (checker.clj:749-819)."""

    def run(test, hist, opts):
        lower = 0
        upper = 0
        pending_reads: dict = {}
        reads = []
        for op in hist:
            key = (op.type, op.f)
            if key == ("invoke", "read"):
                completion = hist.completion(op)
                if completion is not None and completion.type == "ok":
                    pending_reads[op.process] = [lower, completion.value]
            elif key == ("ok", "read"):
                r = pending_reads.pop(op.process, None)
                if r is not None:
                    reads.append([r[0], r[1], upper])
            elif key == ("invoke", "add"):
                assert op.value >= 0, "counter checker assumes increments"
                completion = hist.completion(op)
                if completion is None or completion.type != "fail":
                    upper += op.value
            elif key == ("ok", "add"):
                lower += op.value
        errors = [r for r in reads if not (r[0] <= r[1] <= r[2])]
        return anomaly_classes(
            {"valid?": not errors, "reads": reads, "errors": errors},
            counter_bounds=bool(errors))

    return _Fn(run)


def log_file_pattern(pattern: str, filename: str) -> Checker:
    """Greps downloaded node logs in the store dir for a pattern
    (checker.clj:863-905)."""

    def run(test, hist, opts):
        from .. import store

        matches = []
        for node in test.get("nodes") or []:
            path = store.path(test, str(node), filename)
            if not path.exists():
                continue
            try:
                text = path.read_text(errors="replace")
            except OSError:
                continue
            for line in text.splitlines():
                if re.search(pattern, line):
                    matches.append({"node": node, "line": line})
        return {"valid?": not matches, "count": len(matches),
                "matches": matches}

    return _Fn(run)


def perf(opts: dict | None = None) -> Checker:
    """Latency + rate + live-monitor graphs (checker/perf.clj plus the
    monitor time-series plot); see reports/perf.py."""
    from ..reports.perf import latency_graph, monitor_graph, rate_graph

    return compose({"latency-graph": latency_graph(opts),
                    "rate-graph": rate_graph(opts),
                    "monitor-graph": monitor_graph(opts)})


def clock_plot() -> Checker:
    """Clock-skew plot (checker/clock.clj:14-49)."""
    from ..reports.clock import plot as clock_plot_fn

    return _Fn(lambda test, hist, opts:
               clock_plot_fn(test, hist, opts) or {"valid?": True})


def timeline() -> Checker:
    """HTML timeline (checker/timeline.clj)."""
    from ..reports.timeline import html as timeline_html

    return timeline_html()
