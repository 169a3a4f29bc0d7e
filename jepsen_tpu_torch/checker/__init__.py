"""Checkers: the linearizability checker of jepsen_tpu/checker, on the
port's device search, and the pieces the port's cycle and bank checkers
share (`_Fn`, `op_indices`, `anomaly_classes`).

Capability reference: jepsen/src/jepsen/checker.clj:79-90 (check-safe)
and 202-233 (linearizable). The counterexample rendering of the JAX
package's checker is not ported yet.
"""

from __future__ import annotations

import hashlib
import logging
import traceback
from pathlib import Path
from typing import Any

from ..history import History

logger = logging.getLogger(__name__)


class Checker:
    def check(self, test, history: History, opts: dict | None = None) -> dict:
        """Returns at least {'valid?': True|False|'unknown'}."""
        raise NotImplementedError


def _as_history(hist) -> History:
    if isinstance(hist, History):
        return hist
    return History(hist)


def check(checker: Checker, test, hist, opts=None) -> dict:
    return checker.check(test, _as_history(hist), opts or {})


def check_safe(checker: Checker, test, hist, opts=None) -> dict:
    """check, but an exception degrades to valid? 'unknown' with the
    traceback under 'error' (checker.clj:79-90)."""
    try:
        return check(checker, test, hist, opts)
    except Exception:  # noqa: BLE001 — the reference's check-safe
        logger.exception("Error while checking history:")
        return {"valid?": "unknown", "error": traceback.format_exc()}


def merge_valid(valids) -> Any:
    """false dominates, then unknown, else true."""
    out: Any = True
    for v in valids:
        if v is False:
            return False
        if v == "unknown":
            out = "unknown"
    return out


class _Fn(Checker):
    def __init__(self, fn):
        self.fn = fn

    def check(self, test, hist, opts=None):
        return self.fn(test, hist, opts or {})


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

    @classmethod
    def _finish(cls, out: dict) -> dict:
        # coverage taxonomy: the one class this checker decides, with
        # the explicit negative ("checked, linearizable") recorded
        out = cls._trim(out)
        return anomaly_classes(
            out, nonlinearizable=out.get("valid?") is False)

    def check(self, test, hist, opts=None):
        """With test["store_dir"] set: test["extend?"] checks through
        analysis_extend, reusing the frontier stored for this run and
        model (a grown run costs O(suffix)); test["checkpoint?"] keeps
        the segmented check's masks in store_dir/checker-frontier, so an
        interrupted check resumes."""
        from ..gpu import wgl

        store_dir = test.get("store_dir") if isinstance(test, dict) \
            else None
        if store_dir and test.get("extend?") and self.algorithm == "gpu":
            return self._finish(wgl.analysis_extend(
                self.model, hist,
                store_path=self._extend_path(store_dir, hist),
                certify=self.certify, device=self.device))
        ckpt_dir = None
        if store_dir and test.get("checkpoint?"):
            # a DIRECTORY: each check derives a per-fingerprint file, so
            # concurrent per-key or composed checkers never collide
            ckpt_dir = Path(store_dir) / "checker-frontier"
        return self._finish(wgl.analysis(self.model, hist,
                                         algorithm=self.algorithm,
                                         certify=self.certify,
                                         device=self.device,
                                         checkpoint_dir=ckpt_dir))

    def _extend_path(self, store_dir, hist) -> Path:
        """The store file of this (model, history identity) under the
        run directory's ckpt/: keyed by the model's repr and the FIRST
        op (stable as the run grows by appending), so concurrent per-key
        checks never share one record. The JAX package's name for the
        same run and model."""
        from ..gpu import ckpt
        from ..store import format as fmt

        h = hashlib.sha256(repr(self.model).encode())
        first = next(iter(hist), None)
        if first is not None:
            h.update(fmt.encode_op(first))
        return ckpt.run_dir_path(store_dir, f"wgl-{h.hexdigest()[:16]}")

    def check_batch(self, test, hists, opts=None) -> list[dict]:
        """check over many histories: with algorithm 'gpu', one batched
        search on the device for all of them (analysis_batch); other
        algorithms check each history on its own. A device failure
        raises."""
        from ..gpu import wgl

        if self.algorithm != "gpu":
            return [self._finish(wgl.analysis(
                        self.model, hh, algorithm=self.algorithm,
                        certify=self.certify, device=self.device))
                    for hh in hists]
        return [self._finish(a) for a in wgl.analysis_batch(
            self.model, hists, certify=self.certify, device=self.device)]


def linearizable(opts: dict) -> Checker:
    return Linearizable(opts)
