"""Checkers: the linearizability checker of jepsen_tpu/checker, on the
port's device search.

Capability reference: jepsen/src/jepsen/checker.clj:202-233
(linearizable). The batch form (`check_batch`), the checkpoint and
extend store paths and the counterexample rendering of the JAX package's
checker are not ported yet.
"""

from __future__ import annotations

from ..history import History


class Checker:
    def check(self, test, history: History, opts: dict | None = None) -> dict:
        """Returns at least {'valid?': True|False|'unknown'}."""
        raise NotImplementedError


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

    def check(self, test, hist, opts=None):
        from ..gpu import wgl

        out = self._trim(wgl.analysis(self.model, hist,
                                      algorithm=self.algorithm,
                                      certify=self.certify,
                                      device=self.device))
        # coverage taxonomy: the one class this checker decides, with
        # the explicit negative ("checked, linearizable") recorded
        return anomaly_classes(
            out, nonlinearizable=out.get("valid?") is False)


def linearizable(opts: dict) -> Checker:
    return Linearizable(opts)
