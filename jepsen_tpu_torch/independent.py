"""Independent key spaces: the checker half of jepsen_tpu/independent.py.

Capability reference: jepsen/src/jepsen/independent.clj — linearizability
checking is exponential in history length, so histories are sharded by
key: subhistories (271-326) and a checker that runs a sub-checker per
key (328-377).

A sub-checker that supports batching (checker.linearizable) gets every
key's history in ONE device launch: per-key histories become the batch
dimension of the WGL kernel (the ensemble path, BASELINE config 5). An
exception from that batch raises out of check(): there is no per-key
retry that would hide a failing device. Sub-checkers without check_batch
run per key through check_safe, as the reference does.

Ops carry (key, value) tuples as their value; `ktuple`/`key_`/`value_`
mirror independent/tuple. The generators (sequential_generator,
concurrent_generator) wait for the port's generator slice.
"""

from __future__ import annotations

from . import checker as chk
from . import telemetry, util
from .history import History


def ktuple(k, v) -> tuple:
    """A key-value pair riding an op's :value (independent/tuple)."""
    return (k, v)


def key_(pair):
    return pair[0] if isinstance(pair, (tuple, list)) and len(pair) == 2 \
        else None


def value_(pair):
    return pair[1] if isinstance(pair, (tuple, list)) and len(pair) == 2 \
        else pair


def subhistories(hist: History) -> dict:
    """Splits a history of (key, value) ops into per-key histories with
    unwrapped values (independent.clj:271-326). Ops keep the whole
    history's indices."""
    out: dict = {}
    for o in hist:
        v = o.value
        if isinstance(v, (tuple, list)) and len(v) == 2:
            k, val = v[0], v[1]
            out.setdefault(k, []).append(o.copy(value=val))
    return {k: History(ops, assign_indices=False)
            for k, ops in out.items()}


class IndependentChecker:
    """Applies a sub-checker to each key's history. If the sub-checker
    supports check_batch (the linearizable checker does), every key is
    checked in one device launch."""

    def __init__(self, inner):
        self.inner = inner

    def check(self, test, hist, opts=None):
        from .gpu import certify

        opts = opts or {}
        with telemetry.span("independent:subhistories"):
            subs = subhistories(hist)
        keys = sorted(subs.keys(), key=str)
        if hasattr(self.inner, "check_batch"):
            results = self.inner.check_batch(
                test, [subs[k] for k in keys], opts)
        else:
            results = util.bounded_pmap(
                lambda k: chk.check_safe(self.inner, test, subs[k], opts),
                keys, limit=8)
        by_key = dict(zip(keys, results))
        # per-key verdict certificates reference the WHOLE history's op
        # indices (subhistories keep them), but their values are wrapped
        # (key, v) tuples there and their digest covers only the
        # subhistory: stamp each certificate with its key (so the
        # validator filters and unwraps during replay) and re-anchor the
        # digest to the whole history the validator will be handed
        full_digest = None
        for k, r in by_key.items():
            cert = r.get("certificate") if isinstance(r, dict) else None
            if isinstance(cert, dict) and "absent" not in cert:
                if not certify._jsonable(k):
                    r["certificate"] = {"v": cert.get("v", 1),
                                        "absent": "independent key "
                                        "is not JSON-serializable"}
                    continue
                if full_digest is None:
                    full_digest = certify.history_digest(hist)
                cert["key"] = certify._jv(k)
                cert["history"] = full_digest
        failures = [k for k, r in by_key.items()
                    if (r or {}).get("valid?") is False]
        valid = chk.merge_valid((r or {}).get("valid?")
                                for r in by_key.values())
        return {"valid?": valid,
                "results": by_key,
                "failures": failures}


def checker(inner) -> IndependentChecker:
    return IndependentChecker(inner)
