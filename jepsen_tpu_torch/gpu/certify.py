"""Verdict certificates: self-proving checker results
(jepsen_tpu/tpu/certify.py, copied for the port: the wgl and elle
halves, without the JEPSEN_TPU_CERTIFY switch).

A device-kernel verdict is only as trustworthy as the kernel. This
module makes wgl/elle verdicts carry a machine-checkable proof, so any
kernel regression is caught by *proof failure* on the very run it
corrupts, instead of by host-differential luck in a test suite:

  valid wgl     a per-segment linearization order, re-derived host-side
                from the device result's reach/choice data (the
                per-(segment, start-state) reach-mask chain
                check_segmented resolves) and composed across segments —
                P-compositionality (arXiv:1504.00204) is what makes the
                concatenated per-segment orders one whole-history proof.
  invalid wgl   the blocked-frontier witness normalized into the same
                schema: a replayable prefix reaching a concrete stuck
                configuration plus the pending op that cannot take
                effect there.
  valid elle    a serialization order over the committed txns, checked
                against the independently-derivable constraint set
                (session order, realtime order, read-from precedence).
  invalid elle  the witnessing cycle's edges, each justified by the
                concrete mops that induce the ww/wr/rw dependency (or a
                justified non-cycle anomaly: aborted read, duplicate
                write).

The *validator* (`validate`, `stamp_results`) shares no code with the
kernels or the checker engines: it re-pairs invocations with
completions from the raw history itself, replays model semantics
through its own tiny step functions, and checks each certificate in one
pass — O(n) in history size. Tampered orders, forged cycle edges, and
certificates replayed against an edited history all fail loudly
(tests/test_certify.py pins the rejection matrix). Results whose proofs
can't be extracted say so honestly (`{"absent": reason}`) — an absent
certificate is allowed, a validating-but-wrong one never is.

Extraction cost is bounded (a node budget on the order search).
"""

from __future__ import annotations

import json
import logging
import zlib
from typing import Any, Iterable

from .. import history as h
from .. import telemetry
from ..history import History

logger = logging.getLogger(__name__)

VERSION = 1

# extraction search budget: configs visited before giving up with an
# honest absent("search-budget") — a certificate extractor must never
# turn a bounded device check into an unbounded host search
SEARCH_BUDGET = 500_000

BIG = 1 << 60


class CertificateError(Exception):
    """The certificate does not prove its verdict against this
    history."""


def absent(reason: str) -> dict:
    """An honest no-proof marker (host floors, non-tabulable models,
    exhausted search budgets). Never claims anything; stamp_results
    counts it separately from validation failures."""
    return {"v": VERSION, "absent": str(reason)[:200]}


def _jv(v):
    """JSON-shape normalization: tuples become lists (certificates
    round-trip through results.json, where a (cur, new) cas pair comes
    back as a list), sets become sorted lists."""
    if isinstance(v, (list, tuple)):
        return [_jv(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted((_jv(x) for x in v), key=repr)
    if isinstance(v, dict):
        return {str(k): _jv(x) for k, x in v.items()}
    return v


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


# ---------------------------------------------------------------------------
# Validator-side model semantics
# ---------------------------------------------------------------------------
#
# Deliberately re-implemented from the datatype definitions (a CAS
# register is five lines), NOT imported from checker.models or the
# encode tabulation: the whole point is that a bug anywhere in the
# model->table->kernel pipeline cannot also be in the replay that
# checks its proofs.

_INCONSISTENT = object()


def _step_register(state, f, value, cas=False):
    if f == "write":
        return value
    if f == "read":
        if value is None or value == state:
            return state
        return _INCONSISTENT
    if cas and f == "cas":
        if not isinstance(value, list) or len(value) != 2:
            return _INCONSISTENT
        cur, new = value
        return new if cur == state else _INCONSISTENT
    return _INCONSISTENT


def _step_cas_register(state, f, value):
    return _step_register(state, f, value, cas=True)


def _step_mutex(state, f, value):
    if f == "acquire":
        return True if not state else _INCONSISTENT
    if f == "release":
        return False if state else _INCONSISTENT
    return _INCONSISTENT


def _step_fifo_queue(state, f, value):
    if f == "enqueue":
        return state + [value]
    if f == "dequeue":
        if state and state[0] == value:
            return state[1:]
        return _INCONSISTENT
    return _INCONSISTENT


def _step_unordered_queue(state, f, value):
    if f == "enqueue":
        return state + [value]
    if f == "dequeue":
        if value in state:
            out = list(state)
            out.remove(value)
            return out
        return _INCONSISTENT
    return _INCONSISTENT


def _step_g_set(state, f, value):
    if f == "add":
        return state if value in state else state + [value]
    if f == "read":
        if value is None:
            return state
        if not isinstance(value, list):
            return _INCONSISTENT
        want = sorted(state, key=repr)
        got = sorted(value, key=repr)
        return state if want == got else _INCONSISTENT
    return _INCONSISTENT


def _step_noop(state, f, value):
    return state


# model name -> (step fn, canonicalizer for state comparison)
_MODELS = {
    "register": (_step_register, lambda s: s),
    "cas-register": (_step_cas_register, lambda s: s),
    "mutex": (_step_mutex, bool),
    "fifo-queue": (_step_fifo_queue, lambda s: list(s)),
    "unordered-queue": (_step_unordered_queue,
                        lambda s: sorted(s, key=repr)),
    "g-set": (_step_g_set, lambda s: sorted(s, key=repr)),
    "noop": (_step_noop, lambda s: None),
}

# checker.models class name -> certificate model name + initial state
_MODEL_CLASSES = {
    "Register": ("register", lambda m: m.value),
    "CASRegister": ("cas-register", lambda m: m.value),
    "Mutex": ("mutex", lambda m: bool(m.locked)),
    "FIFOQueue": ("fifo-queue", lambda m: list(m.pending)),
    "UnorderedQueue": ("unordered-queue",
                       lambda m: sorted(m.pending, key=repr)),
    "GSet": ("g-set", lambda m: sorted(m.elements, key=repr)),
    "NoOp": ("noop", lambda m: None),
}


def describe_model(model) -> dict | None:
    """{"name", "init"} for a model the validator can replay; None for
    models outside the registry (object models, suite-specific types) —
    those verdicts carry an honest absent certificate."""
    entry = _MODEL_CLASSES.get(type(model).__name__)
    if entry is None:
        return None
    name, init_fn = entry
    try:
        init = _jv(init_fn(model))
    except Exception:  # noqa: BLE001 — unexpected model shape
        return None
    if not _jsonable(init):
        return None
    return {"name": name, "init": init}


def _state_json(model_name: str, model_obj):
    """A model *object* (enc.states entry) projected to the JSON state
    the validator's step functions operate on."""
    for cls, (name, init_fn) in _MODEL_CLASSES.items():
        if name == model_name and type(model_obj).__name__ == cls:
            return _jv(init_fn(model_obj))
    raise CertificateError(f"can't project state of "
                           f"{type(model_obj).__name__}")


# ---------------------------------------------------------------------------
# History digest + effective-op pairing (validator side)
# ---------------------------------------------------------------------------

def history_digest(hist) -> dict:
    """A structural fingerprint of the history: op count plus a crc
    over (index, type, process, f) per op. Values are deliberately NOT
    digested — every value a certificate relies on is re-read from the
    live history during replay, so value tampering fails the replay
    itself; the digest catches reordered / swapped / truncated
    histories where a replay might accidentally still pass."""
    crc = 0
    n = 0
    buf: list[str] = []
    for o in hist:
        buf.append(f"{o.index}|{o.type}|{o.process}|{o.f}")
        n += 1
        if len(buf) >= 8192:
            crc = zlib.crc32("\n".join(buf).encode(), crc)
            buf = []
    if buf:
        crc = zlib.crc32("\n".join(buf).encode(), crc)
    return {"ops": n, "crc": crc}


def effective_ops(hist, key=None) -> dict[int, dict]:
    """invocation-index -> effective-op entry, re-paired from the raw
    history in one pass (the validator's own pairing — nothing shared
    with encode): {"inv_pos", "ret_pos", "crashed", "f", "value"}.
    :fail invocations never appear (they never took effect). With
    `key`, only ops whose value is the independent checker's (key, v)
    tuple for that key count, and values are unwrapped."""
    if not isinstance(hist, History):
        hist = History(hist)
    out: dict[int, dict] = {}
    open_inv: dict[Any, tuple[int, Any]] = {}

    def unwrap(v):
        if key is None:
            return v
        if (isinstance(v, (list, tuple)) and len(v) == 2
                and _jv(v[0]) == key):
            return v[1]
        return _NOT_THIS_KEY

    for pos, o in enumerate(hist):
        if not h.is_client_op(o):
            continue
        if o.type == h.INVOKE:
            v = unwrap(o.value)
            if v is _NOT_THIS_KEY:
                open_inv.pop(o.process, None)
                continue
            open_inv[o.process] = (pos, o, v)
        elif o.type in (h.OK, h.FAIL, h.INFO):
            got = open_inv.pop(o.process, None)
            if got is None:
                continue
            inv_pos, inv, inv_v = got
            if o.type == h.FAIL:
                continue
            crashed = o.type != h.OK
            value = inv_v
            if not crashed and o.value is not None:
                cv = unwrap(o.value)
                if cv is not _NOT_THIS_KEY and cv is not None:
                    value = cv
            out[inv.index] = {
                "inv_pos": inv_pos,
                "ret_pos": BIG if crashed else pos,
                "crashed": crashed,
                "f": inv.f,
                "value": value,
            }
    for inv_pos, inv, inv_v in open_inv.values():
        out[inv.index] = {"inv_pos": inv_pos, "ret_pos": BIG,
                          "crashed": True, "f": inv.f, "value": inv_v}
    return out


_NOT_THIS_KEY = object()


def _check_digest(hist, cert, digest: dict | None = None) -> None:
    d = cert.get("history")
    if not isinstance(d, dict):
        raise CertificateError("certificate carries no history digest")
    got = digest if digest is not None else history_digest(hist)
    if got != d:
        raise CertificateError(
            f"stale certificate: history digest {got} != certified "
            f"{d} (the history changed since this proof was made)")


# ---------------------------------------------------------------------------
# wgl validation: replay a linearization order
# ---------------------------------------------------------------------------

def _replay_order(order, entries: dict, model_spec: dict,
                  what: str) -> tuple[Any, set]:
    """Replays one composed linearization order: every step must
    respect real-time precedence (an op that completed before another
    invoked must come first — checked with a running max over placed
    invocation positions) and the model's sequential semantics.
    Returns (final state, set of placed op indices)."""
    name = model_spec.get("name")
    if name not in _MODELS:
        raise CertificateError(f"unknown model {name!r}")
    step, _canon = _MODELS[name]
    state = _jv(model_spec.get("init"))
    seen: set[int] = set()
    max_inv = -1
    for j, item in enumerate(order):
        if (not isinstance(item, (list, tuple)) or len(item) != 2
                or item[1] not in ("apply", "discard")):
            raise CertificateError(f"{what}[{j}]: malformed step "
                                   f"{item!r}")
        idx, action = item
        e = entries.get(idx)
        if e is None:
            raise CertificateError(
                f"{what}[{j}]: op {idx} is not an effective client "
                "op of this history")
        if idx in seen:
            raise CertificateError(f"{what}[{j}]: op {idx} linearized "
                                   "twice")
        seen.add(idx)
        if e["ret_pos"] < max_inv:
            raise CertificateError(
                f"{what}[{j}]: op {idx} completed before an "
                "earlier-linearized op invoked (real-time order "
                "violated)")
        max_inv = max(max_inv, e["inv_pos"])
        if action == "discard":
            if not e["crashed"]:
                raise CertificateError(
                    f"{what}[{j}]: op {idx} completed ok but the "
                    "order discards it")
            continue
        state = step(state, e["f"], _jv(e["value"]))
        if state is _INCONSISTENT:
            raise CertificateError(
                f"{what}[{j}]: op {idx} ({e['f']} {e['value']!r}) is "
                "inconsistent at this point in the claimed order")
    return state, seen


def _wgl_order(cert) -> list:
    out = []
    for seg in cert.get("segments") or []:
        if not isinstance(seg, dict) or not isinstance(
                seg.get("order"), list):
            raise CertificateError("malformed segment in certificate")
        out.extend(seg["order"])
    return out


def _validate_wgl(hist, cert) -> None:
    entries = effective_ops(hist, cert.get("key"))
    model_spec = cert.get("model") or {}
    verdict = cert.get("verdict")
    if verdict == "valid":
        order = _wgl_order(cert)
        _state, seen = _replay_order(order, entries, model_spec,
                                     "order")
        missing = [i for i, e in entries.items()
                   if not e["crashed"] and i not in seen]
        if missing:
            raise CertificateError(
                f"linearization omits completed op(s) "
                f"{sorted(missing)[:8]} — not a whole-history proof")
        return
    if verdict == "invalid":
        w = cert.get("witness")
        if not isinstance(w, dict):
            raise CertificateError("invalid verdict without a witness")
        prefix = _wgl_order(cert) + list(w.get("prefix") or [])
        state, seen = _replay_order(prefix, entries, model_spec,
                                    "witness prefix")
        name = model_spec.get("name")
        step, canon = _MODELS[name]
        if "state" in w and canon(state) != canon(_jv(w["state"])):
            raise CertificateError(
                f"witness prefix replays to {state!r}, certificate "
                f"claims {w['state']!r}")
        stuck = w.get("op-index")
        e = entries.get(stuck)
        if e is None:
            raise CertificateError(f"stuck op {stuck!r} is not an "
                                   "effective client op")
        if stuck in seen:
            raise CertificateError(f"stuck op {stuck} is already in "
                                   "the witness prefix")
        if e["crashed"]:
            raise CertificateError(
                f"stuck op {stuck} crashed — a crashed op can always "
                "be discarded and is no blocking evidence")
        if step(state, e["f"], _jv(e["value"])) is not _INCONSISTENT:
            raise CertificateError(
                f"claimed stuck op {stuck} ({e['f']} {e['value']!r}) "
                "actually applies at the witness state — the witness "
                "proves nothing")
        for p in w.get("pending") or []:
            if p not in entries:
                raise CertificateError(f"pending op {p!r} is not an "
                                       "effective client op")
        return
    raise CertificateError(f"unknown wgl verdict {verdict!r}")


# ---------------------------------------------------------------------------
# elle validation
# ---------------------------------------------------------------------------

def _collect_txns(hist) -> dict[int, dict]:
    """invocation-index -> txn entry, paired in one pass:
    {"inv_pos", "ret_pos", "type", "process", "mops"} — :ok txns carry
    the completion's mops (read results), everything else the
    invocation's."""
    if not isinstance(hist, History):
        hist = History(hist)
    out: dict[int, dict] = {}
    open_inv: dict[Any, tuple[int, Any]] = {}
    for pos, o in enumerate(hist):
        if not h.is_client_op(o):
            continue
        if o.type == h.INVOKE:
            open_inv[o.process] = (pos, o)
        elif o.type in (h.OK, h.FAIL, h.INFO):
            got = open_inv.pop(o.process, None)
            if got is None:
                continue
            inv_pos, inv = got
            mops = o.value if (o.type == h.OK and o.value is not None
                               ) else inv.value
            out[inv.index] = {"inv_pos": inv_pos, "ret_pos": pos,
                              "type": o.type, "process": inv.process,
                              "mops": _jv(mops or [])}
    for inv_pos, inv in open_inv.values():
        out[inv.index] = {"inv_pos": inv_pos, "ret_pos": BIG,
                          "type": h.INFO, "process": inv.process,
                          "mops": _jv(inv.value or [])}
    return out


def _writes(t: dict, family: str) -> list[tuple]:
    wf = "append" if family == "list-append" else "w"
    return [(m[1], m[2]) for m in t["mops"]
            if isinstance(m, list) and len(m) >= 3 and m[0] == wf]


def _reads(t: dict) -> list[tuple]:
    return [(m[1], m[2]) for m in t["mops"]
            if isinstance(m, list) and len(m) >= 3 and m[0] == "r"
            and m[2] is not None]


def _fkey(k, v):
    return (json.dumps(k, sort_keys=True, default=repr),
            json.dumps(v, sort_keys=True, default=repr))


def _writer_map(txns: dict, family: str) -> dict:
    """(key, value) -> [writer inv indices] over non-:fail txns."""
    out: dict = {}
    for i, t in txns.items():
        if t["type"] == h.FAIL:
            continue
        for k, v in _writes(t, family):
            out.setdefault(_fkey(k, v), []).append(i)
    return out


def _observed(t: dict, k, v, family: str) -> bool:
    """Did committed txn t read value v on key k?"""
    for rk, rv in _reads(t):
        if rk != k:
            continue
        if family == "list-append":
            if isinstance(rv, list) and v in rv:
                return True
        elif rv == v:
            return True
    return False


def _adjacent_in_read(t: dict, k, u, v) -> bool:
    for rk, rv in _reads(t):
        if rk != k or not isinstance(rv, list):
            continue
        for a, b in zip(rv, rv[1:]):
            if a == u and b == v:
                return True
    return False


def _read_then_wrote(t: dict, k, u, v) -> bool:
    """Register succession proof: t read u on k, then wrote v on k."""
    saw = False
    for m in t["mops"]:
        if not isinstance(m, list) or len(m) < 3 or m[1] != k:
            continue
        if m[0] == "r" and m[2] == u:
            saw = True
        elif m[0] == "w" and m[2] == v and saw:
            return True
    return False


def _justify_edge(edge: dict, txns: dict, family: str,
                  where: str) -> None:
    ty = edge.get("type")
    a = txns.get(edge.get("from"))
    b = txns.get(edge.get("to"))
    if a is None or b is None:
        raise CertificateError(f"{where}: edge references unknown "
                               f"txn(s) {edge.get('from')!r} -> "
                               f"{edge.get('to')!r}")
    k, v, u = edge.get("key"), edge.get("value"), edge.get("prev-value")
    if ty == "realtime":
        if not (a["ret_pos"] < b["inv_pos"]):
            raise CertificateError(
                f"{where}: realtime edge forged — txn "
                f"{edge['from']} did not complete before "
                f"{edge['to']} invoked")
        return
    if ty == "process":
        if not (a["process"] == b["process"]
                and a["inv_pos"] < b["inv_pos"]):
            raise CertificateError(f"{where}: process edge forged")
        return
    if ty == "wr":
        if not any(wk == k and wv == v for wk, wv in
                   _writes(a, family)):
            raise CertificateError(
                f"{where}: wr edge forged — txn {edge['from']} never "
                f"wrote {v!r} to {k!r}")
        if b["type"] != h.OK or not _observed(b, k, v, family):
            raise CertificateError(
                f"{where}: wr edge forged — txn {edge['to']} never "
                f"observed {v!r} on {k!r}")
        return
    if ty == "ww":
        if not any(wk == k and wv == u for wk, wv in
                   _writes(a, family)):
            raise CertificateError(f"{where}: ww edge forged — "
                                   f"{edge['from']} never wrote "
                                   f"{u!r} to {k!r}")
        if not any(wk == k and wv == v for wk, wv in
                   _writes(b, family)):
            raise CertificateError(f"{where}: ww edge forged — "
                                   f"{edge['to']} never wrote "
                                   f"{v!r} to {k!r}")
        if family == "list-append":
            via = txns.get(edge.get("via-read"))
            if via is None or via["type"] != h.OK or \
                    not _adjacent_in_read(via, k, u, v):
                raise CertificateError(
                    f"{where}: ww edge unjustified — no committed "
                    f"read observes {u!r} immediately before {v!r} "
                    f"on {k!r}")
        elif not _read_then_wrote(b, k, u, v):
            raise CertificateError(
                f"{where}: ww edge unjustified — {edge['to']} did "
                f"not read {u!r} then write {v!r} on {k!r}")
        return
    if ty == "rw":
        if b["type"] == h.FAIL or not any(
                wk == k and wv == v for wk, wv in _writes(b, family)):
            raise CertificateError(f"{where}: rw edge forged — "
                                   f"{edge['to']} never wrote "
                                   f"{v!r} to {k!r}")
        if a["type"] != h.OK:
            raise CertificateError(f"{where}: rw edge forged — reader "
                                   f"{edge['from']} did not commit")
        if family == "list-append":
            if u is None:
                # empty-read anti-dependency: the reader observed []
                if not any(rk == k and rv == [] for rk, rv in
                           _reads(a)):
                    raise CertificateError(
                        f"{where}: rw empty-read edge forged — "
                        f"{edge['from']} never read [] on {k!r}")
                return
            if not any(rk == k and isinstance(rv, list) and rv
                       and rv[-1] == u for rk, rv in _reads(a)):
                raise CertificateError(
                    f"{where}: rw edge forged — {edge['from']} never "
                    f"read {u!r} as the last element of {k!r}")
            via = txns.get(edge.get("via-read"))
            if via is None or via["type"] != h.OK or \
                    not _adjacent_in_read(via, k, u, v):
                raise CertificateError(
                    f"{where}: rw edge unjustified — no committed "
                    f"read proves {v!r} directly follows {u!r} on "
                    f"{k!r}")
        else:
            if not any(rk == k and rv == u for rk, rv in _reads(a)):
                raise CertificateError(
                    f"{where}: rw edge forged — {edge['from']} never "
                    f"read {u!r} on {k!r}")
            if not _read_then_wrote(b, k, u, v):
                raise CertificateError(
                    f"{where}: rw edge unjustified — {edge['to']} "
                    f"did not read {u!r} then write {v!r} on {k!r}")
        return
    raise CertificateError(f"{where}: unknown edge type {ty!r}")


def _validate_elle(hist, cert) -> None:
    family = cert.get("family")
    if family not in ("list-append", "rw-register"):
        raise CertificateError(f"unknown elle family {family!r}")
    txns = _collect_txns(hist)
    verdict = cert.get("verdict")
    if verdict == "invalid":
        cycle = cert.get("cycle")
        if cycle:
            if len(cycle) < 2:
                raise CertificateError("cycle shorter than two edges")
            for j, edge in enumerate(cycle):
                nxt = cycle[(j + 1) % len(cycle)]
                if edge.get("to") != nxt.get("from"):
                    raise CertificateError(
                        f"cycle edge {j} does not chain: {edge!r} -> "
                        f"{nxt!r}")
                _justify_edge(edge, txns, family, f"cycle edge {j}")
            return
        anom = cert.get("anomaly")
        if isinstance(anom, dict):
            _validate_elle_anomaly(anom, txns, family)
            return
        raise CertificateError("invalid verdict with neither cycle "
                               "nor anomaly evidence")
    if verdict == "valid":
        order = cert.get("topo-order")
        if not isinstance(order, list):
            raise CertificateError("valid verdict without a "
                                   "topo-order")
        committed = {i for i, t in txns.items() if t["type"] == h.OK}
        if set(order) != committed or len(order) != len(committed):
            raise CertificateError(
                "topo-order is not a permutation of the committed "
                f"txns ({len(order)} vs {len(committed)})")
        pos = {i: j for j, i in enumerate(order)}
        # realtime: running max over invocation positions
        max_inv = -1
        last_by_proc: dict = {}
        for i in order:
            t = txns[i]
            if t["ret_pos"] < max_inv:
                raise CertificateError(
                    f"topo-order violates realtime order at txn {i}")
            max_inv = max(max_inv, t["inv_pos"])
            prev = last_by_proc.get(t["process"])
            if prev is not None and t["inv_pos"] < prev:
                raise CertificateError(
                    f"topo-order violates session order at txn {i}")
            last_by_proc[t["process"]] = t["inv_pos"]
        # read-from precedence: a committed read of v must follow v's
        # committed writer (writers re-derived in one pass)
        writers = _writer_map(txns, family)
        for i in order:
            for k, rv in _reads(txns[i]):
                vals = (rv if family == "list-append"
                        and isinstance(rv, list) else [rv])
                for v in vals:
                    ws = writers.get(_fkey(k, v), [])
                    ws = [w for w in ws if w in pos and w != i]
                    if len(ws) == 1 and pos[ws[0]] > pos[i]:
                        raise CertificateError(
                            f"topo-order violates read-from: txn {i} "
                            f"reads {v!r} on {k!r} before its writer "
                            f"{ws[0]}")
        return
    raise CertificateError(f"unknown elle verdict {verdict!r}")


def _validate_elle_anomaly(anom: dict, txns: dict, family: str
                           ) -> None:
    cls = anom.get("class")
    k, v = anom.get("key"), anom.get("value")
    if cls == "G1a":
        w = txns.get(anom.get("writer"))
        r = txns.get(anom.get("reader"))
        if w is None or w["type"] != h.FAIL or not any(
                wk == k and wv == v for wk, wv in _writes(w, family)):
            raise CertificateError(
                f"G1a forged — txn {anom.get('writer')!r} is not an "
                f"aborted writer of {v!r} on {k!r}")
        if r is None or r["type"] != h.OK or not _observed(
                r, k, v, family):
            raise CertificateError(
                f"G1a forged — txn {anom.get('reader')!r} never "
                f"observed {v!r} on {k!r}")
        return
    if cls == "duplicate":
        ws = anom.get("writers") or []
        if len(set(ws)) < 2:
            raise CertificateError("duplicate anomaly needs two "
                                   "distinct writers")
        for wi in ws:
            w = txns.get(wi)
            if w is None or w["type"] == h.FAIL or not any(
                    wk == k and wv == v
                    for wk, wv in _writes(w, family)):
                raise CertificateError(
                    f"duplicate forged — txn {wi!r} is not a "
                    f"surviving writer of {v!r} on {k!r}")
        return
    raise CertificateError(f"unjustifiable anomaly class {cls!r}")


# ---------------------------------------------------------------------------
# Public validation API
# ---------------------------------------------------------------------------

def validate_schema(cert) -> None:
    """Structural check (no history needed): run by tier-1 on every
    stored certificate alongside the other artifact validators."""
    if not isinstance(cert, dict):
        raise CertificateError("certificate must be a dict")
    if cert.get("v") != VERSION:
        raise CertificateError(f"unknown certificate version "
                               f"{cert.get('v')!r}")
    if "absent" in cert:
        if not isinstance(cert["absent"], str) or not cert["absent"]:
            raise CertificateError("absent marker must carry a reason")
        return
    kind = cert.get("kind")
    if kind not in ("wgl", "elle"):
        raise CertificateError(f"unknown certificate kind {kind!r}")
    if cert.get("verdict") not in ("valid", "invalid"):
        raise CertificateError(f"bad verdict {cert.get('verdict')!r}")
    if not isinstance(cert.get("history"), dict):
        raise CertificateError("missing history digest")
    if not _jsonable(cert):
        raise CertificateError("certificate is not JSON-serializable")
    if kind == "wgl":
        if not isinstance(cert.get("model"), dict):
            raise CertificateError("wgl certificate without a model")
        if cert["verdict"] == "valid" and not isinstance(
                cert.get("segments"), list):
            raise CertificateError("valid wgl certificate without "
                                   "segments")
        if cert["verdict"] == "invalid" and not isinstance(
                cert.get("witness"), dict):
            raise CertificateError("invalid wgl certificate without "
                                   "a witness")
    else:
        if cert.get("family") not in ("list-append", "rw-register"):
            raise CertificateError("elle certificate without a family")
        if cert["verdict"] == "valid" and not isinstance(
                cert.get("topo-order"), list):
            raise CertificateError("valid elle certificate without a "
                                   "topo-order")


def validate(hist, cert, digest: dict | None = None) -> None:
    """Replays one certificate against the raw history; raises
    CertificateError unless the certificate proves its verdict. Absent
    certificates raise too — callers decide whether absence is
    acceptable (stamp_results counts them separately). `digest`: a
    precomputed history_digest(hist), so callers validating many
    certificates against one history (per-key independent results)
    pay the O(n) digest pass once, not per certificate."""
    validate_schema(cert)
    if "absent" in cert:
        raise CertificateError(f"no proof: {cert['absent']}")
    _check_digest(hist, cert, digest)
    if cert["kind"] == "wgl":
        _validate_wgl(hist, cert)
    else:
        _validate_elle(hist, cert)


def iter_certificates(results, path: str = "", depth: int = 0
                      ) -> Iterable[tuple[str, dict]]:
    """Yields (path, result dict) for every result in the tree that
    carries a certificate — including the independent checker's
    per-key sub-results."""
    if not isinstance(results, dict) or depth > 6:
        return
    if isinstance(results.get("certificate"), dict):
        yield path or "result", results
    for k, v in sorted(results.items(), key=lambda kv: str(kv[0])):
        if isinstance(v, dict) and k not in ("certificate",
                                             "anomalies"):
            sub = f"{path}/{k}" if path else str(k)
            yield from iter_certificates(v, sub, depth + 1)


def stamp_results(results, hist) -> dict:
    """Validates every certificate in a results tree against the
    history, stamping each carrying result with `certified: True` or
    `certificate-error: reason`. Returns {"certified", "errors",
    "absent"} counts. Live in core.analyze; offline via `analyze
    --resume`; loud in telemetry (certify.* counters) either way."""
    out = {"certified": 0, "errors": 0, "absent": 0}
    digest = None
    for path, res in iter_certificates(results):
        cert = res["certificate"]
        if "absent" in cert:
            out["absent"] += 1
            telemetry.count("certify.absent")
            continue
        if digest is None:
            digest = history_digest(hist)
        try:
            validate(hist, cert, digest=digest)
        except CertificateError as e:
            res["certificate-error"] = str(e)[:300]
            out["errors"] += 1
            telemetry.count("certify.errors")
            logger.error("certificate at %s failed validation: %s",
                         path, e)
        except Exception as e:  # noqa: BLE001 — validator bug: loud,
            # but it must never sink the analysis that carries it
            res["certificate-error"] = f"validator crashed: {e!r}"[:300]
            out["errors"] += 1
            telemetry.count("certify.errors")
            logger.exception("certificate validator crashed at %s",
                             path)
        else:
            res["certified"] = True
            out["certified"] += 1
            telemetry.count("certify.validated")
    return out


# ---------------------------------------------------------------------------
# wgl extraction: order search over an Encoded history
# ---------------------------------------------------------------------------

def _trailing_ones(x: int) -> int:
    t = 0
    while x & 1:
        x >>= 1
        t += 1
    return t


class _Budget(Exception):
    """Order-search node budget exhausted."""


def _order_search(enc, targets=None, witness: bool = False,
                  budget: int = SEARCH_BUDGET):
    """DFS over WGL configurations recording the linearization path —
    the prover-side search that turns the kernel's yes/no (plus
    reach-mask choice data) back into checkable steps. Returns
    (True, actions) on success (`actions` = [(entry, 'apply'|'discard')]
    reaching the end, in a target state when `targets` given), or
    (False, best) where best = (actions, p, wmask, state) is the
    deepest configuration reached (the witness stub). Raises _Budget
    past the node budget."""
    m = enc.m
    if m == 0:
        return True, []
    inv_t, ret_t, crashed, trans = (enc.inv_t, enc.ret_t, enc.crashed,
                                    enc.trans)
    sufmin = enc.suffix_min_ret()

    def min_ret(p: int, wmask: int) -> int:
        span = wmask.bit_length()
        mr = int(sufmin[min(p + span, m)])
        for i in range(span):
            if not (wmask >> i) & 1 and p + i < m:
                r = int(ret_t[p + i])
                if r < mr:
                    mr = r
        return mr

    def moves(p: int, wmask: int, st: int):
        mr = min_ret(p, wmask)
        i = 0
        while p + i < m and int(inv_t[p + i]) < mr:
            if not (wmask >> i) & 1:
                e = p + i
                nmask = wmask | (1 << i)
                t = _trailing_ones(nmask)
                np_, nm = p + t, nmask >> t
                s2 = int(trans[e, st])
                if s2 >= 0:
                    yield e, "apply", np_, nm, s2
                if crashed[e]:
                    yield e, "discard", np_, nm, st
            i += 1

    start = (0, 0, enc.init_state)
    seen = {start}
    frames = [(start, moves(*start))]
    path: list[tuple[int, str]] = []
    best = ([], 0, 0, enc.init_state)
    visited = 1
    while frames:
        (p, wmask, st), it = frames[-1]
        advanced = False
        for e, action, np_, nm, s2 in it:
            cfg = (np_, nm, s2)
            if cfg in seen:
                continue
            seen.add(cfg)
            visited += 1
            if visited > budget:
                raise _Budget()
            path.append((e, action))
            if np_ >= m:
                if targets is None or s2 in targets:
                    return True, list(path)
                path.pop()
                continue
            if witness and np_ > best[1]:
                best = (list(path), np_, nm, s2)
            frames.append((cfg, moves(*cfg)))
            advanced = True
            break
        if not advanced:
            frames.pop()
            if path:
                path.pop()
    return False, best


def _entry_order_json(enc, actions) -> list:
    return [[int(enc.entry_ops[e].index), a] for e, a in actions]


def _witness_from_best(enc, best, model_name: str) -> dict:
    """A stuck-configuration witness from the deepest config the
    search reached: the prefix, the state, and a non-crashed candidate
    whose transition is inconsistent there."""
    actions, p, wmask, st = best
    inv_t, ret_t, crashed, trans = (enc.inv_t, enc.ret_t, enc.crashed,
                                    enc.trans)
    sufmin = enc.suffix_min_ret()
    m = enc.m
    span = wmask.bit_length()
    mr = int(sufmin[min(p + span, m)])
    for i in range(span):
        if not (wmask >> i) & 1 and p + i < m:
            mr = min(mr, int(ret_t[p + i]))
    stuck = None
    pending = []
    i = 0
    while p + i < m and int(inv_t[p + i]) < mr:
        if not (wmask >> i) & 1:
            e = p + i
            pending.append(int(enc.entry_ops[e].index))
            if (stuck is None and not crashed[e]
                    and int(trans[e, st]) < 0):
                stuck = e
        i += 1
    if stuck is None:
        raise CertificateError("no blocked non-crashed candidate at "
                               "the witness configuration")
    return {
        "op-index": int(enc.entry_ops[stuck].index),
        "state": _state_json(model_name, enc.states[st]),
        "prefix": _entry_order_json(enc, actions),
        "pending": pending[:8],
    }


def wgl_certificate(model, hist, enc, result) -> dict:
    """Builds the certificate for one wgl analysis result. Valid
    verdicts get a per-segment linearization order guided by the
    result's reach/choice chain (`search-chain`, recorded by
    check_segmented) when present; invalid verdicts a replayable
    blocked-frontier witness. Failure to extract returns an honest
    absent marker, never raises."""
    try:
        return _wgl_certificate(model, hist, enc, result)
    except _Budget:
        return absent("search-budget-exceeded")
    except CertificateError as e:
        return absent(str(e))
    except Exception as e:  # noqa: BLE001 — extraction is best-effort
        logger.exception("wgl certificate extraction failed")
        return absent(f"extraction-failed: {e!r}")


def _wgl_certificate(model, hist, enc, result) -> dict:
    verdict = result.get("valid?")
    if verdict not in (True, False):
        return absent("verdict is indeterminate")
    spec = describe_model(model)
    if spec is None:
        return absent(f"model {type(model).__name__} is outside the "
                      "validator's replay registry")
    if enc is None:
        return absent("history was not encodable (object-model "
                      "search)")
    cert: dict = {"v": VERSION, "kind": "wgl",
                  "verdict": "valid" if verdict else "invalid",
                  "model": spec, "history": history_digest(hist),
                  "segments": []}
    chain_info = result.get("search-chain")
    model_name = spec["name"]
    if verdict:
        if chain_info:
            cuts = chain_info["cuts"]
            chain = chain_info["chain"]
            for j in range(len(cuts) - 1):
                seg = enc.segment(cuts[j], cuts[j + 1],
                                  init_state=chain[j])
                ok, actions = _order_search(seg,
                                            targets={chain[j + 1]})
                if not ok:
                    raise CertificateError(
                        f"no linearization of segment {j} from state "
                        f"{chain[j]} to {chain[j + 1]} — the reach "
                        "chain lies")
                cert["segments"].append({
                    "range": [int(cuts[j]), int(cuts[j + 1])],
                    "order": _entry_order_json(seg, actions)})
        else:
            ok, actions = _order_search(enc)
            if not ok:
                raise CertificateError(
                    "no whole-history linearization found for a "
                    "valid verdict")
            cert["segments"].append({"range": [0, int(enc.m)],
                                     "order": _entry_order_json(
                                         enc, actions)})
        return cert
    # invalid: a replayable prefix (certified segments up to the
    # failing one) + the stuck-configuration witness inside it
    if chain_info and "failed-segment" in result:
        cuts = chain_info["cuts"]
        chain = chain_info["chain"]
        k = int(result["failed-segment"])
        for j in range(k):
            seg = enc.segment(cuts[j], cuts[j + 1],
                              init_state=chain[j])
            ok, actions = _order_search(seg, targets={chain[j + 1]})
            if not ok:
                raise CertificateError(
                    f"no linearization of pre-witness segment {j}")
            cert["segments"].append({
                "range": [int(cuts[j]), int(cuts[j + 1])],
                "order": _entry_order_json(seg, actions)})
        wseg = enc.segment(cuts[k], cuts[k + 1], init_state=chain[k])
        found, best = _order_search(wseg, witness=True)
        if found:
            raise CertificateError(
                "witness segment linearizes — the invalid verdict's "
                "choice data is wrong")
        cert["witness"] = _witness_from_best(wseg, best, model_name)
    else:
        found, best = _order_search(enc, witness=True)
        if found:
            raise CertificateError("history linearizes — invalid "
                                   "verdict is wrong")
        cert["witness"] = _witness_from_best(enc, best, model_name)
    return cert


def attach_wgl(model, hist, enc, result) -> dict:
    """Attaches a certificate to a wgl analysis result (checker entry
    points call this; raw kernel paths don't)."""
    if not isinstance(result, dict):
        return result
    # spanned so certification is priced apart from device compute
    with telemetry.span("certify.attach"):
        cert = wgl_certificate(model, hist, enc, result)
    result["certificate"] = cert
    telemetry.count("certify.absent" if "absent" in cert
                    else "certify.extracted")
    return result


# ---------------------------------------------------------------------------
# elle extraction
# ---------------------------------------------------------------------------

def _resolve_op_index(hist: History, o) -> int | None:
    idx = getattr(o, "index", None)
    if idx is None and isinstance(o, dict):
        idx = o.get("index")
    if not isinstance(idx, int) or idx < 0:
        return None
    ty = getattr(o, "type", None) or (o.get("type")
                                      if isinstance(o, dict) else None)
    if ty is not None and ty != h.INVOKE:
        try:
            inv = hist.invocation(o)
            if inv is not None:
                idx = inv.index
        except (KeyError, TypeError, AttributeError):
            pass
    return idx


def _adjacency_index(txns: dict, family: str) -> dict:
    """(key, u, v) -> committed read txn observing u immediately
    before v — the via-read justification for list-append ww/rw
    edges. One pass over read volume."""
    out: dict = {}
    if family != "list-append":
        return out
    for i, t in txns.items():
        if t["type"] != h.OK:
            continue
        for k, rv in _reads(t):
            if not isinstance(rv, list):
                continue
            for a, b in zip(rv, rv[1:]):
                out.setdefault(_fkey(k, (a, b)), i)
    return out


def _justification(a_i, b_i, ty, txns, family, adj) -> dict | None:
    """Edge fields proving dependency a -> b, derived from the raw
    mops; None when no justification exists (extraction then goes
    absent rather than emitting an unprovable edge)."""
    edge = {"from": a_i, "to": b_i, "type": ty}
    a, b = txns[a_i], txns[b_i]
    if ty in ("realtime", "process"):
        return edge
    if ty == "wr":
        for k, v in _writes(a, family):
            if _observed(b, k, v, family):
                edge.update(key=k, value=v)
                return edge
        return None
    if ty == "ww":
        for k, u in _writes(a, family):
            for k2, v in _writes(b, family):
                if k2 != k:
                    continue
                if family == "list-append":
                    via = adj.get(_fkey(k, (u, v)))
                    if via is not None:
                        edge.update(key=k, value=v, **{
                            "prev-value": u, "via-read": via})
                        return edge
                elif _read_then_wrote(b, k, u, v):
                    edge.update(key=k, value=v, **{"prev-value": u})
                    return edge
        return None
    if ty == "rw":
        if family == "list-append":
            for k, rv in _reads(a):
                if not isinstance(rv, list):
                    continue
                if not rv:
                    for k2, v in _writes(b, family):
                        if k2 == k:
                            edge.update(key=k, value=v,
                                        **{"prev-value": None})
                            return edge
                    continue
                u = rv[-1]
                for k2, v in _writes(b, family):
                    if k2 != k:
                        continue
                    via = adj.get(_fkey(k, (u, v)))
                    if via is not None:
                        edge.update(key=k, value=v, **{
                            "prev-value": u, "via-read": via})
                        return edge
            return None
        for k, u in _reads(a):
            for k2, v in _writes(b, family):
                if k2 == k and _read_then_wrote(b, k, u, v):
                    edge.update(key=k, value=v, **{"prev-value": u})
                    return edge
        return None
    return None


def _first_cycle(result: dict):
    for name in sorted(result.get("anomalies") or {}):
        for rec in result["anomalies"][name] or []:
            if isinstance(rec, dict) and rec.get("steps") \
                    and rec.get("cycle"):
                return rec
    return None


def _realtime_order_ok(order: list[int], txns: dict) -> bool:
    max_inv = -1
    for i in order:
        if txns[i]["ret_pos"] < max_inv:
            return False
        max_inv = max(max_inv, txns[i]["inv_pos"])
    return True


def _topo_order(txns: dict, family: str) -> list[int] | None:
    """A committed-txn order consistent with session, realtime, and
    read-from constraints — derived directly from the raw history (the
    independently-checkable edge subset), so it never depends on the
    engine's ww/rw version-order inference. Completion order satisfies
    session + realtime by construction; read-from violations are
    repaired by a Kahn pass over the wr edges when needed."""
    committed = sorted((i for i, t in txns.items()
                        if t["type"] == h.OK),
                       key=lambda i: txns[i]["ret_pos"])
    pos = {i: j for j, i in enumerate(committed)}
    writers = _writer_map(txns, family)
    wr_edges: list[tuple[int, int]] = []
    bad = False
    for i in committed:
        for k, rv in _reads(txns[i]):
            vals = (rv if family == "list-append"
                    and isinstance(rv, list) else [rv])
            for v in vals:
                ws = [w for w in writers.get(_fkey(k, v), [])
                      if w in pos and w != i]
                if len(ws) == 1:
                    wr_edges.append((ws[0], i))
                    if pos[ws[0]] > pos[i]:
                        bad = True
    if not bad:
        return committed
    # Kahn over wr + session + realtime-as-tiebreak: realtime and
    # session constraints are kept by ordering the ready set by
    # completion position; a genuine conflict (cycle) yields None.
    import heapq

    adj: dict[int, list[int]] = {}
    indeg = {i: 0 for i in committed}
    last_by_proc: dict = {}
    for i in sorted(committed, key=lambda x: txns[x]["inv_pos"]):
        p = txns[i]["process"]
        prev = last_by_proc.get(p)
        if prev is not None:
            adj.setdefault(prev, []).append(i)
            indeg[i] += 1
        last_by_proc[p] = i
    for a, b in wr_edges:
        adj.setdefault(a, []).append(b)
        indeg[b] += 1
    ready = [(txns[i]["ret_pos"], i) for i in committed
             if indeg[i] == 0]
    heapq.heapify(ready)
    out: list[int] = []
    while ready:
        _r, i = heapq.heappop(ready)
        out.append(i)
        for j in adj.get(i, []):
            indeg[j] -= 1
            if indeg[j] == 0:
                heapq.heappush(ready, (txns[j]["ret_pos"], j))
    if len(out) != len(committed) or not _realtime_order_ok(out, txns):
        return None
    return out


def elle_certificate(hist, result, family: str) -> dict:
    """Builds the certificate for an elle check result (either
    engine): a justified cycle (or G1a/duplicate evidence) for invalid
    verdicts, a constraint-checked serialization order for valid ones.
    Never raises — unprovable results go absent."""
    try:
        return _elle_certificate(hist, result, family)
    except CertificateError as e:
        return absent(str(e))
    except Exception as e:  # noqa: BLE001 — extraction is best-effort
        logger.exception("elle certificate extraction failed")
        return absent(f"extraction-failed: {e!r}")


def _elle_certificate(hist, result, family: str) -> dict:
    if not isinstance(hist, History):
        hist = History(hist)
    verdict = result.get("valid?")
    if verdict not in (True, False):
        return absent("verdict is indeterminate")
    cert: dict = {"v": VERSION, "kind": "elle", "family": family,
                  "verdict": "valid" if verdict else "invalid",
                  "history": history_digest(hist)}
    txns = _collect_txns(hist)
    if verdict:
        order = _topo_order(txns, family)
        if order is None:
            return absent("no session/realtime/read-from-consistent "
                          "serialization order found")
        cert["topo-order"] = order
        return cert
    cyc = _first_cycle(result)
    if cyc is not None:
        adj = _adjacency_index(txns, family)
        ops = cyc["cycle"]
        idxs = [_resolve_op_index(hist, o) for o in ops]
        if any(i is None or i not in txns for i in idxs):
            return absent("cycle ops do not resolve to txns")
        edges = []
        for j, step in enumerate(cyc["steps"]):
            a_i = idxs[j]
            b_i = idxs[(j + 1) % len(idxs)]
            edge = _justification(a_i, b_i, step.get("type"), txns,
                                  family, adj)
            if edge is None:
                return absent(
                    f"no mop justification for {step.get('type')} "
                    f"edge {a_i} -> {b_i}")
            edges.append(edge)
        cert["cycle"] = edges
        return cert
    # non-cycle anomalies: the justifiable classes
    anomalies = result.get("anomalies") or {}
    for rec in anomalies.get("G1a") or []:
        w_i = _resolve_op_index(hist, rec.get("writer"))
        r_i = _resolve_op_index(hist, rec.get("op"))
        if w_i in txns and r_i in txns:
            cert["anomaly"] = {"class": "G1a",
                               "key": _jv(rec.get("key")),
                               "value": _jv(rec.get("value")),
                               "writer": w_i, "reader": r_i}
            return cert
    dup_cls = ("duplicate-appends" if family == "list-append"
               else "duplicate-writes")
    for rec in anomalies.get(dup_cls) or []:
        k, v = _jv(rec.get("key")), _jv(rec.get("value"))
        ws = [i for i, t in txns.items() if t["type"] != h.FAIL
              and any(wk == k and wv == v
                      for wk, wv in _writes(t, family))]
        if len(ws) >= 2:
            cert["anomaly"] = {"class": "duplicate", "key": k,
                               "value": v, "writers": ws[:2]}
            return cert
    return absent("no justifiable cycle or anomaly evidence in the "
                  f"result (classes: {sorted(anomalies)})")


def attach_elle(hist, result, family: str) -> dict:
    """Attaches a certificate to an elle check result (the checker
    wrappers opt in via opts['certify']; raw bench calls don't)."""
    if not isinstance(result, dict):
        return result
    with telemetry.span("certify.attach"):
        cert = elle_certificate(hist, result, family)
    result["certificate"] = cert
    telemetry.count("certify.absent" if "absent" in cert
                    else "certify.extracted")
    return result
