"""The plain reference for the register cells: a CAS register's
semantics, its own pairing of invocations with completions, and the
replays that decide a history's verdict and judge the certificate that
the program attached to it.

Plain Python. It imports nothing of the program, of JAX or of the JAX
package, and takes nothing the program made: it reads the program's
verdicts, anomaly ops and certificates only to judge them.

Events are `(type, process, f, value)` tuples; an event's index is its
position. The model is knossos' cas-register: a write sets the value, a
cas [cur, new] sets `new` where the value is `cur`, a read of v needs
the value v, and a read of None (a crashed read, or a read of the
initial value) matches any value. A :fail op never took effect; an
:info op, or one never completed, may have taken effect at any instant
after its invocation.

How a verdict is decided: the benchmark's generator returns its witness,
the invocations in the order it applied them to the true register. A
history whose witness replays (real-time order and the model both hold,
every completed op placed) is linearizable. A history with an ok read of
a value that no op writes and that is not the initial value is not, and
that read is its anomaly. A history that is neither is undecided, which
the harness counts as a fault of its own inputs.
"""

from __future__ import annotations

import zlib

INF = 1 << 62


class Rejected(Exception):
    """A replayed order or a certificate does not hold."""


def step(state, f: str, value):
    """The next state, or raises Rejected where the op cannot take
    effect in `state`."""
    if f == "write":
        return value
    if f == "read":
        if value is None or value == state:
            return state
        raise Rejected(f"read of {value!r} in state {state!r}")
    if f == "cas":
        if not isinstance(value, (list, tuple)) or len(value) != 2:
            raise Rejected(f"malformed cas {value!r}")
        if value[0] != state:
            raise Rejected(f"cas {list(value)!r} in state {state!r}")
        return value[1]
    raise Rejected(f"unknown f {f!r}")


def split(events: list) -> dict:
    """key -> [(position, (type, process, f, value))] of an independent
    history, whose values are (key, value) pairs, values unwrapped."""
    out: dict = {}
    for pos, (t, p, f, v) in enumerate(events):
        if isinstance(v, (tuple, list)) and len(v) == 2:
            out.setdefault(v[0], []).append((pos, (t, p, f, v[1])))
    return out


def pair(items) -> dict:
    """invocation position -> [inv_pos, ret_pos, f, value, crashed] of
    every op that may have taken effect, from (position, event) items
    (`enumerate(events)`, or one key's items of `split`): :fail ops are
    left out, an :info op or one never completed gets ret_pos INF. A
    completion pairs with the open invocation of its process."""
    out: dict = {}
    open_inv: dict = {}
    for pos, (t, p, f, v) in items:
        if t == "invoke":
            open_inv[p] = (pos, f, v)
            continue
        got = open_inv.pop(p, None)
        if got is None or t == "fail":
            continue
        inv_pos, f0, v0 = got
        if t == "ok":
            out[inv_pos] = [inv_pos, pos, f0, v if v is not None else v0,
                            False]
        else:
            out[inv_pos] = [inv_pos, INF, f0, v0, True]
    for inv_pos, f0, v0 in open_inv.values():
        out[inv_pos] = [inv_pos, INF, f0, v0, True]
    return out


def replay(order, entries: dict, init=None, what: str = "order"):
    """Replays `order`, a list of (invocation position, "apply" |
    "discard"), from `init`: each op is placed once, no op is placed
    after one whose invocation follows its completion, only crashed ops
    are discarded, and every applied op takes effect. Returns (state,
    placed positions)."""
    state = init
    seen: set = set()
    max_inv = -1
    for j, item in enumerate(order):
        try:
            pos, action = item
        except (TypeError, ValueError):
            raise Rejected(f"{what}[{j}]: malformed step {item!r}")
        e = entries.get(pos) if isinstance(pos, int) else None
        if e is None:
            raise Rejected(f"{what}[{j}]: {pos!r} is no effective op")
        if pos in seen:
            raise Rejected(f"{what}[{j}]: op {pos} placed twice")
        seen.add(pos)
        if e[1] < max_inv:
            raise Rejected(f"{what}[{j}]: op {pos} completed before an "
                           "op placed earlier was invoked")
        max_inv = max(max_inv, e[0])
        if action == "discard":
            if not e[4]:
                raise Rejected(f"{what}[{j}]: completed op {pos} "
                               "discarded")
            continue
        if action != "apply":
            raise Rejected(f"{what}[{j}]: unknown action {action!r}")
        try:
            state = step(state, e[2], e[3])
        except Rejected as err:
            raise Rejected(f"{what}[{j}]: op {pos}: {err}") from None
    return state, seen


def _complete(entries: dict, seen: set, what: str) -> None:
    missing = [p for p, e in entries.items() if not e[4] and p not in seen]
    if missing:
        raise Rejected(f"{what} leaves out completed ops "
                       f"{sorted(missing)[:4]}")


def unwritable_reads(entries: dict) -> list[int]:
    """Invocation positions of completed reads whose value no op writes
    and that is not the initial value (None), in history order."""
    written = set()
    for e in entries.values():
        if e[2] == "write":
            written.add(e[3])
        elif e[2] == "cas" and isinstance(e[3], (list, tuple)) \
                and len(e[3]) == 2:
            written.add(e[3][1])
    return sorted(p for p, e in entries.items()
                  if e[2] == "read" and not e[4] and e[3] is not None
                  and e[3] not in written)


def decide(entries: dict, witness: list) -> tuple:
    """(valid, anomaly) of the paired ops `entries`: (True, None) where
    the generator's witness replays; (False, invocation position of the
    first unwritable read) where one exists; (None, None) where neither
    decides."""
    bad = unwritable_reads(entries)
    if bad:
        return False, bad[0]
    try:
        _state, seen = replay([(p, "apply") for p in witness], entries,
                              what="witness")
        _complete(entries, seen, "witness")
    except Rejected:
        return None, None
    return True, None


def history_digest(events: list) -> dict:
    """The certificate schema's history fingerprint: the op count and a
    crc32 over "index|type|process|f" lines, fed 8,192 lines at a
    time."""
    crc = 0
    buf: list = []
    for i, (t, p, f, _v) in enumerate(events):
        buf.append(f"{i}|{t}|{p}|{f}")
        if len(buf) >= 8192:
            crc = zlib.crc32("\n".join(buf).encode(), crc)
            buf = []
    if buf:
        crc = zlib.crc32("\n".join(buf).encode(), crc)
    return {"ops": len(events), "crc": crc}


def _order(cert: dict) -> list:
    out: list = []
    for seg in cert.get("segments") or []:
        if not isinstance(seg, dict) or not isinstance(seg.get("order"),
                                                       list):
            raise Rejected("malformed segment")
        out.extend(seg["order"])
    return out


def _as_value(v):
    """A certificate's JSON value as the history holds it (a cas pair
    comes back as a list)."""
    return list(v) if isinstance(v, tuple) else v


_NO_KEY = object()


def check_certificate(cert, entries: dict, valid: bool, digest: dict,
                      key=_NO_KEY) -> None:
    """Raises Rejected unless `cert` proves `valid` for the paired ops
    `entries` of a history whose `history_digest` is `digest` (for `key`
    of an independent history): a valid certificate's order places every
    completed op and replays; an invalid one's prefix replays to its
    stated state, at which its stuck op, a completed op outside the
    prefix, cannot take effect."""
    if not isinstance(cert, dict):
        raise Rejected("no certificate")
    if "absent" in cert:
        raise Rejected(f"absent: {cert['absent']}")
    if cert.get("kind") != "wgl":
        raise Rejected(f"kind {cert.get('kind')!r}")
    model = cert.get("model") or {}
    if model.get("name") != "cas-register" or model.get("init") is not None:
        raise Rejected(f"model {model!r}")
    if key is not _NO_KEY and cert.get("key") != key:
        raise Rejected(f"key {cert.get('key')!r} for key {key!r}")
    if cert.get("history") != digest:
        raise Rejected(f"digest {cert.get('history')!r} != {digest!r}")
    if valid:
        if cert.get("verdict") != "valid":
            raise Rejected(f"verdict {cert.get('verdict')!r}")
        _state, seen = replay(_order(cert), entries)
        _complete(entries, seen, "order")
        return
    if cert.get("verdict") != "invalid":
        raise Rejected(f"verdict {cert.get('verdict')!r}")
    w = cert.get("witness")
    if not isinstance(w, dict):
        raise Rejected("invalid verdict without a witness")
    state, seen = replay(_order(cert) + list(w.get("prefix") or []),
                         entries, what="prefix")
    if "state" in w and _as_value(w["state"]) != state:
        raise Rejected(f"prefix ends in {state!r}, certificate says "
                       f"{w['state']!r}")
    stuck = w.get("op-index")
    e = entries.get(stuck) if isinstance(stuck, int) else None
    if e is None or stuck in seen or e[4]:
        raise Rejected(f"stuck op {stuck!r} is no completed op outside "
                       "the prefix")
    try:
        step(state, e[2], e[3])
    except Rejected:
        return
    raise Rejected(f"stuck op {stuck} takes effect at the prefix's end")


# ---------------------------------------------------------------------------
# Judging one answer of the program
# ---------------------------------------------------------------------------

# Every comparison is exact, so every limit is 0.
LIMITS = {"verdicts_wrong": 0, "anomaly_ops_wrong": 0,
          "certificates_absent": 0, "certificates_rejected": 0}


def _op_index(op):
    """The history index of an answer's op (an op object or its dict)."""
    if isinstance(op, dict):
        return op.get("index")
    return getattr(op, "index", None)


def _judge_one(counts: dict, ans, entries: dict, witness: list,
               digest: dict, certified: bool, key=_NO_KEY) -> bool:
    """Judges one verdict (one key's, with `key`) into `counts`; returns
    the reference's verdict."""
    want, anomaly = decide(entries, witness)
    if want is None:
        raise RuntimeError("the reference cannot decide a history of the "
                           "benchmark's own making")
    if not isinstance(ans, dict) or ans.get("valid?") is not want:
        counts["verdicts_wrong"] += 1
        return want
    if want is False and _op_index(ans.get("op")) != anomaly:
        counts["anomaly_ops_wrong"] += 1
    cert = ans.get("certificate")
    if not isinstance(cert, dict) or "absent" in cert:
        counts["certificates_absent"] += certified
        return want
    try:
        check_certificate(cert, entries, want, digest, key=key)
    except Rejected:
        counts["certificates_rejected"] += 1
    return want


def judge(config: dict, history: dict, answer, counts: dict) -> None:
    """Adds to `counts` (the keys of LIMITS) what the reference finds
    wrong in the program's `answer` for `history`, the events a check
    was handed and the generator's witness (for `"entry":
    "independent"`, key -> witness):

    - verdicts_wrong: verdicts that differ from the reference's, or are
      missing (under `"entry": "independent"`, each key's, and the whole
      history's, which is valid only where every key's is);
    - anomaly_ops_wrong: invalid verdicts whose op is not the reference's
      anomaly;
    - certificates_absent: verdicts without a certificate, counted only
      where the configuration's `guarantees` state a `certificate`;
    - certificates_rejected: certificates whose replay does not prove
      the reference's verdict.
    """
    certified = "certificate" in config["guarantees"]
    events = history["events"]
    digest = history_digest(events)
    if config["entry"] != "independent":
        _judge_one(counts, answer, pair(enumerate(events)),
                   history["witness"], digest, certified)
        return
    items = split(events)
    results = answer.get("results") if isinstance(answer, dict) else None
    results = results if isinstance(results, dict) else {}
    wants = [_judge_one(counts, results.get(k), pair(items.get(k, ())), w,
                        digest, certified, key=k)
             for k, w in history["witness"].items()]
    if not isinstance(answer, dict) or answer.get("valid?") is not all(wants):
        counts["verdicts_wrong"] += 1
