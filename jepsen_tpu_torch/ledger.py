"""The bench ledger and slow-bleed detection, and the crash-safe write
primitives of the checkpoint store and coverage atlas (the port's copy
of jepsen_tpu/ledger.py).

  bench_ledger.jsonl   one JSON line per bench round: round id,
                       timestamp, the headline line, and a per-kernel
                       breakdown ({name: {value, unit,
                       higher_is_better}}) so a regression is
                       attributed to a kernel (wgl_search, scc,
                       bank_reduce, encode) rather than just the
                       blended headline. append_entry() is the one
                       writer; chip_smoke.py appends one entry per
                       kernel of a card run to a ledger of its own.

  slow_bleed()         an EWMA vs best-of-N detector: the recency-
                       weighted average of a kernel's series is
                       compared against the best value in the recent
                       window; a drift that never trips a per-round
                       gate still accumulates in the EWMA and fires
                       here (3 x 10% drops -> ~20% below best ->
                       flagged; round-to-round noise stays silent).

  validate_entries()   the schema check of the ledger (required keys,
                       strictly-monotonic round ids).

Reading tolerates a torn trailing line (the writer died mid-append) —
the shared crash-tolerance contract of the repo's jsonl artifacts.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

LEDGER_FILE = "bench_ledger.jsonl"

REQUIRED = ("round", "ts", "headline", "kernels")

# slow-bleed policy: EWMA weight on the newest
# point, how many recent rounds define "best", and the drop fraction
# below best that fires. 0.15 sits under the per-round gate's 0.20 on
# purpose: the gate catches cliffs, this catches drifts.
EWMA_ALPHA = 0.5
BEST_WINDOW = 5
BLEED_THRESHOLD = 0.15
MIN_ROUNDS = 3


def read_entries(path) -> list[dict]:
    """Ledger entries in append order; a torn/corrupt trailing line is
    dropped rather than raised."""
    p = Path(path)
    if not p.exists():
        return []
    out: list[dict] = []
    with open(p) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                break
    return out


def append_entry(path, entry: dict) -> dict:
    """Appends one round's entry (ts stamped if absent); returns it.
    The append is ONE os.write on an O_APPEND fd — the jlog
    concurrent-append discipline: two writers (two bench rounds
    racing) can
    interleave LINES but never bytes, so readers at worst drop a torn
    trailing line, never mis-parse a spliced one."""
    entry = dict(entry)
    entry.setdefault("ts", round(time.time(), 3))
    atomic_append_line(path, json.dumps(entry))
    return entry



def write_all(fd: int, buf: bytes) -> None:
    """os.write until every byte lands, raising on a zero-progress
    write: a silently torn record behind a durability promise is the
    failure this exists to prevent."""
    view = memoryview(buf)
    while view:
        n = os.write(fd, view)
        if n <= 0:
            raise OSError("short write")
        view = view[n:]


def atomic_append_line(path, line: str) -> None:
    """One whole line, one os.write, O_APPEND: the shared-journal
    append primitive of the coverage atlas. Short writes (ENOSPC,
    signals) are continued rather than silently torn; the continuation
    can interleave with another writer only in the already-degraded
    disk-full case, where the torn-tail read rule still drops the
    damage."""
    fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        write_all(fd, (line + "\n").encode())
    finally:
        os.close(fd)


def next_round(entries: list[dict], floor: int = 0) -> int:
    """The next round id: one past the ledger's max (and past `floor`,
    the newest BENCH_r<NN> artifact's round, so ledger rounds stay
    aligned with the driver's files even if the ledger starts late)."""
    last = max((int(e.get("round", 0)) for e in entries), default=0)
    return max(last, floor) + 1


def validate_entries(entries) -> int:
    """Schema check for a ledger stream: required keys, numeric
    headline value, kernels a dict of {value, ...} maps, and STRICTLY
    monotonic round ids. Returns the entry count; raises ValueError on
    the first violation. Run in tier-1 like tracing.validate_records."""
    prev_round = 0
    n = 0
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise ValueError(f"entry {i}: not a dict")
        for key in REQUIRED:
            if key not in e:
                raise ValueError(f"entry {i} missing {key!r}: {e}")
        rnd = e["round"]
        if not isinstance(rnd, int) or rnd <= prev_round:
            raise ValueError(
                f"entry {i}: round {rnd!r} not monotonic "
                f"(previous {prev_round})")
        prev_round = rnd
        if not isinstance(e["ts"], (int, float)) or e["ts"] < 0:
            raise ValueError(f"entry {i}: bad ts {e['ts']!r}")
        hl = e["headline"]
        if not isinstance(hl, dict) or not isinstance(
                hl.get("value"), (int, float)):
            raise ValueError(f"entry {i}: bad headline {hl!r}")
        if not isinstance(e["kernels"], dict):
            raise ValueError(f"entry {i}: kernels must be a dict")
        for name, k in e["kernels"].items():
            if not isinstance(k, dict) or not isinstance(
                    k.get("value"), (int, float)):
                raise ValueError(
                    f"entry {i}: kernel {name!r} bad value: {k!r}")
        # optional search-shape fields (witness position, frontier
        # peak, states explored — gpu/wgl.py's explorer): the
        # cross-run view of how the search's shape drifts
        s = e.get("search")
        if s is not None:
            if not isinstance(s, dict) or not all(
                    isinstance(v, (int, float)) and not isinstance(
                        v, bool)
                    for v in s.values()):
                raise ValueError(f"entry {i}: bad search stats {s!r}")
        # optional lint aggregates (the JAX package's graftlint
        # numbers: non-donated bytes, replicated bytes, unsharded
        # batch-axis count, plus a per-rule findings breakdown)
        li = e.get("lint")
        if li is not None:
            if not isinstance(li, dict):
                raise ValueError(f"entry {i}: bad lint stats {li!r}")
            for k, v in li.items():
                if k == "findings":
                    if not isinstance(v, dict) or not all(
                            isinstance(x, int) for x in v.values()):
                        raise ValueError(
                            f"entry {i}: bad lint findings {v!r}")
                elif not isinstance(v, int) or isinstance(v, bool):
                    raise ValueError(
                        f"entry {i}: bad lint field {k!r}: {v!r}")
        # optional fleet flight-recorder summary (fleet/flightrec.py):
        # verdict/ack latency quantiles, per-class batch
        # occupancy, and the scheduler decision-log counts
        fl = e.get("fleet")
        if fl is not None:
            if not isinstance(fl, dict):
                raise ValueError(f"entry {i}: bad fleet stats {fl!r}")
            for k, v in fl.items():
                if k == "occupancy":
                    if not isinstance(v, dict) or not all(
                            x is None or (
                                isinstance(x, (int, float))
                                and not isinstance(x, bool)
                                and 0 <= x <= 1)
                            for x in v.values()):
                        raise ValueError(
                            f"entry {i}: bad fleet occupancy {v!r}")
                elif k == "decisions":
                    if not isinstance(v, dict) or not all(
                            isinstance(x, int)
                            and not isinstance(x, bool)
                            for x in v.values()):
                        raise ValueError(
                            f"entry {i}: bad fleet decisions {v!r}")
                elif v is not None and (
                        isinstance(v, bool)
                        or not isinstance(v, (int, float))):
                    raise ValueError(
                        f"entry {i}: bad fleet field {k!r}: {v!r}")
        n += 1
    return n


# ---------------------------------------------------------------------------
# Slow-bleed detection
# ---------------------------------------------------------------------------

def ewma(values, alpha: float = EWMA_ALPHA) -> float:
    it = iter(values)
    acc = float(next(it))
    for v in it:
        acc = alpha * float(v) + (1 - alpha) * acc
    return acc


def slow_bleed(values, window: int = BEST_WINDOW,
               threshold: float = BLEED_THRESHOLD,
               alpha: float = EWMA_ALPHA,
               higher_is_better: bool = True) -> dict:
    """Detects gradual regression in a chronological series of round
    values. Returns {'bleeding': bool, 'ewma', 'best', 'drop', 'n'}
    where `drop` is how far the recency-weighted average sits below
    the best of the last `window` rounds (in the higher-is-better
    frame; lower-is-better series — seconds — are inverted first).
    Under MIN_ROUNDS points nothing fires: one round is a gate's job,
    a bleed needs history."""
    vals = [float(v) for v in values if v is not None]
    out = {"bleeding": False, "ewma": None, "best": None,
           "drop": None, "n": len(vals)}
    if len(vals) < MIN_ROUNDS or any(v <= 0 for v in vals):
        return out
    series = vals if higher_is_better else [1.0 / v for v in vals]
    avg = ewma(series, alpha)
    best = max(series[-window:])
    drop = 1.0 - avg / best
    out.update(ewma=round(avg, 6), best=round(best, 6),
               drop=round(drop, 4), bleeding=drop > threshold)
    return out


def kernel_series(entries: list[dict], name: str) -> list[float]:
    """One kernel's chronological value series across ledger entries
    (rounds missing the kernel are skipped, keeping ratios honest)."""
    out = []
    for e in entries:
        k = (e.get("kernels") or {}).get(name)
        if isinstance(k, dict) and isinstance(k.get("value"),
                                              (int, float)):
            out.append(float(k["value"]))
    return out


def detect(entries: list[dict], window: int = BEST_WINDOW,
           threshold: float = BLEED_THRESHOLD) -> dict[str, dict]:
    """Per-kernel slow-bleed verdicts over a ledger (the newest entry
    is the round under test). Keys: every kernel named by the newest
    entry, plus 'headline'. Each verdict is slow_bleed()'s dict."""
    if not entries:
        return {}
    newest = entries[-1]
    out: dict[str, dict] = {}
    hl = [e["headline"]["value"] for e in entries
          if isinstance(e.get("headline"), dict)
          and isinstance(e["headline"].get("value"), (int, float))]
    out["headline"] = slow_bleed(hl, window, threshold)
    for name, k in (newest.get("kernels") or {}).items():
        out[name] = slow_bleed(
            kernel_series(entries, name), window, threshold,
            higher_is_better=bool(k.get("higher_is_better", True))
            if isinstance(k, dict) else True)
    return out
