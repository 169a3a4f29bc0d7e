"""Kafka/Redpanda-style queue workload: totally-ordered append-only
partitions, producers sending [offset value] messages, consumers
polling ranges, with the full anomaly analysis.

Capability reference: jepsen/src/jepsen/tests/kafka.clj (the
reference's largest workload, 2149 LoC) — operation encoding
(kafka.clj:24-97), version orders from send/poll offset agreement
(docstring §2, inconsistent-offsets), aborted reads (§1, G1a), lost
writes below the highest observed offset (§3, lost-write), unseen
messages, ww/wr dependency cycles via elle (§4), internal poll/send
contiguity, external poll contiguity, and nonmonotonic sends (§5-6;
external send-SKIPS are deliberately not detected, matching the
reference — "We don't even bother looking at external send skips",
kafka.clj:2022), duplicates, and the
allowed-error-type policy (kafka.clj:2019-2046: int-send-skip and G0
always allowed; poll-skip/nonmonotonic-poll allowed under subscribe;
G1c allowed when ww edges are inferred).

Operation encoding (mirrors the reference):
  {"f": "subscribe"|"assign", "value": [k, ...]}
  {"f": "send"|"poll"|"txn", "value": [mop, ...]}
    send mop: ["send", k, v] -> completed ["send", k, [offset, v]]
    poll mop: ["poll"] -> completed ["poll", {k: [[offset, v], ...]}]

The analysis interns values per key and leans on the elle engine's
cycle machinery (classification + witness extraction); version orders
and contiguity checks are array-friendly rank lookups.

The port's copy of jepsen_tpu/workloads/kafka.py; its cycles go through
the port's gpu/elle.py on the host (scipy), as in the JAX package. No
kernel runs.
"""

from __future__ import annotations

import random
from collections import defaultdict

from .. import checker as chk
from .. import generator as gen
from .. import history as h
from ..checker import _Fn
from ..history import History
from ..gpu import elle

# Error types allowed regardless of configuration
# (kafka.clj:2019-2035).
_ALWAYS_ALLOWED = {"int-send-skip", "G0", "G0-process", "G0-realtime"}

_TXN_FS = ("txn", "send", "poll")


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

def generator(n_keys: int = 4, max_txn: int = 4, send_p: float = 0.5,
              subscribe_p: float = 0.05, seed=None):
    """Mix of send/poll txns with occasional subscribe ops re-assigning
    the consumer's partitions (kafka.clj txn-generator + interleave of
    subscribe ops)."""
    rng = random.Random(seed)
    next_val = [0]

    def one():
        if rng.random() < subscribe_p:
            ks = sorted(rng.sample(range(n_keys),
                                   rng.randint(1, n_keys)))
            return {"f": "subscribe", "value": ks}
        mops = []
        for _ in range(rng.randint(1, max_txn)):
            if rng.random() < send_p:
                next_val[0] += 1
                mops.append(["send", rng.randrange(n_keys),
                             next_val[0]])
            else:
                mops.append(["poll"])
        fs = {m[0] for m in mops}
        f = "send" if fs == {"send"} else (
            "poll" if fs == {"poll"} else "txn")
        return {"f": f, "value": mops}

    return one


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------

def _collect(hist: History) -> list:
    """Pairs invocations with completions like elle.collect, but keeps
    the COMPLETION micro-ops for :info ops too — an indeterminate send
    may still report the offsets it wrote, and dropping them would hide
    e.g. offset conflicts it witnessed (round-3 review finding)."""
    txns = []
    open_inv: dict = {}
    for pos, o in enumerate(hist):
        if not h.is_client_op(o):
            continue
        if o.type == h.INVOKE:
            open_inv[o.process] = (pos, o)
        elif o.type in (h.OK, h.FAIL, h.INFO):
            pair = open_inv.pop(o.process, None)
            if pair is None:
                continue
            inv_pos, inv = pair
            mops = (o.value if (o.type in (h.OK, h.INFO)
                                and o.value is not None) else inv.value)
            txns.append(elle.Txn(len(txns), o, o.type, o.process,
                                 inv_pos, pos, mops or []))
    for inv_pos, inv in open_inv.values():
        txns.append(elle.Txn(len(txns), inv, h.INFO, inv.process,
                             inv_pos, 1 << 60, inv.value or []))
    return txns


def _mop_sends(mops):
    for m in mops or []:
        if m[0] == "send":
            yield m


def _mop_polls(mops):
    for m in mops or []:
        if m[0] == "poll":
            yield m


class Analysis:
    """Builds version orders and every anomaly class from a history
    (kafka.clj `analysis`, 1881-1984)."""

    def __init__(self, hist: History, ww_deps: bool = True,
                 sub_via=("subscribe",)):
        self.ww_deps = ww_deps
        self.sub_via = set(sub_via)
        self.errors: dict[str, list] = defaultdict(list)
        # one paired stream: txn/send/poll ops carry micro-ops,
        # subscribe/assign ops mark consumer resets
        self.stream = _collect(hist)
        self.obs = list(self._observations())
        self._version_orders()
        self._writers_readers()
        self._g1a()
        self._duplicates()
        self._lost_and_unseen()
        self._contiguity()
        self._cycles()

    # -- version orders ----------------------------------------------------

    def _observations(self):
        """Yields (txn, key, offset, value, kind) for every offset
        observation: kind 'send' (ok/info send completions that carry
        offsets) or 'poll' (ok poll reads)."""
        for t in self.stream:
            f = t.op.f
            if f not in _TXN_FS:
                continue
            if t.type == h.OK or (t.type == h.INFO and f != "poll"):
                for m in _mop_sends(t.mops):
                    v = m[2]
                    if isinstance(v, list) and len(v) == 2:
                        off, val = v
                        if off is not None:
                            yield t, m[1], off, val, "send"
            if t.type == h.OK:
                for m in _mop_polls(t.mops):
                    if len(m) > 1 and isinstance(m[1], dict):
                        for k, pairs in m[1].items():
                            for off, val in pairs:
                                if off is not None:
                                    yield t, k, off, val, "poll"

    def _version_orders(self):
        """offset -> value per key; conflicting values at one offset
        are inconsistent-offsets errors. The per-key version order is
        the offset-sorted value list (rank order: gaps in offsets are
        transaction-metadata slots and carry no meaning)."""
        by_key: dict = defaultdict(dict)  # k -> off -> set(values)
        for _t, k, off, val, _kind in self.obs:
            by_key[k].setdefault(off, set()).add(val)
        self.orders: dict = {}       # k -> [v in offset order]
        self.rank: dict = {}         # (k, v) -> rank
        self.offset_of: dict = {}    # (k, v) -> offset
        for k, offs in by_key.items():
            bad = {o: sorted(vs, key=repr) for o, vs in offs.items()
                   if len(vs) > 1}
            if bad:
                self.errors["inconsistent-offsets"].append(
                    {"key": k, "values": bad})
            order = []
            for o in sorted(offs):
                v = next(iter(offs[o]))
                self.offset_of[(k, v)] = o
                self.rank[(k, v)] = len(order)
                order.append(v)
            self.orders[k] = order

    # -- writers / readers -------------------------------------------------

    def _writers_readers(self):
        self.writer_of: dict = {}     # (k, v) -> txn
        self.readers_of: dict = defaultdict(list)
        for t in self.stream:
            if t.op.f not in _TXN_FS:
                continue
            for m in _mop_sends(t.mops):
                v = m[2]
                val = (v[1] if isinstance(v, list) and len(v) == 2
                       else v)
                if val is None:
                    continue
                prev = self.writer_of.get((m[1], val))
                if (prev is not None and prev is not t
                        and prev.type != h.FAIL and t.type != h.FAIL):
                    self.errors["duplicate"].append(
                        {"key": m[1], "value": val,
                         "writers": [prev.op, t.op]})
                if t.type != h.FAIL or prev is None:
                    self.writer_of[(m[1], val)] = t
            if t.type == h.OK:
                for m in _mop_polls(t.mops):
                    if len(m) > 1 and isinstance(m[1], dict):
                        for k, pairs in m[1].items():
                            for _off, val in pairs:
                                self.readers_of[(k, val)].append(t)

    def _g1a(self):
        """Reads of values whose writer :failed (kafka.clj docstring
        §1)."""
        for (k, v), readers in self.readers_of.items():
            w = self.writer_of.get((k, v))
            if w is not None and w.type == h.FAIL:
                self.errors["G1a"].append(
                    {"key": k, "value": v, "writer": w.op,
                     "readers": [r.op for r in readers[:4]]})

    def _duplicates(self):
        """A value at more than one offset in a key's log (kafka.clj
        duplicate-cases)."""
        seen: dict = defaultdict(set)
        for _t, k, off, val, _kind in self.obs:
            seen[(k, val)].add(off)
        for (k, val), offs in seen.items():
            if len(offs) > 1:
                self.errors["duplicate-offsets"].append(
                    {"key": k, "value": val, "offsets": sorted(offs)})

    def _lost_and_unseen(self):
        """§3: every ok send at or below a key's highest *polled*
        offset must have been polled by someone (else: lost-write);
        acknowledged sends above it that nobody ever polled are
        'unseen' — an error at history end (check() flags any
        leftover unseen; the workload's final drain phase exists so
        healthy runs come back clean)."""
        highest_polled: dict = {}
        for t, k, off, _val, kind in self.obs:
            if kind == "poll":
                highest_polled[k] = max(highest_polled.get(k, -1), off)
        unseen: dict = defaultdict(list)
        for t in self.stream:
            if t.type != h.OK or t.op.f not in _TXN_FS:
                continue
            for m in _mop_sends(t.mops):
                v = m[2]
                if not (isinstance(v, list) and len(v) == 2):
                    continue
                off, val = v
                k = m[1]
                if self.readers_of.get((k, val)):
                    continue
                if off is not None and off <= highest_polled.get(k, -1):
                    self.errors["lost-write"].append(
                        {"key": k, "value": val, "offset": off,
                         "writer": t.op,
                         "highest-polled": highest_polled.get(k)})
                else:
                    unseen[k].append(val)
        self.unseen = dict(unseen)

    # -- contiguity --------------------------------------------------------

    def _contiguity(self):
        """§5-6: poll/send offset-rank contiguity, both within a txn
        (int-*) and across txns per process (external). Assignment
        changes reset external poll tracking (a rebalance legitimately
        moves the consumer)."""
        last_polled: dict = {}   # (process, k) -> rank
        last_sent: dict = {}     # (process, k) -> rank
        for t in self.stream:
            f = t.op.f
            p = t.process
            if f in ("subscribe", "assign"):
                if t.type != h.FAIL:  # failed re-assignment changes nothing
                    for key in list(last_polled):
                        if key[0] == p:
                            del last_polled[key]
                continue
            if f not in _TXN_FS or t.type != h.OK:
                continue
            int_polled: dict = {}
            int_sent: dict = {}
            for m in t.mops:
                if m[0] == "poll" and len(m) > 1 and isinstance(
                        m[1], dict):
                    for k, pairs in m[1].items():
                        for _off, val in pairs:
                            r = self.rank.get((k, val))
                            if r is None:
                                continue
                            for scope, store, ext in (
                                    ("int", int_polled, False),
                                    ("ext", last_polled, True)):
                                key = (p, k) if ext else k
                                prev = store.get(key)
                                if prev is not None:
                                    delta = r - prev
                                    if delta <= 0:
                                        name = ("nonmonotonic-poll"
                                                if ext else
                                                "int-nonmonotonic-poll")
                                        self.errors[name].append(
                                            {"key": k, "delta": delta,
                                             "op": t.op})
                                    elif delta > 1 and not ext:
                                        self.errors[
                                            "int-poll-skip"].append(
                                            {"key": k, "delta": delta,
                                             "op": t.op})
                                    elif delta > 1 and ext:
                                        self.errors["poll-skip"].append(
                                            {"key": k, "delta": delta,
                                             "op": t.op})
                                store[key] = r
                elif m[0] == "send":
                    v = m[2]
                    if not (isinstance(v, list) and len(v) == 2):
                        continue
                    k = m[1]
                    r = self.rank.get((k, v[1]))
                    if r is None:
                        continue
                    for scope, store, ext in (
                            ("int", int_sent, False),
                            ("ext", last_sent, True)):
                        key = (p, k) if ext else k
                        prev = store.get(key)
                        if prev is not None:
                            delta = r - prev
                            if delta <= 0:
                                name = ("nonmonotonic-send" if ext
                                        else "int-nonmonotonic-send")
                                self.errors[name].append(
                                    {"key": k, "delta": delta,
                                     "op": t.op})
                            elif delta > 1 and not ext:
                                self.errors["int-send-skip"].append(
                                    {"key": k, "delta": delta,
                                     "op": t.op})
                        store[key] = r

    # -- realtime lag ------------------------------------------------------

    def realtime_lag(self) -> dict:
        """How far each consumer ran behind the log, in wall time
        (kafka.clj realtime-lag, 1359): at every ok poll completion,
        the lag is the age of the oldest acknowledged-but-not-yet-
        polled message on that consumer's keys — 0 when caught up.
        Returns the stats tail: worst observation plus per-(process,
        key) final lags. Shares _LagTracker with the live lag_probe so
        post-hoc and streamed numbers can't diverge."""
        tracker = _LagTracker()
        worst = None
        final: dict = {}                  # (process, k) -> last lag ms
        for t in self.stream:             # completion order
            if t.op.f not in _TXN_FS:
                continue
            if t.type == h.OK or (t.type == h.INFO
                                  and t.op.f != "poll"):
                for m in _mop_sends(t.mops):
                    tracker.ack_send(m, t.op.time)
            if t.type != h.OK:
                continue
            for m in _mop_polls(t.mops):
                if not (len(m) > 1 and isinstance(m[1], dict)):
                    continue
                for k, lag_ms in tracker.poll_lags(
                        t.process, m[1], t.op.time):
                    final[(t.process, k)] = lag_ms
                    if worst is None or lag_ms > worst["lag-ms"]:
                        worst = {"process": t.process, "key": k,
                                 "time": t.op.time, "lag-ms": lag_ms}
        return {
            "worst-realtime-lag": worst or {"lag-ms": 0.0},
            "max-lag-ms": worst["lag-ms"] if worst else 0.0,
            "final-lags-ms": {f"{p}:{k}": v
                              for (p, k), v in sorted(
                                  final.items(), key=repr)},
        }

    # -- dependency cycles -------------------------------------------------

    def _cycles(self):
        """§4: ww (adjacent versions, when ww_deps) and wr (highest
        read of a key reads-from its writer), plus session/realtime
        order, classified through the elle engine's cycle machinery.
        No rw anti-dependency edges: a consumer legitimately lags the
        log, so reading version r while r+1 exists implies nothing —
        the reference leaves its rw-graph commented out for the same
        reason (kafka.clj:1859)."""
        txns = [t for t in self.stream if t.op.f in _TXN_FS]
        index = {id(t): i for i, t in enumerate(txns)}
        edges: list[tuple[int, int, int]] = []
        if self.ww_deps:
            for k, order in self.orders.items():
                prev = None
                for v in order:
                    w = self.writer_of.get((k, v))
                    if w is None or w.type == h.FAIL:
                        continue
                    if prev is not None and prev is not w:
                        edges.append((index[id(prev)], index[id(w)],
                                      elle.WW))
                    prev = w
        for t in txns:
            if t.type != h.OK:
                continue
            # wr-graph (kafka.clj:1840-1852): writer of v -> EVERY txn
            # that polled v, for every polled value (a highest-only
            # link misses cycles closed through older reads)
            linked: set = set()
            for m in _mop_polls(t.mops):
                if len(m) > 1 and isinstance(m[1], dict):
                    for k, pairs in m[1].items():
                        for _off, val in pairs:
                            w = self.writer_of.get((k, val))
                            if (w is not None and w is not t
                                    and w.type != h.FAIL
                                    and id(w) not in linked):
                                linked.add(id(w))
                                edges.append((index[id(w)],
                                              index[id(t)], elle.WR))
        committed = []
        for i, t in enumerate(txns):
            if t.type == h.OK:
                t2 = elle.Txn(i, t.op, t.type, t.process, t.invoke_pos,
                              t.complete_pos, t.mops)
                committed.append(t2)
        src, dst, ty = elle.order_edge_arrays(committed)
        edges.extend(zip(src.tolist(), dst.tolist(), ty.tolist()))
        for name, ws in elle.cycle_anomalies(
                len(txns), list(dict.fromkeys(edges)), txns).items():
            self.errors[name] = ws


def check(hist, opts: dict | None = None) -> dict:
    """kafka.clj `checker`: runs the analysis, then filters error
    types through the allowed-error policy."""
    o = dict(opts or {})
    if not isinstance(hist, History):
        hist = History(hist)
    a = Analysis(hist, ww_deps=o.get("ww-deps", True),
                 sub_via=o.get("sub-via", ("subscribe",)))
    allowed = set(_ALWAYS_ALLOWED)
    if "subscribe" in a.sub_via:
        allowed |= {"poll-skip", "nonmonotonic-poll"}
    if a.ww_deps:
        allowed |= {"G1c", "G1c-process", "G1c-realtime"}
    errors = {k: v for k, v in a.errors.items() if v}
    if a.unseen:
        # kafka.clj's last-unseen: acked sends nobody ever polled are
        # an error at history end (the workload's final polls drain,
        # so healthy runs come back clean)
        errors["unseen"] = [
            {"key": k, "count": len(vs), "messages": sorted(vs)[:32]}
            for k, vs in sorted(a.unseen.items())]
    bad = sorted(k for k in errors if k not in allowed)
    # condense-error ordering: skip/nonmonotonic families sort by how
    # far the offset jumped (worst first)
    _DELTA = {"poll-skip", "int-poll-skip", "int-send-skip"}
    _NEG_DELTA = {"nonmonotonic-poll", "nonmonotonic-send",
                  "int-nonmonotonic-poll", "int-nonmonotonic-send"}
    out_errors = {}
    for k, v in errors.items():
        if k in _DELTA:
            v = sorted(v, key=lambda e: -e.get("delta", 0))
        elif k in _NEG_DELTA:
            v = sorted(v, key=lambda e: e.get("delta", 0))
        out_errors[k] = v[:8]
    return {
        "valid?": not bad,
        "error-types": sorted(errors.keys()),
        "bad-error-types": bad,
        "errors": out_errors,
        "unseen": {k: len(v) for k, v in a.unseen.items()},
        # the stats tail (kafka.clj realtime-lag + unseen recovery):
        # how far consumers ran behind, and what never surfaced
        "realtime-lag": dict(
            a.realtime_lag(),
            **{"unseen-at-end": {k: len(v) for k, v in sorted(
                a.unseen.items())}}),
    }


def checker(opts: dict | None = None) -> chk.Checker:
    o = dict(opts or {})

    def run(test, hist, copts):
        merged = dict(o)
        if isinstance(test, dict):
            for key in ("ww-deps", "sub-via"):
                if key in test:
                    merged[key] = test[key]
        return check(hist, merged)

    return _Fn(run)


class _LagTracker:
    """The realtime-lag bookkeeping shared by the post-hoc analysis
    (Analysis.realtime_lag) and the live monitor probe (lag_probe):
    acked sends per key, each consumer's highest polled offset, and
    the age of the oldest acked-but-unpolled message at a poll.

    Memory/scan cost is bounded by pruning acked entries every
    consumer known to poll a key has passed: a long run holds only the
    slowest consumer's backlog per key, not every send ever acked.
    (Tradeoff: a consumer that starts polling a key only late in the
    run can't be charged for messages pruned before its first poll —
    the lag it reports from then on is still exact.)"""

    def __init__(self):
        self.acked: dict = defaultdict(list)  # k -> [(off, ack t ns)]
        self.hp: dict = defaultdict(dict)     # k -> {process: off}

    def ack_send(self, mop, now: int) -> None:
        """Records one completed send mop carrying [offset, value]."""
        v = mop[2]
        if isinstance(v, list) and len(v) == 2 and v[0] is not None:
            self.acked[mop[1]].append((v[0], now))

    def poll_lags(self, process, reads: dict, now: int):
        """Yields (key, lag_ms) for one ok poll's {k: pairs} reads."""
        for k, pairs in reads.items():
            frontiers = self.hp[k]
            seen = frontiers.get(process, -1)
            for off, _val in pairs:
                if off is not None and off > seen:
                    seen = off
            frontiers[process] = seen
            acked = self.acked[k]
            oldest = min((at for off, at in acked if off > seen),
                         default=None)
            floor = min(frontiers.values())
            if floor >= 0:
                self.acked[k] = [e for e in acked if e[0] > floor]
            yield k, (round((now - oldest) / 1e6, 3)
                      if oldest is not None else 0.0)


def lag_probe():
    """A live-monitor probe (the monitor's probe protocol: a
    factory returning `probe(op, monitor)`) streaming consumer
    realtime lag into the run's time-series — the online counterpart
    of Analysis.realtime_lag, over the same _LagTracker."""
    tracker = _LagTracker()

    def probe(op, monitor):
        # ok AND info completions ack their sends (an indeterminate
        # send that reported offsets still landed — same rule as the
        # post-hoc path, so live and stored lag numbers agree); polls
        # only count when ok
        if op.type not in (h.OK, h.INFO) or op.f not in _TXN_FS \
                or not isinstance(op.value, list):
            return
        max_lag = None
        for m in op.value:
            if m[0] == "send":
                tracker.ack_send(m, op.time)
            elif (op.type == h.OK and m[0] == "poll" and len(m) > 1
                    and isinstance(m[1], dict)):
                for _k, lag in tracker.poll_lags(
                        op.process, m[1], op.time):
                    if max_lag is None or lag > max_lag:
                        max_lag = lag
        if max_lag is not None:
            monitor.probe_gauge("kafka.realtime-lag-ms", max_lag)

    return probe


class _DrainGen(gen.Generator):
    """Emits polls until this thread's LAST completed poll returned
    no pairs (caught up with the tail). Functional: state advances on
    completion events via update(), never on probes."""

    def __init__(self, done: bool = False):
        self.done = done

    def op(self, test, ctx):
        if self.done:
            return None  # exhausted (the op() protocol's bare None)
        m = gen.fill_in_op({"f": "poll", "value": [["poll"]]}, ctx)
        if m is gen.PENDING:
            return gen.PENDING, self
        return m, self

    def update(self, test, ctx, event):
        if (event.type == h.OK and event.f == "poll"
                and isinstance(event.value, list)):
            polled = any(
                m[0] == "poll" and len(m) > 1
                and isinstance(m[1], dict) and any(m[1].values())
                for m in event.value)
            if not polled:
                return _DrainGen(done=True)
        return self


def workload(opts: dict | None = None) -> dict:
    from .. import generator as gen

    o = dict(opts or {})
    n_keys = o.get("n-keys", 4)
    g = generator(n_keys=n_keys,
                  max_txn=o.get("max-txn-length", 4),
                  seed=o.get("seed"))
    if o.get("ops"):
        g = gen.limit(o["ops"], g)
    # final drain (the reference's final-polls loop, kafka.clj
    # 405-432: repeat assign+poll until caught up): every thread takes
    # ownership of all keys, then polls until a poll comes back EMPTY
    # (the log tail), bounded by final-polls as a safety cap — so
    # acked-but-unpolled sends don't read as 'unseen' errors. Clients
    # with bounded poll batches drain across iterations.
    keys = list(range(n_keys))
    final = gen.each_thread(gen.phases(
        gen.once(lambda: {"f": "assign", "value": keys}),
        gen.limit(o.get("final-polls", 32), _DrainGen())))
    return {
        "generator": g,
        "final_generator": final,
        "checker": chk.compose({"kafka": checker(o),
                                "stats": chk.stats()}),
        # consumer lag streams into timeseries.jsonl while the test
        # runs (core.run hands these factories to the Monitor)
        "monitor_probes": [lag_probe],
    }
