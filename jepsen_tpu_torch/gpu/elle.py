"""Elle-style transactional anomaly checking (list-append, rw-register):
jepsen_tpu/tpu/elle.py ported, StreamingElle included.

Capability reference: the reference wraps the external elle 0.2.1
library (jepsen/src/jepsen/tests/cycle/append.clj:6-27, wr.clj:5-25):
infer ww/wr/rw dependency edges from each transaction's external reads
and writes (txn/src/jepsen/txn.clj:48-80), build the dependency graph,
find strongly-connected components, extract and classify cycle
witnesses (G0, G1a, G1b, G1c, G-single, G2-item), plus non-cycle
anomalies (aborted read, intermediate read, internal inconsistency,
incompatible version orders, duplicate appends).

This module is the HOST REFERENCE engine: plain-Python edge inference
and scipy SCC, kept simple as the correctness baseline. Large
histories dispatch (engine="auto") to the device engine —
gpu/elle_device interns txns/keys/values into int arrays, infers edges
with numpy segment ops, and runs cycle detection through the
label-propagation SCC kernel on the card (gpu/scc); differential tests
pin the two engines to identical anomaly results, and both to the JAX
package's.

opts["device"] picks where the device engine's SCC runs: None (the
CUDA card, the default) or "cpu" (the kernel's plain PyTorch version).
Once the device engine is chosen it finishes on the card or raises:
no error of the card (out of memory included) steps down to the host
engine. A caller that wants the host passes engine="host".

Pipeline here:
  1. collect committed/aborted/indeterminate txns from the history;
  2. per-key version orders: for list-append, the longest observed read
     is the spine and every read must be one of its prefixes;
  3. ww/wr/rw edge inference from external reads/writes against the
     spine;
  4. exact SCC via scipy.sparse.csgraph (compiled Tarjan-equivalent:
     the graph step the reference runs on the JVM), cycle witness
     extraction host-side, classified by edge composition.

Realtime edges implement the FULL interval order (A precedes B iff A
completed before B invoked), reduced by a covering-frontier sweep to
O(n * concurrency) edges; per-process chains carry session order.
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from typing import Any

import numpy as np

from .. import history as h
from .. import telemetry
from ..store import format as fmt
from ..history import History
from .. import txn as txnlib
from ..device import resolve_device
from . import ckpt

WW, WR, RW, RT, PROC = 0, 1, 2, 3, 4
EDGE_NAMES = {WW: "ww", WR: "wr", RW: "rw", RT: "realtime",
              PROC: "process"}


class Txn:
    __slots__ = ("i", "op", "type", "process", "invoke_pos",
                 "complete_pos", "mops")

    def __init__(self, i, op, type_, process, invoke_pos, complete_pos,
                 mops):
        self.i = i
        self.op = op
        self.type = type_
        self.process = process
        self.invoke_pos = invoke_pos
        self.complete_pos = complete_pos
        self.mops = mops


def collect(hist: History) -> list[Txn]:
    """Pairs txn invocations with completions. Committed (:ok) txns use
    the completion's mops (which carry read results); :fail txns are
    aborted; :info indeterminate."""
    txns: list[Txn] = []
    open_inv: dict[Any, tuple[int, Any]] = {}
    for pos, op in enumerate(hist):
        if not h.is_client_op(op):
            continue
        if op.type == h.INVOKE:
            open_inv[op.process] = (pos, op)
        elif op.type in (h.OK, h.FAIL, h.INFO):
            pair = open_inv.pop(op.process, None)
            if pair is None:
                continue
            inv_pos, inv = pair
            mops = op.value if (op.type == h.OK and op.value is not None
                                ) else inv.value
            txns.append(Txn(len(txns), op, op.type, op.process, inv_pos,
                            pos, mops or []))
    for inv_pos, inv in open_inv.values():
        txns.append(Txn(len(txns), inv, h.INFO, inv.process, inv_pos,
                        1 << 60, inv.value or []))
    return txns


# ---------------------------------------------------------------------------
# list-append analysis
# ---------------------------------------------------------------------------

def _freeze(v):
    return tuple(v) if isinstance(v, list) else v


class AppendAnalysis:
    def __init__(self, hist: History):
        self.txns = collect(hist)
        self.anomalies: dict[str, list] = defaultdict(list)
        # writer[(k, v)] = (txn, position among txn's appends to k,
        #                   total appends by txn to k)
        self.writer: dict = {}
        self._index_appends()
        self.spine: dict = {}      # k -> [v...] observed version order
        self._version_orders()
        self._read_anomalies()
        self.edges = self._edges()

    def _index_appends(self):
        # Writers that may have committed (:ok, or :info indeterminate —
        # a cycle through an unexecuted :info writer can't close, since
        # its outgoing edges all require its values to be observed).
        self.writers_by_key: dict = defaultdict(dict)
        for t in self.txns:
            per_key: dict = defaultdict(list)
            for mop in t.mops:
                f, k, v = mop[0], mop[1], mop[2]
                if f == "append":
                    per_key[k].append(v)
            for k, vs in per_key.items():
                if t.type != h.FAIL:
                    self.writers_by_key[k][t.i] = t
                for j, v in enumerate(vs):
                    key = (k, _freeze(v))
                    prev = self.writer.get(key)
                    if (prev is not None and t.type != h.FAIL
                            and prev[0].type != h.FAIL):
                        self.anomalies["duplicate-appends"].append(
                            {"key": k, "value": v, "op": t.op})
                    if t.type != h.FAIL or prev is None:
                        self.writer[key] = (t, j, len(vs))

    def _reads(self):
        for t in self.txns:
            if t.type != h.OK:
                continue
            for mop in t.mops:
                if mop[0] == "r" and mop[2] is not None:
                    yield t, mop[1], list(mop[2])

    def _version_orders(self):
        longest: dict = {}
        for _t, k, vs in self._reads():
            if len(vs) > len(longest.get(k, [])):
                longest[k] = vs
        self.spine = longest
        for t, k, vs in self._reads():
            sp = self.spine.get(k, [])
            if vs != sp[:len(vs)]:
                self.anomalies["incompatible-order"].append(
                    {"key": k, "read": vs, "spine": sp, "op": t.op})

    def _read_anomalies(self):
        for t, k, vs in self._reads():
            for v in vs:
                w = self.writer.get((k, _freeze(v)))
                if w is None:
                    self.anomalies["unobservable-read"].append(
                        {"key": k, "value": v, "op": t.op})
                    continue
                wt, j, total = w
                if wt.type == h.FAIL:
                    self.anomalies["G1a"].append(
                        {"key": k, "value": v, "op": t.op,
                         "writer": wt.op})
            if vs:
                w = self.writer.get((k, _freeze(vs[-1])))
                if w is not None:
                    wt, j, total = w
                    if j != total - 1 and wt.i != t.i:
                        self.anomalies["G1b"].append(
                            {"key": k, "value": vs[-1], "op": t.op,
                             "writer": wt.op})
            # internal: own appends so far must be a suffix of the read
            pre = []
            for mop in t.mops:
                if mop[1] != k:
                    continue
                if mop[0] == "append":
                    pre.append(mop[2])
                elif mop[0] == "r" and mop[2] is not None:
                    got = list(mop[2])
                    if pre and got[-len(pre):] != pre:
                        self.anomalies["internal"].append(
                            {"key": k, "expected-suffix": pre,
                             "read": got, "op": t.op})
                        break

    def _edges(self) -> list[tuple[int, int, int]]:
        """(src txn idx, dst txn idx, edge type). Per-key data-edge
        counts accumulate in self.key_edges — the search explorer's
        per-key cost attribution."""
        edges: list[tuple[int, int, int]] = []
        self.key_edges: dict = defaultdict(int)
        committed = [t for t in self.txns if t.type == h.OK]
        # ww along each spine; wr/rw from each read's last element
        for k, sp in self.spine.items():
            prev = None
            for v in sp:
                w = self.writer.get((k, _freeze(v)))
                if w is None or w[0].type == h.FAIL:
                    continue  # aborted writers are G1a, not graph nodes
                if prev is not None and prev.i != w[0].i:
                    edges.append((prev.i, w[0].i, WW))
                    self.key_edges[k] += 1
                prev = w[0]
        nxt: dict = {}
        for k, sp in self.spine.items():
            for a, b in zip(sp, sp[1:]):
                nxt[(k, _freeze(a))] = b
        # Targets for empty-read anti-dependencies, one set per key:
        # the first spine writer (the rest of the spine is reachable
        # from it via the ww chain) plus every possibly-committed
        # writer none of whose appends made the observed spine.
        empty_targets: dict = {}

        def _targets(k):
            ts = empty_targets.get(k)
            if ts is None:
                ts = {}
                spine_writers = set()
                for v in self.spine.get(k) or []:
                    w = self.writer.get((k, _freeze(v)))
                    if w is not None and w[0].type != h.FAIL:
                        if not spine_writers:
                            ts[w[0].i] = w[0]
                        spine_writers.add(w[0].i)
                for wt in self.writers_by_key.get(k, {}).values():
                    if wt.i not in spine_writers:
                        ts[wt.i] = wt
                empty_targets[k] = ts
            return ts

        for t, k, vs in self._reads():
            if vs:
                last = _freeze(vs[-1])
                w = self.writer.get((k, last))
                if (w is not None and w[0].i != t.i
                        and w[0].type != h.FAIL):
                    edges.append((w[0].i, t.i, WR))
                    self.key_edges[k] += 1
                # anti-dependency: reader -> writer of the next version
                nv = nxt.get((k, last))
                if nv is not None:
                    w = self.writer.get((k, _freeze(nv)))
                    if (w is not None and w[0].i != t.i
                            and w[0].type != h.FAIL):
                        edges.append((t.i, w[0].i, RW))
                        self.key_edges[k] += 1
            else:
                # An external read of [] precedes EVERY install on this
                # key: in any serial order consistent with it, t runs
                # before each committed appender (else t would observe
                # its value). This also covers keys no read ever
                # observed, which a spine-based path would miss.
                for wt in _targets(k).values():
                    if wt.i != t.i:
                        edges.append((t.i, wt.i, RW))
                        self.key_edges[k] += 1
        edges.extend(_order_edges(committed))
        return list(dict.fromkeys(edges))


def order_edge_arrays(committed: list[Txn]):
    """Process chains (session order per process) plus the FULL
    realtime interval order, reduced: a time sweep keeps a covering
    frontier of completed txns, so A reaches B by realtime edges iff
    A completed before B invoked — exactly elle's realtime relation,
    with O(n * concurrency) edges instead of O(n^2). Returns int
    (src, dst, type) arrays; the single implementation behind both the
    host and device engines. Process chains are a lexsort; the sweep
    runs in C (native/order.c) with a Python loop as fallback."""
    n = len(committed)
    if n == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), e.copy()
    ids = np.fromiter((t.i for t in committed), dtype=np.int64,
                      count=n)
    inv = np.fromiter((t.invoke_pos for t in committed),
                      dtype=np.int64, count=n)
    comp = np.fromiter((t.complete_pos for t in committed),
                       dtype=np.int64, count=n)
    proc_ids: dict = {}
    procid = np.fromiter(
        (proc_ids.setdefault(t.process, len(proc_ids))
         for t in committed), dtype=np.int64, count=n)
    return order_edges_from_arrays(ids, inv, comp, procid)


def order_edges_from_arrays(ids, inv, comp, procid):
    """Array-native core of order_edge_arrays: txn ids, invoke and
    complete history positions, and per-txn process codes (any ints
    that equal iff the process is the same)."""
    n = len(ids)
    if n == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), e.copy()
    # session order: adjacent pairs within each process
    order = np.lexsort((inv, procid))
    same = procid[order][1:] == procid[order][:-1]
    p_src = ids[order[:-1][same]]
    p_dst = ids[order[1:][same]]
    # realtime order: completion-frontier sweep
    try:
        from .. import native

        r_src_i, r_dst_i = native.realtime_edges(inv, comp)
    except RuntimeError:
        r_src_i, r_dst_i = _realtime_edges_arrays_py(inv, comp)
    r_src, r_dst = ids[r_src_i], ids[r_dst_i]
    src = np.concatenate([p_src, r_src])
    dst = np.concatenate([p_dst, r_dst])
    ty = np.concatenate([np.full(len(p_src), PROC, dtype=np.int64),
                         np.full(len(r_src), RT, dtype=np.int64)])
    return src, dst, ty


def _realtime_edges_arrays_py(inv, comp):
    """Pure-Python frontier sweep (the C path's reference semantics),
    over dense row indices. On a completion, drop frontier members the
    completing txn already covers; on an invocation, link every
    frontier member in."""
    src: list[int] = []
    dst: list[int] = []
    events = []
    for i in range(len(inv)):
        events.append((int(inv[i]), 1, i))
        events.append((int(comp[i]), 0, i))
    events.sort()
    frontier: list[int] = []
    for _pos, is_inv, i in events:
        if is_inv:
            for a in frontier:
                if a != i:
                    src.append(a)
                    dst.append(i)
        else:
            frontier[:] = [y for y in frontier
                           if int(comp[y]) >= int(inv[i])]
            frontier.append(i)
    return (np.asarray(src, dtype=np.int64),
            np.asarray(dst, dtype=np.int64))


def _order_edges(committed: list[Txn]) -> list[tuple[int, int, int]]:
    src, dst, ty = order_edge_arrays(committed)
    return [(int(a), int(b), int(c)) for a, b, c in zip(src, dst, ty)]


# ---------------------------------------------------------------------------
# Cycle search + classification
# ---------------------------------------------------------------------------

def _sccs(n: int, edges) -> list[list[int]]:
    """Nontrivial SCCs via scipy's compiled graph kernels."""
    if not edges or n == 0:
        return []
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    src = np.array([e[0] for e in edges])
    dst = np.array([e[1] for e in edges])
    g = coo_matrix((np.ones(len(src), dtype=np.int8), (src, dst)),
                   shape=(n, n))
    ncomp, labels = connected_components(g, directed=True,
                                         connection="strong")
    groups: dict = defaultdict(list)
    for v, lbl in enumerate(labels):
        groups[lbl].append(v)
    return [vs for vs in groups.values() if len(vs) > 1]


def _find_cycle(scc: list[int], edges) -> list[tuple[int, int, int]]:
    """A short cycle within an SCC: BFS from the first node back to
    itself, restricted to SCC members. Returns edge list."""
    members = set(scc)
    adj: dict = defaultdict(list)
    for s, d, ty in edges:
        if s in members and d in members:
            adj[s].append((d, ty))
    start = scc[0]
    prev: dict = {}
    frontier = [start]
    seen = {start}
    while frontier:
        nf = []
        for u in frontier:
            for v, ty in adj[u]:
                if v == start:
                    path = [(u, v, ty)]
                    while u != start:
                        pu, pty = prev[u]
                        path.append((pu, u, pty))
                        u = pu
                    return list(reversed(path))
                if v not in seen:
                    seen.add(v)
                    prev[v] = (u, ty)
                    nf.append(v)
        frontier = nf
    return []


def _classify(cycle) -> str:
    """Adya class from edge composition. Cycles that only close through
    realtime/process edges get a -realtime/-process suffix (elle naming:
    they violate strict/session variants, not serializability itself)."""
    types = {ty for _s, _d, ty in cycle}
    data = types & {WW, WR, RW}
    n_rw = sum(1 for _s, _d, ty in cycle if ty == RW)
    if data <= {WW}:
        name = "G0"
    elif RW not in data:
        name = "G1c"
    elif n_rw == 1:
        name = "G-single"
    else:
        name = "G2-item"
    if RT in types:
        name += "-realtime"
    elif PROC in types:
        name += "-process"
    return name


_SERIALIZABILITY = {"G0", "G1c", "G-single", "G2-item"}

# The anomaly classes each engine CHECKS — the coverage taxonomy's
# negative-result declaration: a valid verdict still reports every one
# of these as explicitly checked-and-clean.
CHECKED_APPEND = ("G0", "G1a", "G1b", "G1c", "G-single", "G2-item",
                  "internal", "unobservable-read", "duplicate-appends",
                  "incompatible-order")
CHECKED_WR = ("G0", "G1a", "G1b", "G1c", "G-single", "G2-item",
              "internal", "unobservable-read", "duplicate-writes")


def _with_classes(result: dict, checked) -> dict:
    """Attaches `anomaly-classes` — one outcome per checked class —
    to an elle check result. A -realtime/-process suffixed cycle
    witnesses its base class (it is a stronger-model violation of the
    same Adya phenomenon)."""
    found = set()
    for name in (result.get("anomalies") or {}):
        base = name
        for suffix in ("-realtime", "-process"):
            if base.endswith(suffix):
                base = base[:-len(suffix)]
        found.add(base)
        found.add(name)
    result["anomaly-classes"] = {
        cls: ("witnessed" if cls in found else "clean")
        for cls in checked}
    return result


def cycle_anomalies(n: int, edges, txns) -> dict[str, list]:
    """SCC search over increasingly strong edge subsets, so each cycle
    is reported at the weakest level it violates (mirrors elle's
    cycle-search strategy)."""
    out: dict[str, list] = defaultdict(list)
    subsets = [
        [e for e in edges if e[2] == WW],
        [e for e in edges if e[2] in (WW, WR)],
        [e for e in edges if e[2] in (WW, WR, RW)],
        [e for e in edges if e[2] in (WW, WR, RW, PROC)],
        list(edges),
    ]
    seen_sccs: set = set()
    for sub in subsets:
        for scc in _sccs(n, sub):
            key = frozenset(scc)
            if key in seen_sccs:
                continue
            seen_sccs.add(key)
            cycle = _find_cycle(scc, sub)
            if not cycle:
                continue
            name = _classify(cycle)
            out[name].append({
                "cycle": [txns[s].op for s, _d, _ty in cycle],
                "steps": [{"from": s, "to": d, "type": EDGE_NAMES[ty]}
                          for s, d, ty in cycle]})
    return out


# ---------------------------------------------------------------------------
# Anomaly provenance
# ---------------------------------------------------------------------------

def annotate_op_indices(result: dict, hist) -> dict:
    """Attaches the participating op (invocation) indices to every
    anomaly record as rec['op-indices'] — the provenance link from a
    verdict back to its traced ops (anomaly records usually carry
    completion ops; checker.op_indices resolves them to the
    invocation indices that trace records and timeline anchors join
    on). reports/explain resolves these into per-anomaly trace
    excerpts; web.py links them to pre-filtered Perfetto/timeline
    views. Shared by both the host and device engines so the
    differential tests stay engine-agnostic."""
    from ..checker import op_indices

    if not isinstance(hist, History):
        hist = History(hist)
    for recs in (result.get("anomalies") or {}).values():
        for rec in recs:
            if not isinstance(rec, dict) or "op-indices" in rec:
                continue
            ops = [rec.get(k) for k in ("op", "writer", "previous-ok")]
            ops.extend(rec.get("cycle") or [])
            rec["op-indices"] = op_indices(hist, *ops)
    return result


# ---------------------------------------------------------------------------
# Public checks
# ---------------------------------------------------------------------------

# Histories at least this many ops take the interned-array device
# engine (elle_device) under engine="auto"; below it, flat-Python
# wins on constant factors.
_DEVICE_MIN_OPS = 4000


def _with_search(result: dict, key_edges: dict | None = None) -> dict:
    """Attaches result['search'] — the search explorer's elle half:
    edge volume, witnessing-cycle count, and (host engine) the per-key
    edge cost attribution. Mirrored into elle.search.* telemetry so
    the profile CLI and ledger see search-shape drift."""
    s: dict = {"edges": int(result.get("edge-count") or 0),
               "txns": int(result.get("txn-count") or 0)}
    cycles = sum(1 for recs in (result.get("anomalies") or {}).values()
                 for rec in recs
                 if isinstance(rec, dict) and rec.get("steps"))
    s["cycles"] = cycles
    if key_edges:
        top = sorted(key_edges.items(), key=lambda kv: (-kv[1],
                                                        str(kv[0])))
        s["keys"] = len(key_edges)
        s["per-key-edges"] = {str(k): int(v) for k, v in top[:8]}
    telemetry.count("elle.search.edges", s["edges"])
    if cycles:
        telemetry.count("elle.search.cycles", cycles)
    result["search"] = s
    return result


def _finish(result: dict, hist, family: str,
            opts: dict | None, key_edges: dict | None = None) -> dict:
    """Shared tail of both public checks: search stats always, a
    verdict certificate when the caller opted in (checker wrappers
    pass opts['certify']; raw bench calls don't pay for proofs)."""
    _with_search(result, key_edges)
    if (opts or {}).get("certify"):
        from . import certify as certify_mod

        certify_mod.attach_elle(hist, result, family)
    return result


def check_list_append(hist, opts: dict | None = None) -> dict:
    """elle.list-append/check equivalent: infers the dependency graph
    from append/read txns and reports anomalies.

    opts["engine"]: "host" (this module's reference implementation),
    "device" (interned arrays + SCC kernel, gpu/elle_device), or "auto"
    (default: device for large histories, host otherwise;
    non-internable histories always fall back to host).
    opts["device"]: None (the card) or "cpu"; resolved unless the
    engine is "host", so a missing card raises."""
    if not isinstance(hist, History):
        hist = History(hist)
    engine = (opts or {}).get("engine", "auto")
    device = (opts or {}).get("device")
    if engine != "host":
        resolve_device(device)
    if engine == "device" or (engine == "auto"
                              and len(hist) >= _DEVICE_MIN_OPS):
        from . import elle_device
        try:
            return _finish(_with_classes(annotate_op_indices(
                elle_device.check_list_append_device(hist, device=device),
                hist), CHECKED_APPEND), hist, "list-append", opts)
        except elle_device.Unvectorizable:
            if engine == "device":
                raise
    a = AppendAnalysis(hist)
    anomalies = dict(a.anomalies)
    for name, ws in cycle_anomalies(len(a.txns), a.edges,
                                    a.txns).items():
        anomalies[name] = ws
    types = sorted(anomalies.keys())
    out = {
        "valid?": not anomalies,
        "anomaly-types": types,
        "anomalies": {k: v[:8] for k, v in anomalies.items()},
        "edge-count": len(a.edges),
        "txn-count": len(a.txns),
    }
    return _finish(_with_classes(annotate_op_indices(out, hist),
                                 CHECKED_APPEND),
                   hist, "list-append", opts, a.key_edges)


def check_rw_register(hist, opts: dict | None = None) -> dict:
    """elle.rw-register/check equivalent over write/read registers,
    assuming distinct written values per key (the generator's
    guarantee). Proven edges only: wr (read-from), ww via
    write-follows-read within a txn, rw against the successor in the
    proven version chain, plus process/realtime order.

    opts["engine"]: "host" (scipy SCC per graded subset), "device"
    (the fully interned array path in elle_device: vectorized edge
    inference + SCC kernel), or "auto" (default: device for large
    histories). Histories the device path can't intern fall back to
    this host implementation, which stays the correctness reference.
    opts["device"]: None (the card) or "cpu"; resolved unless the
    engine is "host"."""
    if not isinstance(hist, History):
        hist = History(hist)
    engine = (opts or {}).get("engine", "auto")
    device = (opts or {}).get("device")
    if engine != "host":
        resolve_device(device)
    want_device = (engine == "device"
                   or (engine == "auto"
                       and len(hist) >= _DEVICE_MIN_OPS))
    if want_device:
        from . import elle_device

        try:
            return _finish(_with_classes(annotate_op_indices(
                elle_device.check_rw_register_device(hist, device=device),
                hist), CHECKED_WR), hist, "rw-register", opts)
        except elle_device.Unvectorizable:
            pass  # host edge inference below; SCC still on device
    txns = collect(hist)
    anomalies: dict[str, list] = defaultdict(list)
    writer: dict = {}
    intermediate: dict = {}  # (k, v) -> txn, for non-final writes
    for t in txns:
        per_key_writes: dict = defaultdict(list)
        for mop in t.mops:
            f, k, v = mop[0], mop[1], mop[2]
            if f == "w":
                key = (k, _freeze(v))
                prev = writer.get(key)
                if (prev is not None and t.type != h.FAIL
                        and prev.type != h.FAIL):
                    anomalies["duplicate-writes"].append(
                        {"key": k, "value": v, "op": t.op})
                if t.type != h.FAIL or prev is None:
                    writer[key] = t
                per_key_writes[k].append(v)
        if t.type != h.FAIL:
            for k, vs in per_key_writes.items():
                for v in vs[:-1]:
                    intermediate[(k, _freeze(v))] = t

    # internal consistency: each mop must agree with the txn's own
    # prior reads/writes of that key (elle.rw-register internal)
    for t in txns:
        if t.type != h.OK:
            continue
        expected: dict = {}
        for mop in t.mops:
            f, k, v = mop[0], mop[1], mop[2]
            if f == "w":
                expected[k] = v
            elif f == "r" and v is not None:
                if k in expected and expected[k] != v:
                    anomalies["internal"].append(
                        {"key": k, "expected": expected[k],
                         "read": v, "op": t.op})
                expected[k] = v

    edges: list[tuple[int, int, int]] = []
    key_edges: dict = defaultdict(int)
    succ: dict = {}  # (k, v) -> next written value, when proven
    for t in txns:
        if t.type != h.OK:
            continue
        last_read: dict = {}
        for mop in t.mops:
            f, k, v = mop[0], mop[1], mop[2]
            if f == "r" and v is not None:
                w = writer.get((k, _freeze(v)))
                if w is None:
                    anomalies["unobservable-read"].append(
                        {"key": k, "value": v, "op": t.op})
                else:
                    if w.type == h.FAIL:
                        anomalies["G1a"].append(
                            {"key": k, "value": v, "op": t.op,
                             "writer": w.op})
                    elif w.i != t.i:
                        iw = intermediate.get((k, _freeze(v)))
                        if iw is not None and iw.i != t.i:
                            anomalies["G1b"].append(
                                {"key": k, "value": v, "op": t.op,
                                 "writer": iw.op})
                        edges.append((w.i, t.i, WR))
                        key_edges[k] += 1
                last_read[k] = v
            elif f == "w":
                # write-follows-read: proven ww + version succession
                pv = last_read.pop(k, None)
                if pv is not None:
                    pw = writer.get((k, _freeze(pv)))
                    if pw is not None and pw.i != t.i:
                        edges.append((pw.i, t.i, WW))
                        key_edges[k] += 1
                    succ[(k, _freeze(pv))] = v
    for t in txns:
        if t.type != h.OK:
            continue
        for k, v in txnlib.ext_reads(t.mops).items():
            if v is None:
                continue
            nv = succ.get((k, _freeze(v)))
            if nv is not None:
                w = writer.get((k, _freeze(nv)))
                if w is not None and w.i != t.i and w.type == h.OK:
                    edges.append((t.i, w.i, RW))
                    key_edges[k] += 1
    committed = [t for t in txns if t.type == h.OK]
    if want_device:
        # unvectorizable values (e.g. strings): edge inference stayed
        # host-side above, but cycle detection still rides the batched
        # device SCC over plain int txn-index edges
        from . import elle_device

        e = (np.asarray(edges, dtype=np.int64).reshape(-1, 3)
             if edges else np.empty((0, 3), dtype=np.int64))
        o_src, o_dst, o_ty = order_edge_arrays(committed)
        src = np.concatenate([e[:, 0], o_src])
        dst = np.concatenate([e[:, 1], o_dst])
        ty = np.concatenate([e[:, 2], o_ty])
        n_edges = int(len(src))
        cyc = elle_device.cycle_anomalies_arrays(
            len(txns), src, dst, ty, txns, device=device)
    else:
        edges.extend(_order_edges(committed))
        n_edges = len(edges)
        cyc = cycle_anomalies(len(txns), edges, txns)
    for name, ws in cyc.items():
        anomalies[name] = ws
    out = {
        "valid?": not anomalies,
        "anomaly-types": sorted(anomalies.keys()),
        "anomalies": {k: v[:8] for k, v in anomalies.items()},
        "edge-count": n_edges,
        "txn-count": len(txns),
    }
    return _finish(_with_classes(annotate_op_indices(out, hist),
                                 CHECKED_WR),
                   hist, "rw-register", opts, key_edges)


# ---------------------------------------------------------------------------
# Streaming elle (checkpoint-and-extend)
# ---------------------------------------------------------------------------

_INF_POS = 1 << 60


class StreamingElle:
    """Incremental committed-txn consumer for the elle families, the
    streaming-wgl contract of the fleet's streams. As chunks arrive,
    the CLOSED txn frontier (txns whose completion is already streamed,
    which does not change as the history grows) extends the dependency
    graph, and the cycle search is scoped to SCCs touching the suffix:
    new txns, or endpoints of edges the previous step had not seen.

    What the stream may claim:
      * a cycle or a monotone read anomaly (G1a, G1b, internal,
        duplicate-appends, incompatible-order: none can un-happen as the
        history grows, given the spine's prefix stability) tightens the
        state to `tentative-invalid` mid-stream;
      * a longer read that REWRITES an already-consumed version-order
        prefix means earlier graph extensions were built on a version
        order the full history contradicts: the stream reports
        `unknown` and stops tightening; the final check decides;
      * `unobservable-read` alone never tightens: the writer may not
        have streamed yet.

    Only list-append streams (its spine IS the observed version order);
    other families report `unsupported` and rely on the final check.

    Checkpoints: after each consumed frontier the `elle` record
    (family, n_closed, per-key versions, the stream's state) goes to
    `ckpt_sink`; `seed()` resumes from a digest-verified record, so a
    restarted server searches only the suffix again. Its cycle search
    is the host engine's (_sccs, _find_cycle), as in the reference.
    """

    _guarded_by_lock = {"_lock": ("_ops", "_since", "_n_closed",
                                  "_versions", "_edges_seen", "_state",
                                  "_inflight", "_frac")}

    STREAM_EVERY = 128

    def __init__(self, family: str, tenant: str = "", run: str = ""):
        self.family = family
        self.tenant = tenant
        self.run = run
        self._ops: list = []
        self._since = 0
        self._lock = threading.Lock()
        self._n_closed = 0
        self._versions: dict[str, list] = {}
        self._edges_seen: set = set()
        self._frac = 0.0
        self._state = "streaming" if family == "list-append" \
            else "unsupported"
        self._inflight = False
        self.ckpt_sink = None  # set at attach time, before streaming

    # -- the stream surface ----------------------------------------------

    def add_ops(self, ops: list) -> None:
        with self._lock:
            self._ops.extend(ops)
            self._since += len(ops)
            due = self._since >= self.STREAM_EVERY
        if due:
            self.step()

    def status(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "checked-frac": round(self._frac, 4),
                    "ops": len(self._ops)}

    def seed(self, ops: list, rec: dict | None) -> bool:
        """Restart recovery: adopt the replayed ops and, when the record
        digest-matches their prefix, the consumed frontier, so the first
        step after a restart searches only the suffix. A stale record is
        counted and ignored (everything is consumed again, never a wrong
        tightening)."""
        resumed = False
        if rec is not None and self._state == "streaming":
            ok = (rec.get("kind") == "elle"
                  and rec.get("family") == self.family
                  and rec.get("n_ops", 0) <= len(ops)
                  and ckpt.ops_digest(ops, rec["n_ops"])
                  == rec.get("digest"))
            if ok:
                resumed = True
                telemetry.count("ckpt.resumed")
            else:
                telemetry.count("ckpt.stale")
        with self._lock:
            self._ops = list(ops)
            if resumed:
                self._n_closed = int(rec["n_closed"])
                self._versions = {str(k): list(v) for k, v
                                  in rec["versions"].items()}
                fr = rec.get("frontier") or {}
                if fr.get("state") in ("tentative-invalid", "unknown"):
                    self._state = fr["state"]
            self._since = max(len(ops), self.STREAM_EVERY)
        return resumed

    def step(self) -> None:
        with self._lock:
            if self._state != "streaming" or self._inflight:
                return
            self._inflight = True
            self._since = 0
        threading.Thread(
            target=self._step_work,
            name=f"elle-stream-{self.tenant}-{self.run}",
            daemon=True).start()

    # -- the consuming step ----------------------------------------------

    @staticmethod
    def _vjson(v):
        return fmt.jsonable(_freeze(v))

    def _settle(self, state: str | None = None) -> None:
        with self._lock:
            self._inflight = False
            if state is not None:
                self._state = state
            elif self._since < self.STREAM_EVERY:
                self._since = self.STREAM_EVERY

    def _step_work(self) -> None:
        try:
            with self._lock:
                snapshot = list(self._ops)
                lo = self._n_closed
                old_versions = {k: list(v) for k, v
                                in self._versions.items()}
                edges_seen = set(self._edges_seen)
            a = AppendAnalysis(History(snapshot))
            closed = sum(1 for t in a.txns if t.complete_pos < _INF_POS)
            if closed <= lo:
                return self._settle()
            # an already-consumed version-order prefix was rewritten by
            # a longer read: the graph extensions consumed so far may be
            # wrong, so the stream says unknown
            new_versions = {str(k): [self._vjson(v) for v in sp]
                            for k, sp in a.spine.items()}
            for k, old in old_versions.items():
                if new_versions.get(k, [])[:len(old)] != old:
                    telemetry.count("elle.stream.reordered")
                    return self._settle("unknown")
            # monotone read anomalies tighten at once; unobservable-read
            # is indecision (its writer may stream later)
            monotone = {name: recs for name, recs in a.anomalies.items()
                        if name != "unobservable-read" and recs}
            # only SCCs touching a new txn or a new edge can hold a new
            # cycle
            new_edges = [e for e in a.edges if e not in edges_seen]
            touched = {e[0] for e in new_edges} \
                | {e[1] for e in new_edges}
            cyclic = False
            for scc in _sccs(len(a.txns), a.edges):
                if not (touched & set(scc) or any(i >= lo for i in scc)):
                    continue
                if _find_cycle(scc, a.edges):
                    cyclic = True
                    break
            with self._lock:
                self._inflight = False
                if self._state != "streaming":
                    return
                self._n_closed = closed
                self._versions = new_versions
                self._edges_seen = set(a.edges)
                self._frac = closed / max(len(a.txns), 1)
                if monotone or cyclic:
                    self._state = "tentative-invalid"
                    telemetry.count("elle.stream.tentative-invalid")
            telemetry.count("elle.stream.segments")
            self._checkpoint(snapshot, closed, new_versions, len(a.edges))
        except Exception:  # noqa: BLE001 — the stream is advisory
            logging.getLogger(__name__).exception(
                "streaming elle step failed")
            return self._settle("unknown")
        with self._lock:
            pending = (self._state == "streaming"
                       and self._since >= self.STREAM_EVERY)
        if pending:
            self.step()

    def _checkpoint(self, snapshot, closed, versions, n_edges) -> None:
        sink = self.ckpt_sink
        if sink is None:
            return
        with self._lock:
            state = self._state
        try:
            sink({"v": ckpt.VERSION, "kind": "elle",
                  "family": self.family, "n_closed": closed,
                  "versions": versions,
                  "frontier": {"state": state, "edges": n_edges},
                  "n_ops": len(snapshot),
                  "digest": ckpt.ops_digest(snapshot)})
        except Exception:  # noqa: BLE001 — checkpoints are advisory
            logging.getLogger(__name__).exception(
                "elle stream checkpoint sink failed")
