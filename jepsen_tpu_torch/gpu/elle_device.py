"""Device-path elle analysis (jepsen_tpu/tpu/elle_device.py, ported):
interned int arrays + vectorized edge inference + the SCC kernel.

Capability reference: elle 0.2.1 behind
jepsen/src/jepsen/tests/cycle/append.clj:6-27 — infer ww/wr/rw
dependency edges from txn external reads/writes, search for cycles,
classify anomalies. The host engine (gpu/elle) is the correctness
reference; this module re-derives the same anomalies with:

  1. one flattening pass turning txn micro-ops into dense int arrays
     (txn ids, interned keys, (key, value) pair ids);
  2. numpy segment ops for writer resolution, version orders (spines),
     read anomalies (G1a/G1b/internal/unobservable/incompatible), and
     ww/wr/rw edge inference — no per-element Python;
  3. cycle detection through the label-propagation SCC kernel (gpu/scc)
     on the card (device=None) or its plain version (device="cpu"),
     host scipy for small graphs and when the kernel's caps are hit;
  4. host-side cycle witness extraction and classification (shared
     with the host engine).

Histories whose append values aren't machine ints (or whose key/value
ranges overflow the pair packing) raise Unvectorizable and the caller
drops to the host engine, so the fast path never changes results.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .. import history as h
from .. import telemetry
from ..device import resolve_device
from ..history import History
from . import profiler, spmd
from . import scc as scc_mod
from .elle import (EDGE_NAMES, PROC, RT, RW, WR, WW, Txn, _classify,
                   _find_cycle, collect, order_edges_from_arrays)

_TYPE_OK, _TYPE_INFO, _TYPE_FAIL = 0, 1, 2
_T_CODE = {h.OK: _TYPE_OK, h.INFO: _TYPE_INFO, h.FAIL: _TYPE_FAIL}

_KEY_BITS = 23
_VAL_BITS = 40


class Unvectorizable(Exception):
    """History can't take the int-array fast path."""


def _dense_first_seen(xs: np.ndarray) -> np.ndarray:
    """Raw ids -> dense codes in FIRST-SEEN order, matching the
    Python flattener's process interning dict."""
    if not len(xs):
        return xs
    _u, first, inv = np.unique(xs, return_index=True,
                               return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return rank[inv]


def _txn_mops(ops: list, arrs: dict, ti: int):
    """A txn's effective micro-ops, mirroring collect(): the completion
    value for committed txns (unless None), else the invocation's."""
    op = ops[int(arrs["t_opidx"][ti])]
    if int(arrs["t_type"][ti]) == _TYPE_OK and op.value is not None:
        return op.value
    return ops[int(arrs["t_inv"][ti])].value or []


def _internal_from_flags(ops: list, arrs: dict) -> list[tuple]:
    """Replays the own-append suffix rule for the (rare) reads the C
    flattener flagged: a committed read of a key the same txn appended
    to earlier must end with the txn's own appends, in order."""
    out: list[tuple] = []
    flags = arrs["flag_rd"]
    if not len(flags):
        return out
    for ti in np.unique(arrs["rd_txn"][flags]):
        op = ops[int(arrs["t_opidx"][ti])]
        own: dict = {}
        for mop in _txn_mops(ops, arrs, int(ti)):
            f, k, v = mop[0], mop[1], mop[2]
            if f == "append":
                own.setdefault(k, []).append(v)
            elif f == "r" and v is not None:
                vs = list(v)
                pre = own.get(k)
                if pre and vs[-len(pre):] != pre:
                    out.append((int(ti), k, {
                        "key": k, "expected-suffix": list(pre),
                        "read": vs, "op": op}))
    return out


class Flat:
    """Dense-array view of a list-append history. Two constructors:
    the Python loop over collected Txn objects (reference semantics),
    and from_native() over the C flattener's arrays (native/elleflat.c,
    one C pass over the raw op list — the fast path; differential
    tests pin the two to identical arrays)."""

    @classmethod
    def from_native(cls, ops: list, arrs: dict, keys: list) -> "Flat":
        self = cls.__new__(cls)
        self.n = len(arrs["t_type"])
        self.t_type = arrs["t_type"].astype(np.int8)
        self.t_inv = arrs["t_inv"]
        self.t_comp = arrs["t_comp"]
        self.t_proc = _dense_first_seen(arrs["t_proc"])
        self.t_opidx = arrs["t_opidx"]
        self.key_names = keys
        for f in ("ap_txn", "ap_key", "ap_val", "rd_txn", "rd_key",
                  "rd_len", "re_vals"):
            setattr(self, f, arrs[f])
        self.rd_off = np.concatenate(
            [[0], np.cumsum(self.rd_len)])[:-1].astype(np.int64)
        self.re_read = np.repeat(np.arange(len(self.rd_txn)),
                                 self.rd_len)
        # The C pass flags reads whose txn appended the same key
        # earlier; only those few txns replay the own-suffix rule here.
        self.internal_bad = _internal_from_flags(ops, arrs)
        return self

    def __init__(self, txns: list[Txn]):
        self.txns = txns
        n = len(txns)
        self.n = n
        self.t_type = np.fromiter((_T_CODE[t.type] for t in txns),
                                  dtype=np.int8, count=n)
        self.t_inv = np.fromiter((t.invoke_pos for t in txns),
                                 dtype=np.int64, count=n)
        self.t_comp = np.fromiter((t.complete_pos for t in txns),
                                  dtype=np.int64, count=n)
        proc_ids: dict = {}
        self.t_proc = np.fromiter(
            (proc_ids.setdefault(t.process, len(proc_ids))
             for t in txns), dtype=np.int64, count=n)

        key_ids: dict = {}
        ap_txn: list[int] = []
        ap_key: list[int] = []
        ap_val: list[int] = []
        rd_txn: list[int] = []
        rd_key: list[int] = []
        rd_len: list[int] = []
        re_vals: list[int] = []
        internal_bad: list[tuple] = []  # (txn_i, key_id, record)

        for t in txns:
            own: dict = {}
            consider_reads = t.type == h.OK
            for mop in t.mops:
                f, k, v = mop[0], mop[1], mop[2]
                kid = key_ids.get(k)
                if kid is None:
                    kid = key_ids[k] = len(key_ids)
                if f == "append":
                    if type(v) is not int or not (0 <= v < (1 << _VAL_BITS)):
                        raise Unvectorizable(f"append value {v!r}")
                    ap_txn.append(t.i)
                    ap_key.append(kid)
                    ap_val.append(v)
                    own.setdefault(kid, []).append(v)
                elif f == "r":
                    if v is None or not consider_reads:
                        continue
                    vs = list(v)
                    for x in vs:
                        if type(x) is not int or not (
                                0 <= x < (1 << _VAL_BITS)):
                            raise Unvectorizable(f"read value {x!r}")
                    rd_txn.append(t.i)
                    rd_key.append(kid)
                    rd_len.append(len(vs))
                    re_vals.extend(vs)
                    pre = own.get(kid)
                    if pre and vs[-len(pre):] != pre:
                        internal_bad.append((t.i, kid, {
                            "key": k, "expected-suffix": list(pre),
                            "read": vs, "op": t.op}))
        if len(key_ids) >= (1 << _KEY_BITS):
            raise Unvectorizable("too many keys for pair packing")

        self.key_names = list(key_ids)
        self.ap_txn = np.asarray(ap_txn, dtype=np.int64)
        self.ap_key = np.asarray(ap_key, dtype=np.int64)
        self.ap_val = np.asarray(ap_val, dtype=np.int64)
        self.rd_txn = np.asarray(rd_txn, dtype=np.int64)
        self.rd_key = np.asarray(rd_key, dtype=np.int64)
        self.rd_len = np.asarray(rd_len, dtype=np.int64)
        self.re_vals = np.asarray(re_vals, dtype=np.int64)
        self.rd_off = np.concatenate(
            [[0], np.cumsum(self.rd_len)])[:-1]
        self.re_read = np.repeat(np.arange(len(rd_txn)), self.rd_len)
        self.internal_bad = internal_bad


def _pack(keys: np.ndarray, vals: np.ndarray) -> np.ndarray:
    return (keys << _VAL_BITS) | vals


class DeviceAppendAnalysis:
    """Mirrors elle.AppendAnalysis over Flat arrays. Flattening runs
    through the C pass (native.elle_flatten) when available; txn/op
    objects materialize lazily, only for anomaly witnesses."""

    _KIND = 0
    _FLAT_CLS = Flat

    def __init__(self, hist: History):
        self._ops = list(hist)
        self.txns: list[Txn] | None = None
        self.flat = self._flatten(hist)
        self.anomalies: dict[str, list] = defaultdict(list)
        self._resolve_writers()
        self._spines()
        self._read_anomalies()
        (self.edge_src, self.edge_dst, self.edge_ty,
         self.edge_key) = self._edges()

    def _flatten(self, hist: History):
        from .. import native

        try:
            arrs, keys = native.elle_flatten(self._ops, self._KIND)
            telemetry.count("elle.flatten.native")
            return self._FLAT_CLS.from_native(self._ops, arrs, keys)
        except native.NotVectorizable as e:
            raise Unvectorizable(str(e)) from e
        except RuntimeError:
            telemetry.count("elle.flatten.python")
            self.txns = collect(hist)
            return self._FLAT_CLS(self.txns)

    def _op(self, ti: int):
        """The witness op for txn row ti (lazy: no Txn objects on the
        native path)."""
        if self.txns is not None:
            return self.txns[int(ti)].op
        return self._ops[int(self.flat.t_opidx[int(ti)])]

    @property
    def n(self) -> int:
        return self.flat.n

    # -- writers -----------------------------------------------------------

    def _resolve_writers(self):
        f = self.flat
        A = len(f.ap_txn)
        ap_code = _pack(f.ap_key, f.ap_val)
        re_code = (_pack(f.rd_key[f.re_read], f.re_vals)
                   if len(f.re_vals) else np.empty(0, dtype=np.int64))
        # dense pair ids over appends AND read elements, so value-based
        # lookups (spine successors) work even for values no append
        # wrote (the host engine keys its nxt dict by raw value)
        codes = np.unique(np.concatenate([ap_code, re_code]))
        self.pair_codes = codes            # sorted unique codes [P]
        P = len(codes)
        inv = np.searchsorted(codes, ap_code)
        self.ap_pid = inv                  # pid per append
        order = np.arange(A)
        nonfail = f.t_type[f.ap_txn] != _TYPE_FAIL
        # writer append-row per pid: last non-fail, else first append;
        # pids nothing appended keep w_txn == -1
        last_nf = np.full(P, -1, dtype=np.int64)
        if A:
            np.maximum.at(last_nf, inv[nonfail], order[nonfail])
        first_any = np.full(P, -1, dtype=np.int64)
        if A:
            has = np.zeros(P, dtype=bool)
            has[inv] = True
            first_of = np.full(P, A, dtype=np.int64)
            np.minimum.at(first_of, inv, order)
            first_any[has] = first_of[has]
        w_row = np.where(last_nf >= 0, last_nf, first_any)
        self.w_txn = np.where(w_row >= 0, f.ap_txn[np.clip(w_row, 0, None)]
                              if A else -1, -1)            # [P]
        self.w_fail = np.where(
            self.w_txn >= 0,
            f.t_type[np.clip(self.w_txn, 0, None)] == _TYPE_FAIL,
            False)                                         # [P]
        # j (index among txn's appends to key) and tot, per append row
        grp = np.lexsort((order, f.ap_key, f.ap_txn))
        gk = np.stack([f.ap_txn[grp], f.ap_key[grp]], axis=1)
        new_grp = np.ones(A, dtype=bool)
        if A > 1:
            new_grp[1:] = (gk[1:] != gk[:-1]).any(axis=1)
        grp_id = np.cumsum(new_grp) - 1
        starts = np.flatnonzero(new_grp)
        j_sorted = np.arange(A) - starts[grp_id]
        counts = np.bincount(grp_id, minlength=starts.size)
        tot_sorted = counts[grp_id]
        j = np.empty(A, dtype=np.int64)
        tot = np.empty(A, dtype=np.int64)
        j[grp] = j_sorted
        tot[grp] = tot_sorted
        self.w_j = np.where(w_row >= 0,
                            j[np.clip(w_row, 0, None)] if A else -1, -1)
        self.w_tot = np.where(w_row >= 0,
                              tot[np.clip(w_row, 0, None)] if A else -1,
                              -1)
        # duplicate-appends: non-fail appends beyond the first non-fail
        # of their pid (mirrors the host writer-overwrite rule)
        if A:
            sub = np.flatnonzero(nonfail)
            if sub.size:
                srt = sub[np.argsort(inv[sub], kind="stable")]
                pid_s = inv[srt]
                first_of = np.ones(srt.size, dtype=bool)
                first_of[1:] = pid_s[1:] != pid_s[:-1]
                for row in srt[~first_of]:
                    self.anomalies["duplicate-appends"].append({
                        "key": f.key_names[f.ap_key[row]],
                        "value": int(f.ap_val[row]),
                        "op": self._op(f.ap_txn[row])})
        # possibly-committed writer txns per key (for empty-read rw)
        nf_k = f.ap_key[nonfail]
        nf_t = f.ap_txn[nonfail]
        kt = np.unique(np.stack([nf_k, nf_t], axis=1), axis=0) \
            if nf_k.size else np.empty((0, 2), dtype=np.int64)
        self.wk_key, self.wk_txn = kt[:, 0], kt[:, 1]

    def _pid_of(self, keys, vals) -> np.ndarray:
        """pid per (key, val); -1 only for pairs seen neither in an
        append nor in any read (writerless pairs have a pid with
        w_txn[pid] == -1)."""
        codes = _pack(np.asarray(keys, dtype=np.int64),
                      np.asarray(vals, dtype=np.int64))
        if len(self.pair_codes) == 0:
            return np.full(len(codes), -1, dtype=np.int64)
        pos = np.searchsorted(self.pair_codes, codes)
        pos = np.clip(pos, 0, len(self.pair_codes) - 1)
        return np.where(self.pair_codes[pos] == codes, pos, -1)

    # -- version orders ----------------------------------------------------

    def _spines(self):
        f = self.flat
        R = len(f.rd_txn)
        K = len(f.key_names)
        # spine read per key: longest, earliest on ties (host tie-break)
        self.spine_read = np.full(K, -1, dtype=np.int64)
        self.spine_len = np.zeros(K, dtype=np.int64)
        if R:
            order = np.lexsort((np.arange(R), -f.rd_len, f.rd_key))
            first = np.ones(R, dtype=bool)
            kk = f.rd_key[order]
            first[1:] = kk[1:] != kk[:-1]
            sel = order[first]
            keep = f.rd_len[sel] > 0
            self.spine_read[kk[first][keep]] = sel[keep]
            self.spine_len[kk[first][keep]] = f.rd_len[sel][keep]
        # flat spine arrays
        srd = self.spine_read[self.spine_read >= 0]
        skey = np.flatnonzero(self.spine_read >= 0)
        self.sp_key_of = skey
        lens = f.rd_len[srd] if srd.size else np.empty(0, dtype=np.int64)
        self.sp_off = np.zeros(K, dtype=np.int64)
        off = np.concatenate([[0], np.cumsum(lens)])[:-1] \
            if srd.size else np.empty(0, dtype=np.int64)
        self.sp_off[skey] = off
        # gather spine element values
        idx = []
        for r in srd:
            idx.append(np.arange(f.rd_off[r], f.rd_off[r] + f.rd_len[r]))
        self.sp_vals = (f.re_vals[np.concatenate(idx)] if idx
                        else np.empty(0, dtype=np.int64))
        self.sp_keys = np.repeat(skey, lens) if srd.size else \
            np.empty(0, dtype=np.int64)
        self.sp_pid = self._pid_of(self.sp_keys, self.sp_vals)
        # successor pid along each spine
        P = len(self.pair_codes)
        self.pair_nxt = np.full(P, -1, dtype=np.int64)
        if len(self.sp_pid) > 1:
            same = self.sp_keys[1:] == self.sp_keys[:-1]
            a = self.sp_pid[:-1][same]
            b = self.sp_pid[1:][same]
            good = a >= 0
            self.pair_nxt[a[good]] = b[good]
        # incompatible-order: each read must be a prefix of its spine
        if R:
            too_long = f.rd_len > self.spine_len[f.rd_key]
            elem_pos = np.arange(len(f.re_vals)) - f.rd_off[f.re_read]
            sp_at = self.sp_off[f.rd_key[f.re_read]] + elem_pos
            in_range = elem_pos < self.spine_len[f.rd_key[f.re_read]]
            if len(self.sp_vals):
                sp_val = np.where(in_range, self.sp_vals[
                    np.clip(sp_at, 0, len(self.sp_vals) - 1)], -1)
            else:
                sp_val = np.full(len(f.re_vals), -1, dtype=np.int64)
            mismatch = np.where(in_range, sp_val != f.re_vals, True)
            bad = too_long.copy()
            np.logical_or.at(bad, f.re_read, mismatch)
            for r in np.flatnonzero(bad):
                o, n_ = int(f.rd_off[r]), int(f.rd_len[r])
                k = int(f.rd_key[r])
                so, sl = int(self.sp_off[k]), int(self.spine_len[k])
                self.anomalies["incompatible-order"].append({
                    "key": f.key_names[k],
                    "read": f.re_vals[o:o + n_].tolist(),
                    "spine": self.sp_vals[so:so + sl].tolist(),
                    "op": self._op(f.rd_txn[r])})

    # -- read anomalies ----------------------------------------------------

    def _read_anomalies(self):
        f = self.flat
        re_pid = self._pid_of(f.rd_key[f.re_read], f.re_vals)
        self.re_pid = re_pid
        # every read element has a pid now; writerless pairs carry -1
        re_w = np.where(re_pid >= 0,
                        self.w_txn[np.clip(re_pid, 0, None)]
                        if len(self.w_txn) else -1, -1)
        unobs = re_w < 0
        for i in np.flatnonzero(unobs):
            r = f.re_read[i]
            self.anomalies["unobservable-read"].append({
                "key": f.key_names[f.rd_key[r]],
                "value": int(f.re_vals[i]), "op": self._op(f.rd_txn[r])})
        aborted = np.zeros(len(re_pid), dtype=bool)
        if len(self.w_txn):
            aborted[~unobs] = self.w_fail[re_pid[~unobs]]
        for i in np.flatnonzero(aborted):
            r = f.re_read[i]
            self.anomalies["G1a"].append({
                "key": f.key_names[f.rd_key[r]],
                "value": int(f.re_vals[i]), "op": self._op(f.rd_txn[r]),
                "writer": self._op(self.w_txn[re_pid[i]])})
        # G1b: last element is an intermediate version of another txn
        nz = np.flatnonzero(f.rd_len > 0)
        last_idx = f.rd_off[nz] + f.rd_len[nz] - 1
        last_pid = re_pid[last_idx]
        self.nz_reads = nz
        self.last_pid = last_pid
        if not len(self.w_txn):
            for _ti, _kid, rec in f.internal_bad:
                self.anomalies["internal"].append(rec)
            return
        wi = np.clip(last_pid, 0, None)
        has_w = (last_pid >= 0) & (self.w_txn[wi] >= 0)
        g1b = has_w & (self.w_j[wi] != self.w_tot[wi] - 1) & \
            (self.w_txn[wi] != f.rd_txn[nz])
        for i in np.flatnonzero(g1b):
            r = nz[i]
            o = int(f.rd_off[r] + f.rd_len[r] - 1)
            self.anomalies["G1b"].append({
                "key": f.key_names[f.rd_key[r]],
                "value": int(f.re_vals[o]), "op": self._op(f.rd_txn[r]),
                "writer": self._op(self.w_txn[last_pid[i]])})
        for _ti, _kid, rec in f.internal_bad:
            self.anomalies["internal"].append(rec)

    # -- edges -------------------------------------------------------------

    def _edges(self):
        f = self.flat
        srcs: list[np.ndarray] = []
        dsts: list[np.ndarray] = []
        tys: list[np.ndarray] = []
        kks: list[np.ndarray] = []

        def emit(s, d, ty, kk=None):
            # kk: the key each dependency edge belongs to (-1 for
            # cross-key session/realtime order): the sharded SCC's
            # key-block layout (gpu/scc.py)
            s = np.asarray(s, dtype=np.int64)
            if s.size:
                srcs.append(s)
                dsts.append(np.asarray(d, dtype=np.int64))
                tys.append(np.full(s.size, ty, dtype=np.int64))
                kks.append(np.full(s.size, -1, dtype=np.int64)
                           if kk is None
                           else np.asarray(kk, dtype=np.int64))

        # ww: consecutive distinct valid writers along each spine
        if len(self.w_txn):
            spw = np.where(self.sp_pid >= 0,
                           self.w_txn[np.clip(self.sp_pid, 0, None)], -1)
            valid = (spw >= 0) & ~self.w_fail[
                np.clip(self.sp_pid, 0, None)]
        else:
            spw = np.empty(0, dtype=np.int64)
            valid = np.zeros(len(self.sp_pid), dtype=bool)
        vk = self.sp_keys[valid]
        vt = spw[valid]
        if vt.size > 1:
            same = vk[1:] == vk[:-1]
            diff = vt[1:] != vt[:-1]
            emit(vt[:-1][same & diff], vt[1:][same & diff], WW,
                 vk[1:][same & diff])
        # wr and rw from each non-empty read's last element
        nz, last_pid = self.nz_reads, self.last_pid
        reader = f.rd_txn[nz]
        rkey = f.rd_key[nz]
        if len(self.w_txn):
            wi = np.clip(last_pid, 0, None)
            has_w = (last_pid >= 0) & (self.w_txn[wi] >= 0)
            wr_ok = has_w & (self.w_txn[wi] != reader) & ~self.w_fail[wi]
            emit(self.w_txn[wi[wr_ok]], reader[wr_ok], WR, rkey[wr_ok])
            # nxt is value-based (host keys its dict by raw value), so
            # the anti-dependency fires even when the read's last
            # element itself has no writer (unobservable value)
            nxt = np.where(last_pid >= 0, self.pair_nxt[wi], -1)
            has_n = nxt >= 0
            ni = np.where(has_n, nxt, 0)
            rw_ok = has_n & (self.w_txn[ni] >= 0) & \
                (self.w_txn[ni] != reader) & ~self.w_fail[ni]
            emit(reader[rw_ok], self.w_txn[ni[rw_ok]], RW, rkey[rw_ok])
        # empty reads: rw to first spine writer + off-spine writers
        ez = np.flatnonzero(f.rd_len == 0)
        if ez.size:
            K = len(f.key_names)
            # first valid spine writer per key
            first_w = np.full(K, -1, dtype=np.int64)
            if vt.size:
                rev_k = vk[::-1]
                rev_t = vt[::-1]
                first_w[rev_k] = rev_t  # earliest wins (reverse order)
            # spine writer txn set per (key, txn)
            if vt.size:
                sp_kt = np.unique(np.stack([vk, vt], axis=1), axis=0)
                sp_kt_code = sp_kt[:, 0] * (self.flat.n + 1) + sp_kt[:, 1]
            else:
                sp_kt_code = np.empty(0, dtype=np.int64)
            wk_code = self.wk_key * (self.flat.n + 1) + self.wk_txn
            off_spine = ~np.isin(wk_code, sp_kt_code)
            tk_key = np.concatenate([
                self.wk_key[off_spine],
                np.flatnonzero(first_w >= 0)])
            tk_txn = np.concatenate([
                self.wk_txn[off_spine], first_w[first_w >= 0]])
            t_order = np.argsort(tk_key, kind="stable")
            tk_key, tk_txn = tk_key[t_order], tk_txn[t_order]
            cnt = np.bincount(tk_key, minlength=K)
            off = np.concatenate([[0], np.cumsum(cnt)])[:-1]
            ek = f.rd_key[ez]
            reps = cnt[ek]
            er_src = np.repeat(f.rd_txn[ez], reps)
            base = np.repeat(off[ek], reps)
            step = np.arange(reps.sum()) - np.repeat(
                np.concatenate([[0], np.cumsum(reps)])[:-1], reps)
            er_dst = tk_txn[base + step]
            keep = er_src != er_dst
            emit(er_src[keep], er_dst[keep], RW,
                 np.repeat(ek, reps)[keep])
        # session order + realtime: the host engine's sweep, shared
        comm = np.flatnonzero(self.flat.t_type == _TYPE_OK)
        if comm.size:
            fl = self.flat
            o_src, o_dst, o_ty = order_edges_from_arrays(
                comm, fl.t_inv[comm], fl.t_comp[comm], fl.t_proc[comm])
            if o_src.size:
                srcs.append(o_src)
                dsts.append(o_dst)
                tys.append(o_ty)
                kks.append(np.full(o_src.size, -1, dtype=np.int64))
        if not srcs:
            e = np.empty(0, dtype=np.int64)
            return e, e, e, e
        src = np.concatenate(srcs)
        dst = np.concatenate(dsts)
        ty = np.concatenate(tys)
        kk = np.concatenate(kks)
        code = (src * (self.flat.n + 1) + dst) * 8 + ty
        _, keep = np.unique(code, return_index=True)
        keep.sort()
        return src[keep], dst[keep], ty[keep], kk[keep]


_SUBSETS = ((WW,), (WW, WR), (WW, WR, RW), (WW, WR, RW, PROC),
            (WW, WR, RW, PROC, RT))


def cycle_anomalies_arrays(n: int, src, dst, ty, txns, device=None,
                           ekey=None) -> dict[str, list]:
    """elle.cycle_anomalies over edge arrays: SCCs per cumulative edge
    subset via the SCC kernel, witnesses extracted host-side. txns is
    either a Txn list or a callable ti -> witness op (the lazy accessor
    of the native flattening path). device: None (the card) or "cpu"
    (the kernel's plain version). ekey: per-edge key ids for the sharded
    SCC's key-block edge layout."""
    op_of = txns if callable(txns) else (lambda i: txns[i].op)
    out: dict[str, list] = defaultdict(list)
    if not len(src):
        return out
    if (ekey is not None and len(ekey) == len(src)
            and len(src) >= scc_mod.DEVICE_MIN_EDGES
            and spmd.route(resolve_device(device), len(src)) is not None):
        # order edges into key blocks ONCE: up to six SCC solves below
        # share the same edge array (only the subset mask differs), and
        # Edges skips its own argsort when the array is already
        # key-sorted. Gated as Edges's sharded layout is: anywhere else
        # the layout is never used and the sort and copies would be
        # pure overhead.
        order = np.argsort(np.asarray(ekey), kind="stable")
        src = np.asarray(src)[order]
        dst = np.asarray(dst)[order]
        ty = np.asarray(ty)[order]
        ekey = np.asarray(ekey)[order]
    # Early exit: subset edges are subsets of the full graph, so a
    # clean full graph proves every graded subset clean too — valid
    # histories cost ONE device SCC instead of five.
    graph = scc_mod.Edges(n, src, dst, device, ekey=ekey)
    full = graph.scc()
    if not scc_mod.nontrivial_from_labels(full):
        return out
    seen: set = set()
    for sub in _SUBSETS:
        # boolean mask over ONE shared edge array. The final subset is
        # the full graph, already solved above.
        mask = np.isin(ty, sub)
        if not mask.any():
            continue
        labels = full if sub == _SUBSETS[-1] else graph.scc(mask)
        groups = scc_mod.nontrivial_from_labels(labels)
        if not groups:
            continue
        # a group is every node of one label, so its edges are the
        # subset's edges whose ends both carry that label: one pass over
        # the edges, grouped by label in edge order (the reference tests
        # membership of every edge for every group)
        lab = np.asarray(labels)
        inner = np.flatnonzero(mask & (lab[src] == lab[dst]))
        inner = inner[np.argsort(lab[src[inner]], kind="stable")]
        inner_lab = lab[src[inner]]
        for members in groups:
            key = frozenset(int(x) for x in members)
            if key in seen:
                continue
            seen.add(key)
            g = lab[members[0]]
            em = inner[np.searchsorted(inner_lab, g, "left"):
                       np.searchsorted(inner_lab, g, "right")]
            edges = [(int(a), int(b), int(c))
                     for a, b, c in zip(src[em], dst[em], ty[em])]
            cycle = _find_cycle(sorted(int(x) for x in members), edges)
            if not cycle:
                continue
            name = _classify(cycle)
            out[name].append({
                "cycle": [op_of(a) for a, _b, _c in cycle],
                "steps": [{"from": a, "to": b, "type": EDGE_NAMES[c]}
                          for a, b, c in cycle]})
    return out


def check_list_append_device(hist, device=None) -> dict:
    """Drop-in device-path analog of elle.check_list_append. Raises
    Unvectorizable when the history can't be interned. device: None
    (the card) or "cpu"."""
    resolve_device(device)
    if not isinstance(hist, History):
        hist = History(hist)
    prof = profiler.get()
    rec = prof.begin("elle-append")
    with telemetry.span("elle:list-append") as sp:
        with prof.phase(rec, "encode_ns"):
            # host side: flatten + edge inference (the SCC launches
            # inside cycle_anomalies_arrays profile themselves)
            a = DeviceAppendAnalysis(hist)
        sp["attrs"] = {"txns": a.flat.n, "edges": int(len(a.edge_src))}
    return _cycle_result(a, device, rec)


def _cycle_result(a, device, rec: dict) -> dict:
    """The shared tail of both device checks: telemetry, the cycle
    search over the analysis's edge arrays (the profiler record's
    compute_ns), and the result dict."""
    prof = profiler.get()
    telemetry.count("elle.txns", a.flat.n)
    telemetry.count("elle.edges", int(len(a.edge_src)))
    rec.update(txns=a.flat.n, edges=int(len(a.edge_src)))
    anomalies = dict(a.anomalies)
    with telemetry.span("elle:cycles"), prof.phase(rec, "compute_ns"):
        for name, ws in cycle_anomalies_arrays(
                a.flat.n, a.edge_src, a.edge_dst, a.edge_ty, a._op,
                device=device, ekey=a.edge_key).items():
            anomalies[name] = ws
    prof.finish(rec)
    return {
        "valid?": not anomalies,
        "anomaly-types": sorted(anomalies.keys()),
        "anomalies": {k: v[:8] for k, v in anomalies.items()},
        "edge-count": int(len(a.edge_src)),
        "txn-count": a.flat.n,
    }


# ---------------------------------------------------------------------------
# rw-register device path
# ---------------------------------------------------------------------------

class RwFlat:
    """Dense-array view of a write/read-register history (the
    rw-register analog of Flat). One Python pass collects writes
    (all txn types — they all claim writer slots), committed reads,
    write-follows-read pairs, external reads, and the per-txn internal
    anomalies; everything downstream is numpy over packed (key, value)
    codes."""

    @classmethod
    def from_native(cls, ops: list, arrs: dict, keys: list) -> "RwFlat":
        self = cls.__new__(cls)
        self.n = len(arrs["t_type"])
        self.t_type = arrs["t_type"].astype(np.int8)
        self.t_inv = arrs["t_inv"]
        self.t_comp = arrs["t_comp"]
        self.t_proc = _dense_first_seen(arrs["t_proc"])
        self.t_opidx = arrs["t_opidx"]
        self.key_names = keys
        for f in ("wr_txn", "wr_key", "wr_val", "wr_nonfinal",
                  "rd_txn", "rd_key", "rd_val",
                  "fr_txn", "fr_key", "fr_prev", "fr_new",
                  "er_txn", "er_key", "er_val"):
            setattr(self, f, arrs[f])
        # internal anomalies: the C pass records (read row, expected)
        self.internal_bad = [
            {"key": keys[int(self.rd_key[r])],
             "expected": int(e), "read": int(self.rd_val[r]),
             "op": ops[int(arrs["t_opidx"][self.rd_txn[r]])]}
            for r, e in zip(arrs["int_row"], arrs["int_expected"])]
        return self

    def __init__(self, txns: list[Txn]):
        self.txns = txns
        n = len(txns)
        self.t_type = np.fromiter((_T_CODE[t.type] for t in txns),
                                  dtype=np.int8, count=n)
        self.t_inv = np.fromiter((t.invoke_pos for t in txns),
                                 dtype=np.int64, count=n)
        self.t_comp = np.fromiter((t.complete_pos for t in txns),
                                  dtype=np.int64, count=n)
        proc_ids: dict = {}
        self.t_proc = np.fromiter(
            (proc_ids.setdefault(t.process, len(proc_ids))
             for t in txns), dtype=np.int64, count=n)
        key_ids: dict = {}
        wr_txn: list[int] = []
        wr_key: list[int] = []
        wr_val: list[int] = []
        wr_nonfinal: list[int] = []  # row indices of non-final writes
        rd_txn: list[int] = []
        rd_key: list[int] = []
        rd_val: list[int] = []
        fr_txn: list[int] = []       # write-follows-read rows
        fr_key: list[int] = []
        fr_prev: list[int] = []
        fr_new: list[int] = []
        er_txn: list[int] = []       # external reads
        er_key: list[int] = []
        er_val: list[int] = []
        internal_bad: list[dict] = []

        def check_val(v):
            if type(v) is not int or not (0 <= v < (1 << _VAL_BITS)):
                raise Unvectorizable(f"register value {v!r}")

        for t in txns:
            ok = t.type == h.OK
            nonfail = t.type != h.FAIL
            expected: dict = {}
            last_read: dict = {}
            written: set = set()
            er_seen: set = set()
            per_key_rows: dict = {}
            for mop in t.mops:
                f, k, v = mop[0], mop[1], mop[2]
                kid = key_ids.get(k)
                if kid is None:
                    kid = key_ids[k] = len(key_ids)
                if f == "w":
                    check_val(v)
                    row = len(wr_txn)
                    wr_txn.append(t.i)
                    wr_key.append(kid)
                    wr_val.append(v)
                    if nonfail:
                        per_key_rows.setdefault(kid, []).append(row)
                    if ok:
                        pv = last_read.pop(kid, None)
                        if pv is not None:
                            fr_txn.append(t.i)
                            fr_key.append(kid)
                            fr_prev.append(pv)
                            fr_new.append(v)
                        expected[kid] = v
                    written.add(kid)
                elif f == "r" and ok:
                    if v is None:
                        # A None first read IS the key's external read
                        # (txnlib.ext_reads records it; the host rw
                        # pass then skips the key) — a later valued
                        # read must NOT be promoted to external
                        if kid not in written:
                            er_seen.add(kid)
                        continue
                    check_val(v)
                    rd_txn.append(t.i)
                    rd_key.append(kid)
                    rd_val.append(v)
                    if kid in expected and expected[kid] != v:
                        internal_bad.append(
                            {"key": k, "expected": expected[kid],
                             "read": v, "op": t.op})
                    expected[kid] = v
                    last_read[kid] = v
                    if kid not in written and kid not in er_seen:
                        er_seen.add(kid)
                        er_txn.append(t.i)
                        er_key.append(kid)
                        er_val.append(v)
            # non-final writes per key (txn.clj: intermediates)
            for rows in per_key_rows.values():
                wr_nonfinal.extend(rows[:-1])
        if len(key_ids) >= (1 << _KEY_BITS):
            raise Unvectorizable("too many keys for pair packing")
        self.key_names = list(key_ids)
        self.wr_txn = np.asarray(wr_txn, dtype=np.int64)
        self.wr_key = np.asarray(wr_key, dtype=np.int64)
        self.wr_val = np.asarray(wr_val, dtype=np.int64)
        self.wr_nonfinal = np.asarray(wr_nonfinal, dtype=np.int64)
        self.rd_txn = np.asarray(rd_txn, dtype=np.int64)
        self.rd_key = np.asarray(rd_key, dtype=np.int64)
        self.rd_val = np.asarray(rd_val, dtype=np.int64)
        self.fr_txn = np.asarray(fr_txn, dtype=np.int64)
        self.fr_key = np.asarray(fr_key, dtype=np.int64)
        self.fr_prev = np.asarray(fr_prev, dtype=np.int64)
        self.fr_new = np.asarray(fr_new, dtype=np.int64)
        self.er_txn = np.asarray(er_txn, dtype=np.int64)
        self.er_key = np.asarray(er_key, dtype=np.int64)
        self.er_val = np.asarray(er_val, dtype=np.int64)
        self.internal_bad = internal_bad
        self.n = n


class DeviceRwAnalysis:
    """Vectorized analog of elle.check_rw_register's per-txn dict
    passes: writer resolution, duplicate/aborted/intermediate read
    anomalies, and wr/ww/rw edge inference as packed-array lookups.
    Witness payloads for flagged rows are extracted host-side, capped
    at the same 8 the result slice keeps."""

    CAP = 8

    _KIND = 1
    _FLAT_CLS = RwFlat

    def __init__(self, hist: History):
        self._ops = list(hist)
        self.txns: list[Txn] | None = None
        f = self.flat = self._flatten(hist)
        self.anomalies: dict[str, list] = defaultdict(list)
        for rec in f.internal_bad:
            self.anomalies["internal"].append(rec)
        self._resolve_writers()
        self._read_anomalies_and_edges()

    _flatten = DeviceAppendAnalysis._flatten
    _op = DeviceAppendAnalysis._op

    def _resolve_writers(self):
        f = self.flat
        W = len(f.wr_txn)
        codes = np.unique(_pack(f.wr_key, f.wr_val)) if W else \
            np.empty(0, dtype=np.int64)
        self.pair_codes = codes
        P = len(codes)
        inv = (np.searchsorted(codes, _pack(f.wr_key, f.wr_val))
               if W else np.empty(0, dtype=np.int64))
        order = np.arange(W)
        nonfail = f.t_type[f.wr_txn] != _TYPE_FAIL if W else \
            np.empty(0, dtype=bool)
        # writer row per pair: last non-fail write, else first write
        # (the host's writer-dict overwrite rule)
        last_nf = np.full(P, -1, dtype=np.int64)
        first_any = np.full(P, W, dtype=np.int64)
        if W:
            np.maximum.at(last_nf, inv[nonfail], order[nonfail])
            np.minimum.at(first_any, inv, order)
        w_row = np.where(last_nf >= 0, last_nf, first_any)
        self.w_txn = (f.wr_txn[np.clip(w_row, 0, max(W - 1, 0))]
                      if W else np.empty(0, dtype=np.int64))
        self.w_fail = (f.t_type[self.w_txn] == _TYPE_FAIL
                       if W else np.empty(0, dtype=bool))
        # duplicate-writes: non-fail writes beyond their pair's first
        # non-fail (host flags when the standing writer is non-fail)
        if W:
            sub = np.flatnonzero(nonfail)
            if sub.size:
                srt = sub[np.argsort(inv[sub], kind="stable")]
                pid_s = inv[srt]
                first = np.ones(srt.size, dtype=bool)
                first[1:] = pid_s[1:] != pid_s[:-1]
                for row in srt[~first][:self.CAP]:
                    self.anomalies["duplicate-writes"].append({
                        "key": f.key_names[f.wr_key[row]],
                        "value": int(f.wr_val[row]),
                        "op": self._op(f.wr_txn[row])})
        # intermediate (non-final) writer per pair: last row in txn
        # order wins, like the host's dict overwrite
        self.inter_txn = np.full(P, -1, dtype=np.int64)
        if len(f.wr_nonfinal):
            rows = f.wr_nonfinal
            pids = inv[rows]
            np.maximum.at(self.inter_txn, pids, rows)
            got = self.inter_txn >= 0
            self.inter_txn[got] = f.wr_txn[self.inter_txn[got]]

    def _pid_of(self, keys, vals) -> np.ndarray:
        codes = _pack(np.asarray(keys, dtype=np.int64),
                      np.asarray(vals, dtype=np.int64))
        if len(self.pair_codes) == 0:
            return np.full(len(codes), -1, dtype=np.int64)
        pos = np.searchsorted(self.pair_codes, codes)
        pos = np.clip(pos, 0, len(self.pair_codes) - 1)
        return np.where(self.pair_codes[pos] == codes, pos, -1)

    def _read_anomalies_and_edges(self):
        f = self.flat
        src: list = []
        dst: list = []
        ty: list = []
        kks: list = []

        def emit(s, d, t, kk=None):
            src.append(np.asarray(s, dtype=np.int64))
            dst.append(np.asarray(d, dtype=np.int64))
            ty.append(np.full(len(s), t, dtype=np.int64))
            kks.append(np.full(len(s), -1, dtype=np.int64)
                       if kk is None
                       else np.asarray(kk, dtype=np.int64))

        # -- reads: unobservable / G1a / G1b + wr edges
        if len(f.rd_txn):
            pid = self._pid_of(f.rd_key, f.rd_val)
            missing = pid == -1
            for i in np.flatnonzero(missing)[:self.CAP]:
                self.anomalies["unobservable-read"].append({
                    "key": f.key_names[f.rd_key[i]],
                    "value": int(f.rd_val[i]),
                    "op": self._op(f.rd_txn[i])})
            found = ~missing
            if len(self.pair_codes):
                wt = np.where(found,
                              self.w_txn[np.clip(pid, 0, None)], -1)
                wfail = np.where(
                    found, self.w_fail[np.clip(pid, 0, None)], False)
            else:  # reads but not a single write anywhere
                wt = np.full(len(f.rd_txn), -1, dtype=np.int64)
                wfail = np.zeros(len(f.rd_txn), dtype=bool)
            g1a = found & wfail
            for i in np.flatnonzero(g1a)[:self.CAP]:
                self.anomalies["G1a"].append({
                    "key": f.key_names[f.rd_key[i]],
                    "value": int(f.rd_val[i]),
                    "op": self._op(f.rd_txn[i]),
                    "writer": self._op(wt[i])})
            ext = found & ~wfail & (wt != f.rd_txn)
            inter = np.where(found,
                             self.inter_txn[np.clip(pid, 0, None)], -1)
            g1b = ext & (inter >= 0) & (inter != f.rd_txn)
            for i in np.flatnonzero(g1b)[:self.CAP]:
                self.anomalies["G1b"].append({
                    "key": f.key_names[f.rd_key[i]],
                    "value": int(f.rd_val[i]),
                    "op": self._op(f.rd_txn[i]),
                    "writer": self._op(inter[i])})
            emit(wt[ext], f.rd_txn[ext], WR, f.rd_key[ext])

        # -- write-follows-read: ww edges + version succession
        if len(f.fr_txn):
            pw_pid = self._pid_of(f.fr_key, f.fr_prev)
            ok = pw_pid >= 0
            pw = np.where(ok, self.w_txn[np.clip(pw_pid, 0, None)], -1)
            m = ok & (pw >= 0) & (pw != f.fr_txn)
            emit(pw[m], f.fr_txn[m], WW, f.fr_key[m])
            # succ[(k, prev)] = new, last in txn order wins
            fp = _pack(f.fr_key, f.fr_prev)
            order = np.argsort(fp, kind="stable")
            fp_s = fp[order]
            last = np.ones(len(fp_s), dtype=bool)
            last[:-1] = fp_s[1:] != fp_s[:-1]
            self.succ_codes = fp_s[last]
            self.succ_vals = f.fr_new[order][last]
        else:
            self.succ_codes = np.empty(0, dtype=np.int64)
            self.succ_vals = np.empty(0, dtype=np.int64)

        # -- external reads -> rw edges against the proven successor
        if len(f.er_txn) and len(self.succ_codes):
            ec = _pack(f.er_key, f.er_val)
            pos = np.searchsorted(self.succ_codes, ec)
            pos = np.clip(pos, 0, len(self.succ_codes) - 1)
            has = self.succ_codes[pos] == ec
            nv = np.where(has, self.succ_vals[pos], 0)
            w2_pid = self._pid_of(f.er_key, nv)
            w2_ok = has & (w2_pid >= 0)
            w2 = np.where(w2_ok,
                          self.w_txn[np.clip(w2_pid, 0, None)], -1)
            m = (w2_ok & (w2 >= 0) & (w2 != f.er_txn)
                 & (f.t_type[np.clip(w2, 0, None)] == _TYPE_OK))
            emit(f.er_txn[m], w2[m], RW, f.er_key[m])

        fl = self.flat
        comm = np.flatnonzero(fl.t_type == _TYPE_OK)
        o_src, o_dst, o_ty = order_edges_from_arrays(
            comm, fl.t_inv[comm], fl.t_comp[comm], fl.t_proc[comm])
        src.append(o_src)
        dst.append(o_dst)
        ty.append(o_ty)
        kks.append(np.full(o_src.size, -1, dtype=np.int64))
        self.edge_src = np.concatenate(src) if src else \
            np.empty(0, dtype=np.int64)
        self.edge_dst = np.concatenate(dst) if dst else \
            np.empty(0, dtype=np.int64)
        self.edge_ty = np.concatenate(ty) if ty else \
            np.empty(0, dtype=np.int64)
        self.edge_key = np.concatenate(kks) if kks else \
            np.empty(0, dtype=np.int64)



def check_rw_register_device(hist, device=None) -> dict:
    """Drop-in device-path analog of elle.check_rw_register. Raises
    Unvectorizable when the history can't be interned. device: None
    (the card) or "cpu"."""
    resolve_device(device)
    if not isinstance(hist, History):
        hist = History(hist)
    prof = profiler.get()
    rec = prof.begin("elle-rw")
    with telemetry.span("elle:rw-register") as sp:
        with prof.phase(rec, "encode_ns"):
            a = DeviceRwAnalysis(hist)
        sp["attrs"] = {"txns": a.flat.n, "edges": int(len(a.edge_src))}
    return _cycle_result(a, device, rec)
