"""Bank workload: concurrent transfers between accounts must conserve
the total balance at every read (jepsen_tpu/workloads/bank.py, ported:
the generator and the checker; the workload bundle with its balance
plot is not).

Capability reference: jepsen/src/jepsen/tests/bank.clj — generators
(19-43: transfer with random from/to/amount, read), checker (56-120:
every ok read sums to :total-amount, no negative balances unless
:negative-balances? is set), bundle (178-191).
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .. import checker as chk
from ..checker import _Fn
from ..device import resolve_device
from ..gpu.kernels import bank_reduce as kernel

# Wide histories with at least this many reads reduce on the card: the
# JAX package's threshold, kept for parity (it was tuned on a TPU).
DEVICE_MIN_READS = 10_000


def generator(accounts=None, max_transfer: int = 5, seed=None):
    accounts = list(accounts if accounts is not None else range(8))
    rng = random.Random(seed)

    def one():
        if rng.random() < 0.5:
            return {"f": "read", "value": None}
        frm, to = rng.sample(accounts, 2)
        return {"f": "transfer",
                "value": {"from": frm, "to": to,
                          "amount": rng.randint(1, max_transfer)}}

    return one


def check_fast(hist, total: int, negative_ok: bool = False,
               device=None) -> dict:
    """Balance-conservation check (SURVEY P4: chunked-fold checkers
    become array folds). Narrow reads (few accounts) take a plain
    C-builtin fold — at width ~8 the per-op dict iteration is the
    floor and array building only adds overhead; wide reads gather
    into a dense [reads, accounts] matrix whose sum/negative scans run
    as array reductions (on device for large histories, where the
    matrix ships to device memory once, and the bank_reduce kernel
    sums each row in int64).

    device: None (the card) or "cpu" (the kernel's plain PyTorch
    version); resolved on entry, so a missing card raises."""
    from itertools import chain

    dev = resolve_device(device)

    narrow = None
    read_count = 0
    err = 0
    bad_op = None
    vals: list = []
    ops = []
    for op in hist:
        if op.type == "ok" and op.f == "read" and op.value is not None:
            v = op.value.values()
            if narrow is None:
                narrow = len(v) < 12
            if narrow:
                # single-pass fold, same cost as the naive reference
                # loop — array building only adds overhead this narrow
                read_count += 1
                if sum(v) != total or (not negative_ok and v
                                       and min(v) < 0):
                    err += 1
                    if bad_op is None:
                        bad_op = op
            else:
                vals.append(v)
                ops.append(op)
    if narrow:
        first = None
        if err:
            v = list(bad_op.value.values())
            s = sum(v)
            first = ({"type": "wrong-total", "expected": total,
                      "found": s, "op": bad_op} if s != total else
                     {"type": "negative-value",
                      "found": [b for b in v if b < 0], "op": bad_op})
        return {"valid?": not err, "read-count": read_count,
                "error-count": err, "first-error": first}
    read_count = len(ops)
    if read_count == 0:
        return {"valid?": "unknown", "read-count": 0, "error-count": 0,
                "first-error": None}
    widths = np.fromiter(map(len, vals), dtype=np.int64,
                         count=read_count)
    width = int(widths.max())
    total_elems = int(widths.sum())
    flat = np.fromiter(chain.from_iterable(vals), dtype=np.int64,
                       count=total_elems)
    if width * read_count == total_elems:
        # homogeneous account sets: one C-speed reshape, no per-row copy
        mat = flat.reshape(read_count, width)
    else:
        mat = np.zeros((read_count, width), dtype=np.int64)
        offs = np.concatenate([[0], np.cumsum(widths)])[:-1]
        cols = np.arange(total_elems) - np.repeat(offs, widths)
        mat[np.repeat(np.arange(read_count), widths), cols] = flat
    if read_count >= DEVICE_MIN_READS:
        dsums, dnegs = kernel.bank_reduce(torch.from_numpy(mat).to(dev))
        sums, negs = dsums.cpu().numpy(), dnegs.cpu().numpy()
    else:
        sums = mat.sum(axis=1)
        negs = (mat < 0).any(axis=1)
    wrong = sums != total
    bad = wrong if negative_ok else (wrong | negs)
    err = int(bad.sum())
    first = None
    if err:
        i = int(np.flatnonzero(bad)[0])
        if wrong[i]:
            first = {"type": "wrong-total", "expected": total,
                     "found": int(sums[i]), "op": ops[i]}
        else:
            first = {"type": "negative-value",
                     "found": [int(b) for b in mat[i] if b < 0],
                     "op": ops[i]}
    return {"valid?": not err, "read-count": read_count,
            "error-count": err, "first-error": first}


def checker(opts: dict | None = None) -> chk.Checker:
    """The conservation checker; opts: "total-amount",
    "negative-balances?" and "device" (None, the card, or "cpu")."""
    o = dict(opts or {})

    def run(test, hist, copts):
        total = (test.get("total-amount")
                 if isinstance(test, dict) else None)
        if total is None:
            total = o.get("total-amount", 0)
        out = check_fast(hist, total,
                         negative_ok=o.get("negative-balances?",
                                           False),
                         device=o.get("device"))
        # coverage taxonomy tag, explicit negative included
        return chk.anomaly_classes(
            out, bank_imbalance=bool(out.get("error-count")))

    return _Fn(run)
