"""Online safety watchdog: incremental checkers that watch the history
as it is produced (the port's copy of jepsen_tpu/watchdog.py).

"Faster linearizability checking via P-compositionality" observes that per-key decomposition makes incremental checking cheap;
this module applies the idea *online*: lightweight adapters subscribe
to the interpreter's completion stream and flag violations the moment
they are observed — minutes before the post-hoc checkers run — without
replacing them. Every adapter check is sound under concurrency (no
false positives from interleaving): each one only flags states no
correct system could produce given the operations *attempted* so far.

Adapters:

  register   per-key CAS-register order: an ok read (or the expected
             side of an ok cas) must be the initial value or a value
             some write/cas attempt could have installed
  counter    bounds: an ok read must lie within [sum of attempted
             negative deltas, sum of attempted positive deltas]
  set        dirty/phantom reads: an ok read may not contain an
             element whose every add attempt failed (none in flight,
             none indeterminate), or one never attempted at all

A violation raises a `watchdog` telemetry span + counter (so the live
monitor streams it) and is attached to the final results under
`watchdog` by core.analyze — which never changes the post-hoc checker
verdicts. With the opt-in `early_abort` test flag the interpreter
additionally stops the run at the first violation, so a multi-minute
test doesn't keep burning time after safety is already lost.

Configuration (test map keys):

  test["watchdog"] = True                      # all adapters
  test["watchdog"] = ["register", "counter"]   # specific adapters
  test["watchdog"] = {"adapters": ["set"], "early_abort": True}
  test["early_abort"] = True                   # flag rides separately
"""

from __future__ import annotations

import logging
from typing import Any

from . import telemetry
from .history import FAIL, INFO, INVOKE, OK, Op

logger = logging.getLogger(__name__)

MAX_VIOLATIONS = 64  # kept in full; beyond this only the count grows


def _split_key(value) -> tuple[Any, Any]:
    """(key, payload) for an op value: independent-workload ops carry
    (key, payload) *tuples* (independent.ktuple); plain ops (scalar
    values, cas [from, to] lists) live on the single default key."""
    if isinstance(value, tuple) and len(value) == 2:
        return value[0], value[1]
    return None, value


class Adapter:
    """One incremental safety check. observe() sees every journaled op
    (invocations and completions) in history order, on the interpreter
    thread; returns a violation dict or None."""

    name = "?"

    def observe(self, op: Op) -> dict | None:
        raise NotImplementedError


class RegisterAdapter(Adapter):
    """Per-key CAS-register order. Values a register can possibly hold
    are the initial value plus everything any write or cas *attempted*
    to install; an ok read outside that set — or an ok cas whose
    expected value is outside it — is impossible under any
    interleaving."""

    name = "register"

    def __init__(self, initial=None):
        self.initial = initial
        self.possible: dict = {}  # key -> set of attempted values
        self.armed = False        # first write/cas arms the checks

    def _possible(self, k) -> set:
        s = self.possible.get(k)
        if s is None:
            s = self.possible[k] = set()
        return s

    def observe(self, op):
        if op.f not in ("read", "write", "cas"):
            return None
        k, v = _split_key(op.value)
        if op.type == INVOKE:
            if op.f == "write":
                self.armed = True
                self._possible(k).add(v)
            elif op.f == "cas" and isinstance(v, (list, tuple)) \
                    and len(v) == 2:
                self.armed = True
                self._possible(k).add(v[1])
            return None
        # reads are ambiguous across workloads (counter reads are
        # numbers too): stay silent until this workload's signature
        # write appears, so co-enabled adapters never cross-flag
        if op.type != OK or not self.armed:
            return None
        if op.f == "read":
            if v is not None and v != self.initial \
                    and v not in self._possible(k):
                return {"type": "impossible-read", "key": k,
                        "value": v}
        elif op.f == "cas" and isinstance(v, (list, tuple)) \
                and len(v) == 2:
            frm = v[0]
            if frm is not None and frm != self.initial \
                    and frm not in self._possible(k):
                return {"type": "impossible-cas-from", "key": k,
                        "value": frm}
        return None


class CounterAdapter(Adapter):
    """Counter bounds. The counter starts at 0; at any instant its
    value lies within [sum of attempted negative deltas, sum of
    attempted positive deltas] — an ok read outside that envelope is
    impossible no matter which attempts actually landed."""

    name = "counter"

    def __init__(self):
        self.lo = 0
        self.hi = 0
        self.armed = False  # first add arms the read check

    def observe(self, op):
        if op.f in ("add", "increment", "inc"):
            if op.type == INVOKE and isinstance(op.value, (int, float)):
                self.armed = True
                if op.value >= 0:
                    self.hi += op.value
                else:
                    self.lo += op.value
            return None
        # arm only once the workload's signature write appears: reads
        # are ambiguous across workloads (a register read is not a
        # counter read), and an adapter enabled alongside others must
        # never flag ops that aren't its own
        if self.armed and op.f == "read" and op.type == OK \
                and isinstance(op.value, (int, float)):
            if not (self.lo <= op.value <= self.hi):
                return {"type": "counter-out-of-bounds",
                        "value": op.value,
                        "bounds": [self.lo, self.hi]}
        return None


class SetAdapter(Adapter):
    """Set dirty/phantom reads. An ok read may not contain an element
    nobody ever attempted to add (a phantom), or one where every add
    attempt is known to have failed AND none is still in flight (a
    dirty read — the failed add's effects leaked). The in-flight count
    keeps retries sound: while any attempt is outstanding the element
    may legitimately appear."""

    name = "set"

    def __init__(self):
        # (key, element) -> [outstanding attempts, possibly applied?]
        self.state: dict = {}
        self.armed_keys: set = set()  # keys with at least one add

    @staticmethod
    def _track(k, e):
        """The tracking key for element e of set k; None when the
        element isn't hashable (e.g. a workload whose reads return
        row lists) — such elements are simply not checked."""
        try:
            hash(e)
        except TypeError:
            return None
        return (k, e)

    def observe(self, op):
        if op.f == "add":
            k, e = _split_key(op.value)
            tk = self._track(k, e)
            if tk is None:
                return None
            st = self.state.get(tk)
            if st is None:
                st = self.state[tk] = [0, False]
            self.armed_keys.add(k)
            if op.type == INVOKE:
                st[0] += 1
            elif op.type in (OK, INFO):
                # INFO is indeterminate: the add may have applied
                st[0] = max(st[0] - 1, 0)
                st[1] = True
            elif op.type == FAIL:
                st[0] = max(st[0] - 1, 0)
            return None
        # arming is per key (no adds seen on a key, no claims on it —
        # same rule as CounterAdapter, sharpened for independent keys)
        if self.state and op.f == "read" and op.type == OK:
            k, elems = _split_key(op.value)
            if k not in self.armed_keys \
                    or not isinstance(elems, (list, set, tuple)):
                return None
            for e in elems:
                tk = self._track(k, e)
                if tk is None:
                    continue
                st = self.state.get(tk)
                if st is None:
                    return {"type": "phantom-read", "key": k,
                            "element": e}
                if not st[1] and st[0] == 0:
                    return {"type": "dirty-read", "key": k,
                            "element": e}
        return None


ADAPTERS = {"register": RegisterAdapter, "counter": CounterAdapter,
            "set": SetAdapter}


class Watchdog:
    """Fans completions out to adapters, records violations, and
    decides whether the interpreter should abort early. Called only
    from the interpreter's main loop — no locking needed; readers
    (sampler, web) see its state through the telemetry counter."""

    def __init__(self, adapters, early_abort: bool = False):
        self.adapters = list(adapters)
        self.early_abort = bool(early_abort)
        self.violations: list[dict] = []
        self.count = 0
        self.tripped = False

    def observe(self, op: Op) -> None:
        if op.process == "nemesis":
            return
        for a in self.adapters:
            try:
                v = a.observe(op)
            except Exception:  # noqa: BLE001 — a broken adapter must
                logger.exception("watchdog adapter %s failed", a.name)
                continue      # not take down the run
            if v is not None:
                self._record(a, v, op)

    def _record(self, adapter: Adapter, violation: dict, op: Op) -> None:
        self.count += 1
        self.tripped = True
        # the counter is what the live monitor streams (visible the
        # tick after it happens, not at exit) and counts everything;
        # the stored list, the spans, and the log lines all cap at
        # MAX_VIOLATIONS so a thoroughly-broken long run can't grow
        # memory or flood telemetry.jsonl without bound
        telemetry.count("watchdog.violations")
        if len(self.violations) >= MAX_VIOLATIONS:
            return
        v = dict(violation)
        v["adapter"] = adapter.name
        v["op-index"] = op.index
        v["time"] = op.time
        v["process"] = op.process
        self.violations.append(v)
        with telemetry.span("watchdog", adapter=adapter.name,
                            type=violation.get("type"),
                            op_index=op.index):
            pass
        logger.warning("watchdog: %s violation at op %s: %s",
                       adapter.name, op.index, violation)

    def results(self) -> dict:
        """The `watchdog` entry core.analyze attaches to the final
        results — informational: it rides NEXT to the checker verdict
        and never changes it."""
        return {"valid?": self.count == 0,
                "count": self.count,
                "early_abort": self.early_abort,
                "tripped": self.tripped,
                "violations": list(self.violations)}


def from_test(test: dict) -> Watchdog | None:
    """Builds the watchdog a test asked for; None when unconfigured."""
    spec = test.get("watchdog")
    if not spec or isinstance(spec, Watchdog):
        return spec or None
    early_abort = bool(test.get("early_abort"))
    if spec is True:
        names = list(ADAPTERS)
    elif isinstance(spec, dict):
        names = list(spec.get("adapters") or ADAPTERS)
        early_abort = bool(spec.get("early_abort", early_abort))
    else:
        names = list(spec)
    adapters = []
    for n in names:
        if isinstance(n, Adapter):
            adapters.append(n)
        elif n in ADAPTERS:
            kwargs = {}
            if n == "register" and test.get("initial") is not None:
                kwargs["initial"] = test["initial"]
            adapters.append(ADAPTERS[n](**kwargs))
        else:
            raise ValueError(
                f"unknown watchdog adapter {n!r}; "
                f"must be one of {sorted(ADAPTERS)}")
    return Watchdog(adapters, early_abort=early_abort)
