"""The bank workload's balance-over-time plot: the part of
jepsen_tpu/reports/perf.py that the bank workload's bundle renders with
(balance_graph and the helpers it calls), the port's own copy.

Capability reference: jepsen/src/jepsen/checker/perf.clj (nemesis
activity shading from package :perf specs, with-nemeses) and
jepsen/src/jepsen/tests/bank.clj:150-176 (the balance plot). The
reference renders through gnuplot; this renders with matplotlib (Agg),
imported when a plot is drawn, into the test's store directory. Without
matplotlib the checker raises ImportError, which check_safe reports as
valid? "unknown", as the JAX package's does. The latency, rate and clock
plots are not ported.
"""

from __future__ import annotations

from collections import defaultdict

from .. import util
from ..history import History, is_ok

DEFAULT_NEMESIS_COLOR = "#cccccc"
NEMESIS_ALPHA = 0.6


def _nemesis_specs(test) -> list:
    """Normalized perf specs from test['plot']['nemeses'] (the package
    'perf' sets, as tuples or dicts)."""
    specs = ((test.get("plot") or {}).get("nemeses")) or []
    out = []
    for s in specs:
        if isinstance(s, tuple):
            name, start, stop, color = (list(s) + [None] * 4)[:4]
            out.append({"name": name, "start": set(start or ()),
                        "stop": set(stop or ()),
                        "color": color or DEFAULT_NEMESIS_COLOR})
        else:
            out.append({"name": s.get("name"),
                        "start": set(s.get("start") or ()),
                        "stop": set(s.get("stop") or ()),
                        "fs": set(s.get("fs") or ()),
                        "color": s.get("color",
                                       DEFAULT_NEMESIS_COLOR)})
    return out


def _shade_nemeses(ax, test, history) -> None:
    """Shades nemesis activity intervals (perf.clj with-nemeses)."""
    specs = _nemesis_specs(test)
    if not specs:
        specs = [{"name": "nemesis", "start": {"start"},
                  "stop": {"stop"}, "color": DEFAULT_NEMESIS_COLOR}]
    tmax = (util.nanos_to_secs(history[-1].time) if len(history) else 0)
    for spec in specs:
        ints = util.nemesis_intervals(
            history, [{"start": spec["start"], "stop": spec["stop"]}])
        for start, stop in ints:
            x0 = util.nanos_to_secs(start.time)
            x1 = (util.nanos_to_secs(stop.time) if stop is not None
                  else tmax)
            ax.axvspan(x0, x1, color=spec["color"],
                       alpha=1 - NEMESIS_ALPHA, lw=0, zorder=0)


def _figure():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 5), dpi=110)
    ax.set_xlabel("Time (s)")
    ax.grid(True, which="both", alpha=0.25)
    return plt, fig, ax


def _save(plt, fig, test, opts, filename):
    from .. import store as jstore

    sub = (opts or {}).get("subdirectory")
    parts = ([sub, filename] if sub else [filename])
    out = jstore.path(test, *parts)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return str(out)


def balances_preview(test, history: History, opts=None) -> dict:
    """Per-account balance over time from the bank workload's ok reads
    (the bank.clj:150-176 plot analog: one line per account, every
    read a sample point), with the shared nemesis shading so a balance
    excursion lines up with the fault window that caused it. Writes
    bank-balances.png."""
    history = history.client_ops()
    series: dict = defaultdict(list)  # account -> [(t, balance)]
    for o in history:
        if is_ok(o) and o.f == "read" and isinstance(o.value, dict):
            t = util.nanos_to_secs(o.time)
            for acct, bal in o.value.items():
                series[acct].append((t, bal))
    if not series:
        return {"valid?": True}
    plt, fig, ax = _figure()
    ax.set_ylabel("Balance")
    ax.set_title(f"{test.get('name') or 'test'} account balances")
    for acct in sorted(series, key=str):
        pts = series[acct]
        ax.plot([t for t, _ in pts], [b for _, b in pts],
                lw=1.0, alpha=0.8, label=f"acct {acct}", zorder=2)
    ax.axhline(0, color="#888", lw=0.8, ls="--", zorder=1)
    _shade_nemeses(ax, test, history)
    ax.legend(loc="upper right", fontsize=7,
              ncol=max(1, len(series) // 8 + 1))
    path = _save(plt, fig, test, opts, "bank-balances.png")
    return {"valid?": True, "file": path,
            "accounts": len(series)}


def balance_graph(graph_opts=None):
    """Checker rendering the bank balance-over-time plot (the
    jepsen/tests/bank.clj plot bundle entry)."""
    from ..checker import _Fn

    def run(test, history, opts):
        if not _plottable(test):
            return {"valid?": True, "skipped": "no store directory"}
        o = {**(graph_opts or {}), **(opts or {})}
        r = balances_preview(test, history, o)
        return {"valid?": True,
                "files": [p for p in [r.get("file")] if p]}

    return _Fn(run)


def _plottable(test) -> bool:
    """Plots need a store directory to land in."""
    return bool(test.get("store_dir") or test.get("name"))
