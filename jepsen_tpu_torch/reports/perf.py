"""Latency and rate graphs over histories (the port's copy of
jepsen_tpu/reports/perf.py).

Capability reference: jepsen/src/jepsen/checker/perf.clj — time
bucketing (22-50), quantiles (52-88), invokes-by-f-type folds
(96-140), latency point + quantile graphs and rate graphs (the rest),
nemesis activity shading from package :perf specs (with-nemeses).
The reference renders through gnuplot; this renders with matplotlib
(Agg), imported only when a figure is drawn, and writes PNGs into the
test's store directory. Without matplotlib a graph checker raises
ImportError, which check_safe reports as valid? "unknown", as the JAX
package's does. The stored nemesis specs are read as lists too
(ROADMAP C7), where the JAX package's copy reads only tuples.
"""

from __future__ import annotations

import logging
import math
from collections import defaultdict

from .. import util
from ..history import History, is_info, is_invoke, is_ok

logger = logging.getLogger(__name__)

DEFAULT_NEMESIS_COLOR = "#cccccc"
NEMESIS_ALPHA = 0.6

TYPE_COLORS = {"ok": "#81BFFC", "info": "#FFA400", "fail": "#FF1E90"}
TYPE_MARKERS = {"ok": "+", "info": "x", "fail": "."}

QUANTILES = [0.5, 0.95, 0.99, 1.0]

DT = 10.0  # rate/quantile bucket width, seconds


def bucket_scale(dt: float, b: int) -> float:
    """Midpoint time of bucket b (perf.clj:22-27)."""
    return b * dt + dt / 2


def bucket_time(dt: float, t: float) -> float:
    """Midpoint time of the bucket containing t (perf.clj:29-33)."""
    return bucket_scale(dt, int(t // dt))


def bucket_points(dt: float, points) -> dict:
    """{bucket-midpoint: [point, ...]} ordered by time
    (perf.clj:42-49)."""
    out: dict = defaultdict(list)
    for p in points:
        out[bucket_time(dt, p[0])].append(p)
    return dict(sorted(out.items()))


def quantiles(qs, values) -> dict:
    """{q: value-at-quantile} (perf.clj:52-63)."""
    s = sorted(values)
    if not s:
        return {}
    n = len(s)
    return {q: s[min(n - 1, int(math.floor(n * q)))] for q in qs}


def latencies_to_quantiles(dt: float, qs, points) -> dict:
    """{q: [[bucket-time, latency-at-q], ...]} (perf.clj:65-88)."""
    assert all(0 <= q <= 1 for q in qs)
    buckets = [(t, quantiles(qs, [p[1] for p in ps]))
               for t, ps in bucket_points(dt, points).items()]
    return {q: [[t, b.get(q)] for t, b in buckets] for q in qs}


def invokes_by_f_type(history: History) -> dict:
    """{f: {type: [(invoke-op, completion-op), ...]}} for client
    invocations (perf.clj invokes-by-f-type)."""
    out: dict = defaultdict(lambda: defaultdict(list))
    for o in history:
        if not is_invoke(o):
            continue
        comp = history.completion(o)
        if comp is None:
            continue
        t = ("ok" if is_ok(comp) else
             "info" if is_info(comp) else "fail")
        out[o.f][t].append((o, comp))
    return {f: dict(ts) for f, ts in out.items()}


def _latency_points(pairs) -> list:
    """[time-s, latency-ms] per (invoke, completion) pair."""
    return [[util.nanos_to_secs(inv.time),
             (comp.time - inv.time) / 1e6] for inv, comp in pairs]


def _nemesis_specs(test) -> list:
    """Normalized perf specs from test['plot']['nemeses'] (the package
    'perf' sets, as tuples or dicts; a stored test.json gives the tuples
    back as lists, which the JAX package's copy does not read: ROADMAP
    C7)."""
    specs = ((test.get("plot") or {}).get("nemeses")) or []
    out = []
    for s in specs:
        if isinstance(s, (tuple, list)):
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


def point_graph(test, history: History, opts=None) -> dict:
    """Raw latency scatter, colored by f x completion type, log-scale ms
    (perf.clj point-graph!). Writes latency-raw.png."""
    history = history.client_ops()
    by_ft = invokes_by_f_type(history)
    if not by_ft:
        return {"valid?": True}
    plt, fig, ax = _figure()
    ax.set_ylabel("Latency (ms)")
    ax.set_yscale("log")
    ax.set_title(f"{test.get('name') or 'test'} latency (raw)")
    fs = sorted(by_ft, key=str)
    for f in fs:
        for t, pairs in sorted(by_ft[f].items()):
            pts = _latency_points(pairs)
            if not pts:
                continue
            ax.scatter([p[0] for p in pts], [p[1] for p in pts],
                       s=14, marker=TYPE_MARKERS[t],
                       color=TYPE_COLORS[t],
                       alpha=0.8 if len(pts) < 5000 else 0.3,
                       label=f"{f} {t}", zorder=2)
    _shade_nemeses(ax, test, history)
    ax.legend(loc="upper right", fontsize=7, ncol=max(1, len(fs)))
    path = _save(plt, fig, test, opts, "latency-raw.png")
    return {"valid?": True, "file": path}


def quantile_graph(test, history: History, opts=None) -> dict:
    """Latency quantiles (0.5/0.95/0.99/1.0) over time windows
    (perf.clj quantile-graph!). Writes latency-quantiles.png."""
    history = history.client_ops()
    pairs = [(o, history.completion(o)) for o in history
             if is_invoke(o)]
    pairs = [(i, c) for i, c in pairs if c is not None]
    if not pairs:
        return {"valid?": True}
    pts = _latency_points(pairs)
    dt = (opts or {}).get("dt", DT)
    qmaps = latencies_to_quantiles(dt, QUANTILES, pts)
    plt, fig, ax = _figure()
    ax.set_ylabel("Latency (ms)")
    ax.set_yscale("log")
    ax.set_title(f"{test.get('name') or 'test'} latency (quantiles)")
    for q in QUANTILES:
        series = [(t, v) for t, v in qmaps[q] if v is not None]
        ax.plot([t for t, _ in series], [v for _, v in series],
                marker="o", ms=3, lw=1.2, label=f"q={q}", zorder=2)
    _shade_nemeses(ax, test, history)
    ax.legend(loc="upper right", fontsize=8)
    path = _save(plt, fig, test, opts, "latency-quantiles.png")
    return {"valid?": True, "file": path}


def rate_preview(test, history: History, opts=None) -> dict:
    """Throughput (ops/s) per f x type in DT-second buckets
    (perf.clj rate-graph!). Writes rate.png."""
    history = history.client_ops()
    dt = (opts or {}).get("dt", DT)
    rates: dict = defaultdict(lambda: defaultdict(float))
    fs = set()
    for o in history:
        if is_invoke(o):
            continue
        t = ("ok" if is_ok(o) else "info" if is_info(o) else "fail")
        b = bucket_time(dt, util.nanos_to_secs(o.time))
        rates[(o.f, t)][b] += 1 / dt
        fs.add(o.f)
    if not rates:
        return {"valid?": True}
    plt, fig, ax = _figure()
    ax.set_ylabel("Throughput (ops/s)")
    ax.set_title(f"{test.get('name') or 'test'} rate")
    for (f, t), buckets in sorted(rates.items(), key=str):
        series = sorted(buckets.items())
        ax.plot([x for x, _ in series], [y for _, y in series],
                marker="o", ms=3, lw=1.2, color=TYPE_COLORS[t],
                alpha={"ok": 1.0, "info": 0.6, "fail": 0.4}[t],
                label=f"{f} {t}", zorder=2)
    _shade_nemeses(ax, test, history)
    ax.legend(loc="upper right", fontsize=7)
    path = _save(plt, fig, test, opts, "rate.png")
    return {"valid?": True, "file": path}


def monitor_preview(test, history: History, opts=None) -> dict:
    """The live monitor's time-series as a post-hoc plot: throughput
    (ops/s) on the left axis, in-flight op count on the right, with
    the same nemesis shading as the latency/rate graphs so fault
    windows line up across all of them. Writes monitor.png. Reads the
    points the sampler streamed (timeseries.jsonl) — the run's live
    view, preserved."""
    from .. import store as jstore

    d = test.get("store_dir")
    if not d:
        return {"valid?": True}
    points = jstore.load_timeseries(d)
    series = [(util.nanos_to_secs(p["t"]), p.get("ops_s"),
               len(p.get("inflight") or {}))
              for p in points if "t" in p]
    series = [(t, r, infl) for t, r, infl in series if r is not None]
    if not series:
        return {"valid?": True}
    plt, fig, ax = _figure()
    ax.set_ylabel("Throughput (ops/s)")
    ax.set_title(f"{test.get('name') or 'test'} live monitor")
    ax.plot([t for t, _, _ in series], [r for _, r, _ in series],
            marker="o", ms=3, lw=1.2, color=TYPE_COLORS["ok"],
            label="ops/s", zorder=2)
    ax2 = ax.twinx()
    ax2.set_ylabel("In-flight ops")
    ax2.step([t for t, _, _ in series], [i for _, _, i in series],
             where="post", lw=1.0, color=TYPE_COLORS["info"],
             alpha=0.8, label="in-flight", zorder=2)
    _shade_nemeses(ax, test, history)
    h1, l1 = ax.get_legend_handles_labels()
    h2, l2 = ax2.get_legend_handles_labels()
    ax.legend(h1 + h2, l1 + l2, loc="upper right", fontsize=8)
    path = _save(plt, fig, test, opts, "monitor.png")
    return {"valid?": True, "file": path, "points": len(series)}


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


def latency_graph(graph_opts=None):
    """Checker rendering latency-raw + latency-quantiles
    (checker.clj latency-graph)."""
    from ..checker import _Fn

    def run(test, history, opts):
        if not _plottable(test):
            return {"valid?": True, "skipped": "no store directory"}
        o = {**(graph_opts or {}), **(opts or {})}
        raw = point_graph(test, history, o)
        q = quantile_graph(test, history, o)
        return {"valid?": True,
                "files": [p for p in [raw.get("file"), q.get("file")]
                          if p]}

    return _Fn(run)


def rate_graph(graph_opts=None):
    """Checker rendering the rate graph (checker.clj rate-graph)."""
    from ..checker import _Fn

    def run(test, history, opts):
        if not _plottable(test):
            return {"valid?": True, "skipped": "no store directory"}
        o = {**(graph_opts or {}), **(opts or {})}
        r = rate_preview(test, history, o)
        return {"valid?": True,
                "files": [p for p in [r.get("file")] if p]}

    return _Fn(run)


def monitor_graph(graph_opts=None):
    """Checker rendering the live-monitor throughput/in-flight plot
    (no reference analog — the series only exists because the monitor
    sampled it)."""
    from ..checker import _Fn

    def run(test, history, opts):
        if not _plottable(test):
            return {"valid?": True, "skipped": "no store directory"}
        o = {**(graph_opts or {}), **(opts or {})}
        r = monitor_preview(test, history, o)
        return {"valid?": True,
                "files": [p for p in [r.get("file")] if p]}

    return _Fn(run)
