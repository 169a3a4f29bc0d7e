"""Rendering for stored telemetry: span trees + metric tables (the
port's copy of jepsen_tpu/reports/telemetry.py; its output is the JAX
module's, byte for byte).

Consumes the artifacts the port's telemetry.py writes into a test's
store directory (telemetry.jsonl / metrics.json) and renders them two
ways: a plain-text span-tree summary for the CLI `telemetry`
subcommand, and an HTML page for web.py's per-test telemetry view.
Pure functions over the loaded records — no recorder access — so they
work equally on a live Telemetry.events() list and on artifacts read
back from disk.
"""

from __future__ import annotations

import html as _html


def _ms(ns: int) -> str:
    if ns >= 1_000_000_000:
        return f"{ns / 1e9:.2f}s"
    return f"{ns / 1e6:.1f}ms"


def span_tree(events) -> list[tuple[int, dict]]:
    """(depth, span) rows in tree order: roots by start time, children
    nested under their parent. Spans whose parent never completed (or
    arrived out of order) degrade to roots rather than vanishing."""
    events = [e for e in events if "t0" in e]
    by_id = {e.get("id"): e for e in events}
    children: dict = {}
    roots = []
    for e in events:
        p = e.get("parent")
        if p is not None and p in by_id:
            children.setdefault(p, []).append(e)
        else:
            roots.append(e)
    rows: list[tuple[int, dict]] = []

    def walk(e, depth):
        rows.append((depth, e))
        for c in sorted(children.get(e.get("id"), []),
                        key=lambda x: x["t0"]):
            walk(c, depth + 1)

    for r in sorted(roots, key=lambda x: x["t0"]):
        walk(r, 0)
    return rows


def filter_spans(events, min_ms: float | None = None,
                 top: int | None = None) -> list:
    """Span-volume control for deep kernel traces (per-launch records
    multiply span counts): keeps spans at least `min_ms` long and/or
    the `top` N longest, PLUS every ancestor of a kept span (so the
    phase context survives the pruning). Open spans always survive —
    they're what a live run is doing right now. No-op when neither
    filter is given."""
    if min_ms is None and top is None:
        return list(events)
    events = [e for e in events if "t0" in e]
    by_id = {e.get("id"): e for e in events}

    def dur_ms(e):
        return (e["t1"] - e["t0"]) / 1e6 if "t1" in e else None

    seeds = [e for e in events
             if dur_ms(e) is None
             or min_ms is None or dur_ms(e) >= min_ms]
    if top is not None:
        closed = sorted((e for e in seeds if dur_ms(e) is not None),
                        key=dur_ms, reverse=True)[:max(top, 0)]
        seeds = [e for e in seeds if dur_ms(e) is None] + closed
    keep = set()
    for e in seeds:
        sid = e.get("id")
        # walk ancestors; the depth bound guards a parent cycle in a
        # corrupt artifact
        for _ in range(64):
            if sid is None or sid in keep:
                break
            keep.add(sid)
            parent = by_id.get(sid)
            sid = parent.get("parent") if parent else None
    return [e for e in events if e.get("id") in keep]


def span_tree_lines(events, min_ms: float | None = None,
                    top: int | None = None) -> list[str]:
    lines = []
    for depth, e in span_tree(filter_spans(events, min_ms, top)):
        dur = _ms(e["t1"] - e["t0"]) if "t1" in e else "(open)"
        extra = ""
        if e.get("attrs"):
            extra = "  " + " ".join(f"{k}={v}" for k, v in
                                    sorted(e["attrs"].items()))
        thread = e.get("thread") or ""
        tcol = f"  [{thread}]" if depth == 0 and thread else ""
        lines.append(f"{'  ' * depth}{e.get('name', '?')}  "
                     f"{dur}{extra}{tcol}")
    return lines


def _metric_rows(metrics: dict) -> list[tuple[str, str, str]]:
    """(section, name, value) rows for counters + gauges + span
    aggregates, kernel metrics grouped first."""
    rows: list[tuple[str, str, str]] = []
    counters = (metrics or {}).get("counters", {})
    gauges = (metrics or {}).get("gauges", {})
    for name in sorted(counters):
        v = counters[name]
        shown = _ms(v) if name.endswith("_ns") else str(v)
        rows.append(("counter", name, shown))
    for name in sorted(gauges):
        rows.append(("gauge", name, str(gauges[name])))
    for name, agg in sorted((metrics or {}).get("spans", {}).items()):
        rows.append(("span", name,
                     f"x{agg['count']}  total {_ms(agg['total_ns'])}  "
                     f"max {_ms(agg['max_ns'])}"))
    return rows


def telemetry_text(events, metrics: dict | None,
                   min_ms: float | None = None,
                   top: int | None = None) -> str:
    """The CLI `telemetry` subcommand's output: span tree (optionally
    pruned by --min-ms / --top, see filter_spans), then the aggregated
    counters/gauges/span table."""
    out = ["# Spans", ""]
    lines = span_tree_lines(events, min_ms=min_ms, top=top)
    if (min_ms is not None or top is not None) and events:
        shown = len(lines)
        out.insert(1, f"(filtered: showing {shown} of "
                      f"{sum(1 for e in events if 't0' in e)} spans)")
    out.extend(lines or ["(no spans recorded)"])
    out += ["", "# Metrics", ""]
    rows = _metric_rows(metrics or {})
    if not rows:
        out.append("(no metrics recorded)")
    else:
        width = max(len(n) for _s, n, _v in rows)
        for section, name, value in rows:
            out.append(f"{section:<8} {name:<{width}}  {value}")
    return "\n".join(out)


def telemetry_html(title: str, events, metrics: dict | None) -> str:
    """The web UI's per-test telemetry page: phase/kernel breakdown as
    a nested span tree plus a metrics table."""
    tree_rows = []
    for depth, e in span_tree(events):
        dur = _ms(e["t1"] - e["t0"]) if "t1" in e else "(open)"
        name = _html.escape(str(e.get("name", "?")))
        attrs = ""
        if e.get("attrs"):
            attrs = _html.escape(
                " ".join(f"{k}={v}" for k, v in sorted(
                    e["attrs"].items())))
        tree_rows.append(
            f"<tr><td style='padding-left:{depth * 18 + 4}px'>"
            f"{name}</td><td>{dur}</td>"
            f"<td class='dim'>{attrs}</td></tr>")
    metric_rows = [
        f"<tr><td class='dim'>{_html.escape(section)}</td>"
        f"<td>{_html.escape(name)}</td>"
        f"<td>{_html.escape(value)}</td></tr>"
        for section, name, value in _metric_rows(metrics or {})]
    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>telemetry — {_html.escape(title)}</title><style>"
        "body { font-family: sans-serif } "
        "table { border-collapse: collapse; margin-bottom: 2em } "
        "td, th { padding: 3px 10px; text-align: left; "
        "border-bottom: 1px solid #eee; font-size: 14px } "
        ".dim { color: #888 }"
        "</style></head><body>"
        f"<h1>telemetry — {_html.escape(title)}</h1>"
        "<h2>Spans</h2><table><tr><th>span</th><th>duration</th>"
        "<th>attrs</th></tr>"
        + "".join(tree_rows or ["<tr><td colspan=3>(none)</td></tr>"])
        + "</table><h2>Metrics</h2>"
        "<table><tr><th></th><th>name</th><th>value</th></tr>"
        + "".join(metric_rows
                  or ["<tr><td colspan=3>(none)</td></tr>"])
        + "</table></body></html>")
