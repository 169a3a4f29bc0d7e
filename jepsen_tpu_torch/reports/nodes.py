"""Node observability plane renderers: per-node summaries, the CLI
table, and the web run page's per-node lanes (the port's copy of
jepsen_tpu/reports/nodes.py).

The lanes are the correlation view the node plane exists for: one
strip per DB node on the run's shared clock — CPU utilization shading,
tagged DB-log event ticks, honest gap ticks where the node couldn't be
probed — under the nemesis fault windows the coverage record captured,
so "the election fired two seconds into the partition, on the node
whose memory was vanishing" is one glance, not three files. See
nodeprobe.py.
"""

from __future__ import annotations

import html as _html
from typing import Iterable

from .. import nodeprobe


# ---------------------------------------------------------------------------
# Summaries
# ---------------------------------------------------------------------------

def summarize(records: Iterable[dict]) -> dict[str, dict]:
    """{node: summary} over nodes.jsonl records: sample/gap/log
    counts, resource extremes, the clock-offset range, and the last
    breaker state seen."""
    out: dict[str, dict] = {}
    for rec in records or []:
        node = str(rec.get("node"))
        s = out.setdefault(node, {
            "samples": 0, "gaps": {}, "logs": {},
            "cpu_max": None, "mem_used_max": None,
            "offset_min": None, "offset_max": None,
            "breaker": None, "t_last": 0})
        s["t_last"] = max(s["t_last"], rec.get("t", 0))
        kind = rec.get("kind")
        if kind == "sample":
            s["samples"] += 1
            busy = (rec.get("cpu") or {}).get("busy")
            if busy is not None:
                s["cpu_max"] = max(s["cpu_max"] or 0.0, busy)
            used = (rec.get("mem") or {}).get("used_frac")
            if used is not None:
                s["mem_used_max"] = max(s["mem_used_max"] or 0.0, used)
            off = rec.get("clock_offset_s")
            if off is not None:
                s["offset_min"] = (off if s["offset_min"] is None
                                   else min(s["offset_min"], off))
                s["offset_max"] = (off if s["offset_max"] is None
                                   else max(s["offset_max"], off))
        elif kind == "gap":
            r = str(rec.get("reason"))
            s["gaps"][r] = s["gaps"].get(r, 0) + 1
        elif kind == "log":
            c = str(rec.get("class"))
            s["logs"][c] = s["logs"].get(c, 0) + 1
        elif kind == "breaker":
            s["breaker"] = rec.get("state")
    return out


def nodes_text(records, history=None) -> str:
    """The `nodes` CLI body: one row per node plus the merged
    clock-skew bound (probe offsets + the history's check-offsets
    observations)."""
    summaries = summarize(records)
    if not summaries:
        return ("(no node-plane records — run with nodeprobe enabled, "
                "e.g. `python -m jepsen_tpu_torch test --no-ssh`)")
    lines = [f"{'node':<10} {'samples':>7} {'gaps':>5} {'cpu max':>8} "
             f"{'mem max':>8} {'offset range (s)':>20}  log events"]
    lines.append("-" * len(lines[0]))
    for node in sorted(summaries):
        s = summaries[node]
        gaps = sum(s["gaps"].values())
        cpu = f"{s['cpu_max']:.0%}" if s["cpu_max"] is not None else "-"
        mem = (f"{s['mem_used_max']:.0%}"
               if s["mem_used_max"] is not None else "-")
        if s["offset_min"] is not None:
            off = f"{s['offset_min']:+.3f}..{s['offset_max']:+.3f}"
        else:
            off = "-"
        logs = ", ".join(f"{c}×{n}" for c, n in sorted(
            s["logs"].items())) or "-"
        badge = f" [{s['breaker']}]" if s["breaker"] not in (
            None, "closed") else ""
        lines.append(f"{node:<10} {s['samples']:>7} {gaps:>5} "
                     f"{cpu:>8} {mem:>8} {off:>20}  {logs}{badge}")
    bound = nodeprobe.clock_skew_bound(records, history)
    lines.append("")
    if bound is not None:
        lines.append(f"clock-skew-bound: {bound:.6f}s (worst |offset| "
                     "across probe + check-offsets series — stamped "
                     "on realtime verdicts)")
    else:
        lines.append("clock-skew-bound: (no clock observations)")
    gaps_total = sum(sum(s["gaps"].values())
                     for s in summaries.values())
    if gaps_total:
        lines.append(f"gap markers: {gaps_total} (missing samples are "
                     "recorded, never interpolated)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Web lanes
# ---------------------------------------------------------------------------

_LANE_W = 640
_LANE_H = 18
_LEFT = 80
_MAX_LANE_SAMPLES = 400  # per node; ~550px of lane can't show more

_CLASS_COLOR = {"panic-assert": "#d22", "oom-kill": "#b36",
                "corruption": "#80d", "election": "#26c",
                "restart": "#2a7"}


def _x(t: int, t_max: int) -> float:
    return _LEFT + (t / t_max) * (_LANE_W - _LEFT - 10)


def lanes_html(records, faults=None, bound=None) -> str:
    """The per-node lanes section: an SVG per run with one lane per
    node (CPU shading, log-event ticks, gap ticks) under the nemesis
    fault windows (the coverage record's `faults` list). `bound`
    overrides the skew caption with the verdict's stamped merged
    bound (probe + check-offsets); without it the caption falls back
    to the probe series alone. Empty string when there are no
    records."""
    records = list(records or [])
    if not records:
        return ""
    by_node: dict[str, list] = {}
    t_max = 1
    for rec in records:
        by_node.setdefault(str(rec.get("node")), []).append(rec)
        t_max = max(t_max, rec.get("t", 0))
    windows = []
    for f in faults or []:
        for w in f.get("windows") or []:
            t0 = w[0]
            t1 = w[1] if w[1] is not None else t_max
            t_max = max(t_max, t1)
            windows.append((str(f.get("kind")), t0, t1))
    summaries = summarize(records)
    nodes = sorted(by_node)
    head_h = 16 if windows else 4
    height = head_h + len(nodes) * (_LANE_H + 6) + 8
    parts = [f"<svg xmlns='http://www.w3.org/2000/svg' "
             f"width='{_LANE_W}' height='{height}' "
             f"font-family='monospace' font-size='10'>"]
    # nemesis fault windows span every lane (the coverage record is
    # the authority on what was injected when)
    for kind, t0, t1 in windows:
        x0, x1 = _x(t0, t_max), _x(t1, t_max)
        parts.append(
            f"<rect x='{x0:.0f}' y='{head_h}' "
            f"width='{max(x1 - x0, 2):.0f}' "
            f"height='{height - head_h - 4}' fill='#FEB5DA' "
            f"fill-opacity='0.35'><title>{_html.escape(kind)} "
            f"window</title></rect>")
        parts.append(f"<text x='{x0:.0f}' y='{head_h - 4}' "
                     f"fill='#b36'>{_html.escape(kind)}</text>")
    for i, node in enumerate(nodes):
        y = head_h + i * (_LANE_H + 6) + 4
        badge = summaries.get(node, {}).get("breaker")
        label = node + (f" [{badge}]" if badge not in (None, "closed")
                        else "")
        parts.append(f"<text x='4' y='{y + 12}' fill='#444'>"
                     f"{_html.escape(label)}</text>")
        parts.append(f"<rect x='{_LEFT}' y='{y}' "
                     f"width='{_LANE_W - _LEFT - 10}' "
                     f"height='{_LANE_H}' fill='#f6f6f6'/>")
        recs = sorted(by_node[node], key=lambda r: r.get("t", 0))
        # bound the SVG: the lane is ~550px wide, so beyond ~400
        # samples extra rects only bloat the page. Stride-sample the
        # resource strip; event/gap/breaker ticks are never dropped.
        samples = [r for r in recs if r.get("kind") == "sample"]
        if len(samples) > _MAX_LANE_SAMPLES:
            stride = -(-len(samples) // _MAX_LANE_SAMPLES)
            keep = set(map(id, samples[::stride]))
            recs = [r for r in recs if r.get("kind") != "sample"
                    or id(r) in keep]
        prev_x = None
        for rec in recs:
            x = _x(rec.get("t", 0), t_max)
            kind = rec.get("kind")
            if kind == "sample":
                busy = (rec.get("cpu") or {}).get("busy")
                if busy is not None and prev_x is not None:
                    # cpu strip: the segment since the previous sample,
                    # shaded by utilization
                    shade = int(230 - 170 * min(busy, 1.0))
                    parts.append(
                        f"<rect x='{prev_x:.0f}' y='{y}' "
                        f"width='{max(x - prev_x, 1):.0f}' "
                        f"height='{_LANE_H}' "
                        f"fill='rgb({shade},{shade},255)'>"
                        f"<title>{_html.escape(node)} cpu "
                        f"{busy:.0%}</title></rect>")
                prev_x = x
            elif kind == "gap":
                # an honest gap tick: the probe could NOT see this
                # node here (no interpolation)
                parts.append(
                    f"<rect x='{x:.0f}' y='{y}' width='3' "
                    f"height='{_LANE_H}' fill='#999'>"
                    f"<title>gap: {_html.escape(str(rec.get('reason')))}"
                    f"</title></rect>")
                prev_x = None  # never shade across a gap
            elif kind == "log":
                cls = str(rec.get("class"))
                color = _CLASS_COLOR.get(cls, "#222")
                title = _html.escape(
                    f"{cls}: {str(rec.get('line'))[:120]}")
                parts.append(
                    f"<rect x='{x:.0f}' y='{y - 2}' width='2' "
                    f"height='{_LANE_H + 4}' fill='{color}'>"
                    f"<title>{title}</title></rect>")
            elif kind == "breaker":
                parts.append(
                    f"<rect x='{x:.0f}' y='{y - 2}' width='2' "
                    f"height='{_LANE_H + 4}' fill='#FFAA26'>"
                    f"<title>breaker → "
                    f"{_html.escape(str(rec.get('state')))}"
                    f"</title></rect>")
    parts.append("</svg>")
    legend = ("<p><small>lanes: blue shading = CPU busy, colored "
              "ticks = tagged DB-log events ("
              + ", ".join(f"<span style='color:{c}'>{cls}</span>"
                          for cls, c in _CLASS_COLOR.items())
              + "), gray = probe gap (node unreachable/quarantined — "
                "never interpolated), pink bands = nemesis fault "
                "windows</small></p>")
    if bound is None:
        bound = nodeprobe.clock_skew_bound(records)
    skew = (f"<p><small>clock-skew-bound: {bound:.6f}s "
            "(probe + check-offsets merged series)</small></p>"
            if bound is not None else "")
    return ("<h2>nodes</h2>" + "".join(parts) + legend + skew)
