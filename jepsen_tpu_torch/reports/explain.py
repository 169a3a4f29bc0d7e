"""Human-readable anomaly explanation artifacts (the port's copy of
jepsen_tpu/reports/explain.py; file names and bytes are the JAX
package's).

Capability reference: the reference writes elle's anomaly files and
graphviz cycle plots into store/<test>/elle/ (append.clj:17-27 passes
:directory to elle.list-append/check) and renders the linearizability
counterexample — the stuck configs around the first un-linearizable
op — as an SVG (knossos.linear.report/render-analysis!, invoked from
jepsen/src/jepsen/checker.clj:222-229).

Both artifacts are dependency-free: anomaly files are plain text,
cycle plots are hand-rolled SVG (circular layout) plus graphviz dot
text, and the linearizability counterexample is an SVG timeline of the
ops in flight at the stuck point, one lane per process.

Anomaly provenance: when the run carried the per-op causal trace
(optrace.jsonl, tracing.py), each anomaly's participating op indices
(the `op-indices` the checkers attach) resolve into *trace excerpts* —
the client calls, remote commands, retries and fault events behind
exactly those ops — written next to the anomaly files.
"""

from __future__ import annotations

import html
import math
from pathlib import Path

# ---------------------------------------------------------------------------
# elle anomaly artifacts
# ---------------------------------------------------------------------------


def _fmt_op(op) -> str:
    if op is None:
        return "nil"
    if hasattr(op, "to_dict"):
        op = op.to_dict()
    return repr(op)


def _fmt_record(rec) -> str:
    if isinstance(rec, dict):
        lines = []
        for k, v in rec.items():
            if k in ("op", "writer", "previous-ok"):
                lines.append(f"  {k}: {_fmt_op(v)}")
            elif k == "cycle":
                lines.append("  cycle:")
                lines.extend(f"    {_fmt_op(o)}" for o in v)
            elif k == "steps":
                lines.append("  steps:")
                lines.extend(
                    f"    T{s['from']} -{s['type']}-> T{s['to']}"
                    for s in v)
            else:
                lines.append(f"  {k}: {v!r}")
        return "\n".join(lines)
    return f"  {rec!r}"


def _fingerprint(obj) -> str:
    """Short deterministic content tag so concurrent per-key checkers
    sharing one store directory never clobber each other's artifacts
    (the checkpoint files solve the same collision the same way)."""
    import zlib

    return f"{zlib.crc32(repr(obj).encode()) & 0xffffffff:08x}"


def write_elle_artifacts(store_dir, result: dict,
                         subdir: str = "elle") -> list[str]:
    """Writes one text file per anomaly type plus cycle plots (SVG +
    dot) into <store_dir>/<subdir>/, filenames tagged with a content
    fingerprint; returns the written paths. No-op (empty list) for
    valid results."""
    anomalies = (result or {}).get("anomalies") or {}
    if not anomalies:
        return []
    out_dir = Path(store_dir) / subdir
    out_dir.mkdir(parents=True, exist_ok=True)
    # fingerprint the CONTENT (records carry op indices), not just the
    # type names — per-key checks often share the same anomaly types
    fp = _fingerprint(sorted((k, repr(v)) for k, v in anomalies.items()))
    written: list[str] = []
    for name, records in sorted(anomalies.items()):
        p = out_dir / f"{name}-{fp}.txt"
        body = [f"{name}: {len(records)} instance(s)", ""]
        for i, rec in enumerate(records):
            body.append(f"-- instance {i} " + "-" * 40)
            body.append(_fmt_record(rec))
            body.append("")
        p.write_text("\n".join(body))
        written.append(str(p))
    # cycle plots for cycle-shaped anomalies (they carry "steps")
    cyc_idx = 0
    dot_lines = ["digraph anomalies {", "  rankdir=LR;"]
    have_cycles = False
    for name, records in sorted(anomalies.items()):
        for rec in records:
            steps = rec.get("steps") if isinstance(rec, dict) else None
            if not steps:
                continue
            have_cycles = True
            svg = _cycle_svg(name, steps, rec.get("cycle"))
            p = out_dir / f"cycle-{name}-{fp}-{cyc_idx}.svg"
            p.write_text(svg)
            written.append(str(p))
            for s in steps:
                dot_lines.append(
                    f'  "T{s["from"]}" -> "T{s["to"]}"'
                    f' [label="{s["type"]}"];  /* {name} */')
            cyc_idx += 1
    if have_cycles:
        dot_lines.append("}")
        p = out_dir / f"cycles-{fp}.dot"
        p.write_text("\n".join(dot_lines))
        written.append(str(p))
    return written


# ---------------------------------------------------------------------------
# Per-anomaly trace excerpts (anomaly provenance)
# ---------------------------------------------------------------------------

_EXCERPT_RECORDS_PER_OP = 12


def trace_excerpt_lines(by_op: dict, indices) -> list[str]:
    """Text lines describing the trace records behind the given op
    (invocation) indices: for each op, its root span then every
    client/remote span and event, one compact line each
    (tracing.describe)."""
    from .. import tracing

    lines: list[str] = []
    for i in indices:
        recs = by_op.get(i)
        if not recs:
            lines.append(f"op {i}: (no trace records)")
            continue
        lines.append(f"op {i}:")
        recs = sorted(recs, key=lambda r: (r.get("t0", 0),
                                           r.get("span", 0)))
        for rec in recs[:_EXCERPT_RECORDS_PER_OP]:
            lines.append(f"  {tracing.describe(rec)}")
        if len(recs) > _EXCERPT_RECORDS_PER_OP:
            lines.append(f"  … {len(recs) - _EXCERPT_RECORDS_PER_OP} "
                         "more record(s)")
    return lines


def _load_by_op(store_dir, optrace):
    from .. import store, tracing

    if optrace is None:
        optrace = store.load_optrace(store_dir)
    return tracing.by_op(optrace or [])


# node-plane context around an anomaly: events this far outside the
# ops' own window still make the excerpt (an OOM-kill 2s before the
# lost write is exactly the context the excerpt exists for)
_NODE_CONTEXT_SLACK_NS = 2_000_000_000
_NODE_CONTEXT_LIMIT = 16


def node_context_lines(noderecs, t0_ns: int, t1_ns: int,
                       slack_ns: int = _NODE_CONTEXT_SLACK_NS
                       ) -> list[str]:
    """Text lines for the node observability plane's events (tagged
    DB-log lines, probe gaps, breaker transitions — nodeprobe.py)
    inside [t0-slack, t1+slack]: what the NODES were doing
    while the anomaly's ops ran. Empty when the run had no node plane
    or nothing happened in the window."""
    lo, hi = t0_ns - slack_ns, t1_ns + slack_ns
    picked = []
    for rec in noderecs or []:
        kind = rec.get("kind")
        if kind not in ("log", "gap", "breaker"):
            continue
        t = rec.get("t", 0)
        if not lo <= t <= hi:
            continue
        if kind == "log":
            desc = (f"{rec.get('class')} ({rec.get('ts')} ts): "
                    f"{str(rec.get('line'))[:140]}")
        elif kind == "gap":
            desc = f"probe gap: {rec.get('reason')}"
        else:
            desc = f"breaker -> {rec.get('state')}"
        picked.append((t, f"  t={t / 1e9:+.3f}s {rec.get('node')}: "
                          f"{desc}"))
    if not picked:
        return []
    picked.sort()
    # the heading names the module that wrote nodes.jsonl, as the JAX
    # package's excerpt does: the two packages' files are byte-equal
    lines = ["", f"node events in the op window ({len(picked)}; "
                 "jepsen_tpu.nodeprobe):"]
    lines.extend(line for _t, line in picked[:_NODE_CONTEXT_LIMIT])
    if len(picked) > _NODE_CONTEXT_LIMIT:
        lines.append(f"  … {len(picked) - _NODE_CONTEXT_LIMIT} "
                     "more event(s)")
    return lines


def _op_window(by_op: dict, indices) -> tuple[int, int] | None:
    """The [min t0, max t1] span of the trace records behind the given
    op indices — the anomaly's op window node context keys on."""
    t0 = t1 = None
    for i in indices:
        for rec in by_op.get(i) or []:
            a = rec.get("t0")
            b = rec.get("t1", a)
            if a is None:
                continue
            t0 = a if t0 is None else min(t0, a)
            t1 = b if t1 is None else max(t1, b if b is not None
                                          else a)
    return (t0, t1) if t0 is not None else None


def _load_noderecs(store_dir, noderecs):
    if noderecs is not None:
        return noderecs
    from .. import nodeprobe

    return nodeprobe.load_records(store_dir)


def write_trace_excerpts(store_dir, result: dict, optrace=None,
                         subdir: str = "elle",
                         noderecs=None) -> list[str]:
    """Resolves each anomaly's op-indices into a per-anomaly trace
    excerpt file (<name>-trace-<fp>.txt next to the anomaly files);
    when the run carried the node observability plane (nodes.jsonl),
    the node events inside the anomaly's op window ride along in the
    same excerpt. Returns the written paths. No-op when the run wasn't
    traced or no record carries op-indices."""
    anomalies = (result or {}).get("anomalies") or {}
    if not anomalies:
        return []
    by_op = _load_by_op(store_dir, optrace)
    if not by_op:
        return []
    noderecs = _load_noderecs(store_dir, noderecs)
    out_dir = Path(store_dir) / subdir
    fp = _fingerprint(sorted((k, repr(v)) for k, v in anomalies.items()))
    written: list[str] = []
    for name, records in sorted(anomalies.items()):
        idxs = sorted({i for rec in records if isinstance(rec, dict)
                       for i in rec.get("op-indices") or []})
        if not idxs:
            continue
        body = [f"{name}: trace excerpts for participating ops "
                f"{idxs}", ""]
        body.extend(trace_excerpt_lines(by_op, idxs))
        window = _op_window(by_op, idxs)
        if window is not None:
            body.extend(node_context_lines(noderecs, *window))
        out_dir.mkdir(parents=True, exist_ok=True)
        p = out_dir / f"{name}-trace-{fp}.txt"
        p.write_text("\n".join(body) + "\n")
        written.append(str(p))
    return written


def write_linear_trace_excerpt(store_dir, analysis: dict,
                               optrace=None) -> str | None:
    """The linearizability counterexample's trace excerpt: the stuck
    op, its predecessor, and the pending ops (analysis['op-indices'],
    attached by tpu/wgl), resolved against the per-op trace. Returns
    the path written, or None when untraced/valid."""
    idxs = (analysis or {}).get("op-indices") or []
    if not idxs or analysis.get("valid?") is not False:
        return None
    by_op = _load_by_op(store_dir, optrace)
    if not any(i in by_op for i in idxs):
        return None
    fp = _fingerprint(tuple(idxs))
    body = [f"linearizability counterexample: trace excerpts for "
            f"participating ops {sorted(idxs)}", ""]
    search = (analysis or {}).get("search")
    if isinstance(search, dict) and \
            search.get("witness-position") is not None:
        # where in the history the search got stuck (the explorer's
        # witness percentile) — localization context for the reader
        body.insert(1, "witnessed at "
                    f"{search['witness-position'] * 100:.1f}% of the "
                    f"history (entry {search.get('witness-entry')} of "
                    f"{search.get('entries')})")
    body.extend(trace_excerpt_lines(by_op, sorted(idxs)))
    window = _op_window(by_op, sorted(idxs))
    if window is not None:
        body.extend(node_context_lines(
            _load_noderecs(store_dir, None), *window))
    p = Path(store_dir) / f"linear-counterexample-trace-{fp}.txt"
    p.write_text("\n".join(body) + "\n")
    return str(p)


def _cycle_svg(name: str, steps: list[dict], cycle_ops=None) -> str:
    """A circular-layout SVG of one dependency cycle."""
    nodes = []
    for s in steps:
        for t in (s["from"], s["to"]):
            if t not in nodes:
                nodes.append(t)
    n = max(len(nodes), 1)
    R, cx, cy = 150, 260, 200
    pos = {t: (cx + R * math.cos(2 * math.pi * i / n - math.pi / 2),
               cy + R * math.sin(2 * math.pi * i / n - math.pi / 2))
           for i, t in enumerate(nodes)}
    ops_by_node = {}
    if cycle_ops:
        for s, op in zip(steps, cycle_ops):
            ops_by_node[s["from"]] = op
    parts = [
        '<svg xmlns="http://www.w3.org/2000/svg" width="520" '
        'height="420" font-family="monospace" font-size="11">',
        f'<text x="10" y="20" font-size="14">{html.escape(name)} '
        f'cycle ({len(steps)} edges)</text>',
        '<defs><marker id="arr" viewBox="0 0 10 10" refX="9" refY="5" '
        'markerWidth="7" markerHeight="7" orient="auto-start-reverse">'
        '<path d="M 0 0 L 10 5 L 0 10 z" fill="#444"/></marker></defs>',
    ]
    for s in steps:
        x1, y1 = pos[s["from"]]
        x2, y2 = pos[s["to"]]
        # shorten toward the node circle so the arrowhead shows
        dx, dy = x2 - x1, y2 - y1
        d = math.hypot(dx, dy) or 1.0
        sx, sy = x1 + dx / d * 22, y1 + dy / d * 22
        ex, ey = x2 - dx / d * 22, y2 - dy / d * 22
        parts.append(
            f'<line x1="{sx:.0f}" y1="{sy:.0f}" x2="{ex:.0f}" '
            f'y2="{ey:.0f}" stroke="#444" marker-end="url(#arr)"/>')
        mx, my = (sx + ex) / 2, (sy + ey) / 2
        parts.append(
            f'<text x="{mx:.0f}" y="{my - 4:.0f}" fill="#a00" '
            f'text-anchor="middle">{html.escape(str(s["type"]))}</text>')
    for t in nodes:
        x, y = pos[t]
        parts.append(
            f'<circle cx="{x:.0f}" cy="{y:.0f}" r="20" fill="#eef" '
            'stroke="#447"/>')
        parts.append(
            f'<text x="{x:.0f}" y="{y + 4:.0f}" '
            f'text-anchor="middle">T{t}</text>')
        op = ops_by_node.get(t)
        if op is not None:
            label = html.escape(_short_op(op))
            parts.append(
                f'<text x="{x:.0f}" y="{y + 34:.0f}" font-size="9" '
                f'text-anchor="middle">{label}</text>')
    parts.append("</svg>")
    return "\n".join(parts)


def _short_op(op, limit: int = 40) -> str:
    try:
        v = op.value if hasattr(op, "value") else op.get("value")
    except Exception:  # noqa: BLE001
        v = None
    s = repr(v)
    return s[:limit] + ("…" if len(s) > limit else "")


# ---------------------------------------------------------------------------
# linearizability counterexample
# ---------------------------------------------------------------------------


def render_linear_svg(analysis: dict, path) -> str | None:
    """Renders the stuck point of a failed linearizability check — the
    first un-linearizable op, its predecessor, and the ops pending in
    each surviving config, one lane per process — to an SVG file.
    Returns the path written, or None for valid/witness-less analyses.
    Mirrors what knossos.linear.report/render-analysis! conveys
    (checker.clj:222-229): WHAT couldn't linearize, WHEN, and what the
    model could have been."""
    if not analysis or analysis.get("valid?") is not False:
        return None
    crash_op = analysis.get("op")
    configs = analysis.get("configs") or []
    prev_ok = analysis.get("previous-ok")
    if crash_op is None and not configs:
        return None

    # collect (op, role) participants
    rows: list[tuple] = []
    if prev_ok is not None:
        rows.append((prev_ok, "previous-ok"))
    if crash_op is not None:
        rows.append((crash_op, "unlinearizable"))
    for ci, cfg in enumerate(configs):
        for op in cfg.get("pending", []):
            rows.append((op, f"pending (config {ci})"))
    seen = set()
    uniq: list[tuple] = []
    for op, role in rows:
        key = (id(op) if not hasattr(op, "index") else op.index, role)
        if key in seen:
            continue
        seen.add(key)
        uniq.append((op, role))

    def op_attr(op, name, default=None):
        if hasattr(op, name):
            return getattr(op, name)
        if isinstance(op, dict):
            return op.get(name, default)
        return default

    procs: list = []
    for op, _ in uniq:
        p = op_attr(op, "process")
        if p not in procs:
            procs.append(p)
    idxs = [op_attr(op, "index", 0) or 0 for op, _ in uniq]
    lo, hi = (min(idxs), max(idxs)) if idxs else (0, 1)
    span = max(hi - lo, 1)

    lane_h, left, width = 34, 90, 640
    height = 90 + lane_h * max(len(procs), 1) + 30 * max(len(configs), 1)
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width + 40}" '
        f'height="{height}" font-family="monospace" font-size="11">',
        '<text x="10" y="18" font-size="14">linearizability '
        'counterexample</text>',
        f'<text x="10" y="34" fill="#666">history indices {lo}..{hi}'
        '</text>',
    ]
    colors = {"previous-ok": "#2a7", "unlinearizable": "#d22"}
    for li, p in enumerate(procs):
        y = 60 + li * lane_h
        parts.append(
            f'<text x="8" y="{y + 4}" fill="#444">proc {p}</text>')
        parts.append(
            f'<line x1="{left}" y1="{y}" x2="{width}" y2="{y}" '
            'stroke="#ddd"/>')
    for op, role in uniq:
        p = op_attr(op, "process")
        li = procs.index(p)
        y = 60 + li * lane_h
        idx = op_attr(op, "index", 0) or 0
        x = left + (idx - lo) / span * (width - left - 60)
        c = colors.get(role, "#48c")
        parts.append(
            f'<circle cx="{x:.0f}" cy="{y}" r="6" fill="{c}"/>')
        f = op_attr(op, "f")
        v = op_attr(op, "value")
        label = html.escape(f"{f} {v!r}"[:36])
        parts.append(
            f'<text x="{x + 10:.0f}" y="{y - 8}" fill="{c}">'
            f'{label}</text>')
        parts.append(
            f'<text x="{x + 10:.0f}" y="{y + 14}" font-size="9" '
            f'fill="#888">{html.escape(role)}</text>')
    y0 = 60 + len(procs) * lane_h + 16
    for ci, cfg in enumerate(configs):
        model = cfg.get("model")
        parts.append(
            f'<text x="10" y="{y0 + ci * 24}" fill="#555">config {ci}: '
            f'model={html.escape(repr(model)[:60])} '
            f'pending={len(cfg.get("pending", []))}</text>')
    if "failed-segment" in analysis:
        parts.append(
            f'<text x="10" y="{height - 10}" fill="#555">failed '
            f'segment {analysis["failed-segment"]} '
            f'(entries {analysis.get("segment-range")})</text>')
    parts.append("</svg>")
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(parts))
    return str(out)
