"""HTML Gantt timeline of a history, one column per process (the port's
copy of jepsen_tpu/reports/timeline.py: the same HTML, byte for byte).

Capability reference: jepsen/src/jepsen/checker/timeline.clj — 10k op
cap (13-15), css styles (28-37), process pairing (39-58), op rendering
and layout constants (timescale 1e6 ns/px, col-width 100px, height
16px).
"""

from __future__ import annotations

import html as _html
import logging

from ..history import History, is_info, is_invoke

logger = logging.getLogger(__name__)

OP_LIMIT = 10_000
"""Maximum ops rendered (timeline.clj:13-15)."""

TIMESCALE = 1e6   # nanoseconds per pixel
COL_WIDTH = 100   # px
GUTTER_WIDTH = 106
HEIGHT = 16

STYLESHEET = """\
body        { font-family: sans-serif; font-size: 11px; }
.ops        { position: absolute; }
.op         { position: absolute; padding: 2px; border-radius: 2px;
              box-shadow: 0 1px 3px rgba(0,0,0,0.12),
                          0 1px 2px rgba(0,0,0,0.24);
              overflow: hidden; }
.op.invoke  { background: #eeeeee; }
.op.ok      { background: #6DB6FE; }
.op.info    { background: #FFAA26; }
.op.fail    { background: #FEB5DA; }
.op:target  { box-shadow: 0 14px 28px rgba(0,0,0,0.25),
                          0 10px 10px rgba(0,0,0,0.22); }
"""


def pairs(history) -> list:
    """[invoke, completion] / [info] / [invoke] pairs per process
    (timeline.clj:39-58)."""
    invocations: dict = {}
    out: list = []
    for o in history:
        if is_invoke(o):
            invocations[o.process] = o
        elif is_info(o) and o.process not in invocations:
            out.append([o])  # unmatched info
        else:
            inv = invocations.pop(o.process, None)
            if inv is not None:
                out.append([inv, o])
            else:
                out.append([o])
    # still-open invocations render as bars to the end
    out.extend([inv] for inv in invocations.values())
    return out


def _title(op, trace_lines=None) -> str:
    lines = [f"process {op.process}", f"type {op.type}", f"f {op.f}",
             f"index {op.index}", f"value {op.value!r}"]
    if op.ext:
        lines += [f"{k} {v!r}" for k, v in op.ext.items()]
    if trace_lines:
        lines.append("— trace —")
        lines.extend(trace_lines)
    return _html.escape("\n".join(lines), quote=True)


_TRACE_LINE_LIMIT = 8
"""Max per-op trace lines in a hover title."""


def trace_titles(optrace) -> dict:
    """{invocation op index: [hover line, ...]} from per-op trace
    records (tracing.py) — what each op *did* (client calls,
    remote commands, retries, reconnects), surfaced where the op sits
    on the timeline."""
    from .. import tracing

    out: dict = {}
    for opi, recs in tracing.by_op(optrace or []).items():
        lines = [tracing.describe(r) for r in recs
                 if r.get("kind") != "op"][:_TRACE_LINE_LIMIT]
        if lines:
            out[opi] = lines
    return out


def render_html(test, history: History, optrace=None) -> str:
    history = History(
        [o for o in history if o.type in
         ("invoke", "ok", "fail", "info")], assign_indices=False)
    truncated = False
    prs = pairs(history)
    if len(prs) > OP_LIMIT:
        prs = prs[:OP_LIMIT]
        truncated = True
    processes: list = []
    seen = set()
    for pair in prs:
        p = pair[0].process
        if p not in seen:
            seen.add(p)
            processes.append(p)
    col_of = {p: i for i, p in enumerate(processes)}
    tmax = max((o.time for o in history), default=0)
    titles = trace_titles(optrace)

    cells = []
    for pair in prs:
        first, last = pair[0], pair[-1]
        t0 = first.time
        t1 = last.time if len(pair) > 1 else tmax
        top = t0 / TIMESCALE
        h = max((t1 - t0) / TIMESCALE, HEIGHT)
        left = GUTTER_WIDTH * col_of[first.process]
        typ = last.type
        label = f"{first.process} {first.f} {first.value!r}"
        cells.append(
            f'<div id="op-{first.index}" class="op {typ}" '
            f'style="left:{left:.0f}px; top:{top:.1f}px; '
            f'width:{COL_WIDTH}px; height:{h:.1f}px" '
            f'title="{_title(last, titles.get(first.index))}">'
            f'{_html.escape(label)}</div>')

    headers = "".join(
        f'<div style="position:absolute; left:{GUTTER_WIDTH * i}px; '
        f'top:0; width:{COL_WIDTH}px; font-weight:bold">'
        f'{_html.escape(str(p))}</div>'
        for i, p in enumerate(processes))
    note = (f"<p><b>Truncated to {OP_LIMIT} operations.</b></p>"
            if truncated else "")
    name = _html.escape(str(test.get("name") or "test"))
    return (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{name} timeline</title>"
            f"<style>{STYLESHEET}</style></head><body>"
            f"<h1>{name}</h1>{note}"
            f"<div style='position:relative; height:24px'>{headers}"
            f"</div><div class='ops' style='position:relative'>"
            + "".join(cells) + "</div></body></html>")


def html():
    """Checker writing timeline.html into the store dir
    (timeline.clj html)."""
    from ..checker import _Fn

    def run(test, history, opts):
        if not (test.get("store_dir") or test.get("name")):
            return {"valid?": True, "skipped": "no store directory"}
        from .. import store

        optrace = None
        if test.get("store_dir"):
            try:  # per-op trace detail in the hover titles, if traced
                optrace = store.load_optrace(test["store_dir"]) or None
            except OSError:
                optrace = None
        sub = (opts or {}).get("subdirectory")
        parts = ([sub, "timeline.html"] if sub else ["timeline.html"])
        out = store.path(test, *parts)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(render_html(test, history, optrace=optrace))
        return {"valid?": True, "file": str(out)}

    return _Fn(run)
