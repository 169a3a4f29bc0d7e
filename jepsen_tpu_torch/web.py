"""Web UI over the store: browse tests, results, and artifacts (the
port's copy of jepsen_tpu/web.py; every page is the JAX module's, byte
for byte over the same store, but for the lint's report, which reads
the port's kernel launches, and the port's command name).

Capability reference: jepsen/src/jepsen/web.clj — home page scanning
the store with cheap header reads (51-112), per-test file browser with
a path-traversal guard (288-388), zip download of a test directory
(340-381), app routes '/' and '/files/' (431-446).

Beyond the reference: a `/telemetry/<run>` span/metrics page, a
`/live/<run>` dashboard that streams an *in-progress* run over
Server-Sent Events by tailing the live monitor's timeseries.jsonl
(monitor.py flushes each point, so the server — typically a
separate process from the test — sees them as they land; `/live/`
with no run path follows the store's `current` symlink), and a
`/trace/<run>?ops=...` endpoint serving the Chrome-trace/Perfetto
JSON, optionally pre-filtered to an anomaly's participating ops — the
run page lists each anomaly with such drill-down links (anomaly
provenance, tracing.py).

`/lint` serves the port's graftlint report (jepsen_tpu_torch.analysis)
gated against lint-baseline-torch.json, with `?json=1` and
`?refresh=1`, and the run page shows its panel, both from one report
cached per process (the report describes the code, not a run).
"""

from __future__ import annotations

import html as _html
import io
import json
import logging
import os
import threading
import time
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, unquote, urlsplit

from . import store as jstore

logger = logging.getLogger(__name__)

# SSE tail tuning: poll cadence for new points, idle heartbeat, and a
# hard cap so an abandoned client can't pin a thread forever.
SSE_POLL_S = 0.25
SSE_HEARTBEAT_S = 10.0
SSE_MAX_S = 6 * 3600.0
# the /fleet live charts poll the fleet server itself, so they tick
# slower than the file-tail cadence above
FLEET_SSE_POLL_S = 2.0


def fast_tests(base: Path | None = None) -> list:
    """Cheap per-test summaries for the home page (web.clj:51-112):
    reads only results.json, never the history. `flags` surfaces the
    run's robustness story: 'degraded' (nodes were quarantined),
    'resumed' (results come from offline `analyze`), 'recoverable' (no
    results but an op log survives — `analyze --resume` can finish the
    job; resume.py). A run whose log is still being written
    (quiet for < RECOVERABLE_QUIET_S) is live, not crashed, and is
    not flagged."""
    out = []
    for td in jstore.tests(base=base):
        res = None
        try:
            res = jstore.load_results(td)
        except (OSError, json.JSONDecodeError):
            pass
        flags = []
        if isinstance(res, dict):
            if res.get("degraded"):
                flags.append("degraded")
            if (res.get("analysis") or {}).get("offline?"):
                flags.append("resumed")
        elif _looks_recoverable(td):
            flags.append("recoverable")
        out.append({"name": td.parent.name, "time": td.name,
                    "dir": td, "flags": flags,
                    "valid": (res or {}).get("valid?", "incomplete")})
    return out


# a resultless run whose store went quiet this long is crashed, not
# live — only then does the home page advertise `analyze --resume`
RECOVERABLE_QUIET_S = 60.0


def _run_pid_alive(td: Path) -> bool:
    """True if the run's recorded control process still exists — a
    live run, however quiet (a single checker can compute for minutes
    without touching any file). Pid reuse can only make a CRASHED run
    look live (missed flag), never a live run look crashed."""
    try:
        pid = int((td / "run.pid").read_text().strip())
    except (OSError, ValueError):
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, different owner
    except OSError:
        return False
    return True


def _looks_recoverable(td: Path) -> bool:
    if not (td / "history.jlog").exists():
        return False  # nothing to recover
    if _run_pid_alive(td):
        return False  # still running, just quiet
    # For runs without a pid marker (older stores), fall back to
    # quietness over EVERY artifact a live run keeps writing: the op
    # log goes quiet when the op phase ends, but analysis still logs
    # (jepsen.log) and streams partial results — a >60s-analysis run
    # must not be advertised as crashed
    last = 0.0
    for name in ("history.jlog", "jepsen.log", "results.partial.jlog",
                 "telemetry.jsonl", "timeseries.jsonl"):
        try:
            last = max(last, (td / name).stat().st_mtime)
        except OSError:
            pass
    return time.time() - last > RECOVERABLE_QUIET_S


def _valid_color(valid) -> str:
    return {True: "#6DB6FE", False: "#FEB5DA",
            "unknown": "#FFAA26"}.get(valid, "#eeeeee")


# coverage heatmap cell colors: witnessed shares the invalid pink
# (an anomaly was found), clean the valid blue, indeterminate the
# unknown orange; never-exercised gaps stay blank
_STATUS_COLOR = {"witnessed": "#FEB5DA", "clean": "#6DB6FE",
                 "unknown": "#FFAA26", "gap": "#f4f4f4"}


def _atlas_cells(base: Path):
    from . import coverage as jcoverage

    entries = jcoverage.read_atlas(Path(base) / jcoverage.ATLAS_FILE)
    return jcoverage.aggregate(entries)


def coverage_html(cells, all_workloads=None) -> str:
    """The /coverage/ heatmap: fault kinds × workloads, each cell
    colored by its folded status and deep-linking to the cell detail
    page (witnessing runs + anomaly classes)."""
    from . import coverage as jcoverage

    faults, wls = jcoverage._axes(cells, all_workloads)
    head = "".join(
        f"<th><div>{_html.escape(k)}</div></th>" for k in faults)
    rows = []
    for w in wls:
        tds = []
        for k in faults:
            st = jcoverage.cell_status(cells, k, w)
            runs = sum(c["runs"] for (ck, cw, _a), c in cells.items()
                       if ck == k and cw == w)
            label = {"witnessed": "X", "clean": "o",
                     "unknown": "?", "gap": ""}[st]
            title = _html.escape(f"{k} × {w}: {st}, {runs} cell-runs")
            tds.append(
                f"<td style='background:{_STATUS_COLOR[st]}' "
                f"title='{title}'>"
                f"<a href='/coverage/{_html.escape(k)}/"
                f"{_html.escape(w)}'>{label or '&nbsp;'}</a></td>")
        rows.append(f"<tr><td class='wl'>{_html.escape(w)}</td>"
                    + "".join(tds) + "</tr>")
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<title>coverage atlas</title><style>"
            "body { font-family: sans-serif } "
            "table { border-collapse: collapse } "
            "td, th { padding: 3px 6px; border: 1px solid #fff; "
            "font-size: 12px; text-align: center } "
            "td.wl { text-align: left } "
            "th div { writing-mode: vertical-rl; "
            "transform: rotate(180deg); } "
            "td a { color: inherit; text-decoration: none; "
            "display: block }"
            "</style></head><body><h1>coverage atlas</h1>"
            "<p>fault kind × workload; X = anomaly witnessed, "
            "o = checked clean, ? = indeterminate, blank = never "
            "exercised. Cells link to witnessing runs.</p>"
            "<table><tr><th>workload</th>" + head + "</tr>"
            + "".join(rows) + "</table>"
            "<p><a href='/'>home</a></p></body></html>")


def coverage_cell_html(cells, fault: str, workload: str) -> str:
    """One cell's drill-down: per-anomaly-class outcomes with links to
    the witnessing runs (whose pages carry the anomaly excerpts and
    pre-filtered trace views)."""
    rows = []
    for (k, w, cls), c in sorted(cells.items()):
        if k != fault or w != workload:
            continue
        links = " ".join(
            f"<a href='/files/{_html.escape(r)}/'>{_html.escape(r)}"
            "</a>" for r in c["witnesses"][:8])
        frac = c.get("earliest-witness-frac")
        at = (f"{frac * 100:.0f}%"
              if isinstance(frac, (int, float)) else "-")
        rows.append(
            "<tr>"
            f"<td>{_html.escape(cls)}</td><td>{c['runs']}</td>"
            f"<td>{c['witnessed']}</td><td>{c['clean']}</td>"
            f"<td>{c['unknown']}</td><td>{at}</td>"
            f"<td>{links}</td></tr>")
    body = ("<table><tr><th>anomaly class</th><th>runs</th>"
            "<th>witnessed</th><th>clean</th><th>unknown</th>"
            "<th>earliest witness</th>"
            "<th>witnessing runs</th></tr>" + "".join(rows)
            + "</table>") if rows else \
        "<p>never exercised — a coverage gap.</p>"
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{_html.escape(fault)} × "
            f"{_html.escape(workload)}</title><style>"
            "body { font-family: sans-serif } "
            "table { border-collapse: collapse } "
            "td, th { padding: 3px 10px; text-align: left; "
            "border-bottom: 1px solid #eee; font-size: 13px }"
            "</style></head><body>"
            f"<h1>{_html.escape(fault)} × {_html.escape(workload)}"
            "</h1>" + body
            + "<p><a href='/coverage/'>atlas</a></p></body></html>")


def home_html(base: Path | None = None) -> str:
    rows = []
    for t in fast_tests(base):
        rel = f"{t['name']}/{t['time']}"
        rows.append(
            f"<tr style='background:{_valid_color(t['valid'])}'>"
            f"<td>{_html.escape(t['name'])}</td>"
            f"<td><a href='/files/{_html.escape(rel)}/'>"
            f"{_html.escape(t['time'])}</a></td>"
            f"<td>{_html.escape(str(t['valid']))}"
            + (f" <small>[{_html.escape(', '.join(t['flags']))}]"
               f"</small>" if t["flags"] else "") + "</td>"
            f"<td><a href='/files/{_html.escape(rel)}/results.json'>"
            f"results</a></td>"
            f"<td><a href='/files/{_html.escape(rel)}/jepsen.log'>log"
            f"</a></td>"
            f"<td><a href='/telemetry/{_html.escape(rel)}'>telemetry"
            f"</a></td>"
            f"<td><a href='/live/{_html.escape(rel)}'>live</a></td>"
            f"<td><a href='/zip/{_html.escape(rel)}'>zip</a></td>"
            f"</tr>")
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<title>Jepsen</title><style>"
            "body { font-family: sans-serif } "
            "table { border-collapse: collapse } "
            "td, th { padding: 4px 10px; text-align: left }"
            "</style></head><body><h1>Jepsen</h1>"
            "<p><a href='/coverage/'>coverage atlas</a> · "
            "<a href='/lint'>graftlint</a> · "
            "<a href='/fleet'>fleet</a></p><table>"
            "<tr><th>Test</th><th>Time</th><th>Valid?</th>"
            "<th colspan=5>Artifacts</th></tr>"
            + "".join(rows) + "</table></body></html>")


def _fleet_stats(base: Path):
    """(stats, addr) of the fleet server advertised under
    <base>/fleet/fleet.addr, or (None, reason)."""
    addr_file = Path(base or "store") / "fleet" / "fleet.addr"
    try:
        addr = addr_file.read_text().splitlines()[0].strip()
    except (OSError, IndexError):
        return None, "no fleet server running (no fleet.addr)"
    try:
        from .fleet.client import FleetClient

        from .control.retry import RetryBudget

        # one short attempt, no retries: a stale fleet.addr pointing
        # at a hung host must not stall every /metrics scrape
        c = FleetClient(addr, "web", "status", io_timeout_s=3.0,
                        observe=True, connect_timeout_s=1.5,
                        budget=RetryBudget(0))
        st = c.status()
        c.close()
        return st, addr
    except Exception as e:  # noqa: BLE001 — stale addr file etc.
        return None, f"fleet at {addr} unreachable: {e}"


def fleet_event_payload(st: dict) -> dict:
    """One SSE sample for the /fleet page's live charts: the flight
    recorder's headline latency quantiles, per-class batch occupancy,
    and the decision-log counts (fleet/flightrec.py)."""
    fr = (st or {}).get("flightrec") or {}
    out: dict = {"enabled": bool(fr.get("enabled"))}
    if not out["enabled"]:
        return out
    for key in ("verdict_ms", "ack_ms"):
        d = fr.get(key) or {}
        out[key] = {q: d.get(q) for q in ("p50", "p99")}
    out["occupancy"] = {c: (v or {}).get("occupancy")
                        for c, v in (fr.get("classes") or {}).items()}
    out["launches"] = fr.get("launches", 0)
    out["decisions"] = fr.get("decisions") or {}
    return out


# the /fleet page's live section: latency sparkline + occupancy
# timeline fed by the SSE endpoint (/fleet?events=1)
_FLEET_LIVE_JS = (
    "<h3>live</h3>"
    "<p>verdict p99 ms <canvas id='lat' width='360' height='48'>"
    "</canvas> &nbsp; batch occupancy <canvas id='occ' width='360'"
    " height='48'></canvas></p>"
    "<script>\n"
    "var lat = [], occS = [], occF = [];\n"
    "function draw(cv, series, max) {\n"
    "  var c = cv.getContext('2d'), w = cv.width, h = cv.height;\n"
    "  c.clearRect(0, 0, w, h);\n"
    "  series.forEach(function (s) {\n"
    "    if (!s.pts.length) return;\n"
    "    c.strokeStyle = s.color; c.beginPath();\n"
    "    s.pts.forEach(function (v, i) {\n"
    "      var x = i * w / Math.max(s.pts.length - 1, 1);\n"
    "      var y = h - 2 - (h - 4) * Math.min(v / max, 1);\n"
    "      i ? c.lineTo(x, y) : c.moveTo(x, y);\n"
    "    });\n"
    "    c.stroke();\n"
    "  });\n"
    "}\n"
    "var es = new EventSource('/fleet?events=1');\n"
    "es.onmessage = function (m) {\n"
    "  var d = JSON.parse(m.data);\n"
    "  if (!d.enabled) return;\n"
    "  if (d.verdict_ms && d.verdict_ms.p99 != null)\n"
    "    lat.push(d.verdict_ms.p99);\n"
    "  occS.push((d.occupancy && d.occupancy['slice']) || 0);\n"
    "  occF.push((d.occupancy && d.occupancy['final']) || 0);\n"
    "  [lat, occS, occF].forEach(function (a) {\n"
    "    while (a.length > 120) a.shift(); });\n"
    "  draw(document.getElementById('lat'),\n"
    "       [{pts: lat, color: '#1668dc'}],\n"
    "       Math.max.apply(null, lat.concat([1])));\n"
    "  draw(document.getElementById('occ'),\n"
    "       [{pts: occS, color: '#2aa198'},\n"
    "        {pts: occF, color: '#d33682'}], 1);\n"
    "};\n"
    "</script>")


def _flightrec_html(fr: dict) -> str:
    """The /fleet page's flight-recorder section (fleet/flightrec.py)."""
    if not fr.get("enabled"):
        return ("<h2>flight recorder</h2><p><em>disabled "
                "(FleetServer(flightrec=False))</em></p>")

    def cell(d, q):
        v = (d or {}).get(q)
        return "–" if v is None else f"{v:g}"

    def qrow(label, d):
        return (f"<tr><td>{label}</td>"
                + "".join(f"<td>{cell(d, q)}</td>"
                          for q in ("p50", "p95", "p99"))
                + f"<td>{(d or {}).get('n', 0)}</td></tr>")

    tenant_rows = "".join(
        f"<tr><td>{_html.escape(t)}</td>"
        f"<td>{cell(v.get('verdict_ms'), 'p50')}</td>"
        f"<td>{cell(v.get('verdict_ms'), 'p99')}</td>"
        f"<td>{cell(v.get('ack_ms'), 'p99')}</td></tr>"
        for t, v in sorted((fr.get("tenants") or {}).items()))
    cls_rows = "".join(
        f"<tr><td>{_html.escape(c)}</td>"
        f"<td>{v.get('launches', 0)}</td>"
        f"<td>{v.get('rows_per_launch', 0)}</td>"
        f"<td>{round(100 * (v.get('occupancy') or 0.0), 1)}%</td>"
        "</tr>"
        for c, v in sorted((fr.get("classes") or {}).items()))
    dec = fr.get("decisions") or {}
    qua = fr.get("quarantine") or {}
    idle = fr.get("idle") or {}
    return (
        "<h2>flight recorder</h2>"
        "<table><tr><th>latency</th><th>p50</th><th>p95</th>"
        "<th>p99</th><th>n</th></tr>"
        + qrow("verdict ms", fr.get("verdict_ms"))
        + qrow("ack ms", fr.get("ack_ms"))
        + "</table><table><tr><th>tenant</th><th>verdict p50</th>"
        "<th>verdict p99</th><th>ack p99</th></tr>" + tenant_rows
        + "</table><table><tr><th>class</th><th>launches</th>"
        "<th>rows/launch</th><th>occupancy</th></tr>" + cls_rows
        + "</table><p>decisions: "
        + " · ".join(f"{r} {dec.get(r, 0)}"
                     for r in ("full", "timeout", "drain", "breaker",
                               "quarantine"))
        + f" · quarantine events {qua.get('quarantined', 0)} in / "
        f"{qua.get('released', 0)} out"
        + f" · device idle {idle.get('gaps', 0)} gaps, "
        f"{idle.get('total_ms', 0.0)} ms</p>"
        + _FLEET_LIVE_JS)


def fleet_html(base: Path | None = None) -> str:
    """The fleet status page: service counters, per-tenant quota use,
    live streaming-check state, scheduler batching stats
    (fleet/)."""
    st, info = _fleet_stats(base or Path("store"))
    head = ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<title>fleet</title><style>"
            "body { font-family: sans-serif } "
            "table { border-collapse: collapse; margin: 8px 0 } "
            "td, th { padding: 3px 10px; text-align: left; "
            "border-bottom: 1px solid #ddd }"
            "</style></head><body><h1>analysis fleet</h1>"
            "<p><a href='/'>&larr; runs</a></p>")
    if st is None:
        return (head + f"<p><em>{_html.escape(str(info))}</em></p>"
                "<p>start one with <code>python -m jepsen_tpu_torch "
                "fleet serve</code></p></body></html>")
    sch = st.get("scheduler") or {}
    rows = "".join(
        f"<tr><td>{_html.escape(t)}</td>"
        + "".join(f"<td>{s.get(k, 0)}</td>"
                  for k in ("streams", "chunks", "ops", "verdicts",
                            "rejected"))
        + "</tr>"
        for t, s in sorted((st.get("tenants") or {}).items()))
    streams = "".join(
        f"<tr><td>{_html.escape(k)}</td>"
        f"<td>{_html.escape(str(v.get('state')))}</td>"
        f"<td>{v.get('checked-frac')}</td><td>{v.get('ops')}</td>"
        f"</tr>"
        for k, v in sorted((st.get("streams") or {}).items()))
    quarantined = sch.get("quarantine") or []
    qrows = "".join(
        f"<tr><td>{_html.escape(str(q.get('tenant')))}/"
        f"{_html.escape(str(q.get('run')))}</td>"
        f"<td>{q.get('probes', 0)}</td>"
        f"<td>{_html.escape(str(q.get('error'))[:120])}</td></tr>"
        for q in quarantined)
    qsection = (
        "<h2>quarantined runs</h2>"
        "<p>poison-isolated to the solo host lane (doc/robustness.md"
        " — the fleet breaker stays closed for everyone else)</p>"
        "<table><tr><th>tenant/run</th><th>probes</th>"
        "<th>error</th></tr>" + qrows + "</table>"
    ) if quarantined else ""
    return (head
            + f"<p>server at <code>{_html.escape(str(info))}</code>"
            f" · {st.get('runs', 0)} runs · "
            f"{st.get('active_streams', 0)} active streams · "
            f"{st.get('verdicts', 0)} verdicts · "
            f"{st.get('rejected', 0)} rejected · "
            f"{st.get('recovered', 0)} recovered</p>"
            "<h2>scheduler</h2><p>"
            + " · ".join(f"{k} {sch.get(k, 0)}" for k in
                         ("launches", "items", "slice_rows",
                          "final_hists", "cross_tenant_launches",
                          "pending"))
            + (" · <b>device breaker OPEN</b>"
               if sch.get("breaker_open") else "")
            + "</p><h2>tenants</h2><table><tr><th>tenant</th>"
            "<th>streams</th><th>chunks</th><th>ops</th>"
            "<th>verdicts</th><th>rejected</th></tr>" + rows
            + "</table>" + qsection
            + "<h2>live streaming checks</h2>"
            "<table><tr><th>tenant/run</th><th>state</th>"
            "<th>checked-frac</th><th>ops</th></tr>" + streams
            + "</table>"
            + _flightrec_html(st.get("flightrec") or {})
            + "</body></html>")


def anomaly_index(res, prefix: str = "", depth: int = 0) -> list:
    """[(label, [op indices])] for every anomaly/counterexample in a
    results map that carries provenance (`op-indices`, attached by the
    elle/wgl/set checkers) — what the per-run page links to
    pre-filtered trace and timeline views."""
    out: list = []
    if not isinstance(res, dict) or depth > 4:
        return out
    anomalies = res.get("anomalies")
    if isinstance(anomalies, dict):
        for name, recs in sorted(anomalies.items(), key=str):
            idxs = sorted({int(i) for rec in recs
                           if isinstance(rec, dict)
                           for i in rec.get("op-indices") or []})
            if idxs:
                out.append((f"{prefix}{name}", idxs))
    if res.get("valid?") is False and res.get("op-indices"):
        out.append((f"{prefix}counterexample",
                    sorted(int(i) for i in res["op-indices"])))
    lost = res.get("lost-op-indices")
    if isinstance(lost, dict):
        idxs = sorted({int(i) for v in lost.values() for i in v})
        if idxs:
            out.append((f"{prefix}lost-elements", idxs))
    for k, v in sorted(res.items(), key=lambda kv: str(kv[0])):
        if isinstance(v, dict) and k not in ("anomalies",
                                             "lost-op-indices"):
            out.extend(anomaly_index(v, prefix=f"{k}/",
                                     depth=depth + 1))
    return out


def _anomaly_html(rel: str, d: Path) -> str:
    """The per-run anomaly-provenance section: each anomaly links to a
    pre-filtered Perfetto export (/trace/<run>?ops=...) and to the
    timeline anchored at its first participating op."""
    try:
        res = jstore.load_results(d)
    except (OSError, json.JSONDecodeError):
        res = None
    links = anomaly_index(res) if res else []
    if not links:
        return ""
    rows = []
    for label, idxs in links[:32]:
        qs = ",".join(str(i) for i in idxs[:64])
        preview = ", ".join(str(i) for i in idxs[:8]) + (
            "…" if len(idxs) > 8 else "")
        rows.append(
            f"<li><b>{_html.escape(label)}</b> (ops {preview}) — "
            f"<a href='/trace/{_html.escape(rel)}?ops={qs}'>perfetto"
            f"</a> · <a href='/files/{_html.escape(rel)}/timeline.html"
            f"#op-{idxs[0]}'>timeline</a></li>")
    return ("<h2>anomalies</h2><p>op references link to the traced "
            "ops behind each anomaly</p><ul>" + "".join(rows)
            + "</ul>")


def _profile_html(d: Path, rel: str) -> str:
    """The per-run kernel-profile section (device launches, cost +
    cache + wall-split table) from the run's metrics.json, with a link
    to the Prometheus exposition of the same metrics."""
    from . import telemetry as jtel
    from .reports import profile as rprofile

    metrics = jtel.read_metrics(d / jtel.METRICS_FILE)
    section = rprofile.profile_html(metrics)
    if not section:
        return ""
    return (section + f"<p><a href='/metrics?run={_html.escape(rel)}'>"
            "prometheus metrics</a></p>")


def _sparkline_svg(curve, width: int = 240, height: int = 36) -> str:
    """An inline polyline sparkline for a frontier-occupancy curve."""
    vals = [float(x) for x in curve]
    top = max(vals) or 1.0
    n = max(len(vals) - 1, 1)
    pts = " ".join(
        f"{i * width / n:.1f},{height - v / top * (height - 2):.1f}"
        for i, v in enumerate(vals))
    return (f"<svg width='{width}' height='{height}' "
            "style='vertical-align:middle'>"
            f"<polyline points='{pts}' fill='none' "
            "stroke='#6DB6FE' stroke-width='1.5'/></svg>")


def search_index(res, prefix: str = "", depth: int = 0) -> list:
    """[(label, search-dict)] for every checker result carrying
    search-dynamics stats (witness position; gpu/wgl.py)."""
    out: list = []
    if not isinstance(res, dict) or depth > 5:
        return out
    s = res.get("search")
    if isinstance(s, dict) and s.get("witness-position") is not None:
        out.append((prefix or "result", s))
    for k, v in sorted(res.items(), key=lambda kv: str(kv[0])):
        if isinstance(v, dict) and k not in ("anomalies", "search"):
            out.extend(search_index(v, prefix=f"{prefix}/{k}"
                                    if prefix else str(k),
                                    depth=depth + 1))
    return out


def certificate_rows(res) -> list:
    """[(path, status)] for every certified result in a results tree
    (status: 'certified', 'error: ...', or 'absent: ...')."""
    from .gpu import certify as jcertify

    rows = []
    for path, r in jcertify.iter_certificates(res or {}):
        cert = r.get("certificate") or {}
        if "absent" in cert:
            rows.append((path, f"absent: {cert['absent']}"))
        elif r.get("certificate-error"):
            rows.append((path, f"ERROR: {r['certificate-error']}"))
        elif r.get("certified"):
            rows.append((path, "certified"))
        else:
            rows.append((path, "unvalidated"))
    return rows


def _explorer_html(d: Path, rel: str) -> str:
    """The search-explorer panel: per-kernel frontier-growth
    sparklines (from the profiler's kernel:<k> telemetry spans), the
    witness-position markers each invalid verdict carries, and the
    run's verdict-certificate statuses."""
    try:
        events, _metrics = jstore.load_telemetry(d)
    except Exception:  # noqa: BLE001 — panel must not 500 the page
        events = []
    curves = []
    for e in events or []:
        name = str(e.get("name", ""))
        attrs = e.get("attrs") or {}
        curve = attrs.get("frontier_curve")
        if (name.startswith("kernel:") and isinstance(curve, list)
                and curve):
            curves.append((e.get("t1", 0) - e.get("t0", 0),
                           name[len("kernel:"):], curve, attrs))
    curves.sort(key=lambda c: -c[0])
    try:
        res = jstore.load_results(d)
    except (OSError, json.JSONDecodeError):
        res = None
    witnesses = search_index(res) if res else []
    certs = certificate_rows(res) if res else []
    if not curves and not witnesses and not certs:
        return ""
    parts = ["<h2>search explorer</h2>"]
    if curves:
        parts.append("<p>frontier growth per BFS level (largest "
                     "launches)</p><ul>")
        for _dur, kernel, curve, attrs in curves[:4]:
            levels = attrs.get("iterations", "?")
            label = (f"{kernel}: peak "
                     f"{attrs.get('frontier_peak', '?')} configs, "
                     f"{levels} levels, "
                     f"{attrs.get('states_explored', '?')} states")
            parts.append(f"<li>{_sparkline_svg(curve)} "
                         f"{_html.escape(label)}</li>")
        parts.append("</ul>")
    for label, s in witnesses[:8]:
        frac = float(s["witness-position"])
        pct = round(frac * 100, 1)
        marker = (
            "<svg width='240' height='12' "
            "style='vertical-align:middle'>"
            "<rect x='0' y='4' width='240' height='4' fill='#eee'/>"
            f"<rect x='{frac * 240 - 1.5:.1f}' y='0' width='3' "
            "height='12' fill='#FEB5DA'/></svg>")
        parts.append(f"<p>{marker} <b>{_html.escape(label)}</b>: "
                     f"witnessed at {pct}% of the history</p>")
    if certs:
        items = "".join(
            f"<li><b>{_html.escape(p)}</b>: {_html.escape(st)}</li>"
            for p, st in certs[:16])
        parts.append("<p>verdict certificates "
                     f"(<a href='/files/{_html.escape(rel)}/"
                     "results.json'>proofs ride in results.json</a>)"
                     f"</p><ul>{items}</ul>")
    return "".join(parts)


# graftlint report cache: the report describes the CODE, not a run,
# so one compute per process serves every page (?refresh=1 re-lints).
_lint_cache: dict = {}
_lint_lock = threading.Lock()


def _lint_baseline_path() -> Path:
    return (Path(__file__).resolve().parent.parent
            / "lint-baseline-torch.json")


def _compute_lint_report():
    from .analysis import driver

    rep = driver.run_lint()
    bp = _lint_baseline_path()
    if bp.exists():
        driver.gate(rep, bp)
    return rep


def _lint_report(refresh: bool = False):
    """Synchronous report for /lint (the user asked for it). The
    compute runs OUTSIDE _lint_lock so concurrent page requests never
    queue behind a trace; a racing duplicate compute is harmless."""
    with _lint_lock:
        rep = _lint_cache.get("rep")
    if rep is not None and not refresh:
        return rep
    rep = _compute_lint_report()
    with _lint_lock:
        _lint_cache["rep"] = rep
    return rep


def _lint_report_cached():
    """Non-blocking report for the run-page panel: the cached report,
    or None after kicking off a one-shot background warm — a run page
    must never stall seconds on the lint's imports and traces inside
    the request handler."""
    with _lint_lock:
        rep = _lint_cache.get("rep")
        if rep is not None:
            return rep
        if _lint_cache.get("warming"):
            return None
        _lint_cache["warming"] = True

    def warm():
        try:
            r = _compute_lint_report()
            with _lint_lock:
                _lint_cache["rep"] = r
        except Exception:  # noqa: BLE001 — warm is best-effort
            logger.exception("lint warm failed")
        finally:
            with _lint_lock:
                _lint_cache["warming"] = False

    threading.Thread(target=warm, name="jepsen-lint-warm",
                     daemon=True).start()
    return None


def lint_panel_html() -> str:
    """The run-page graftlint panel: per-rule counts, the R3/R4
    aggregates, and the baseline gate status — linked to the full /lint
    report. Renders a warming placeholder until the cached report
    exists."""
    try:
        rep = _lint_report_cached()
    except Exception:  # noqa: BLE001 — the panel must not 500 the page
        logger.exception("lint panel failed")
        return ""
    if rep is None:
        return ("<h2>graftlint</h2><p><a href='/lint'>report "
                "warming…</a> (computed in the background; "
                "refresh shortly)</p>")
    agg = rep.aggregates()
    rules = " ".join(f"{r}={n}" for r, n in agg["findings"].items()) \
        or "clean"
    gatetxt = ""
    if rep.ratchet is not None:
        new = len(rep.ratchet["new"])
        gatetxt = (f" · baseline: <b style='color:#b00'>{new} NEW"
                   "</b>" if new else " · baseline: ok")
    return ("<h2>graftlint</h2><p>"
            f"<a href='/lint'>{len(rep.findings)} finding(s)</a> "
            f"({_html.escape(rules)}) · copied "
            f"{agg['non_donated_bytes'] // 1024} KiB · replicated "
            f"{agg['replicated_bytes'] // 1024} KiB · unsharded axes "
            f"{agg['unsharded_axes']}{gatetxt}</p>")


def lint_html(refresh: bool = False) -> str:
    rep = _lint_report(refresh=refresh)
    agg = rep.aggregates()
    new_keys = ({f.key for f in rep.ratchet["new"]}
                if rep.ratchet is not None else set())
    rows = []
    for f in rep.findings:
        where = f"{f.file}:{f.line}" if f.file else ""
        flag = "<b style='color:#b00'>NEW</b>" if f.key in new_keys \
            else ("baselined" if rep.ratchet is not None else "")
        rows.append(
            f"<tr><td>{_html.escape(f.rule)}</td>"
            f"<td>{_html.escape(f.kernel)}</td>"
            f"<td>{_html.escape(f.site)}</td>"
            f"<td>{_html.escape(f.message)}"
            + (f"<br><i>fix: {_html.escape(f.hint)}</i>" if f.hint
               else "")
            + f"</td><td>{_html.escape(where)}</td>"
            f"<td>{flag}</td></tr>")
    stale = ""
    if rep.ratchet is not None and rep.ratchet["stale"]:
        stale = ("<p>stale baseline entries (fixed): "
                 + ", ".join(_html.escape(k)
                             for k in rep.ratchet["stale"])
                 + " — prune with <code>python -m jepsen_tpu_torch lint "
                   "--baseline lint-baseline-torch.json --update</code></p>")
    return ("<!DOCTYPE html><html><head><style>"
            "table { border-collapse: collapse } "
            "td, th { padding: 3px 10px; text-align: left; "
            "vertical-align: top; border-bottom: 1px solid #eee; "
            "font-size: 13px }</style></head><body>"
            "<h1>graftlint — kernel-launch static analysis</h1>"
            f"<p>{len(rep.findings)} finding(s) across "
            f"{len(rep.traces)} launch trace(s) in {rep.wall_s:.2f}s"
            " · R3 copied "
            f"{agg['non_donated_bytes'] // 1024} KiB · R4 replicated "
            f"{agg['replicated_bytes'] // 1024} KiB · R4 unsharded "
            f"axes {agg['unsharded_axes']} · "
            "<a href='/lint?refresh=1'>re-lint</a> · "
            "<a href='/lint?json=1'>json</a> · rule catalog: "
            "doc/static-analysis-torch.md</p>"
            + stale
            + "<table><tr><th>rule</th><th>kernel</th><th>site</th>"
              "<th>finding</th><th>provenance</th><th>baseline</th>"
              "</tr>" + "".join(rows) + "</table>"
            "<p><a href='/'>home</a></p></body></html>")


def _nodes_html(d: Path) -> str:
    """The per-node observability lanes (nodeprobe.py):
    resource strips + DB-log event markers + gap/breaker ticks under
    the run's nemesis fault windows (from its coverage record)."""
    from . import coverage as jcoverage
    from .reports import nodes as rnodes

    records = jstore.load_nodes(d)
    if not records:
        return ""
    faults = (jcoverage.load_record(d) or {}).get("faults")
    # the MERGED skew bound (probe + check-offsets) the verdict was
    # stamped with, from results.json — cheaper than re-reading the
    # history, and guaranteed consistent with what the verdict says
    bound = None
    try:
        res = jstore.load_results(d)
        if isinstance(res, dict):
            bound = res.get("clock-skew-bound")
    except (OSError, json.JSONDecodeError):
        pass
    try:
        return rnodes.lanes_html(records, faults, bound=bound)
    except Exception:  # noqa: BLE001 — lanes must not 500 the page
        logger.exception("rendering node lanes failed")
        return ""


def dir_html(rel: str, d: Path) -> str:
    entries = sorted(d.iterdir(),
                     key=lambda p: (not p.is_dir(), p.name))
    items = "".join(
        f"<li><a href='/files/{_html.escape(rel)}{_html.escape(e.name)}"
        f"{'/' if e.is_dir() else ''}'>{_html.escape(e.name)}"
        f"{'/' if e.is_dir() else ''}</a></li>" for e in entries)
    views = ""
    anomalies = ""
    profile = ""
    nodes = ""
    explorer = ""
    if (d / "test.json").exists():
        # a run directory: link its rendered views next to the raw files
        run_rel = _html.escape(rel.rstrip("/"))
        views = (f"<p>views: <a href='/telemetry/{run_rel}'>telemetry"
                 f"</a> · <a href='/live/{run_rel}'>live</a> · "
                 f"<a href='/trace/{run_rel}'>perfetto json</a></p>")
        anomalies = _anomaly_html(rel.rstrip("/"), d)
        nodes = _nodes_html(d)
        try:
            explorer = _explorer_html(d, rel.rstrip("/"))
        except Exception:  # noqa: BLE001 — panel must not 500
            logger.exception("rendering search explorer failed")
        profile = _profile_html(d, rel.rstrip("/")) + lint_panel_html()
    return (f"<!DOCTYPE html><html><head><style>"
            "table { border-collapse: collapse } "
            "td, th { padding: 3px 10px; text-align: left; "
            "border-bottom: 1px solid #eee; font-size: 13px }"
            "</style></head><body>"
            f"<h1>{_html.escape(rel)}</h1>"
            f"{views}{anomalies}{explorer}{nodes}{profile}"
            f"<ul>{items}</ul>"
            "</body></html>")


def live_html(rel: str) -> str:
    """The live dashboard: an EventSource over the SSE endpoint,
    rendering the newest sample point's vitals plus a rolling log.
    Works for finished runs too (replays the stored series, then
    gets the end event)."""
    sse = f"/live/{rel}?events=1" if rel else "/live/?events=1"
    title = _html.escape(rel or "current run")
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>live — {title}</title><style>"
            "body { font-family: sans-serif; margin: 1.5em } "
            ".tiles { display: flex; gap: 1em; flex-wrap: wrap } "
            ".tile { border: 1px solid #ddd; border-radius: 6px; "
            "padding: .6em 1em; min-width: 7em } "
            ".tile b { display: block; font-size: 1.6em } "
            ".tile span { color: #888; font-size: .8em } "
            "#spans, #nemesis { color: #888 } "
            "table { border-collapse: collapse; margin-top: 1em } "
            "td, th { padding: 2px 10px; text-align: right; "
            "border-bottom: 1px solid #eee; font-size: 13px } "
            "#state { color: #888 }"
            "</style></head><body>"
            f"<h1>live — {title}</h1><p id='state'>connecting…</p>"
            "<div class='tiles'>"
            "<div class='tile'><b id='ops'>–</b><span>ops/s</span></div>"
            "<div class='tile'><b id='p50'>–</b><span>p50 ms</span></div>"
            "<div class='tile'><b id='p99'>–</b><span>p99 ms</span></div>"
            "<div class='tile'><b id='inflight'>–</b>"
            "<span>in flight</span></div>"
            "<div class='tile'><b id='stalls'>–</b>"
            "<span>stalls/s</span></div>"
            "<div class='tile'><b id='watchdog'>0</b>"
            "<span>watchdog</span></div>"
            "</div>"
            "<p>open spans: <span id='spans'>–</span><br>"
            "nemesis: <span id='nemesis'>–</span></p>"
            "<table id='log'><tr><th>t (s)</th><th>ops/s</th>"
            "<th>p50</th><th>p95</th><th>p99</th><th>in&nbsp;flight</th>"
            "<th>stalls/s</th></tr></table>"
            "<script>\n"
            f"var es = new EventSource({json.dumps(sse)});\n"
            "var n = 0;\n"
            "function set(id, v) { document.getElementById(id)"
            ".textContent = (v === null || v === undefined) ? '–' : v; }\n"
            "es.onopen = function() { set('state', 'streaming'); };\n"
            "es.addEventListener('end', function() { "
            "set('state', 'run complete'); es.close(); });\n"
            "es.onerror = function() { set('state', 'disconnected'); };\n"
            "es.onmessage = function(m) {\n"
            "  var p = JSON.parse(m.data);\n"
            "  var lat = p.latency_ms || {};\n"
            "  set('ops', p.ops_s); set('p50', lat.p50); "
            "set('p99', lat.p99);\n"
            "  set('inflight', Object.keys(p.inflight || {}).length);\n"
            "  set('stalls', p.stall_rate); "
            "set('watchdog', p.watchdog || 0);\n"
            "  set('spans', (p.open_spans || []).join(' › ') || '(none)');"
            "\n"
            "  set('nemesis', (p.nemesis || []).join(', ') || '(quiet)');"
            "\n"
            "  var tr = document.createElement('tr');\n"
            "  [ (p.t / 1e9).toFixed(1), p.ops_s, lat.p50, lat.p95, "
            "lat.p99,\n"
            "    Object.keys(p.inflight || {}).length, p.stall_rate ]\n"
            "    .forEach(function(v) { var td = "
            "document.createElement('td');\n"
            "      td.textContent = (v === null || v === undefined) "
            "? '–' : v; tr.appendChild(td); });\n"
            "  var log = document.getElementById('log');\n"
            "  log.insertBefore(tr, log.rows[1] || null);\n"
            "  if (log.rows.length > 31) "
            "log.deleteRow(log.rows.length - 1);\n"
            "  n++;\n"
            "};\n"
            "</script></body></html>")


CONTENT_TYPES = {".html": "text/html", ".json": "application/json",
                 ".log": "text/plain", ".txt": "text/plain",
                 ".png": "image/png", ".svg": "image/svg+xml",
                 ".jlog": "application/octet-stream"}


class StoreHandler(BaseHTTPRequestHandler):
    base: Path = Path("store")

    def log_message(self, fmt, *args):  # quiet
        logger.debug("web: " + fmt, *args)

    def _send(self, code: int, body: bytes,
              ctype: str = "text/html") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _resolve(self, rel: str) -> Path | None:
        """Path-traversal guard (web.clj:382-388): the resolved path
        must stay under the store root."""
        p = (self.base / rel).resolve()
        root = self.base.resolve()
        if p == root or root in p.parents:
            return p
        return None

    def _live_dir(self, rel: str) -> Path | None:
        """The run directory a /live/ path names; an empty rel follows
        the store's `current` symlink (the run in progress), falling
        back to `latest`."""
        if rel:
            p = self._resolve(rel)
            return p if p is not None and p.is_dir() else None
        for link in ("current", "latest"):
            p = self.base / link
            if p.is_dir():
                # pin the real directory: the `current` symlink is
                # removed when the run finishes, mid-stream
                return p.resolve()
        return None

    def _sse_stream(self, d: Path) -> None:
        """Tails the run's timeseries.jsonl as Server-Sent Events: one
        `data:` message per sample point, `event: end` once the run
        has finished and the series is drained. The monitor flushes
        every point, so an in-progress run streams live even though
        this server is a different process."""
        from . import monitor as jmonitor

        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        ts = d / jmonitor.TIMESERIES_FILE
        deadline = time.monotonic() + SSE_MAX_S
        last_beat = time.monotonic()
        f = None
        try:
            while time.monotonic() < deadline:
                if f is None and ts.exists():
                    f = open(ts)
                progressed = False
                if f is not None:
                    while True:
                        pos = f.tell()
                        line = f.readline()
                        if not line.endswith("\n"):
                            # torn tail (sampler mid-write): rewind,
                            # retry next poll
                            f.seek(pos)
                            break
                        line = line.strip()
                        if line:
                            self.wfile.write(
                                b"data: " + line.encode() + b"\n\n")
                            progressed = True
                if progressed:
                    self.wfile.flush()
                    last_beat = time.monotonic()
                # results.json marks the run finished; core.run stops
                # the monitor (final point flushed) before writing it,
                # so draining then ending cannot skip the last sample
                if not progressed and (d / "results.json").exists():
                    self.wfile.write(b"event: end\ndata: {}\n\n")
                    self.wfile.flush()
                    return
                if time.monotonic() - last_beat > SSE_HEARTBEAT_S:
                    self.wfile.write(b": ping\n\n")  # keep-alive
                    self.wfile.flush()
                    last_beat = time.monotonic()
                time.sleep(SSE_POLL_S)
        finally:
            if f is not None:
                f.close()

    def _fleet_sse(self) -> None:
        """Streams flight-recorder samples for the /fleet page's live
        charts (fleet_event_payload): one JSON `data:` message per
        poll of the fleet server's stats."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        deadline = time.monotonic() + SSE_MAX_S
        while time.monotonic() < deadline:
            st, _info = _fleet_stats(self.base)
            payload = fleet_event_payload(st or {})
            self.wfile.write(b"data: "
                             + json.dumps(payload).encode() + b"\n\n")
            self.wfile.flush()
            time.sleep(FLEET_SSE_POLL_S)

    def do_GET(self):  # noqa: N802
        split = urlsplit(self.path)
        path = unquote(split.path)
        query = parse_qs(split.query)
        try:
            if path == "/":
                self._send(200, home_html(self.base).encode())
            elif path.startswith("/files/"):
                rel = path[len("/files/"):]
                p = self._resolve(rel)
                if p is None or not p.exists():
                    self._send(404, b"not found", "text/plain")
                elif p.is_dir():
                    if not path.endswith("/"):
                        rel += "/"
                    self._send(200, dir_html(rel, p).encode())
                else:
                    ctype = CONTENT_TYPES.get(p.suffix, "text/plain")
                    self._send(200, p.read_bytes(), ctype)
            elif path.startswith("/telemetry/"):
                rel = path[len("/telemetry/"):].rstrip("/")
                p = self._resolve(rel)
                if p is None or not p.is_dir():
                    self._send(404, b"not found", "text/plain")
                else:
                    from .reports import telemetry as rtel

                    events, metrics = jstore.load_telemetry(p)
                    if not events and metrics is None:
                        self._send(404, b"no telemetry recorded",
                                   "text/plain")
                    else:
                        self._send(200, rtel.telemetry_html(
                            rel, events, metrics).encode())
            elif path == "/live" or path.startswith("/live/"):
                rel = path[len("/live/"):].rstrip("/") \
                    if path.startswith("/live/") else ""
                d = self._live_dir(rel)
                if d is None:
                    self._send(404, b"no such run (and no run in "
                               b"progress)", "text/plain")
                elif query.get("events"):
                    self._sse_stream(d)
                else:
                    self._send(200, live_html(rel).encode())
            elif path.startswith("/trace/"):
                rel = path[len("/trace/"):].rstrip("/")
                p = self._resolve(rel)
                if p is None or not p.is_dir():
                    self._send(404, b"not found", "text/plain")
                else:
                    from .reports import trace as rtrace

                    ops = None
                    if query.get("ops"):
                        ops = [int(x) for x in query["ops"][0].split(",")
                               if x.strip().lstrip("-").isdigit()]
                    test = jstore.load(p)
                    events, _m = jstore.load_telemetry(p)
                    optrace = jstore.load_optrace(p)
                    noderecs = jstore.load_nodes(p)
                    doc = rtrace.chrome_trace(
                        test, test.get("history") or [], events,
                        optrace=optrace, ops=ops, noderecs=noderecs)
                    self._send(200, json.dumps(doc).encode(),
                               "application/json")
            elif path == "/lint" or path == "/lint/":
                # graftlint: the kernel-launch static-analysis report
                # (jepsen_tpu_torch.analysis; repo state, cached per
                # process)
                refresh = bool(query.get("refresh"))
                if query.get("json"):
                    rep = _lint_report(refresh=refresh)
                    self._send(200,
                               json.dumps(rep.to_dict()).encode(),
                               "application/json")
                else:
                    self._send(200, lint_html(refresh).encode())
            elif path == "/fleet" or path == "/fleet/":
                # checking-as-a-service status (fleet/):
                # reads <base>/fleet/fleet.addr and asks the live
                # server for its per-tenant stats; ?events=1 is the
                # flight-recorder SSE feed for the live charts
                if query.get("events"):
                    self._fleet_sse()
                else:
                    self._send(200, fleet_html(self.base).encode())
            elif path == "/coverage" or path.startswith("/coverage/"):
                # the cross-run fault × workload × anomaly heatmap
                # (coverage.py); /coverage/<fault>/<workload>
                # drills into one cell's witnessing runs
                cells = _atlas_cells(self.base)
                rest = [x for x in
                        path[len("/coverage"):].split("/") if x]
                if len(rest) == 2:
                    self._send(200, coverage_cell_html(
                        cells, rest[0], rest[1]).encode())
                else:
                    try:
                        from . import workloads

                        wls = list(workloads.REGISTRY)
                    except ImportError:
                        wls = None
                    self._send(200,
                               coverage_html(cells, wls).encode())
            elif path == "/metrics":
                # Prometheus text exposition of a run's metrics.json
                # (?run=<rel>; default: the current/latest run)
                rel = (query.get("run") or [""])[0].rstrip("/")
                d = self._live_dir(rel)
                if d is None:
                    self._send(404, b"no such run", "text/plain")
                else:
                    from . import telemetry as jtel
                    from .reports import profile as rprofile

                    metrics = jtel.read_metrics(d / jtel.METRICS_FILE)
                    if metrics is None:
                        self._send(404, b"no metrics recorded",
                                   "text/plain")
                    else:
                        body = rprofile.prometheus_text(
                            metrics, run=rel or d.name)
                        # node observability samples (latest per-node
                        # resource/skew gauges + log-event counters)
                        # ride on the same scrape
                        try:
                            from . import nodeprobe as jnodeprobe

                            nlines = jnodeprobe.prometheus_lines(
                                jstore.load_nodes(d))
                            if nlines:
                                body += "\n".join(nlines) + "\n"
                        except Exception:  # noqa: BLE001
                            logger.exception("node metrics failed")
                        # atlas-level coverage samples ride on the
                        # same scrape (coverage.py)
                        try:
                            from . import coverage as jcoverage

                            cells = _atlas_cells(self.base)
                            if cells:
                                body += "\n".join(
                                    jcoverage.prometheus_lines(
                                        cells)) + "\n"
                        except Exception:  # noqa: BLE001
                            logger.exception(
                                "coverage metrics failed")
                        # fleet samples (per-tenant labels) ride on
                        # the same scrape when a server is running
                        try:
                            from .fleet.server import \
                                prometheus_from_stats

                            st, _info = _fleet_stats(self.base)
                            if st is not None:
                                body += prometheus_from_stats(st)
                        except Exception:  # noqa: BLE001
                            logger.exception("fleet metrics failed")
                        self._send(
                            200, body.encode(),
                            "text/plain; version=0.0.4; "
                            "charset=utf-8")
            elif path.startswith("/zip/"):
                rel = path[len("/zip/"):].rstrip("/")
                p = self._resolve(rel)
                if p is None or not p.is_dir():
                    self._send(404, b"not found", "text/plain")
                else:
                    buf = io.BytesIO()
                    with zipfile.ZipFile(buf, "w",
                                         zipfile.ZIP_DEFLATED) as z:
                        for f in sorted(p.rglob("*")):
                            if f.is_file():
                                z.write(f, f.relative_to(p.parent))
                    self._send(200, buf.getvalue(), "application/zip")
            else:
                self._send(404, b"not found", "text/plain")
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away (normal for abandoned SSE tails)
        except Exception:  # noqa: BLE001
            logger.exception("web error")
            self._send(500, b"internal error", "text/plain")


def serve(host: str = "0.0.0.0", port: int = 8080,
          base: Path | None = None) -> ThreadingHTTPServer:
    """Starts the store browser on a daemon thread; returns the server
    (web.clj:431-446)."""
    handler = type("Handler", (StoreHandler,),
                   {"base": Path(base) if base else jstore.BASE})
    server = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server
