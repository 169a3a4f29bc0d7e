"""Rendering for stored device-kernel profiles (the port's copy of
jepsen_tpu/reports/profile.py; its output is the JAX module's, byte for
byte, metric and label names included).

Consumes the `profiler.<kernel>.*` counters/gauges the device profiler
(gpu/profiler.py) aggregates into a run's metrics.json, plus the
per-launch `kernel:<name>` spans in telemetry.jsonl, and renders the
per-kernel cost/occupancy table (profile_text, profile_html) and the
Prometheus text exposition of a metrics.json. Pure functions over
loaded artifacts — no recorder access. The CLI's `profile` subcommand
and the web UI's run page and `/metrics` route call them."""

from __future__ import annotations

import html as _html


def kernel_stats(metrics: dict | None) -> dict[str, dict]:
    """{kernel: {field: value}} parsed back out of a metrics.json's
    profiler counters and gauges. Kernel names are dot-free by
    construction, so the counter name splits unambiguously."""
    out: dict[str, dict] = {}
    for section in ("counters", "gauges"):
        for name, v in ((metrics or {}).get(section) or {}).items():
            parts = name.split(".")
            if parts[0] != "profiler" or len(parts) < 3:
                continue
            kernel = parts[1]
            field = ".".join(parts[2:])
            if not isinstance(v, (int, float)):
                continue
            out.setdefault(kernel, {})[field] = v
    return out


def _fmt_count(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    for unit, scale in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if v >= scale:
            return f"{v / scale:.1f}{unit}"
    return f"{v:.0f}"


def _fmt_bytes(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    for unit, scale in (("GB", 1 << 30), ("MB", 1 << 20),
                        ("kB", 1 << 10)):
        if v >= scale:
            return f"{v / scale:.1f}{unit}"
    return f"{v:.0f}B"


def _fmt_ms(ns) -> str:
    if not ns:
        return "-"
    if ns >= 1e9:
        return f"{ns / 1e9:.2f}s"
    return f"{ns / 1e6:.1f}ms"


def kernel_rows(metrics: dict | None) -> list[dict]:
    """One display row per kernel: formatted cost totals, cache hit
    rate, and the wall-time split across pipeline phases (encode /
    H2D / dispatch / compute / D2H, as % of the summed phase time —
    dispatch includes compile on a bucket's first launch, which the
    separate compile column calls out)."""
    rows = []
    for kernel, st in sorted(kernel_stats(metrics).items()):
        hits = int(st.get("compile.hit", 0))
        misses = int(st.get("compile.miss", 0))
        looked = hits + misses
        phases = [("encode", st.get("encode_ns", 0)),
                  ("h2d", st.get("h2d_ns", 0)),
                  ("dispatch", st.get("dispatch_ns", 0)),
                  ("compute", st.get("compute_ns", 0)),
                  ("d2h", st.get("d2h_ns", 0))]
        total_ph = sum(v for _n, v in phases)
        split = " ".join(f"{n} {v / total_ph * 100:.0f}%"
                         for n, v in phases if v) if total_ph else "-"
        rows.append({
            "kernel": kernel,
            "launches": int(st.get("launches", 0)),
            "cache": (f"{hits}/{looked}" if looked else "-"),
            "flops": _fmt_count(st.get("flops")),
            "bytes": _fmt_bytes(st.get("bytes")),
            "peak_mem": _fmt_bytes(st.get("peak_memory_bytes")),
            "compile": _fmt_ms(st.get("compile_ns")),
            "wall": _fmt_ms(st.get("wall_ns")),
            "split": split,
            "iterations": _fmt_count(st.get("iterations"))
            if st.get("iterations") else "-",
            # the search explorer's per-kernel shape: peak BFS frontier
            # occupancy, states explored, and dedup hits
            # (gpu/wgl.py _drain)
            "frontier": _fmt_count(st.get("frontier_peak"))
            if st.get("frontier_peak") else "-",
            "states": _fmt_count(st.get("states"))
            if st.get("states") else "-",
            "dedup": _fmt_count(st.get("dedup_hits"))
            if st.get("dedup_hits") else "-",
        })
    return rows


_COLS = (("kernel", "kernel"), ("launches", "launches"),
         ("cache", "cache hit"), ("flops", "FLOPs"),
         ("bytes", "bytes"), ("peak_mem", "peak mem"),
         ("compile", "compile"), ("wall", "wall"),
         ("split", "wall split"), ("iterations", "iters"),
         ("frontier", "frontier"), ("states", "states"),
         ("dedup", "dedup"))


def slowest_launches(events, top: int = 5) -> list[dict]:
    """The `top` slowest per-launch records from a run's telemetry
    spans (name `kernel:<k>`), slowest first."""
    launches = [e for e in events or []
                if str(e.get("name", "")).startswith("kernel:")
                and "t1" in e]
    launches.sort(key=lambda e: e["t1"] - e["t0"], reverse=True)
    return launches[:top]


def profile_text(events, metrics: dict | None) -> str:
    """The `profile` CLI's output: the per-kernel table plus the
    slowest individual launches with their attrs."""
    rows = kernel_rows(metrics)
    if not rows:
        return ("(no kernel launches profiled — the run predates the "
                "profiler, or no device kernel ran)")
    widths = {k: max(len(h), *(len(str(r[k])) for r in rows))
              for k, h in _COLS}
    out = ["  ".join(h.ljust(widths[k]) for k, h in _COLS),
           "  ".join("-" * widths[k] for k, _h in _COLS)]
    for r in rows:
        out.append("  ".join(str(r[k]).ljust(widths[k])
                             for k, _h in _COLS))
    slow = slowest_launches(events)
    if slow:
        out += ["", "# Slowest launches", ""]
        for e in slow:
            attrs = e.get("attrs") or {}
            extra = " ".join(
                f"{k}={v}" for k, v in sorted(attrs.items())
                if k not in ("bucket",) and not k.endswith("_ns"))
            out.append(f"{e['name'][len('kernel:'):]:<12} "
                       f"{_fmt_ms(e['t1'] - e['t0']):>8}  {extra}")
    return "\n".join(out)


def profile_html(metrics: dict | None) -> str:
    """The kernel-profile section of a run's web page (empty string
    when the run has no profiled launches)."""
    rows = kernel_rows(metrics)
    if not rows:
        return ""
    head = "".join(f"<th>{_html.escape(h)}</th>" for _k, h in _COLS)
    body = "".join(
        "<tr>" + "".join(f"<td>{_html.escape(str(r[k]))}</td>"
                         for k, _h in _COLS) + "</tr>"
        for r in rows)
    return ("<h2>kernel profile</h2><table>"
            f"<tr>{head}</tr>{body}</table>")


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return "jepsen_tpu_" + s


def prometheus_text(metrics: dict | None, run: str | None = None
                    ) -> str:
    """A metrics.json rendered in Prometheus text exposition format
    (a /metrics endpoint's body): counters and
    numeric gauges as flat samples, span aggregates as labeled
    count/total samples. The optional `run` label names the source
    run directory."""
    if run:
        run = str(run).replace("\\", "_").replace('"', "_")
    label = f'{{run="{run}"}}' if run else ""
    lines: list[str] = []
    for name, v in sorted(((metrics or {}).get("counters") or {})
                          .items()):
        if isinstance(v, (int, float)):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn}{label} {v}")
    for name, v in sorted(((metrics or {}).get("gauges") or {})
                          .items()):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn}{label} {v}")
    span_label = '{span="%s"' + (f',run="{run}"' if run else "") + "}"
    for name, agg in sorted(((metrics or {}).get("spans") or {})
                            .items()):
        if not isinstance(agg, dict):
            continue
        safe = name.replace("\\", "_").replace('"', "_")
        for field in ("count", "total_ns"):
            if isinstance(agg.get(field), (int, float)):
                pn = f"jepsen_tpu_span_{field}"
                lines.append(
                    f"{pn}{span_label % safe} {agg[field]}")
    return "\n".join(lines) + "\n"


def validate_prometheus_text(text: str) -> int:
    """Scrape-parses a Prometheus exposition document: every
    non-comment line must be `name{labels}? value`. Returns the sample
    count; raises ValueError on the first bad line."""
    import re

    sample = re.compile(
        r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
        r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""
        r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"
        r" [0-9.eE+-]+(\.[0-9]+)?$")
    n = 0
    for i, line in enumerate(text.splitlines()):
        if not line.strip() or line.startswith("#"):
            continue
        if not sample.match(line):
            raise ValueError(f"line {i}: not a prometheus sample: "
                             f"{line!r}")
        n += 1
    return n
