"""Clock-skew-over-time plots (the port's copy of
jepsen_tpu/reports/clock.py).

Capability reference: jepsen/src/jepsen/checker/clock.clj —
history->datasets building {node: [[t, offset], ...]} from ops carrying
'clock-offsets' (14-35), step plots per node with nemesis shading
(48-76). Renders via matplotlib instead of gnuplot; the node probe's
sampled offsets come from the port's nodeprobe.
"""

from __future__ import annotations

import logging

from .. import util
from .perf import _figure, _save, _shade_nemeses

logger = logging.getLogger(__name__)


def history_to_datasets(history) -> dict:
    """{node: [[t-seconds, offset], ...]} from 'clock-offsets' ops
    (clock.clj:14-35)."""
    if not len(history):
        return {}
    final_time = util.nanos_to_secs(history[-1].time)
    series: dict = {}
    for op in history:
        offsets = op.get("clock-offsets")
        if not offsets:
            continue
        t = util.nanos_to_secs(op.time)
        for node, offset in offsets.items():
            series.setdefault(node, []).append([t, offset])
    # extend each series to the end of the test so steps render fully
    for pts in series.values():
        pts.append([final_time, pts[-1][1]])
    return series


def short_node_names(nodes) -> list:
    """Strips common trailing domain components (clock.clj:37-46)."""
    split = [str(n).split(".") for n in nodes]
    if not split:
        return []
    # drop the longest common proper suffix
    k = 0
    while (k < min(len(s) for s in split) - 1
           and len({tuple(s[len(s) - k - 1:]) for s in split}) == 1):
        k += 1
    return [".".join(s[:len(s) - k]) for s in split]


def merge_nodeprobe(datasets: dict, test) -> dict:
    """Folds the node probe's per-tick clock offsets (nodes.jsonl,
    nodeprobe.py) into the check-offsets datasets, so the skew
    plot shows the continuously-sampled series, not just the nemesis's
    occasional observations. Points merge time-sorted per node."""
    from .. import nodeprobe

    records = nodeprobe.load_records(test.get("store_dir"))
    if not records:
        return datasets
    merged = nodeprobe.clock_series(records)  # probe points only —
    # the history's check-offsets already live in `datasets`
    if not merged:
        return datasets
    out = {n: list(pts) for n, pts in datasets.items()}
    for node, pts in merged.items():
        out.setdefault(node, []).extend(
            [util.nanos_to_secs(t), off] for t, off in pts)
    for pts in out.values():
        pts.sort(key=lambda p: p[0])
    return out


def plot(test, history, opts=None) -> dict:
    """Writes clock-skew.png (clock.clj plot!): the history's
    check-offsets observations merged with the node probe's sampled
    offset series."""
    if not (test.get("store_dir") or test.get("name")):
        return {"valid?": True, "skipped": "no store directory"}
    datasets = merge_nodeprobe(history_to_datasets(history), test)
    if not datasets:
        return {"valid?": True}
    nodes = sorted(datasets, key=str)
    names = short_node_names(nodes)
    plt, fig, ax = _figure()
    ax.set_ylabel("Skew (s)")
    ax.set_title(f"{test.get('name') or 'test'} clock skew")
    for node, name in zip(nodes, names):
        pts = datasets[node]
        ax.step([t for t, _ in pts], [v for _, v in pts],
                where="post", lw=1.2, label=name, zorder=2)
    _shade_nemeses(ax, test, history)
    ax.legend(loc="upper right", fontsize=8)
    path = _save(plt, fig, test, opts, "clock-skew.png")
    return {"valid?": True, "file": path}
