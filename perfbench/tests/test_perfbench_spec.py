"""BENCHMARK.json against the contract the harness is built to, and the
harness's files found by name."""

import json
import re

import pytest
from harness import cell, judge

BENCH = json.loads((cell.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_every_name_and_unit_uses_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
    for text in ([c["why"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text, text


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
    for m in METRICS:
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("name", CELLS)
def test_the_harness_finds_every_file_of_a_cell(name):
    spec = cell.resolve(name)
    ent = cell.entry_module(spec["config"])
    for fn in ("inputs", "labels", "history", "checker"):
        assert callable(getattr(ent, fn))
    ref = judge.reference(spec["config"])
    assert callable(ref.judge) and ref.LIMITS
    assert spec["traffic"]["loop"] == "closed"
    e2e = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(cell.reader(m["name"]))
    for m in spec["per_layer"]:
        assert m["moves"] in e2e


def test_every_config_file_states_its_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((cell.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["guarantees"] and cfg["assumed"]
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in METRICS:
        assert any(cell.applies(m, w) for w in CELLS), m["name"]


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
