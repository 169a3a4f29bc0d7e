"""The benchmark's command on the card: one short run of a cell is
correct, and its control, the program with its certificates switched off
(JEPSEN_TPU_CERTIFY=0), is not. Skips without a card; run on the card
with `python -m pytest perfbench/tests -m card`."""

import json
import os
import subprocess
import sys

import pytest
from harness import cell


def _run(card, cell_name: str, seed: int, **env) -> dict:
    proc = subprocess.run(
        [sys.executable, str(cell.PERFBENCH / "run.py"), "--workload",
         cell_name, "--seed", str(seed), "--seconds", "15", "--trace", "0"],
        cwd=cell.ROOT, capture_output=True, text=True, timeout=360,
        env={**os.environ, **env})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.card
def test_a_short_run_is_correct(card):
    out = _run(card, "independent-1024.valid", 2**31 + 5)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == __import__("torch").cuda \
        .get_device_name(0)


@pytest.mark.card
def test_the_control_is_not_correct(card):
    out = _run(card, "independent-1024.valid", 2**31 + 6,
               JEPSEN_TPU_CERTIFY="0")
    assert out["correct"] is False
    assert out["compared"]["certificates_absent"]["value"] > 0
