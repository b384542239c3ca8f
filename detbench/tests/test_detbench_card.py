"""On the card: a short run of every cell is correct, and the control
fails there.  Skips without a CUDA card; on the chip:
``python -m pytest detbench/tests -m card``."""

import json
from pathlib import Path

import pytest

from detbench import control, harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_is_correct_on_the_card(cuda_card, cell):
    out = harness.run_cell(cell, 2**31 + 3, 2.0, False, bench=BENCH)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["attempted"] > 0


@pytest.mark.card
def test_the_control_fails_on_the_card(cuda_card):
    got = control.control_readings("narrow.mixed", 5, device="cuda")
    assert all(c["fails"] for c in got["checks"].values()), got
