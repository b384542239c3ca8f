"""On the card: a short run of every cell is correct, the control
fails there, and the LM driver's fixture (yi-34b, 2 layers at full
width) runs correct with its device metrics.  Skips without a CUDA
card; on the chip: ``python -m pytest detbench/tests -m card``."""

import json
from pathlib import Path

import pytest

from conftest import add_lm_fixture
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


@pytest.mark.card
def test_the_lm_fixture_runs_on_the_card(cuda_card, tmp_path):
    fx = add_lm_fixture(tmp_path)
    for trace in (False, True):
        out = harness.run_cell("yi34b_2l.serve", 2**31 + 7, 2.0, trace,
                               bench=fx.bench, root=fx.root)
        assert out["correct"] is True, out["checks"]
        got = out["metrics"]
        if trace:
            assert 0 < got["mfu"]["value"] < 100
            assert 0 <= got["idle_share"]["value"] < 100
        else:
            assert {"req_per_s", "p95_ms", "setup_s"} <= set(got)
