"""The harness's plumbing rehearsed on the CPU: a tiny cell through
``DetQueue(backend="torch", device="cpu")`` (the harness's look for a
card is ``run.py``'s and is skipped), its window, drain, counters, the
result line, the comparison and what makes it fail."""

import copy
import dataclasses
import itertools
import json
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from detbench import control, harness, reference
from detbench import run as run_py
from detbench.traffic import Traffic, load_workload

REPO = Path(__file__).resolve().parents[2]
DETBENCH = REPO / "detbench"
SHAPES = [[2, 5], [3, 6], [3, 7], [4, 8]]
SEED = 2**33 + 17


@pytest.fixture
def tiny(tmp_path):
    """A benchmark root with tiny cells (``tiny.values``, ``tiny.mixed``,
    ``tiny.open``) of the ``narrow`` configuration at max_batch 4, and a
    BENCHMARK.json whose metrics name them beside the real cells."""
    root = tmp_path / "detbench"
    shutil.copytree(DETBENCH / "metrics", root / "metrics")
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    cfg = json.loads((DETBENCH / "configs" / "narrow.json").read_text())
    cfg["max_batch"] = 4
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    cells = {
        "tiny.values": {"outstanding": 32},
        "tiny.mixed": {"outstanding": 32, "grad_period": 4},
        "tiny.open": {"loop": "open", "rate": 400.0},
    }
    for name, extra in cells.items():
        w = {"config": "tiny", "shapes": SHAPES, "check_per_shape": 64,
             **extra}
        (root / "workloads" / f"{name}.json").write_text(json.dumps(w))
    bench = copy.deepcopy(json.loads((REPO / "BENCHMARK.json").read_text()))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(cells)
    return types.SimpleNamespace(root=root, bench=bench)


def rehearse(tiny, cell, trace=False, seconds=0.4, seed=SEED):
    return harness.run_cell(cell, seed, seconds, trace, bench=tiny.bench,
                            device="cpu", backend="torch", root=tiny.root)


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contract_keys(tiny, trace, capsys):
    out = rehearse(tiny, "tiny.mixed", trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 32
    assert set(out["checks"]) == {"value_err_rss", "grad_rel_err"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    if trace:
        # counters read; the device metrics are never a CPU number
        assert {"batch_fill", "stage_ms", "plan_misses"} <= set(out["metrics"])
        assert not {"kernel_roofline", "idle_share"} & set(out["metrics"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["device"]["window_s"] > 0.4
    else:
        assert set(out["metrics"]) == {"req_per_s", "p95_ms", "setup_s"}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["device"]["platform"] == "cpu"
    harness.print_result(out)
    got = capsys.readouterr()
    assert json.loads(got.out.splitlines()[-1]) == json.loads(json.dumps(out))
    assert got.err.splitlines()[-1].startswith("check ")


def test_the_window_counts_its_own_work_only(tiny):
    w = load_workload("tiny.mixed", tiny.root)
    cfg = json.loads((tiny.root / "configs" / "tiny.json").read_text())
    run, sample = harness.serve_window(w, cfg, SEED, 0.4, False,
                                       device="cpu", backend="torch")
    assert run.answered == run.attempted == run.delta("completed")
    assert run.failed == 0 and len(run.latency_s) == run.attempted
    assert run.drain_s >= 0 and run.window_s >= 0.4
    assert run.delta("dispatches") >= run.delta("grad_dispatches") > 0
    t = Traffic(w, SEED)
    assert run.grads.sum() == sum(t.is_grad(k)
                                  for k in range(run.attempted))
    kinds = {(k % t.S, t.is_grad(k)) for k in sample}
    assert len(kinds) == 2 * len(SHAPES)
    for k, v in sample.items():
        assert np.shape(v) == (t.shape(k) if t.is_grad(k) else ())
    assert sum(run.collections["count"]) >= 0


def test_an_open_loop_cell_stops_before_its_window(tiny):
    with pytest.raises(ValueError, match="closed loop"):
        rehearse(tiny, "tiny.open")


@pytest.mark.parametrize("cell", ["tiny.values", "tiny.mixed"])
@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out",
                                   "nan_in_the_first_shape"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    from repro_torch.core import engine as eng

    def spoil(out, A):
        out = out.clone()
        if fault == "answer_altered":
            out[0] = out[0] + 1.0
        elif fault == "half_batch_left_out":
            out[out.shape[0] // 2:] = 0
        elif list(A.shape[1:]) == SHAPES[0]:
            # the first shape's answers are no number; the others sound
            out[:] = float("nan")
        return out

    build = eng.DetEngine._build_torch

    def broken(self, key, total):
        plan = build(self, key, total)
        ex, gx = plan.executable, plan.grad_executable
        return dataclasses.replace(
            plan, executable=lambda A: spoil(ex(A), A),
            grad_executable=lambda A, ct: spoil(gx(A, ct), A))

    monkeypatch.setattr(eng.DetEngine, "_build_torch", broken)
    out = rehearse(tiny, cell)
    assert out["correct"] is False
    assert any(not c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("spoiled", [0, 2])
def test_a_nan_answer_is_worse_than_any_number(tiny, spoiled):
    """NaN in one shape's answers, the first or a later one, wins over
    the sound answers of every other shape."""
    w = load_workload("tiny.values", tiny.root)
    t = Traffic(w, SEED)
    ks = range(4 * len(SHAPES))
    sample = {k: reference.radic_values(torch.from_numpy(
        t.matrix(k)[None]))[0].item() for k in ks}
    assert harness.compare(w, t, sample, "cpu")["value_err_rss"] < 1e-12
    for k in ks:
        if k % t.S == spoiled:
            sample[k] = float("nan")
    assert harness.compare(w, t, sample, "cpu")["value_err_rss"] == np.inf


@pytest.mark.parametrize("seed", [3, 2**32 + 9, 41])
def test_the_control_fails_the_limits(tiny, seed):
    got = control.control_readings("tiny.mixed", seed, device="cpu",
                                   root=tiny.root)
    assert got["compared"] == 4 * 32   # every request of the window
    assert all(c["fails"] for c in got["checks"].values()), got


def test_without_a_card_there_is_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_py.main(["--workload", "narrow.values", "--seed", "1",
                      "--seconds", "1", "--trace", "0"])
    got = capsys.readouterr()
    assert rc != 0 and "{" not in got.out
    assert "no result" in got.err


def test_jax_is_found_by_its_whole_top_level_name():
    clean = {"torch": None, "repro_torch": None, "repro_torch.core": None,
             "detbench.harness": None, "reprolint": None}
    assert run_py.forbidden_modules(clean) == []
    assert run_py.forbidden_modules({**clean, "repro.core": None}) == ["repro"]
    assert run_py.forbidden_modules(
        {**clean, "jax.numpy": None, "flax": None, "jaxlib.xla": None}
    ) == ["flax", "jax", "jaxlib"]


def brute(A: np.ndarray):
    """Radic's determinant and gradient by the definition, in numpy."""
    m, n = A.shape
    val, grad = 0.0, np.zeros((m, n))
    for J in itertools.combinations(range(n), m):
        s = (-1) ** (m * (m + 1) // 2 + sum(j + 1 for j in J))
        M = A[:, J]
        d = np.linalg.det(M)
        val += s * d
        grad[:, J] += s * d * np.linalg.inv(M).T
    return val, grad


@pytest.mark.parametrize("m,n", [(1, 4), (2, 5), (3, 3), (3, 7), (5, 9)])
def test_the_reference_is_the_definition(m, n):
    rng = np.random.default_rng(m * 100 + n)
    A = rng.standard_normal((2, m, n))
    cts = np.array([1.0, -2.5])
    vals, rss = reference.radic_values(torch.from_numpy(A))
    grads = reference.radic_grads(torch.from_numpy(A), torch.from_numpy(cts))
    for i in range(2):
        v, g = brute(A[i])
        assert vals[i].item() == pytest.approx(v, rel=1e-10, abs=1e-10)
        np.testing.assert_allclose(grads[i].numpy(), cts[i] * g,
                                   rtol=1e-9, atol=1e-9)
    assert (rss > 0).all()
    zero, _ = reference.radic_values(torch.zeros((1, 3, 2)))
    assert zero.item() == 0


def test_the_reference_agrees_with_the_program_on_the_cpu():
    from repro_torch.core.engine import DetEngine
    A = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 4, 9)))
    plan = DetEngine().plan(4, 9, backend="torch", device="cpu",
                            dtype=np.float64)
    want, _ = reference.radic_values(A)
    torch.testing.assert_close(plan(A), want, rtol=1e-9, atol=1e-9)
