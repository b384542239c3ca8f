"""The language-model driver (``drivers/lm_serve.py``) rehearsed on the
CPU on the yi-34b smoke preset (``fixtures/``): its window, sample,
comparison and what makes it fail; the LM yardstick (``lm_work.py``,
``metrics/mfu.py``); and that a configuration of either kind joins the
benchmark as new files and entries only."""

import copy
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import REPO, add_lm_fixture
from detbench import harness, lm_work, tracer

SMOKE = "yi34b_smoke.serve"
SEED = 2**33 + 29
ACCEPTED = ["narrow.values", "wide.values", "narrow.mixed"]


def rehearse(lm_bench, trace=False, seconds=0.3, seed=SEED):
    return harness.run_cell(SMOKE, seed, seconds, trace, bench=lm_bench.bench,
                            device="cpu", root=lm_bench.root)


def driver(lm_bench):
    return harness.cell_driver(SMOKE, lm_bench.root)


def window(lm_bench, seconds=0.3, trace=False, seed=SEED):
    drv = driver(lm_bench)
    w = drv.load_workload(SMOKE, lm_bench.root)
    cfg, mcfg = drv.load_config(w.config, lm_bench.root)
    run, sample = drv.serve_window(w, cfg, mcfg, seed, seconds, trace,
                                   device="cpu")
    return drv, w, cfg, run, sample


def test_a_configuration_without_a_driver_takes_the_radic_path():
    for cell in ACCEPTED:
        assert harness.cell_driver(cell) is None


@pytest.mark.parametrize("name", ["nosuch", "../detbench/run"])
def test_an_unknown_driver_fails_with_the_file_s_name(tmp_path, name):
    (tmp_path / "configs").mkdir()
    (tmp_path / "workloads").mkdir()
    (tmp_path / "configs" / "odd.json").write_text(
        json.dumps({"driver": name}))
    (tmp_path / "workloads" / "odd.cell.json").write_text(
        json.dumps({"config": "odd"}))
    with pytest.raises(ValueError, match=r"configs/odd\.json"):
        harness.run_cell("odd.cell", 1, 0.1, False, bench={}, device="cpu",
                         root=tmp_path)


def test_an_lm_configuration_joins_as_new_files_only(lm_bench):
    """The fixture adds files and entries; every file the benchmark had
    is the same, byte for byte, and the cell runs correct, with the
    end-to-end metrics of every cell."""
    for f in (REPO / "detbench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            copied = lm_bench.root / f.relative_to(REPO / "detbench")
            assert copied.read_bytes() == f.read_bytes(), f
    assert all(not (REPO / "detbench" / p.relative_to(lm_bench.root)
                    ).exists() for p in lm_bench.added)
    assert len(lm_bench.added) == 5
    out = rehearse(lm_bench)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert set(out["metrics"]) == {"req_per_s", "p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["attempted"] % 4 == 0 and out["attempted"] >= 8
    assert set(out["checks"]) == {"logit_err"}
    assert out["checks"]["logit_err"]["value"] < 1e-5
    traced = rehearse(lm_bench, trace=True)
    assert traced["correct"] is True
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert traced["device"]["window_s"] > 0.3
    # the device metrics are never a CPU number
    assert not {"idle_share", "mfu"} & set(traced["metrics"])


def test_the_readers_read_the_lm_run(lm_bench):
    drv, w, cfg, run, sample = window(lm_bench)
    batches = run.attempted // w.batch
    assert run.answered == run.attempted and run.failed == 0
    assert batches >= len(w.lengths) and len(run.latency_s) == run.attempted
    assert run.tokens_prefill == int(run.shapes[:, 0].sum())
    assert run.tokens_decode == int(run.shapes[:, 1].sum())
    assert list(run.shapes[:w.batch * 2:w.batch].tolist()) == [
        list(p) for p in w.lengths]
    read = {name: harness.read_metric(name, run, lm_bench.root)
            for name in ("req_per_s", "p95_ms", "setup_s", "mfu",
                         "idle_share")}
    assert read["req_per_s"] == pytest.approx(run.answered / run.window_s)
    assert read["p95_ms"] == pytest.approx(
        np.percentile(run.latency_s, 95) * 1e3)
    assert read["setup_s"] == run.setup_s > 0
    assert read["mfu"] is None and read["idle_share"] is None
    # the same counts on a card: the share of bf16's or float32's peak
    card = copy.copy(run)
    card.device = "cuda"
    flops = sum(lm_work.prefill_flops(run.model, p)
                + lm_work.decode_flops(run.model, p, g)
                for p, g in run.shapes.tolist())
    assert harness.read_metric("mfu", card, lm_bench.root) == pytest.approx(
        100 * flops / run.window_s / 66.9e12)
    radic = harness.Run(workload=None, config={}, window_s=1.0,
                        device="cuda")
    assert harness.read_metric("mfu", radic, lm_bench.root) is None


def test_host_ranges_mirrored_on_the_device_are_no_device_work():
    """A span around launches (``client.batch``) appears on the device's
    timeline too; busy time and the breakdown leave it out."""
    ev = tracer.Events(
        dev_name=["client.batch", "nvjet_gemm", "lm.decode", "Memcpy DtoH"],
        dev_start=np.array([0.0, 10.0, 5.0, 60.0]),
        dev_end=np.array([100.0, 40.0, 95.0, 70.0]),
        host_name=["client.batch", "lm.decode", "aten::mm"],
        host_start=np.array([0.0, 5.0, 9.0]),
        host_end=np.array([100.0, 95.0, 11.0]))
    got = tracer.reduce(tracer.without_annotations(ev), {}, {})
    assert got["device_events"] == 2
    assert got["busy_s"] == pytest.approx(40e-9)
    assert [n for n, _ in got["device_ops"]] == ["nvjet_gemm", "Memcpy DtoH"]


def test_the_sample_is_a_fixed_prefix_drawn_by_the_seed(lm_bench):
    """A slower run compares the same sequences, and another seed
    others."""
    drv, w, _, _, short = window(lm_bench, seconds=0.0)
    *_, long = window(lm_bench, seconds=0.3)
    key = [(q.batch, q.row) for q in short.sequences]
    assert key == [(q.batch, q.row) for q in long.sequences]
    assert len(key) == 4 and {b for b, _ in key} == {0, 1}
    for a, b in zip(short.sequences, long.sequences):
        assert np.array_equal(a.emitted, b.emitted)
        gen = w.lengths[a.batch][1]
        assert sorted(a.kept) == [0, *drv.keep_steps(gen, 3)]
        assert gen in a.kept
        torch.testing.assert_close(a.kept[gen], b.kept[gen], rtol=0, atol=0)
    *_, other = window(lm_bench, seconds=0.0, seed=SEED + 1)
    assert any(not np.array_equal(a.emitted, b.emitted)
               for a, b in zip(other.sequences, short.sequences))


@pytest.mark.parametrize("spoil", ["one_logit", "row_nan"])
def test_a_perturbed_logit_row_fails(lm_bench, spoil):
    drv, w, cfg, run, sample = window(lm_bench, seconds=0.0)
    limit = cfg["guarantees"]["logit_err"]
    sound = drv.compare(sample, cfg, SEED, "cpu", lm_bench.root)
    assert sound["logit_err"] < limit / 10
    row = sample.sequences[-1].kept[max(sample.sequences[-1].kept)]
    with torch.inference_mode():
        if spoil == "one_logit":
            row[7] += 0.05 * row.square().mean().sqrt()
        else:
            row[3] = float("nan")
    got = drv.compare(sample, cfg, SEED, "cpu", lm_bench.root)["logit_err"]
    assert not got <= limit
    if spoil == "row_nan":
        assert got == np.inf


@pytest.mark.parametrize("seed", [3, 2**32 + 9, 41])
def test_the_bf16_control_fails_the_limit(lm_bench, seed):
    got = driver(lm_bench).control_readings(SMOKE, seed, device="cpu",
                                            root=lm_bench.root)
    c = got["checks"]["logit_err"]
    assert got["dtype"] == "bfloat16" and got["compared"] == 4
    assert c["fails"] and c["value"] > 30 * c["limit"]
    assert c["program"] < c["limit"] / 10


@pytest.mark.parametrize("fault", ["state_unchanged", "one_logit_altered",
                                   "nan_logits"])
def test_a_broken_timed_path_is_not_correct(lm_bench, monkeypatch, fault):
    from repro_torch.models.lm import CausalLM
    step = CausalLM.decode_step

    def broken(self, cache, tokens):
        logits, new = step(self, cache, tokens)
        if fault == "state_unchanged":
            return logits, cache
        logits = logits.clone()
        if fault == "one_logit_altered":
            logits[:, 11] += 1.0
        else:
            logits[:] = float("nan")
        return logits, new

    monkeypatch.setattr(CausalLM, "decode_step", broken)
    out = rehearse(lm_bench, seconds=0.0)
    assert out["correct"] is False
    if fault == "nan_logits":
        assert out["failed"] == out["attempted"]
    else:
        assert out["checks"]["logit_err"]["value"] > 1e-2


@pytest.mark.parametrize("bad", [
    {"loop": "open"},
    {"batch": 0},
    {"lengths": []},
    {"lengths": [[8, 6], [8, 6]]},
    {"lengths": [[0, 6]]},
    {"check_sequences": 9},
    {"check_steps": 5},
])
def test_a_malformed_lm_workload_is_refused(lm_bench, bad):
    d = json.loads((lm_bench.root / "workloads" / f"{SMOKE}.json"
                    ).read_text())
    with pytest.raises((ValueError, KeyError)):
        driver(lm_bench).workload_from_dict("bad", {**d, **bad})


@pytest.mark.parametrize("bad,match", [
    ({"arch": "yi-35b"}, "registry"),
    ({"overrides": {"n_layers": 2, "hidden": 64}}, "no ModelConfig field"),
    ({"hidden_size": 128}, "other values"),
    ({"dtype": "bfloat16"}, "dtype"),
    ({"driver": "other"}, "lm_serve"),
    ({"reference": "../reference.py"}, "reference"),
    ({"reference": "references/nosuch.py"}, "reference"),
])
def test_a_configuration_the_program_would_not_run_is_refused(lm_bench, bad,
                                                              match):
    drv = driver(lm_bench)
    path = lm_bench.root / "configs" / "yi34b_smoke.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **bad}))
    with pytest.raises(ValueError, match=match):
        drv.load_config("yi34b_smoke", lm_bench.root)


def _toy(**kw):
    base = dict(family="dense", n_layers=2, d_model=4, n_heads=2,
                n_kv_heads=1, head_dim=2, d_ff=8, vocab_size=10,
                attn_window=None, local_global_period=None, n_experts=0,
                top_k=0, dense_residual_ff=0, ssm_state=2, ssm_head_dim=4,
                ssm_expand=2, ssm_conv=4, n_frames=0, dtype="float32")
    return types.SimpleNamespace(**{**base, **kw})


def test_lm_work_by_hand_at_a_two_layer_toy():
    c = _toy()
    # a token: attention 2·4·4 + 2·4·2, GLU 3·4·8 → 144 weights a layer
    assert lm_work.layer_weights(c) == 144
    # prefill of 3: 2·144·2 a token, 4·2·2·t a layer at context t, the
    # head 2·4·10 once
    assert lm_work.prefill_flops(c, 3) == 576 * 3 + 32 * (1 + 2 + 3) + 80
    # 2 steps after it: contexts 4 and 5, the head each step
    assert lm_work.decode_flops(c, 3, 2) == 576 * 2 + 32 * (4 + 5) + 160
    # a window of 2 on every layer: a token sees at most 2 positions
    w = _toy(attn_window=2)
    assert lm_work.prefill_flops(w, 3) == 576 * 3 + 32 * (1 + 2 + 2) + 80
    # gemma2's alternation: layer 0 local, layer 1 global
    g = _toy(attn_window=2, local_global_period=2)
    assert lm_work.prefill_flops(g, 3) == (576 * 3 + 16 * (1 + 2 + 2)
                                           + 16 * (1 + 2 + 3) + 80)
    # SSM: in_proj 4·(16 + 4 + 2), conv 4·12, out_proj 8·4; the state
    # (2 heads of 4 × 2) updated and read, 2·2·16 a token
    s = _toy(family="ssm")
    assert lm_work.layer_weights(s) == 88 + 48 + 32
    assert lm_work.prefill_flops(s, 3) == 3 * 2 * (2 * 168 + 64) + 80
    # experts: the router and the one routed to
    m = _toy(family="moe", n_experts=4, top_k=1)
    assert lm_work.layer_weights(m) == 48 + 4 * 4 + 96


@pytest.mark.parametrize("a,b,window", [(1, 9, 4), (3, 3, None), (5, 12, 4),
                                        (2, 7, 9), (6, 6, 1)])
def test_lm_work_sums_the_positions_seen(a, b, window):
    want = sum(t if window is None else min(t, window)
               for t in range(a, b + 1))
    assert lm_work._seen(a, b, window) == want


def _archs():
    from repro_torch.configs.registry import ARCHS
    return list(ARCHS)


@pytest.mark.parametrize("arch", _archs())
def test_lm_work_counts_no_more_than_the_program_does(arch):
    """``mfu`` cannot pass 100 %: at every registry arch's published
    widths (a whole period of its layers, on ``meta``), the count is at
    most the products the program's prefill and decode step run
    (``FlopCounterMode``), so at most what the card computed.  The
    counter sees no elementwise op: an SSM state's update is left out of
    the comparison."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    c = get_config(arch)
    c = c.replace(n_layers=c.local_global_period or 2)
    model = build_model(c, device="meta")
    B, P = 2, 1100
    batch = {"tokens": torch.zeros((B, P), dtype=torch.long, device="meta")}
    extra = 0
    if c.prefix_embeds:
        extra = c.n_patches
        batch["prefix_embeds"] = torch.zeros(
            (B, c.n_patches, c.d_model), dtype=c.adtype, device="meta")
    if c.family == "audio":
        batch["frame_embeds"] = torch.zeros(
            (B, c.n_frames, c.d_model), dtype=c.adtype, device="meta")
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        out = make_prefill_step(model, P + extra + 1)(batch)
    assert B * lm_work.prefill_flops(c, P) <= fc.get_total_flops()
    cache = (model.init_cache(B, P + 1) if c.family == "audio"
             else out[1])
    tok = {"tokens": torch.zeros((B, 1), dtype=torch.int32, device="meta")}
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        make_decode_step(model)(cache, tok)
    update = (c.n_layers * lm_work.ssm_update_flops(c)
              if c.family in ("ssm", "hybrid") else 0)
    assert B * (lm_work.decode_flops(c, P, 1) - update) \
        <= fc.get_total_flops()
    assert lm_work.peak_flops(c) == 989.4e12


def _contract(repo: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly",
         str(repo / "detbench" / "tests" / "test_detbench_contract.py")],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("case", ["added", "width_cut"])
def test_added_cells_pass_the_contract_tests_unedited(tmp_path, case):
    """``wide.mixed`` (data only) and the yi-34b fixture's LM cell,
    added as files and entries, pass the contract tests as they are; a
    cut of a width does not."""
    fx = add_lm_fixture(tmp_path)
    root, bench = fx.root, fx.bench
    bench["configs"] = [c for c in bench["configs"]
                        if c["name"] != "yi34b_smoke"]
    bench["workloads"] = [w for w in bench["workloads"]
                          if w["name"] != SMOKE]
    mix = json.loads((root / "workloads" / "wide.values.json").read_text())
    mix["grad_period"] = 4
    (root / "workloads" / "wide.mixed.json").write_text(json.dumps(mix))
    bench["workloads"].append({
        "name": "wide.mixed", "config": "wide", "traffic": "wide.mixed",
        "chips": 1, "why": "wide.values' walk shapes, every 4th a gradient"})
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        m["workloads"] = [c for c in m["workloads"] if c in cells]
        if m["name"] == "idle_share":
            m["workloads"].append("wide.mixed")
    if case == "width_cut":
        cfg = root / "configs" / "yi34b_2l.json"
        d = json.loads(cfg.read_text())
        d["intermediate_size"] = 10240
        cfg.write_text(json.dumps(d))
        next(c for c in bench["configs"] if c["name"] == "yi34b_2l"
             )["reduced"].append("intermediate_size")
    (fx.repo / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    got = _contract(fx.repo)
    if case == "added":
        assert got.returncode == 0, got.stdout[-3000:]
        assert "failed" not in got.stdout
    else:
        assert got.returncode == 1, got.stdout[-3000:]
        assert "1 failed" in got.stdout
