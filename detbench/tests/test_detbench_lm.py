"""The language-model driver (``drivers/lm_serve.py``) rehearsed on the
CPU on the yi-34b smoke preset (``fixtures/``): its window, sample,
comparison and what makes it fail; the LM yardstick (``lm_work.py``,
``metrics/mfu.py``); and that a configuration of either kind joins the
benchmark as new files and entries only."""

import copy
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import FIXTURES, REPO, add_lm_fixture
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


def _layer_weights(c) -> int:
    plan = lm_work.family_plan(c)
    return sum(part.weights(plan.d_model) for part in plan.layers[0])


def test_lm_work_by_hand_at_a_two_layer_toy():
    c = _toy()
    # a token: attention 2·4·4 + 2·4·2, GLU 3·4·8 → 144 weights a layer
    assert _layer_weights(c) == 144
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
    assert _layer_weights(s) == 88 + 48 + 32
    assert lm_work.prefill_flops(s, 3) == 3 * 2 * (2 * 168 + 64) + 80
    # experts: the router and the one routed to
    m = _toy(family="moe", n_experts=4, top_k=1)
    assert _layer_weights(m) == 48 + 4 * 4 + 96


@pytest.mark.parametrize("a,b,window", [(1, 9, 4), (3, 3, None), (5, 12, 4),
                                        (2, 7, 9), (6, 6, 1)])
def test_lm_work_sums_the_positions_seen(a, b, window):
    want = sum(t if window is None else min(t, window)
               for t in range(a, b + 1))
    assert lm_work._seen(a, b, window) == want


def _lm_serve():
    """The LM driver's module, loaded by path as ``harness.cell_driver``
    loads it."""
    path = REPO / "detbench" / "drivers" / "lm_serve.py"
    spec = importlib.util.spec_from_file_location("detbench_lm_serve_test",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _archs() -> list[str]:
    """The registry's archs whose family has a family plan."""
    from repro_torch.configs.registry import ARCHS, get_config
    return [a for a in ARCHS if get_config(a).family in lm_work.FAMILIES]


def _lm_files() -> list[Path]:
    """Every language-model configuration file of the benchmark and of
    its tests' fixtures whose arch the program's registry holds."""
    from repro_torch.configs.registry import ARCHS
    root = REPO / "detbench"
    out = []
    for d in (root / "configs", root / "tests" / "fixtures" / "configs"):
        for p in sorted(d.glob("*.json")):
            cfg = json.loads(p.read_text())
            if cfg.get("driver") == "lm_serve" and cfg.get("arch") in ARCHS:
                out.append(p)
    return out


def _program_flops(c, B: int, P: int, device: str) -> tuple[int, int]:
    """``FlopCounterMode``'s totals of the program's prefill of ``B``
    prompts of ``P`` tokens and of one decode step after it."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    model = build_model(c, device=device)
    batch = {"tokens": torch.zeros((B, P), dtype=torch.long, device=device)}
    extra = 0
    if c.prefix_embeds:
        extra = c.n_patches
        batch["prefix_embeds"] = torch.zeros(
            (B, c.n_patches, c.d_model), dtype=c.adtype, device=device)
    if c.family == "audio":
        batch["frame_embeds"] = torch.zeros(
            (B, c.n_frames, c.d_model), dtype=c.adtype, device=device)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        out = make_prefill_step(model, P + extra + 1)(batch)
    prefill = fc.get_total_flops()
    cache = (model.init_cache(B, P + 1) if c.family == "audio"
             else out[1])
    tok = {"tokens": torch.zeros((B, 1), dtype=torch.int32, device=device)}
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        make_decode_step(model)(cache, tok)
    return prefill, fc.get_total_flops()


def _hold_count(c, config=None, *, device="meta", P=1100, B=2) -> None:
    """The count (the file's layers, else the family's) at or under the
    program's.  The counter sees no elementwise op: a Mamba-2 state's
    update in a decode step is left out of the comparison."""
    prefill, decode = _program_flops(c, B, P, device)
    assert B * lm_work.prefill_flops(c, P, config) <= prefill
    update = sum(2 * m.heads * m.head_dim * m.state
                 for layer in lm_work.plan(c, config).layers for m in layer
                 if isinstance(m, lm_work.Mamba2))
    assert B * (lm_work.decode_flops(c, P, 1, config) - update) <= decode


# a prompt short enough for a model at its published widths on the CPU
CPU_PROMPT = 16


def _needs_data(e: RuntimeError) -> bool:
    """Whether ``meta`` refused an operation because its result depends
    on the values (a dropless router's counts, ``.item()``, ``nonzero``):
    torch's message then names meta.  Any other error is a fault."""
    return re.search(r"meta tensor|register_meta", str(e), re.I) is not None


def _every_kind(cfg: dict, depth: int) -> dict:
    """The configuration cut to the fewest layers that still hold every
    kind: with a ``layers`` block, the shortest run of its pattern that
    holds every letter (``MEMEM*EMEMEM*`` → ``EM*``), written to the
    pattern's key and to any override that holds the pattern as run; with
    no such override the program cuts its own pattern by depth, so the
    shortest prefix that holds every letter.  Without a block, ``depth``
    layers of the family's.  ``num_hidden_layers`` and ``overrides``'
    ``n_layers`` follow."""
    out = copy.deepcopy(cfg)
    if "layers" in cfg:
        pattern = cfg[cfg["layers"]["pattern"]]
        held = [k for k, v in cfg["overrides"].items()
                if v in (pattern, list(pattern))]
        starts = range(len(pattern)) if held else (0,)
        cut = min((pattern[i:j] for i in starts
                   for j in range(i + 1, len(pattern) + 1)
                   if set(pattern[i:j]) == set(pattern)), key=len)
        out[cfg["layers"]["pattern"]] = cut
        for k in held:
            out["overrides"][k] = (cut if isinstance(cfg["overrides"][k], str)
                                   else list(cut))
        depth = len(cut)
    out["overrides"]["n_layers"] = depth
    if "num_hidden_layers" in cfg:
        out["num_hidden_layers"] = depth
    return out


@pytest.mark.parametrize("arch", _archs())
def test_lm_work_counts_no_more_than_the_program_does(arch):
    """``mfu`` cannot pass 100 %: at every registry arch's published
    widths (a whole period of its layers, on ``meta``), the family's
    count is at most the products the program's prefill and decode step
    run (``FlopCounterMode``), so at most what the card computed."""
    from repro_torch.configs.registry import get_config
    c = get_config(arch)
    _hold_count(c.replace(n_layers=c.local_global_period or 2))
    assert lm_work.peak_flops(c) == 989.4e12


@pytest.mark.parametrize("path", _lm_files(),
                         ids=lambda p: str(p.relative_to(REPO / "detbench")))
def test_lm_work_counts_no_more_than_the_program_does_for_a_file(path):
    """The same for every LM configuration file, counted as ``mfu``
    counts it (its ``layers`` block where it has one) at the depth it
    runs: on ``meta`` where the model runs there; where it routes by the
    data (an expert layer that drops no token), on the CPU at a short
    prompt and the fewest layers that hold every kind (``_every_kind``),
    counted by the same parts."""
    cfg = json.loads(path.read_text())
    drv = _lm_serve()
    c = drv.model_config(cfg, str(path))
    try:
        _hold_count(c, cfg)
    except RuntimeError as e:
        if not _needs_data(e):
            raise
        cut = _every_kind(cfg, c.local_global_period or 2)
        small = drv.model_config(cut, str(path))
        assert set(lm_work.plan(small, cut).layers) \
            == set(lm_work.plan(c, cfg).layers)
        _hold_count(small, cut, device="cpu", P=CPU_PROMPT)


def test_only_meta_s_refusals_of_data_are_taken_for_routing():
    """The CPU case is taken for the errors ``meta`` raises where an
    operation needs the values, and for no other error."""
    x = torch.zeros(8, dtype=torch.long, device="meta")
    refusals = []
    for op in (lambda: x.sum().item(), x.nonzero, lambda: torch.bincount(x),
               x.tolist, lambda: torch.repeat_interleave(x)):
        with pytest.raises(RuntimeError) as e:
            op()
        refusals.append(_needs_data(e.value))
    assert refusals == [True] * 5
    with pytest.raises(RuntimeError) as e:
        x.view(3, 3)
    assert not _needs_data(e.value)


@pytest.mark.parametrize("held", [True, False])
def test_the_cpu_case_cuts_a_pattern_to_every_kind(held):
    """Nemotron-3-Nano's 13 layers cut for the CPU: every kind, each
    counted by the parts the file states, and the cut a run of the
    published pattern, so that ``file_plan`` takes it."""
    cfg = json.loads((FIXTURES / "configs" / "nemotron3_nano_13l.json"
                      ).read_text())
    if held:
        cfg["overrides"]["layer_pattern"] = cfg["hybrid_override_pattern"]
    cut = _every_kind(cfg, 2)
    want = "EM*" if held else "MEMEM*"
    assert cut["hybrid_override_pattern"] == want
    assert cut["num_hidden_layers"] == cut["overrides"]["n_layers"] \
        == len(want)
    assert cut["overrides"].get("layer_pattern", want) == want
    full, small = lm_work.file_plan(cfg), lm_work.file_plan(cut, "cut")
    assert set(small.layers) == set(full.layers) and len(full.layers) == 13
    assert cfg["hybrid_override_pattern"] == "MEMEM*EMEMEM*"


def test_the_program_s_count_on_the_cpu_is_meta_s():
    """The CPU, where a file's model cannot run on ``meta``, counts the
    program's products as ``meta`` does."""
    path = FIXTURES / "configs" / "yi34b_smoke.json"
    c = _lm_serve().model_config(json.loads(path.read_text()), str(path))
    assert _program_flops(c, 2, CPU_PROMPT, "cpu") == _program_flops(
        c, 2, CPU_PROMPT, "meta")


def test_every_registry_arch_is_counted():
    """A registry arch whose family has no family plan is counted from
    the benchmark's configuration files that name it, each with a
    ``layers`` block, and is named by one at least."""
    from repro_torch.configs.registry import ARCHS, get_config
    root = REPO / "detbench"
    files: dict = {}
    for d in (root / "configs", root / "tests" / "fixtures" / "configs"):
        for p in sorted(d.glob("*.json")):
            cfg = json.loads(p.read_text())
            files.setdefault(cfg.get("arch"), []).append(
                (p.name, "layers" in cfg))
    uncounted = {a: files.get(a, []) for a in ARCHS
                 if get_config(a).family not in lm_work.FAMILIES
                 and not (files.get(a) and all(has for _, has in files[a]))}
    assert not uncounted, uncounted


# prefill_flops(1100) and decode_flops(1100, 1) as lm_work counted them
# by family alone, before a configuration file could state its layers
FAMILY_COUNTS = {
    "yi-34b": (74677858304000, 69752668160),
    "gemma2-9b": (18730442752000, 19239829504),
    "llama3-405b": (888626965905408, 816587341824),
    "llama3-8b": (15673041354752, 15586557952),
    "hymba-1.5b": (3514706102400, 3395966592),
    "arctic-480b": (37698239488000, 35281899520),
    "grok-1-314b": (183443401998336, 169241739264),
    "mamba2-1.3b": (2839490887680, 2787115008),
    "internvl2-26b": (41906893860864, 39882829824),
    "whisper-medium": (1218402437120, 1267877888),
    "yi34b_2l": (2490148864000, 3212009472),
    "yi34b_smoke": (463297536, 768512),
}


@pytest.mark.parametrize("name", list(FAMILY_COUNTS))
def test_the_family_count_has_not_moved(name):
    from repro_torch.configs.registry import ARCHS, get_config
    if name in ARCHS:
        c, cfg = get_config(name), None
    else:
        path = FIXTURES / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        c = _lm_serve().model_config(cfg, str(path))
    assert (lm_work.prefill_flops(c, 1100, cfg),
            lm_work.decode_flops(c, 1100, 1, cfg)) == FAMILY_COUNTS[name]


_COUNT_FROM_FILE = """
import json, sys
from detbench import lm_work
cfg = json.load(open(sys.argv[1]))
p = lm_work.file_plan(cfg, sys.argv[1])
parts = [part for layer in p.layers for part in layer]
print(json.dumps({
    "kinds": sorted({type(q).__name__: sum(type(r) is type(q) for r in parts)
                     for q in parts}.items()),
    "token": sum(2 * q.weights(p.d_model) + q.token_flops() for q in parts),
    "position": sum(q.span_flops(1, 1) for q in parts),
    "head": lm_work.head_flops(p),
    "prefill": lm_work.prefill_flops(None, 2048, cfg),
    "decode": lm_work.decode_flops(None, 2048, 128, cfg),
    "loaded": sorted({"torch", "repro_torch", "numpy"} & set(sys.modules)),
}))
"""


def test_the_pattern_fixture_is_counted_from_its_file_alone():
    """Nemotron-3-Nano's first 13 layers (``MEMEM*EMEMEM*``: Mamba-2 of
    64 heads × 64 in 8 groups, 128 relu² experts top-6 beside a shared
    one, GQA 32/2) from the file alone, in a process that loads nothing
    of the program, to the numbers counted by hand: 6 Mamba-2 layers of
    79,560,704 FLOPs a token, 5 expert layers of 160,333,824 and 2
    attention layers of 46,792,704, plus 4 · 32 · 128 a position seen in
    each attention layer."""
    path = FIXTURES / "configs" / "nemotron3_nano_13l.json"
    got = subprocess.run(
        [sys.executable, "-c", _COUNT_FROM_FILE, str(path)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=60, check=True)
    out = json.loads(got.stdout)
    assert out["kinds"] == [["Attention", 2], ["Mamba2", 6], ["Moe", 5]]
    assert out["token"] == 6 * 79_560_704 + 5 * 160_333_824 \
        + 2 * 46_792_704 == 1_372_618_752
    assert out["position"] == 32_768
    assert out["head"] == 704_643_072
    assert out["prefill"] == 2_880_580_878_336
    assert out["decode"] == 274_749_980_672
    assert out["loaded"] == []


def test_mfu_counts_the_file_s_layers():
    """``mfu`` reads the configuration file's layers, not a family's."""
    cfg = json.loads((FIXTURES / "configs" / "nemotron3_nano_13l.json"
                      ).read_text())
    run = harness.Run(workload=None, config=cfg, window_s=2.0,
                      device="cuda", model=types.SimpleNamespace(
                          dtype="bfloat16"),
                      shapes=np.array([[2048, 128]] * 16 + [[512, 64]] * 16),
                      tokens_prefill=16 * 2560, tokens_decode=16 * 192)
    want = 16 * (2_880_580_878_336 + 274_749_980_672
                 + lm_work.prefill_flops(None, 512, cfg)
                 + lm_work.decode_flops(None, 512, 64, cfg))
    assert harness.read_metric("mfu", run) == pytest.approx(
        100 * want / 2.0 / 989.4e12, rel=1e-12)


@pytest.mark.parametrize("family", ["nemotron_h", "vlm", "audio"])
def test_lm_serve_takes_any_family_but_those_needing_other_inputs(
        monkeypatch, family):
    """A stub arch of a family `lm_serve` has never seen is served;
    ``vlm`` and ``audio``, which need image embeddings or an encoder's
    frames beside the tokens, are refused."""
    from repro_torch.configs import registry
    from repro_torch.models.config import ModelConfig
    stub = ModelConfig(name="stub", family=family, n_layers=4, d_model=64,
                       n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                       vocab_size=512, dtype="float32")
    monkeypatch.setitem(registry.ARCHS, "stub-arch", "stub")
    monkeypatch.setattr(registry, "get_config", lambda name, **kw: stub)
    cfg = {"driver": "lm_serve", "arch": "stub-arch",
           "overrides": {"n_layers": 2}, "dtype": "float32",
           "num_hidden_layers": 2, "hidden_size": 64}
    drv = _lm_serve()
    if family == "nemotron_h":
        assert drv.model_config(cfg, "stub.json").n_layers == 2
    else:
        with pytest.raises(ValueError, match=r"stub\.json: the .* family "
                           "is not served"):
            drv.model_config(cfg, "stub.json")


def _pytest(repo: Path, path: Path, *args: str,
            plugins: Path | None = None) -> subprocess.CompletedProcess:
    """pytest over ``path`` in the checkout ``repo``; ``plugins``: a
    directory of plugin modules put on the import path (``-p``)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + ([str(plugins)] if plugins else [])))
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", *args, str(path)],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)


def _contract(repo: Path, *args: str, plugins: Path | None = None
              ) -> subprocess.CompletedProcess:
    return _pytest(repo, repo / "detbench" / "tests"
                   / "test_detbench_contract.py", *args, plugins=plugins)


# the arch a model_config change registers for the pattern fixture: its
# name and ModelConfig, of a family without a family plan
_STUB_ARCH = """
from repro_torch.configs import registry
from repro_torch.models.config import ModelConfig

STUB = ModelConfig(name="nemotron-3-nano-30b-a3b", family="nemotron_h",
                   n_layers=52, d_model=2688, n_heads=32, n_kv_heads=2,
                   head_dim=128, d_ff=1856, vocab_size=131072,
                   rope_theta=10000.0, dtype="bfloat16")
registry.ARCHS[STUB.name] = "stub"
_get = registry.get_config


def _get_config(name, smoke=False, optimized=False):
    return STUB if name == STUB.name else _get(name, smoke, optimized)


registry.get_config = _get_config
"""


def _add_pattern_model(fx, tmp_path: Path) -> Path:
    """What a model_config change adds for the pattern fixture: it as a
    configuration, a workload, a reference, the entries, and its arch in
    the registry (a stub plugin here) → the plugin's directory."""
    name = "nemotron3_nano_13l"
    shutil.copy(FIXTURES / "configs" / f"{name}.json", fx.root / "configs")
    cfg = json.loads((fx.root / "configs" / f"{name}.json").read_text())
    (fx.root / "workloads" / f"{name}.serve.json").write_text(json.dumps({
        "config": name, "loop": "closed", "batch": 16,
        "lengths": [[2048, 128]], "check_sequences": 4, "check_steps": 3}))
    (fx.root / cfg["reference"]).write_text(
        "import torch\n\n\ndef forward(params, cfg, tokens):\n"
        "    raise NotImplementedError\n")
    fx.bench["configs"].append({
        "name": name, "source": cfg["source"],
        "file": f"detbench/configs/{name}.json",
        "reduced": ["hybrid_override_pattern", "num_hidden_layers"],
        "why": "Mamba-2, relu2 experts and GQA by hybrid_override_pattern"})
    fx.bench["workloads"].append({
        "name": f"{name}.serve", "config": name,
        "traffic": f"{name}.serve", "chips": 1,
        "why": "batches of 16, prompts of 2048, 128 greedy steps"})
    for m in fx.bench["per_layer"]:
        if m["name"] in ("mfu", "idle_share"):
            m["workloads"].append(f"{name}.serve")
    plugins = tmp_path / "plugins"
    plugins.mkdir()
    (plugins / "stub_arch.py").write_text(_STUB_ARCH)
    return plugins


@pytest.mark.parametrize("case", ["added", "width_cut", "pattern_model"])
def test_added_cells_pass_the_contract_tests_unedited(tmp_path, case):
    """``wide.mixed`` (data only) and the yi-34b fixture's LM cell,
    added as files and entries, pass the contract tests as they are; a
    cut of a width does not.  The pattern fixture (Nemotron-3-Nano, a
    family the program does not have yet), added as a configuration with
    its arch stubbed into the registry, passes them too; the count's
    tests collect it as a file to count, and count its arch by its file,
    and by nothing once its ``layers`` block is gone."""
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
    plugins = None
    if case == "width_cut":
        cfg = root / "configs" / "yi34b_2l.json"
        d = json.loads(cfg.read_text())
        d["intermediate_size"] = 10240
        cfg.write_text(json.dumps(d))
        next(c for c in bench["configs"] if c["name"] == "yi34b_2l"
             )["reduced"].append("intermediate_size")
    if case == "pattern_model":
        plugins = _add_pattern_model(fx, tmp_path)
    (fx.repo / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    stub = ("-p", "stub_arch") if plugins else ()
    got = _contract(fx.repo, *stub, plugins=plugins)
    if case == "width_cut":
        assert got.returncode == 1, got.stdout[-3000:]
        assert "1 failed" in got.stdout
        return
    assert got.returncode == 0, got.stdout[-3000:]
    assert "failed" not in got.stdout
    if case == "added":
        return
    lm_tests = root / "tests" / "test_detbench_lm.py"
    listed = _pytest(fx.repo, lm_tests, "--collect-only", *stub,
                     plugins=plugins)
    assert listed.returncode == 0, listed.stdout[-3000:]
    assert "program_does_for_a_file[configs/nemotron3_nano_13l.json]" \
        in listed.stdout, listed.stdout[-3000:]
    assert "program_does[nemotron-3-nano-30b-a3b]" not in listed.stdout
    counted = _pytest(fx.repo, lm_tests, "-k", "every_registry_arch",
                      *stub, plugins=plugins)
    assert counted.returncode == 0, counted.stdout[-3000:]
    assert "1 passed" in counted.stdout, counted.stdout[-3000:]
    path = root / "configs" / "nemotron3_nano_13l.json"
    cfg = json.loads(path.read_text())
    del cfg["layers"]
    path.write_text(json.dumps(cfg))
    uncounted = _pytest(fx.repo, lm_tests, "-k", "every_registry_arch",
                        *stub, plugins=plugins)
    assert uncounted.returncode == 1, uncounted.stdout[-3000:]
    assert "nemotron-3-nano-30b-a3b" in uncounted.stdout
