"""The port's dry run (``repro_torch.launch.dryrun``): the tiny cell of
``test_drivers.py::test_dryrun_cell_tiny_mesh`` (llama3-8b cut to 2
layers of width 256, train_4k, on a (2, 2, 2) mesh in place of the
production one) through ``lower_cell``, its argument bytes per device
equal to a hand count of its shard shapes; a tiny prefill's counted
FLOPs equal to a hand count of its matmuls; the record's absent
collectives and its methods; the reference's skip reason for an
inapplicable cell; ``main`` writing one JSON per cell (read back, not
rerun, the second time) and exiting 0, and 1 on a planted failure; and
:class:`LiveBytes` on a toy graph."""

import json
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core import Mesh
from repro_torch.launch import dryrun as dr

TINY = {"n_layers": 2, "d_model": 256, "n_heads": 8, "n_kv_heads": 2,
        "head_dim": 32, "d_ff": 512, "vocab_size": 1024}


def tiny_mesh(multi_pod=False):
    """The reference test's shrunken production mesh, on meta."""
    shape = (2, 2, 2) if multi_pod else (4, 2)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.full(shape, torch.device("meta"), dtype=object), names)


@pytest.fixture(scope="module")
def tiny_train():
    with mock.patch.object(dr, "make_production_mesh", tiny_mesh):
        return dr.lower_cell("llama3-8b", "train_4k", True, TINY)


def test_tiny_cell_argument_bytes_equal_a_hand_count(tiny_train):
    """llama3-8b's small param rules on (pod 2, data 2, model 2): "embed"
    over data, qdim/kvdim/mlp/vocab over model, the layer stack and the
    norms whole; bf16 weights, float32 norms, float32 moments."""
    lowered, counted, _ = tiny_train
    # shard shapes' elements: embed (512, 128); wq, wo (2, 128, 128);
    # wk, wv (2, 128, 32); w_gate, w_up (2, 128, 256); w_down
    # (2, 256, 128); lm_head (128, 512); norm1, norm2 (2, 256) and
    # final_norm (256,) whole
    bf16 = 65536 + 2 * 32768 + 2 * 8192 + 3 * 65536 + 65536
    f32 = 2 * 512 + 256
    params = 2 * bf16 + 4 * f32
    moments = 2 * 4 * (bf16 + f32)
    step = 4
    batch = 2 * 4 * (256 // 4) * 4096  # tokens, labels over (pod, data)
    assert lowered.batch_split == 4
    assert lowered.argument_bytes() == params + moments + step + batch
    # the step holds every gradient at once: at least the params' bytes
    # unsplit (4 of the 8 positions hold each weight)
    assert counted.temp_bytes >= 2 * 2 * bf16


def test_tiny_prefill_flops_equal_a_hand_count():
    with mock.patch.object(dr, "make_production_mesh", tiny_mesh):
        lowered, counted, _ = dr.lower_cell("llama3-8b", "prefill_32k",
                                            True, TINY)
    B, S = 32 // 4, 32768
    T, d, q, kv, ff, V, H, D = B * S, 256, 256, 64, 512, 1024, 8, 32
    per_layer = (2 * T * d * (q + 2 * kv)   # wq, wk, wv
                 + 2 * T * q * d            # wo
                 + 2 * 2 * B * H * S * S * D  # scores and their values
                 + 3 * 2 * T * d * ff       # the GLU MLP
                 + 2 * 2 * T * d * kv)      # the cache's k and v
    head = 2 * B * d * V                    # the last position's logits
    assert counted.flops == 2 * per_layer + head
    assert set(counted.by_op) == {"aten.mm", "aten.bmm"}


def test_record_fields(tiny_train):
    lowered, counted, meta = tiny_train
    rec = dr.analyze(lowered, counted, lowered.cfg, "train_4k", "tiny",
                     lowered.mesh.size)
    assert rec["collective_bytes_per_device"] is None
    assert rec["hlo_bytes_per_device"] is None
    assert rec["collectives_reason"].startswith("absent")
    assert rec["cost_method"] == "counted-eager (meta)"
    assert "upper bound" in rec["temp_method"]
    assert rec["flops_per_device"] == counted.flops / 2
    assert rec["flops_global"] == counted.flops * 4
    assert rec["memory"] == {"argument_size_in_bytes":
                             lowered.argument_bytes(),
                             "temp_size_in_bytes": counted.temp_bytes}
    assert rec["fits_hbm_80g"] is (rec["live_bytes_per_device"]
                                   <= dr.HBM_PER_CARD)
    assert rec["n_chips"] == 8 and rec["per_device_batch"] == 64
    assert set(meta) == {"t_place_s", "t_run_s"}
    json.dumps(rec)


def test_inapplicable_cell_gives_the_reference_reason():
    ref_shapes = pytest.importorskip("repro.configs.shapes")
    from repro.configs.registry import get_config
    lowered, counted, meta = dr.lower_cell("llama3-8b", "long_500k", False)
    assert lowered is None and counted is None
    assert meta["skipped"] == ref_shapes.applicable(
        get_config("llama3-8b"), "long_500k")[1]


def _main(argv) -> int:
    with pytest.raises(SystemExit) as e:
        dr.main(argv)
    return e.value.code


def test_main_writes_one_record_per_cell(tmp_path, capsys):
    out = str(tmp_path)
    assert _main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                  "--mesh", "both", "--outdir", out]) == 0
    assert _main(["--arch", "llama3-8b", "--shape", "long_500k",
                  "--mesh", "single", "--outdir", out]) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["llama3-8b__long_500k__pod_16x16.json",
                     "mamba2-1.3b__long_500k__multipod_2x16x16.json",
                     "mamba2-1.3b__long_500k__pod_16x16.json"]
    text = capsys.readouterr().out
    assert text.count("[ok] ") == 2 and text.count("[skip] ") == 1
    assert "done; failures=0" in text
    rec = json.loads((tmp_path / files[2]).read_text())
    assert rec["n_chips"] == 256 and rec["batch_split"] == 1
    assert rec["fits_hbm_80g"] and rec["flops_counted"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert "skipped" in json.loads((tmp_path / files[0]).read_text())
    # a cell already written is read back, not run again
    assert _main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                  "--mesh", "single", "--outdir", out]) == 0
    assert "[skip-cached] mamba2-1.3b__long_500k__pod_16x16" in \
        capsys.readouterr().out


def test_a_failing_cell_exits_1(tmp_path, capsys, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("planted")

    monkeypatch.setattr(dr, "lower_cell", broken)
    assert _main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                  "--mesh", "single", "--outdir", str(tmp_path)]) == 1
    text = capsys.readouterr().out
    assert "[FAIL] mamba2-1.3b__long_500k__pod_16x16: RuntimeError: planted" \
        in text and "done; failures=1" in text
    rec = json.loads(next(tmp_path.iterdir()).read_text())
    assert rec["error"] == "RuntimeError: planted"


def test_live_bytes_on_a_toy_graph():
    """New storages count while alive; views, in-place results and the
    arguments do not; the peak stays."""
    a = torch.empty(1000, device="meta")              # 4000 bytes
    with dr.LiveBytes([a]) as lb:
        b = a * 2                                     # +4000
        v = b.view(10, 100)                           # a view: +0
        a.add_(1)                                     # in place: +0
        c = torch.empty(500, dtype=torch.float64, device="meta")  # +4000
        assert (lb.live, lb.peak) == (8000, 8000)
        del b
        assert lb.live == 8000                        # v holds b's storage
        del v, c
        assert lb.live == 0
        d = a.sum()                                   # +4
        assert (lb.live, lb.peak) == (4, 8000)
        cpu = torch.ones(10)                          # not meta: +0
        assert lb.live == 4
    del d, cpu
