"""The port's serve driver (``repro_torch.launch.serve``) on the CPU, as
``tests/test_drivers.py`` drives the reference's: the generated tokens'
shape, the EOS dead-slot path, a vlm, an ssm, a hybrid, a moe and the
audio arch (its warm cross cache and forced prompt), and the card as
the default device."""

import numpy as np
import pytest
import torch

from repro_torch.launch import serve

ARGS = ["--arch", "llama3-8b", "--smoke", "--device", "cpu",
        "--batch", "2", "--prompt-len", "8", "--gen", "6"]


def test_serve_generates(capsys):
    gen = serve.main(ARGS)
    assert gen.shape == (2, 6)
    assert (gen >= 0).all() and (gen < 512).all()
    out = capsys.readouterr().out
    assert "generated (2, 6) tokens" in out and "live=2/2" in out
    assert "prefill " in out and " ms/step on cpu" in out
    # seeded: the same command line serves the same tokens
    assert np.array_equal(serve.main(ARGS), gen)


def test_serve_logits_are_greedy_and_finite():
    out = serve.run(ARGS)
    logits = out["logits"]
    assert len(logits) == 7 and out["n_live_tokens"] == 12
    for t in range(6):
        assert torch.isfinite(logits[t]).all()
        assert logits[t].shape == (2, 512) and logits[t].dtype == \
            torch.float32
        assert np.array_equal(torch.argmax(logits[t], -1).numpy(),
                              out["tokens"][:, t])
    assert out["prefill_ms"] > 0 and out["decode_ms"] > 0


def test_serve_eos_frees_slots(capsys):
    """A token that slot 0 emits at step 2 as EOS: slot 0 dies after it,
    pads with EOS, and its live tokens stop counting."""
    gen = serve.main(ARGS)
    eos = int(gen[0, 2])
    capsys.readouterr()
    out = serve.run(ARGS + ["--eos", str(eos)])
    got = out["tokens"]
    assert out["live"] < 2
    first = [int(np.argmax(row == eos)) if (row == eos).any() else None
             for row in gen]
    for b in range(2):
        if first[b] is not None and first[b] >= 1:
            stop = first[b]
            assert np.array_equal(got[b, :stop + 1], gen[b, :stop + 1])
            assert (got[b, stop:] == eos).all()
    assert out["n_live_tokens"] < 12
    assert f"live={out['live']}/2" in capsys.readouterr().out


def test_serve_vlm_arch():
    gen = serve.main(["--arch", "internvl2-26b", "--smoke", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "4",
                      "--gen", "3"])
    assert gen.shape == (2, 3)


def test_serve_ssm_arch():
    gen = serve.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert gen.shape == (2, 4)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "arctic-480b"])
def test_serve_hybrid_and_moe_archs(arch):
    """The hybrid cache (k/v with conv/state) and the moe dispatch through
    the greedy loop: each served token the argmax of its logits."""
    out = serve.run(["--arch", arch, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "9", "--gen", "4"])
    assert out["tokens"].shape == (2, 4) and len(out["logits"]) == 5
    for t in range(4):
        assert torch.isfinite(out["logits"][t]).all()
        assert np.array_equal(torch.argmax(out["logits"][t], -1).numpy(),
                              out["tokens"][:, t])


def test_serve_layers_cuts_depth_only():
    """``--layers N`` keeps the first N layers at the config's width."""
    out = serve.run(["--arch", "grok-1-314b", "--smoke", "--device", "cpu",
                     "--layers", "1", "--batch", "2", "--prompt-len", "4",
                     "--gen", "2"])
    model = out["model"]
    assert len(model.layers) == model.cfg.n_layers == 1
    assert model.cfg.d_model == 64 and out["tokens"].shape == (2, 2)


def test_serve_audio_arch(capsys):
    """The encoder-decoder: stand-in frames warm the cross cache, the
    prompt is forced through decode, and the prefill time covers both;
    the first token is the argmax of the forced prompt's last logits,
    which equal the teacher-forced forward's."""
    args = ["--arch", "whisper-medium", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "5", "--gen", "3"]
    out = serve.run(args)
    assert out["tokens"].shape == (2, 3) and out["prefill_ms"] > 0
    frames = out["frame_embeds"]
    assert tuple(frames.shape) == (2, 12, 64)
    with torch.inference_mode():
        full, _ = out["model"].forward(out["prompts"], frames)
    np.testing.assert_allclose(out["logits"][0].numpy(),
                               full[:, -1].numpy(), rtol=2e-3, atol=2e-3)
    assert np.array_equal(torch.argmax(out["logits"][0], -1).numpy(),
                          out["tokens"][:, 0])
    assert "live=2/2" in capsys.readouterr().out
    assert np.array_equal(serve.main(args), out["tokens"])


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3-8b", "--smoke"])
