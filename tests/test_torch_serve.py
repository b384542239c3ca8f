"""The port's serve driver (``repro_torch.launch.serve``) on the CPU, as
``tests/test_drivers.py`` drives the reference's: the generated tokens'
shape, the EOS dead-slot path, a vlm arch, and the card as the default
device."""

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


def test_serve_unported_family_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu"])


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3-8b", "--smoke"])
