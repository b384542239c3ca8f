"""The port's det_serve CLI against the reference CLI: the same seed
gives the same requests and the same determinants."""

import re

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.launch import det_serve as ref_serve  # noqa: E402
from repro_torch.launch import det_serve  # noqa: E402

ARGS = ["--num", "24", "--verify"]


def test_random_queue_equals_reference():
    for seed in (0, 1):
        for got, want in zip(det_serve._random_queue(40, 5, 12, seed),
                             ref_serve._random_queue(40, 5, 12, seed)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("extra,ref_extra", [
    ([], []),
    (["--sync"], ["--sync"]),
    (["--backend", "torch"], []),
    (["--policy", "merge"], ["--policy", "merge"]),
])
def test_main_matches_reference_dets(extra, ref_extra, capsys):
    dets, stats = det_serve.main([*ARGS, "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert re.search(r"^total,24 mats,[0-9.]+s,[0-9.]+ mats/s$", out,
                     re.MULTILINE)
    assert re.search(r"verify: worst rel err [0-9.e+-]+", out)
    want, _ = ref_serve.main([*ARGS, *ref_extra])
    capsys.readouterr()
    assert len(dets) == len(want) == 24
    np.testing.assert_allclose(dets, want, rtol=1e-3, atol=1e-4)


def test_async_stats_and_shedding(capsys):
    dets, stats = det_serve.main(["--num", "24", "--device", "cpu",
                                  "--max-pending", "5"])
    capsys.readouterr()
    assert stats["shed"] == 19 and sum(d is None for d in dets) == 19
    assert stats["completed"] == 5


def test_cli_rejects_reference_only_flags():
    with pytest.raises(SystemExit):
        det_serve.main(["--device", "cpu", "--workers", "2"])
    with pytest.raises(SystemExit):
        det_serve.main(["--device", "cpu", "--backend", "pallas"])


def test_grad_mix_equals_reference_and_verifies(capsys):
    """--grad-frac submits the reference's value/grad mix for the seed; the
    verify leg checks every gradient against float64 autograd."""
    argv = ["--num", "24", "--grad-frac", "0.25", "--verify"]
    dets, stats = det_serve.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"verify: worst rel err [0-9.e+-]+, worst grad rel "
                     r"err [0-9.e+-]+", out)
    want, ref_stats = ref_serve.main(argv)
    capsys.readouterr()
    mix = det_serve._grad_mix(24, 0.25, 0)
    grng = np.random.default_rng(1)
    assert mix == [(bool(grng.random() < 0.25), 1.0) for _ in range(24)]
    assert sum(g for g, _ in mix) == stats["grad_dispatches"] > 0
    for (g, _), got, ref_got in zip(mix, dets, want):
        if g:
            assert isinstance(got, np.ndarray) and got.shape == ref_got.shape
            np.testing.assert_allclose(got, ref_got, rtol=1e-3, atol=1e-4)
        else:
            np.testing.assert_allclose(got, ref_got, rtol=1e-3, atol=1e-4)


def test_grad_frac_is_async_only():
    with pytest.raises(SystemExit):
        det_serve.main(["--device", "cpu", "--grad-frac", "0.5", "--sync"])
    with pytest.raises(SystemExit):
        det_serve.main(["--device", "cpu", "--grad-frac", "1.5"])
