"""The ``cuda`` entries at m = 0 and the kernel wrappers' guards, on the
CPU.

Every ``cuda`` entry answers m = 0 as ``radic_det_oracle`` and the
reference's jnp backend answer it (the one rank of C(n, 0) is the empty
column set, whose signed minor is 1; the gradient has no entry), before
any table, launch or build; the reference's pallas backend raises
``ZeroDivisionError`` there, which is not copied.  Every kernel wrapper
runs what the card checks (m's range, the table's shape, the int32 rank
range, the batch limit, a square stack) before its CPU branch, so a CPU
tensor is refused what a CUDA tensor would be.  On the card
``chip_smoke.py`` phase 10 checks the same m = 0 answers with no launch
counted."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core import radic_det as ref_radic_det  # noqa: E402
from repro.core import radic_det_batched as ref_radic_det_batched  # noqa: E402
from repro.core.oracle import radic_det_oracle as ref_oracle  # noqa: E402
from repro_torch.core import radic_det, radic_det_batched  # noqa: E402
from repro_torch.core.engine import DetEngine  # noqa: E402
from repro_torch.core.pascal import binom_table  # noqa: E402
from repro_torch.kernels import (launch_counts, minor_det_cuda,  # noqa: E402
                                 ops, reset_launch_counts, unrank_cuda)
from repro_torch.kernels import radic_fused as rf  # noqa: E402


def _launches() -> int:
    return sum(launch_counts().values())


def _ref_scalar(n: int) -> float:
    """m = 0 in the reference: its jnp backend and its oracle agree."""
    jnp_value = float(ref_radic_det(jnp.zeros((0, n), jnp.float32),
                                    backend="jnp"))
    assert jnp_value == ref_oracle(np.zeros((0, n))) == 1.0
    return jnp_value


@pytest.mark.parametrize("n", [0, 1, 5])
def test_m0_scalar_entries_answer_as_the_oracle(n):
    want = _ref_scalar(n)
    reset_launch_counts()
    A = torch.zeros(0, n)
    got = ops.radic_det_cuda(A)
    assert got.shape == () and got.dtype == A.dtype and float(got) == want
    g = ops.radic_det_grad_cuda(A, 1.0)
    assert g.shape == (0, n)
    # a rank range of C(n, 0) = 1: empty sums to 0, past it raises
    assert float(ops.radic_det_cuda(A, q_start=1, count=0)) == 0.0
    with pytest.raises(ValueError, match="rank range"):
        ops.radic_det_cuda(A, q_start=1, count=1)
    # the autograd path: radic_det -> DetPlan -> the cuda entries
    A.requires_grad_(True)
    d = radic_det(A, backend="cuda", device="cpu")
    (gA,) = torch.autograd.grad(d, A)
    assert float(d.detach()) == want and gA.shape == (0, n)
    assert _launches() == 0


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("B", [1, 3])
def test_m0_batched_entries_answer_as_the_reference(B, n):
    want = np.asarray(ref_radic_det_batched(jnp.zeros((B, 0, n),
                                                      jnp.float32),
                                            backend="jnp"))
    np.testing.assert_array_equal(want, np.full(B, ref_oracle(
        np.zeros((0, n)))))
    reset_launch_counts()
    As = torch.zeros(B, 0, n, dtype=torch.float64)
    for got in (ops.radic_det_batched_cuda(As),
                ops.radic_det_batched_cuda_bygrid(As)):
        assert got.shape == (B,) and got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want)
    g = ops.radic_det_batched_grad_cuda(As, torch.ones(B))
    assert g.shape == (B, 0, n)
    As.requires_grad_(True)
    d = radic_det_batched(As, backend="cuda", device="cpu")
    (gA,) = torch.autograd.grad(d.sum(), As)
    np.testing.assert_array_equal(d.detach().numpy(), want)
    assert gA.shape == (B, 0, n)
    assert _launches() == 0


@pytest.mark.parametrize("n", [0, 4])
def test_m0_plans_answer_as_the_oracle(n):
    """``DetEngine.plan(0, n, backend="cuda")``, scalar and batched: one
    plan each, its forward the oracle's 1.0, its pullback (0, n)."""
    want = ref_oracle(np.zeros((0, n)))
    engine = DetEngine()
    scalar = engine.plan(0, n, batched=False, backend="cuda", device="cpu")
    assert scalar.total == 1 and not scalar.degenerate
    assert float(scalar(np.zeros((0, n), np.float32))) == want
    assert scalar.grad(np.zeros((0, n), np.float32), 1.0).shape == (0, n)
    batched = engine.plan(0, n, backend="cuda", device="cpu")
    np.testing.assert_array_equal(
        batched(np.zeros((2, 0, n), np.float32)).numpy(), [want, want])
    assert batched.grad(np.zeros((2, 0, n), np.float32),
                        np.ones(2)).shape == (2, 0, n)


# ------------------------------------------------- the wrappers' guards
def _table(n, m):
    """The int32 Pascal table, or, past int32 (at (34, 34)), a table of
    its shape: the guards check its shape only."""
    if m > 33:
        return torch.zeros(n + 1, m + 1, dtype=torch.int32)
    return torch.as_tensor(binom_table(n, m, dtype=np.int32))


def _radic_calls(As, table, q0, count):
    """K1, K2, K4, K3 and K3 at B = 1 on the same arguments."""
    cts = torch.ones(As.shape[0])
    return [
        lambda: rf.radic_batched_partial_cuda(As, table, q0, count),
        lambda: rf.radic_partial_cuda(As[0], table, q0, count),
        lambda: rf.radic_batched_partial_bygrid_cuda(As, table, q0, count),
        lambda: rf.radic_batched_grad_partial_cuda(As, cts, table, q0,
                                                   count),
        lambda: rf.radic_grad_partial_cuda(As[0], 1.0, table, q0, count),
    ]


@pytest.mark.parametrize("case,match", [
    ("m34", "built for 1 <= m <= 33"),
    ("m0", "built for 1 <= m <= 33"),
    ("table", "table shape"),
    ("m_gt_n", "expected m <= n"),
    ("ranks", "int32 ranks"),
])
def test_k1_to_k4_wrappers_raise_the_cards_errors_on_the_cpu(case, match):
    """K1–K4 given a CPU tensor raise what their CUDA branch raises
    (``_check``), before the plain version runs."""
    m, n = {"m34": (34, 34), "m0": (0, 3), "m_gt_n": (4, 3)}.get(case,
                                                                 (2, 5))
    As = torch.ones(2, m, n)
    table = _table(n, m) if case != "table" else _table(n + 1, m)
    q0, count = (2 ** 31 - 4, 8) if case == "ranks" else (0, 1)
    reset_launch_counts()
    for call in _radic_calls(As, table, q0, count):
        with pytest.raises(ValueError, match=match):
            call()
    assert _launches() == 0


def test_bygrid_batch_limit_on_the_cpu():
    """K4's grid holds one matrix a block: 65,535 at most, as on the
    card; K1 takes the same stack."""
    As = torch.zeros(65536, 1, 1)
    table = _table(1, 1)
    with pytest.raises(ValueError, match="batch 65536 exceeds 65535"):
        rf.radic_batched_partial_bygrid_cuda(As, table, 0, 1)
    assert not rf.radic_batched_partial_cuda(As, table, 0, 1).any()


def test_k5_wrapper_checks_the_table_on_the_cpu():
    qs = torch.arange(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="table shape"):
        unrank_cuda(qs, 6, 2, _table(6, 3))
    assert unrank_cuda(qs, 6, 2, _table(6, 2)).shape == (5, 2)


@pytest.mark.parametrize("shape", [(3, 4, 5), (2, 34, 33), (1, 0, 2)])
def test_k6_wrapper_checks_a_square_stack_on_the_cpu(shape):
    with pytest.raises(ValueError, match=r"expected \(B, m, m\)"):
        minor_det_cuda(torch.ones(shape))
    with pytest.raises(ValueError, match=r"expected \(B, m, m\)"):
        ops.minor_det(torch.ones(shape))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_m0_n0_stack_answers_the_oracle(backend):
    """(B, 0, 0): one empty minor per matrix, 1.0 each on both backends,
    as the oracle and the reference's scalar entry answer (0, 0); the
    reference's batched jnp entry answers B for each matrix there, a
    reference fault that is not copied."""
    want = ref_oracle(np.zeros((0, 0)))
    assert float(ref_radic_det(jnp.zeros((0, 0), jnp.float32))) == want
    for B in (1, 3):
        got = radic_det_batched(torch.zeros(B, 0, 0), backend=backend,
                                device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.full(B, want))
