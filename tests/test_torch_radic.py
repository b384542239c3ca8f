"""The port's eager evaluator (backend ``"torch"``) against the reference
``jnp`` backend and the float64/exact oracles, plus the Radic properties
of ``tests/test_radic.py`` on the port."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core import radic_det as ref_radic_det  # noqa: E402
from repro.core import radic_det_batched as ref_radic_det_batched  # noqa: E402
from repro_torch.core import (radic_det, radic_det_batched,  # noqa: E402
                              radic_det_exact, radic_det_oracle)

SHAPES = [(1, 1), (1, 5), (2, 6), (3, 3), (3, 7), (4, 9), (2, 12), (5, 10),
          (6, 12), (4, 2)]


def _mat(seed, m, n):
    return np.random.default_rng(seed).normal(size=(m, n)).astype(np.float32)


def _det(A, **kw):
    return float(radic_det(torch.from_numpy(np.asarray(A)), backend="torch",
                           **kw))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m,n", SHAPES)
def test_eager_matches_reference_jnp_and_oracle(m, n, seed):
    A = _mat(seed, m, n)
    got = _det(A, chunk=64)
    want_ref = float(ref_radic_det(jnp.asarray(A), chunk=64))
    np.testing.assert_allclose(got, want_ref, rtol=1e-3, atol=1e-4)
    want = radic_det_oracle(A)
    assert abs(got - want) <= 2e-3 * max(1.0, abs(want))


@pytest.mark.parametrize("cap", [1, 2, 8])
@pytest.mark.parametrize("m,n", [(2, 6), (3, 7), (1, 5), (3, 3), (4, 9)])
def test_eager_batched_matches_reference_jnp(m, n, cap):
    As = np.random.default_rng(10 * m + n + cap).normal(
        size=(cap, m, n)).astype(np.float32)
    got = radic_det_batched(torch.from_numpy(As), chunk=64, backend="torch")
    want = np.asarray(ref_radic_det_batched(jnp.asarray(As), chunk=64))
    assert got.shape == (cap,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_square_case_is_standard_det(m):
    A = _mat(100 + m, m, m)
    want = np.linalg.det(A.astype(np.float64))
    assert abs(_det(A) - want) <= 1e-3 * max(1.0, abs(want))


@pytest.mark.parametrize("m,n", [(2, 5), (3, 7), (4, 8)])
def test_equal_rows_give_zero(m, n):
    A = _mat(7, m, n)
    A[m - 1] = A[0]
    assert abs(_det(A, chunk=64)) <= 1e-3


@pytest.mark.parametrize("m,n", [(2, 5), (3, 7), (4, 8)])
def test_row_swap_negates_and_scaling_is_linear(m, n):
    A = _mat(11, m, n)
    d = _det(A, chunk=64)
    B = A.copy()
    B[[0, 1]] = B[[1, 0]]
    assert abs(d + _det(B, chunk=64)) <= 1e-3 * max(1.0, abs(d))
    C = A.copy()
    C[0] *= -2.5
    assert abs(_det(C, chunk=64) + 2.5 * d) <= 1e-2 * max(1.0, abs(2.5 * d))


def test_m_equals_1_alternating_sum_and_m_greater_than_n():
    a = np.array([[1.0, 2.0, 3.0, 4.0]], dtype=np.float32)
    assert abs(_det(a) - (1 - 2 + 3 - 4)) < 1e-5
    assert _det(np.ones((4, 3), np.float32)) == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_exact_integer_agreement(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 4))
    n = int(rng.integers(m, 7))
    A = rng.integers(-4, 5, size=(m, n))
    got = _det(A.astype(np.float32), chunk=64)
    want = float(radic_det_exact(A))
    assert abs(got - want) <= 1e-3 * max(1.0, abs(want))


def test_kahan_matches_plain_and_reference():
    A = _mat(7, 4, 10)
    plain = _det(A, chunk=32)
    kahan = _det(A, chunk=32, kahan=True)
    want = radic_det_oracle(A)
    assert abs(kahan - want) <= abs(plain - want) + 1e-4
    ref_kahan = float(ref_radic_det(jnp.asarray(A), chunk=32, kahan=True))
    np.testing.assert_allclose(kahan, ref_kahan, rtol=1e-3, atol=1e-4)


def test_float64_input_stays_float64():
    A = np.random.default_rng(3).normal(size=(3, 8))
    got = radic_det(torch.from_numpy(A), backend="torch", chunk=16)
    assert got.dtype == torch.float64
    assert abs(float(got) - radic_det_oracle(A)) <= 1e-10


def test_numpy_input_needs_a_device_choice():
    """Host data runs on the card unless the CPU is asked for."""
    A = _mat(0, 2, 5)
    got = radic_det(A, backend="torch", device="cpu")
    assert got.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            radic_det(A, backend="torch")
    with pytest.raises(ValueError):
        radic_det_batched(torch.zeros(2, 3), backend="torch")
    assert radic_det_batched(torch.zeros(0, 2, 3)).shape == (0,)
