"""Twin of ``tests/test_batched_props.py``: the batched entries of the
port on the degenerate shapes the serving tier leans on — square
(m == n), single-row (m == 1), the (1, 1) corner, and all-zero padded
rows — for the ``torch`` backend and for the ``cuda`` entries (their
plain versions on the CPU), each against the reference's
``radic_det_batched`` (jnp backend) on the same numpy-seeded inputs.

The padding property is the invariant ``DetQueue``'s bit-determinism
rests on: zero-padded rows come out exactly 0, and the real rows are bit
for bit the same whatever fills the padding slots.  On the card
``chip_smoke.py`` checks the same of K1 and the warp kernels (slot 37 of
64 against the matrix alone).

Runs under hypothesis when installed, else the seeded fallback sampler
(tests/_hyp_fallback.py), with the reference file's strategies.
"""

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # optional extra — seeded-random fallback
    from _hyp_fallback import given, settings, st

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core import radic_det_batched as ref_batched  # noqa: E402
from repro_torch.core import radic_det, radic_det_batched  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SEEDS = st.integers(0, 2**31 - 1)
BACKENDS = ["torch", "cuda"]


def _batch(seed, B, m, n):
    return np.random.default_rng(seed).normal(size=(B, m, n)) \
        .astype(np.float32)


def _port(As, backend, chunk=2048):
    """The port's batched entry on the CPU: the eager evaluator, or the
    ``cuda`` entry's plain version (``ops`` directly: no plan cache, so
    the chunk is the kernel wrapper's own)."""
    X = torch.from_numpy(As)
    if backend == "torch":
        return radic_det_batched(X, chunk=chunk, backend="torch",
                                 device="cpu").numpy()
    return ops.radic_det_batched_cuda(X).numpy()


def _loop(As, backend):
    """Per-matrix values through the port's non-batched entry."""
    return np.array([float(radic_det(torch.from_numpy(A), backend=backend,
                                     device="cpu")) for A in As])


def _ref(As, chunk):
    return np.asarray(ref_batched(jnp.asarray(As), chunk=chunk))


@given(st.integers(1, 4), st.integers(1, 4), SEEDS)
def test_square_matches_linalg_det(m, B, seed):
    """m == n: one minor of sign +1, the classical determinant."""
    As = _batch(seed, B, m, m)
    want = torch.linalg.det(torch.from_numpy(As).double()).numpy()
    ref = _ref(As, 64)
    for backend in BACKENDS:
        got = _port(As, backend, chunk=64)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, _loop(As, backend), rtol=1e-5,
                                   atol=1e-6)


@given(st.integers(1, 8), st.integers(1, 4), SEEDS)
def test_single_row_alternating_sum(n, B, seed):
    """m == 1: every minor is one entry, so the determinant is
    a1 − a2 + a3 − …"""
    As = _batch(seed, B, 1, n)
    signs = (-1.0) ** np.arange(n, dtype=np.float64)
    want = (As[:, 0, :].astype(np.float64) * signs).sum(axis=1)
    ref = _ref(As, 16)
    for backend in BACKENDS:
        got = _port(As, backend, chunk=16)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, _loop(As, backend), rtol=1e-5,
                                   atol=1e-6)


@given(st.integers(1, 4), SEEDS)
def test_one_by_one_single_column(B, seed):
    """(1, 1): one minor, the entry itself (exactly, in the port; the
    reference's jnp backend within its own file's rtol of 1e-6)."""
    As = _batch(seed, B, 1, 1)
    ref = _ref(As, 2048)
    for backend in BACKENDS:
        got = _port(As, backend)
        np.testing.assert_array_equal(got, As[:, 0, 0])
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got, _loop(As, backend))


dims = st.tuples(st.integers(1, 3), st.integers(1, 6)).filter(
    lambda t: t[0] <= t[1])


def _padding_holds(As, pad, seed, backend):
    """Zero padding gives exactly 0.0; the real rows' bits do not depend
    on what fills the padding slots.  Returns the real rows' values."""
    B, m, n = As.shape
    cap = B + pad
    stack = np.zeros((cap, m, n), np.float32)
    stack[:B] = As
    out = _port(stack, backend, chunk=32)
    assert (out[B:] == 0.0).all()
    # same capacity, other company in the padding slots
    stack2 = _batch(seed + 1, cap, m, n)
    stack2[:B] = As
    out2 = _port(stack2, backend, chunk=32)
    np.testing.assert_array_equal(out[:B], out2[:B])
    return out[:B]


@given(dims, st.integers(2, 3), st.integers(1, 2), SEEDS)
@settings(deadline=None)
def test_zero_padded_rows_exact_and_inert(dims, B, pad, seed):
    """All-zero padded rows give exactly 0.0, and the real rows are bit
    for bit the same whatever fills the padding slots."""
    m, n = dims
    As = _batch(seed, B, m, n)
    ref = _ref(As, 32)
    for backend in BACKENDS:
        got = _padding_holds(As, pad, seed, backend)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, _loop(As, backend), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("m,n", [(5, 9), (8, 12), (17, 19)])
def test_zero_padding_inert_at_wider_shapes(backend, m, n):
    """The padding property past the reference file's sizes: m = 5 and 8
    on the register kernels' shapes, m = 17 on the warp kernels'."""
    As = (_batch(m * 41 + n, 3, m, n) / np.sqrt(m)).astype(np.float32)
    got = _padding_holds(As, 2, m + n, backend)
    np.testing.assert_allclose(got, _ref(As, 32), rtol=1e-3, atol=1e-4)
