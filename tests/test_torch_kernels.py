"""The kernels' plain versions (what the CUDA wrappers run for a CPU
tensor) against the reference Pallas kernels in interpret mode and the
numpy oracles, and the ``ops`` guard order.  The CUDA kernels themselves
run only on a card: ``chip_smoke.py`` holds them against these same plain
versions there."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.core.pascal import binom_table, comb  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import radic_fused as rf  # noqa: E402

SHAPES = [(2, 6), (3, 7), (1, 5), (3, 3), (4, 9)]


def _stack(seed, B, m, n):
    return np.random.default_rng(seed).normal(
        size=(B, m, n)).astype(np.float32)


@pytest.mark.parametrize("cap", [1, 2, 8])
@pytest.mark.parametrize("m,n", SHAPES)
def test_k1_plain_matches_reference_pallas(m, n, cap):
    As = _stack(m * 31 + n + cap, cap, m, n)
    got = ops.radic_det_batched_cuda(torch.from_numpy(As))
    want = np.asarray(ref_ops.radic_det_batched_pallas(jnp.asarray(As)))
    assert got.shape == (cap,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("m,n", [(2, 6), (3, 7), (4, 8), (5, 8), (1, 5),
                                 (3, 3), (2, 12)])
def test_k2_plain_matches_reference_pallas_and_oracle(m, n):
    A = _stack(m * 7 + n, 1, m, n)[0]
    got = float(ops.radic_det_cuda(torch.from_numpy(A)))
    want = float(ref_ops.radic_det_pallas(jnp.asarray(A), tile=32))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    oracle = ref.radic_det_oracle(A)
    assert abs(got - oracle) <= 2e-3 * max(1.0, abs(oracle))


@pytest.mark.parametrize("q0,cnt", [(0, 1), (10, 17), (50, 6), (0, 56),
                                    (7, 40)])
def test_partial_ranges(q0, cnt):
    As = _stack(5, 3, 3, 8)
    got = ops.radic_det_batched_cuda(torch.from_numpy(As), q0, cnt)
    want = np.asarray(ref_ops.radic_det_batched_pallas(
        jnp.asarray(As), q0, cnt, tile=8))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    for b in range(3):
        exact = ref.radic_partial_ref(As[b], q0, cnt)
        assert abs(float(got[b]) - exact) <= 1e-3 * max(1.0, abs(exact))
    one = float(ops.radic_det_cuda(torch.from_numpy(As[0]), q_start=q0,
                                   count=cnt))
    assert abs(one - ref_ref.radic_partial_ref(As[0], q0, cnt)) <= \
        1e-3 * max(1.0, abs(ref_ref.radic_partial_ref(As[0], q0, cnt)))


def test_partials_compose():
    A = _stack(9, 1, 3, 9)[0]
    total = comb(9, 3)
    cuts = [0, 20, 21, 60, total]
    parts = [float(ops.radic_det_cuda(torch.from_numpy(A), q_start=a,
                                      count=b - a))
             for a, b in zip(cuts[:-1], cuts[1:])]
    want = ref.radic_det_oracle(A)
    assert abs(sum(parts) - want) <= 2e-3 * max(1.0, abs(want))


def test_bf16_input_promoted():
    A = _stack(2, 1, 3, 7)[0]
    got = ops.radic_det_cuda(torch.from_numpy(A).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = ref.radic_det_oracle(A)
    assert abs(float(got) - want) <= 0.05 * max(1.0, abs(want))
    ref_got = float(ref_ops.radic_det_pallas(
        jnp.asarray(A, jnp.bfloat16), tile=32))
    assert abs(float(got) - ref_got) <= 0.05 * max(1.0, abs(ref_got))


def test_singular_minors_match_reference():
    """Duplicate and zero columns make most minors singular: det 0, not
    NaN, in both packages."""
    As = _stack(4, 3, 3, 6)
    As[:, :, 1] = As[:, :, 0]
    As[:, :, 3] = 2 * As[:, :, 0]
    As[:, :, 5] = 0
    got = ops.radic_det_batched_cuda(torch.from_numpy(As))
    assert torch.isfinite(got).all()
    want = np.asarray(ref_ops.radic_det_batched_pallas(jnp.asarray(As)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def test_plain_versions_agree_and_do_not_count():
    """K1 at B=1 and K2 are the same function; CPU calls run the plain
    versions and never count as kernel launches."""
    rf.reset_launch_counts()
    A = torch.from_numpy(_stack(6, 1, 4, 9)[0])
    table = torch.as_tensor(binom_table(9, 4, dtype=np.int32))
    k2 = rf.radic_partial_cuda(A, table, 0, comb(9, 4))
    k1 = rf.radic_batched_partial_cuda(A[None], table, 0, comb(9, 4))
    assert torch.equal(k2, k1[0])
    f64 = rf.radic_partial_plain(A, table, 0, comb(9, 4),
                                 dtype=torch.float64)
    assert abs(float(f64) - ref.radic_det_oracle(A.numpy())) <= 1e-9
    assert rf.radic_batched_partial_cuda.launches == 0
    assert rf.radic_partial_cuda.launches == 0


# ------------------------------------------------------------ guard order
def test_ops_guard_order():
    """The reference's order: m > n zeros, then the rank-width guard, then
    the rank range; the bound on m is the port's own."""
    # m > n returns zeros first, whatever else is wrong with the shape
    z = ops.radic_det_batched_cuda(torch.ones(3, 17, 4))
    assert z.shape == (3,) and not z.any()
    assert float(ops.radic_det_cuda(torch.ones(50, 44))) == 0.0
    assert float(ref_ops.radic_det_pallas(jnp.ones((50, 44)))) == 0.0
    # int32 rank width, at plan time, in both packages
    for shape in [(16, 40), (10, 44)]:
        with pytest.raises(OverflowError):
            ops.radic_det_cuda(torch.ones(shape))
        with pytest.raises(OverflowError):
            ref_ops.radic_det_pallas(jnp.ones(shape, jnp.float32))
    with pytest.raises(OverflowError):
        ops.radic_det_batched_cuda(torch.ones(2, 10, 44))
    # the kernel's bound on m, named in the error
    with pytest.raises(ValueError, match="16"):
        ops.radic_det_batched_cuda(torch.ones(1, 17, 20))
    # a rank range past C(n, m), in both packages
    with pytest.raises(ValueError, match="rank range"):
        ops.radic_det_cuda(torch.ones(3, 8), q_start=50, count=7)
    with pytest.raises(ValueError, match="rank range"):
        ref_ops.radic_det_pallas(jnp.ones((3, 8), jnp.float32), q_start=50,
                                 count=7)
    with pytest.raises(TypeError):
        ops.radic_det_cuda(np.ones((3, 8), np.float32))


def test_wrappers_raise_off_cpu_and_cuda():
    table = torch.zeros(6, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rf.radic_batched_partial_cuda(torch.zeros(1, 2, 5, device="meta"),
                                      table, 0, 10)


def test_oracles_equal_reference_oracles():
    qs = np.arange(comb(9, 4))
    np.testing.assert_array_equal(ref.unrank_ref(qs, 9, 4),
                                  ref_ref.unrank_ref(qs, 9, 4))
    mats = np.random.default_rng(1).normal(size=(5, 3, 3))
    np.testing.assert_array_equal(ref.minor_det_ref(mats),
                                  ref_ref.minor_det_ref(mats))
    A = _stack(8, 1, 3, 7)[0]
    assert ref.radic_partial_ref(A, 3, 20) == \
        ref_ref.radic_partial_ref(A, 3, 20)


# ------------------------------------------------------------------ build
def test_build_raises_with_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build._compile(tmp_path / "lib.so")
    assert not list(tmp_path.iterdir())


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


# ------------------------------------------------- K4, K5, K6 plain versions
@pytest.mark.parametrize("cap", [1, 2, 8])
@pytest.mark.parametrize("m,n", SHAPES)
def test_k4_plain_matches_reference_bygrid(m, n, cap):
    As = _stack(m * 37 + n + cap, cap, m, n)
    got = ops.radic_det_batched_cuda_bygrid(torch.from_numpy(As))
    want = np.asarray(ref_ops.radic_det_batched_pallas_bygrid(
        jnp.asarray(As)))
    assert got.shape == (cap,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    # the twin of K1, as the reference's by-grid kernel is of its combo
    # kernel (tests/test_kernel_parity.py:53); on the card chip_smoke.py
    # holds the two kernels to the same equality
    assert torch.equal(got, ops.radic_det_batched_cuda(torch.from_numpy(As)))


def test_k4_plain_partial_ranges():
    As = _stack(13, 4, 3, 9)
    for q0, cnt in [(0, 84), (10, 40), (60, 24)]:
        got = ops.radic_det_batched_cuda_bygrid(torch.from_numpy(As), q0,
                                                cnt)
        want = np.asarray(ref_ops.radic_det_batched_pallas_bygrid(
            jnp.asarray(As), q0, cnt, tile=32))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n,m", [(8, 5), (6, 3), (10, 2), (12, 6), (5, 5),
                                 (9, 1), (16, 3)])
@pytest.mark.parametrize("tile", [8, 64])
def test_k5_plain_matches_reference_unrank(n, m, tile):
    qs = np.arange(comb(n, m), dtype=np.int32)
    got = ops.unrank(torch.from_numpy(qs), n, m, tile=tile)
    assert got.dtype == torch.int32 and got.shape == (len(qs), m)
    np.testing.assert_array_equal(got.numpy(), ref.unrank_ref(qs, n, m))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_ops.unrank(jnp.asarray(qs), n, m,
                                               tile=tile)))


@pytest.mark.parametrize("B,m", [(1, 1), (3, 2), (7, 3), (130, 4), (64, 5),
                                 (5, 8), (256, 2)])
def test_k6_plain_matches_reference_minor_det(B, m):
    mats = np.random.default_rng(B * 10 + m).normal(
        size=(B, m, m)).astype(np.float32)
    got = ops.minor_det(torch.from_numpy(mats), tile=32)
    assert got.dtype == torch.float32 and got.shape == (B,)
    want = np.asarray(ref_ops.minor_det(jnp.asarray(mats), tile=32))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref.minor_det_ref(mats),
                               rtol=5e-4, atol=1e-4)


def test_k6_plain_singular_and_permuted():
    a = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)
    sing = a.copy()
    sing[2] = sing[0]  # rank-deficient
    perm = a[[1, 0, 2, 3]]  # one swap -> -det
    mats = np.stack([a, sing, perm, np.eye(4, dtype=np.float32)])
    got = ops.minor_det(torch.from_numpy(mats), tile=8)
    np.testing.assert_allclose(
        got.numpy(), [np.linalg.det(a), 0.0, -np.linalg.det(a), 1.0],
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref_ops.minor_det(jnp.asarray(mats), tile=8)),
        rtol=5e-4, atol=1e-4)
    f64 = ops.minor_det(torch.from_numpy(mats.astype(np.float64)))
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(f64.numpy(), np.linalg.det(mats.astype(
        np.float64)), rtol=1e-12, atol=1e-12)


def test_new_entries_guard_order():
    """The reference's guard order on the gradient, by-grid and unrank
    entries; minor_det's only guard is its kernel's bound on m."""
    # m > n returns zeros first
    g = ops.radic_det_batched_grad_cuda(torch.ones(2, 17, 4), [1.0, 1.0])
    assert g.shape == (2, 17, 4) and not g.any()
    assert not ops.radic_det_grad_cuda(torch.ones(50, 44), 1.0).any()
    assert not ops.radic_det_batched_cuda_bygrid(torch.ones(3, 5, 4)).any()
    # int32 rank width, at plan time, like the reference's pallas guard
    for fn in (lambda: ops.radic_det_grad_cuda(torch.ones(10, 44), 1.0),
               lambda: ops.radic_det_batched_grad_cuda(
                   torch.ones(1, 16, 40), [1.0]),
               lambda: ops.radic_det_batched_cuda_bygrid(
                   torch.ones(2, 10, 44)),
               lambda: ops.unrank(torch.zeros(3, dtype=torch.int32), 44, 10)):
        with pytest.raises(OverflowError):
            fn()
    with pytest.raises(OverflowError):
        ref_ops.unrank(jnp.zeros(3, jnp.int32), 44, 10)
    with pytest.raises(OverflowError):
        ref_ops.radic_det_batched_grad_pallas(jnp.ones((1, 16, 40)),
                                              jnp.ones(1))
    # the kernels' bound on m, named in the error; unrank has none
    with pytest.raises(ValueError, match="16"):
        ops.radic_det_batched_grad_cuda(torch.ones(1, 17, 20), [1.0])
    with pytest.raises(ValueError, match="16"):
        ops.minor_det(torch.ones(2, 17, 17))
    got = ops.unrank(torch.arange(5, dtype=torch.int32), 20, 17)
    np.testing.assert_array_equal(got.numpy(), ref.unrank_ref(
        np.arange(5), 20, 17))
    # a rank range past C(n, m), in both packages
    with pytest.raises(ValueError, match="rank range"):
        ops.radic_det_grad_cuda(torch.ones(3, 8), 1.0, q_start=50, count=7)
    with pytest.raises(ValueError, match="rank range"):
        ref_ops.radic_det_grad_pallas(jnp.ones((3, 8), jnp.float32), 1.0,
                                      q_start=50, count=7)
    with pytest.raises(ValueError, match="rank range"):
        ops.radic_det_batched_cuda_bygrid(torch.ones(1, 3, 8), 50, 7)
    # cotangents: reshaped to (B,) in the input dtype
    g = ops.radic_det_batched_grad_cuda(torch.ones(2, 2, 3,
                                                   dtype=torch.float64),
                                        np.array([[1.0], [2.0]]))
    assert g.dtype == torch.float64
    with pytest.raises(RuntimeError):
        ops.radic_det_batched_grad_cuda(torch.ones(2, 2, 3), [1.0, 2.0, 3.0])
    for fn in (lambda: ops.radic_det_grad_cuda(np.ones((3, 8)), 1.0),
               lambda: ops.unrank(np.arange(3), 5, 2),
               lambda: ops.minor_det(np.ones((2, 3, 3)))):
        with pytest.raises(TypeError):
            fn()


def test_new_wrappers_raise_off_cpu_and_cuda():
    """Every new wrapper runs its plain version for a CPU tensor only and
    refuses any other non-CUDA device; none counts a launch on the CPU."""
    from repro_torch.kernels import (minor_det_cuda, reset_launch_counts,
                                     unrank_cuda)
    reset_launch_counts()
    meta = torch.device("meta")
    table = torch.as_tensor(binom_table(5, 2, dtype=np.int32))
    calls = [
        lambda d: rf.radic_batched_grad_partial_cuda(
            torch.zeros(1, 2, 5, device=d), torch.ones(1, device=d), table,
            0, 10),
        lambda d: rf.radic_grad_partial_cuda(torch.zeros(2, 5, device=d),
                                             1.0, table, 0, 10),
        lambda d: rf.radic_batched_partial_bygrid_cuda(
            torch.zeros(1, 2, 5, device=d), table, 0, 10),
        lambda d: unrank_cuda(torch.zeros(4, dtype=torch.int32, device=d),
                              5, 2, table),
        lambda d: minor_det_cuda(torch.zeros(3, 2, 2, device=d)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call(meta)
        call("cpu")
    for w in (rf.radic_batched_grad_partial_cuda, rf.radic_grad_partial_cuda,
              rf.radic_batched_partial_bygrid_cuda, unrank_cuda,
              minor_det_cuda):
        assert w.launches == 0


def test_grad_tiling_is_a_function_of_the_shape():
    """The gradient kernel's block count depends on (count, m, n) and the
    kernel's tile for m only, so a gradient's bits never depend on B; its
    partials stay within 512 KB per matrix."""
    for count, m, n, tile in [(1, 1, 5, 256), (10 ** 7, 8, 31, 128),
                              (4845, 16, 20, 32), (10 ** 6, 16, 40, 32),
                              (10 ** 6, 1, 10 ** 6, 256)]:
        g = rf.grad_grid_blocks(count, m, n, tile)
        assert 1 <= g <= min(-(-count // tile), rf.GRAD_MAX_BLOCKS)
        assert g == 1 or g * m * n <= rf.GRAD_PARTIAL_FLOATS
    assert rf.grad_grid_blocks(10 ** 7, 8, 31, 128) == \
        rf.GRAD_PARTIAL_FLOATS // (8 * 31)
