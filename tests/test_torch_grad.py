"""The port's differentiable Radic determinant against the reference's
(``tests/test_grad.py``, its non-mesh legs): ``torch.autograd.grad`` of
``radic_det``/``radic_det_batched`` on both backends, ``DetPlan.grad``,
the plain version of the backward kernel (K3) and the queue's gradient
requests, on the same numpy inputs as ``jax.grad`` of the reference (its
Pallas backward in interpret mode).  The CUDA kernel itself runs only on a
card: ``chip_smoke.py`` holds it against the plain version there."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import radic_det as ref_radic_det  # noqa: E402
from repro.core import radic_det_batched as ref_radic_det_batched  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.launch import det_queue as ref_q  # noqa: E402
from repro_torch.core import (DetEngine, radic_det,  # noqa: E402
                              radic_det_batched, rank_table)
from repro_torch.core.pascal import comb  # noqa: E402
from repro_torch.core.radic import _column_sums, cofactors  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import radic_fused as rf  # noqa: E402
from repro_torch.launch.det_queue import (BucketPolicy, DetQueue,  # noqa: E402
                                          Request, plan_buckets)

CPU = "cpu"
BACKENDS = ["torch", "cuda"]


def _mat(seed, *shape, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _grad(A, backend, **kw):
    T = torch.from_numpy(np.asarray(A)).requires_grad_(True)
    (g,) = torch.autograd.grad(radic_det(T, backend=backend, device=CPU,
                                         **kw), T)
    return g.numpy()


def _ref_grad(A, backend="jnp"):
    return np.asarray(jax.grad(
        lambda M: ref_radic_det(M, backend=backend))(jnp.asarray(A)))


def _singular_inputs():
    """The four singular inputs: a zero column, duplicate columns, rank
    1 (true gradient 0), exact integers with two equal columns."""
    rng = np.random.default_rng(0)
    zero = rng.normal(size=(3, 5)).astype(np.float32)
    zero[:, 2] = 0
    dup = rng.normal(size=(3, 6)).astype(np.float32)
    dup[:, 1] = dup[:, 0]
    dup[:, 3] = 2 * dup[:, 0]
    rank1 = np.outer(rng.normal(size=3), rng.normal(size=6)).astype(
        np.float32)
    ints = rng.integers(-3, 4, size=(3, 5)).astype(np.float32)
    ints[:, 3] = ints[:, 1]
    return {"zero_column": zero, "duplicate_columns": dup, "rank1": rank1,
            "integer_duplicate": ints}


def _central_differences(A, eps=1e-6):
    fd = np.zeros_like(A)
    for i in range(A.shape[0]):
        for j in range(A.shape[1]):
            E = np.zeros_like(A)
            E[i, j] = eps
            hi = float(radic_det(torch.from_numpy(A + E), backend="torch"))
            lo = float(radic_det(torch.from_numpy(A - E), backend="torch"))
            fd[i, j] = (hi - lo) / (2 * eps)
    return fd


# ------------------------------------------------------- float64 ground truth
@pytest.mark.parametrize("m,n", [(1, 4), (2, 5), (3, 7), (3, 3)])
def test_grad_matches_finite_differences_f64(m, n):
    A = _mat(m * 10 + n, m, n, dtype=np.float64)
    g = _grad(A, "torch")
    fd = _central_differences(A)
    assert np.max(np.abs(g - fd)) <= 1e-5 * max(1.0, np.max(np.abs(fd)))
    # the kernel's plain version, computed in float32
    np.testing.assert_allclose(_grad(A, "cuda"), g, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", list(_singular_inputs()))
def test_singular_inputs_match_reference_and_differences(name):
    """Exactly singular minors: torch.linalg.det's own backward gives 0
    for them; the port's cofactors are right, like the reference's jnp
    backward (held to central differences here).  The reference's Pallas
    backward differs from both on the integer input (an exactly zero
    pivot inside its GE), so it is not the yardstick here."""
    A = _singular_inputs()[name]
    want = _ref_grad(A)
    fd = _central_differences(A.astype(np.float64))
    assert np.max(np.abs(want - fd)) <= 1e-3 * max(1.0, np.max(np.abs(fd)))
    for backend in BACKENDS:
        got = _grad(A, backend)
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_cofactors_at_every_rank():
    """The closed-form pullback of one minor: det·M⁻ᵀ when nonsingular,
    explicit cofactors when a pivot is exactly zero."""
    rng = np.random.default_rng(5)
    full = rng.normal(size=(4, 4))
    rank3 = full.copy()
    rank3[3] = rank3[0] + rank3[1]
    rank2 = full.copy()
    rank2[2] = rank2[0]
    rank2[3] = rank2[1]
    mats = np.stack([full, rank3, rank2, np.zeros((4, 4)),
                     np.array([[0., 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
                               [0, 0, 0, 0]])])
    got = cofactors(torch.from_numpy(mats)).numpy()
    for M, c in zip(mats, got):
        want = np.array([[(-1) ** (r + j) * np.linalg.det(
            np.delete(np.delete(M, r, 0), j, 1)) for j in range(4)]
            for r in range(4)])
        np.testing.assert_allclose(c, want, atol=1e-12)
    assert cofactors(torch.ones(3, 1, 1)).eq(1).all()


def test_column_sums_is_a_fixed_order_scatter_add():
    """The torch backend's scatter: the sums of index_add_, in an order
    that depends on the columns alone — a row's sums are bit-identical
    whatever rows stand beside it."""
    rng = np.random.default_rng(8)
    cols = torch.from_numpy(rng.integers(0, 9, size=300))
    vals = torch.from_numpy(rng.normal(size=(5, 3, 300)))
    got = _column_sums(vals, cols, 11)
    want = torch.zeros(5, 3, 11, dtype=torch.float64).index_add_(2, cols,
                                                                 vals)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    ints = vals.round()
    assert torch.equal(_column_sums(ints, cols, 11),
                       torch.zeros_like(want).index_add_(2, cols, ints))
    assert torch.equal(_column_sums(vals[3:4], cols, 11)[0], got[3])
    assert torch.equal(_column_sums(vals, cols, 11), got)


def test_torch_backend_grad_bit_identical_across_slots():
    """The torch backend's gradient does not depend on the batch: a
    repeat, slot 37 of 64 and the matrix alone agree to the bit."""
    m, n = 3, 8
    As = torch.from_numpy(_mat(9, 64, m, n))
    cts = torch.from_numpy(_mat(10, 64))
    eng = DetEngine()
    full = eng.plan(m, n, chunk=16, backend="torch", device=CPU).grad(As,
                                                                      cts)
    assert torch.equal(full, eng.plan(m, n, chunk=16, backend="torch",
                                      device=CPU).grad(As, cts))
    alone = eng.plan(m, n, chunk=16, backend="torch", device=CPU).grad(
        As[37:38].clone(), cts[37:38].clone())
    assert torch.equal(alone[0], full[37])


# --------------------------------------------------- float32 in-process checks
def test_grad_square_matches_linalg_det():
    A = _mat(1, 4, 4)
    T = torch.from_numpy(A).requires_grad_(True)
    (gd,) = torch.autograd.grad(torch.linalg.det(T), T)
    want = np.asarray(jax.grad(jnp.linalg.det)(jnp.asarray(A)))
    for backend in BACKENDS:
        got = _grad(A, backend)
        np.testing.assert_allclose(got, gd.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("m,n", [(2, 6), (3, 8), (3, 3), (4, 9), (1, 5)])
def test_autograd_matches_reference_jax_grad(m, n, backend):
    """Acceptance: torch.autograd.grad(radic_det(A)) against
    jax.grad(radic_det) of the reference, scalar and batched."""
    A = _mat(m * 13 + n, m, n)
    np.testing.assert_allclose(_grad(A, backend), _ref_grad(A), rtol=1e-3,
                               atol=1e-4)
    As = _mat(m * 17 + n, 4, m, n)
    T = torch.from_numpy(As).requires_grad_(True)
    (got,) = torch.autograd.grad(
        radic_det_batched(T, backend=backend, device=CPU).sum(), T)
    want = np.asarray(jax.grad(
        lambda M: jnp.sum(ref_radic_det_batched(M, backend="pallas")))(
            jnp.asarray(As)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("m,n", [(2, 6), (3, 8), (3, 3)])
def test_k3_plain_matches_reference_pallas_grad(m, n):
    """The backward kernel's plain version through the ops entries, against
    ops.radic_det_grad_pallas / ops.radic_det_batched_grad_pallas."""
    A = _mat(m * 3 + n, m, n)
    got = ops.radic_det_grad_cuda(torch.from_numpy(A), -1.5)
    want = np.asarray(ref_ops.radic_det_grad_pallas(jnp.asarray(A), -1.5))
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    As = _mat(m * 5 + n, 4, m, n)
    cts = np.array([1.0, -2.0, 0.5, 0.0], np.float32)
    got = ops.radic_det_batched_grad_cuda(torch.from_numpy(As), cts)
    want = np.asarray(ref_ops.radic_det_batched_grad_pallas(
        jnp.asarray(As), jnp.asarray(cts)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    assert not got[3].any()  # ct = 0 (queue padding) is exactly 0


@pytest.mark.parametrize("q0,cnt", [(0, 1), (10, 17), (50, 6), (0, 56),
                                    (7, 40)])
def test_k3_plain_partial_ranges(q0, cnt):
    As = _mat(11, 3, 3, 8)
    cts = np.array([1.0, -0.5, 2.0], np.float32)
    got = ops.radic_det_batched_grad_cuda(torch.from_numpy(As), cts, q0, cnt)
    want = np.asarray(ref_ops.radic_det_batched_grad_pallas(
        jnp.asarray(As), jnp.asarray(cts), q0, cnt, tile=8))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    one = ops.radic_det_grad_cuda(torch.from_numpy(As[1]), cts[1], q0, cnt)
    np.testing.assert_allclose(one.numpy(), want[1], rtol=1e-3, atol=1e-4)


def test_k3_plain_partials_compose_and_do_not_count():
    """Rank-range gradients add up to the full gradient; CPU calls run
    the plain version and never count as kernel launches; float64 plain
    is the ground truth the kernel is held to on the card."""
    rf.reset_launch_counts()
    A = torch.from_numpy(_mat(12, 3, 9))
    table = rank_table(9, 3, device=CPU)
    total = comb(9, 3)
    cuts = [0, 20, 21, 60, total]
    parts = sum(rf.radic_grad_partial_cuda(A, 2.0, table, a, b - a)
                for a, b in zip(cuts[:-1], cuts[1:]))
    full = rf.radic_grad_partial_cuda(A, 2.0, table, 0, total)
    np.testing.assert_allclose(parts.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)
    f64 = rf.radic_grad_partial_plain(A, 2.0, table, 0, total,
                                      dtype=torch.float64)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(full.numpy(), f64.numpy(), rtol=1e-4,
                               atol=1e-5)
    batched = rf.radic_batched_grad_partial_cuda(
        A[None], torch.tensor([2.0]), table, 0, total)
    assert torch.equal(batched[0], full)
    assert rf.radic_grad_partial_cuda.launches == 0
    assert rf.radic_batched_grad_partial_cuda.launches == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_grad_matches_scalar(backend):
    As = _mat(2, 5, 3, 7)
    cts = torch.tensor([1.0, -2.0, 0.5, 3.0, -0.25])
    T = torch.from_numpy(As).requires_grad_(True)
    (gb,) = torch.autograd.grad(
        radic_det_batched(T, backend=backend, device=CPU), T,
        grad_outputs=cts)
    for b in range(5):
        Tb = torch.from_numpy(As[b]).requires_grad_(True)
        (gs,) = torch.autograd.grad(
            radic_det(Tb, backend=backend, device=CPU), Tb,
            grad_outputs=cts[b])
        np.testing.assert_allclose(gb[b].numpy(), gs.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_degenerate_m_gt_n_grad_is_zero(backend):
    A = torch.from_numpy(_mat(3, 4, 2)).requires_grad_(True)
    out = radic_det(A, backend=backend, device=CPU)
    assert float(out.detach()) == 0.0
    (g,) = torch.autograd.grad(out, A)
    assert g.shape == (4, 2) and not g.any()
    As = torch.from_numpy(_mat(4, 3, 4, 2)).requires_grad_(True)
    (gb,) = torch.autograd.grad(
        radic_det_batched(As, backend=backend, device=CPU).sum(), As)
    assert gb.shape == (3, 4, 2) and not gb.any()
    want = np.asarray(jax.grad(ref_radic_det)(jnp.asarray(_mat(3, 4, 2))))
    np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_plan_grad_bit_identical_to_autograd(backend):
    """DetPlan.grad (the serving tier's dispatch) and torch.autograd.grad
    of radic_det_batched run the same backward: equal to the bit,
    including nonuniform cotangents; ct = 0 slots are exact zeros."""
    m, n, cap = 3, 7, 4
    plan = DetEngine().plan(m, n, capacity=cap, chunk=64, backend=backend,
                            device=CPU)
    As = torch.from_numpy(_mat(6, cap, m, n))
    cts = torch.tensor([1.0, -2.0, 0.5, 0.0])
    direct = plan.grad(As, cts)
    T = As.clone().requires_grad_(True)
    (traced,) = torch.autograd.grad(
        radic_det_batched(T, chunk=64, backend=backend, device=CPU), T,
        grad_outputs=cts)
    assert torch.equal(direct, traced)
    assert not direct[3].any() and torch.isfinite(direct).all()
    # the value path is untouched by the autograd wrapper
    assert torch.equal(plan(As), plan.differentiable(As).detach())


@pytest.mark.parametrize("backend", BACKENDS)
def test_grad_reuses_the_cached_plan(backend):
    """The forward and the backward share one cached plan: a gradient
    after a value call plans nothing new, and repeats are bit-identical."""
    eng = DetEngine(max_plans=4)
    A = torch.from_numpy(_mat(7, 3, 11))
    plan = eng.plan(3, 11, batched=False, chunk=64, backend=backend,
                    device=CPU)
    value = plan(A)
    T = A.clone().requires_grad_(True)
    out = eng.plan(3, 11, batched=False, chunk=64, backend=backend,
                   device=CPU).differentiable(T)
    assert torch.equal(out.detach(), value)
    (g1,) = torch.autograd.grad(out, T)
    g2 = plan.grad(A, 1.0)
    assert torch.equal(g1, g2) and torch.isfinite(g1).all()
    info = eng.cache_info()
    assert info["size"] == 1 and info["misses"] == 1 and info["hits"] == 1


def test_torch_backward_replays_chunks_without_a_graph():
    """The torch backend's forward keeps no autograd graph across its
    chunk walk: the Function saves only its input, whatever C(n, m)."""
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    A = torch.from_numpy(_mat(8, 3, 12)).requires_grad_(True)  # 220 ranks
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = radic_det(A, backend="torch", chunk=16, device=CPU)
    assert saved == [(3, 12)]
    (g,) = torch.autograd.grad(out, A)
    np.testing.assert_allclose(g.numpy(), _ref_grad(A.detach().numpy()),
                               rtol=1e-3, atol=1e-4)
    with pytest.raises(RuntimeError):  # once differentiable, as the
        # reference's kernel backend
        (g2,) = torch.autograd.grad(
            radic_det(A, backend="torch", device=CPU), A, create_graph=True)
        torch.autograd.grad(g2.sum(), A)


def test_kahan_forward_plain_backward():
    A = _mat(9, 3, 9)
    np.testing.assert_array_equal(_grad(A, "torch", kahan=True),
                                  _grad(A, "torch"))


# ------------------------------------------------------------ serving paths
def test_plan_buckets_never_merge_grad():
    """Grad requests bucket by exact (shape, grad), in the port exactly as
    in the reference."""
    pol = dict(max_batch=8, mode="merge", pin_capacity=True)
    rng = np.random.default_rng(0)
    spec = [((2, 5), False), ((2, 6), False), ((2, 5), True),
            ((2, 6), True), ((2, 5), True)]
    mats = [rng.normal(size=s).astype(np.float32) for s, _ in spec]
    reqs = [Request(seq=i, array=a, shape=a.shape, grad=g)
            for i, (a, (_, g)) in enumerate(zip(mats, spec))]
    ref_reqs = [ref_q.Request(seq=i, array=a, shape=a.shape, grad=g)
                for i, (a, (_, g)) in enumerate(zip(mats, spec))]
    plans = plan_buckets(reqs, BucketPolicy(**pol))
    want = ref_q.plan_buckets(ref_reqs, ref_q.BucketPolicy(**pol))
    assert [(p.shape, [r.seq for r in p.requests], p.grad) for p in plans] \
        == [(p.shape, [r.seq for r in p.requests], p.grad) for p in want]
    for sp in plans:
        assert len({r.grad for r in sp.requests}) == 1
        if sp.grad:
            assert {r.shape for r in sp.requests} == {sp.shape}
    assert sum(1 for sp in plans if not sp.grad) == 1
    assert sum(1 for sp in plans if sp.grad) == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_queue_grad_requests(backend):
    """Mixed value/grad burst through the port's DetQueue: gradients equal
    the reference's VJP with the cotangent pulled through, values are
    untouched by the grad batches sharing the pipeline."""
    policy = BucketPolicy(max_batch=8, mode="merge", pin_capacity=True)
    rng = np.random.default_rng(0)
    mats = [rng.normal(size=(3, 7)).astype(np.float32) for _ in range(6)]
    cts = [1.0, -2.0, 0.5, 1.0, 3.0, 0.0]
    with DetQueue(chunk=128, policy=policy, backend=backend,
                  device=CPU) as q:
        futs = q.submit_many(mats, [(i % 2 == 0, cts[i]) for i in range(6)])
        got = [f.result(timeout=300) for f in futs]
        gneg = q.submit(mats[0], grad=True, cotangent=-1.5).result(300)
        stats = q.snapshot()
    assert stats["grad_dispatches"] == 2 and stats["dispatches"] == 3
    for i, (A, val) in enumerate(zip(mats, got)):
        Aj = jnp.asarray(A[None])
        if i % 2 == 0:
            _, pull = jax.vjp(lambda M: ref_radic_det_batched(M, chunk=128),
                              Aj)
            (want,) = pull(jnp.asarray([cts[i]], np.float32))
            assert isinstance(val, np.ndarray) and val.shape == (3, 7)
            np.testing.assert_allclose(val, np.asarray(want)[0], rtol=1e-3,
                                       atol=1e-4)
        else:
            want = float(ref_radic_det_batched(Aj, chunk=128)[0])
            assert isinstance(val, float)
            assert abs(val - want) <= 1e-3 * max(1.0, abs(want))
    np.testing.assert_allclose(gneg, -1.5 * np.asarray(got[0]), rtol=1e-5,
                               atol=1e-6)


def test_queue_grad_bit_identical_alone_and_in_a_batch():
    """A grad request's result does not depend on its batch: alone, at a
    late slot of a full batch, and through DetPlan.grad."""
    mats = [_mat(20 + i, 3, 8) for i in range(8)]
    policy = BucketPolicy(max_batch=8, mode="never")
    with DetQueue(chunk=64, policy=policy, device=CPU) as q:
        full = [f.result(300) for f in q.submit_many(
            mats, [(True, 1.0)] * 8)]
        alone = q.submit(mats[6], grad=True).result(300)
    np.testing.assert_array_equal(full[6], alone)


def test_queue_grad_degenerate_and_errors():
    """m > n grad requests resolve to exact zero arrays through the
    queue's trivial path; grads keyword validation mirrors values."""
    with DetQueue(chunk=64, device=CPU) as q:
        val = q.submit(_mat(1, 4, 2), grad=True).result(timeout=120)
        np.testing.assert_array_equal(val, np.zeros((4, 2), np.float32))
        with pytest.raises(ValueError):
            q.submit_many([_mat(2, 2, 5)], grads=[(True, 1.0), (False, 1.0)])
        bad = q.submit(np.ones((16, 40), np.float32), grad=True)
        with pytest.raises(OverflowError):
            bad.result(timeout=120)
        stats = q.snapshot()
    assert stats["dispatches"] == 0 and stats["completed"] == 1


# --------------------------------------------------------- mesh plans
def _grid(*shape):
    from repro_torch.core import Mesh
    return Mesh(np.full(shape, CPU, dtype=object), ("data", "model"))


@pytest.mark.parametrize("mode", ["grains", "flat"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_scalar_mesh_grad_is_the_single_device_plans(backend, mode):
    """A scalar mesh plan pulls back through the single-device plan of its
    backend on the mesh's first device: the same bits, through
    ``plan.grad`` and through autograd of ``radic_det(mesh=...)``."""
    A = _mat(31, 3, 8)
    eng = DetEngine()
    kw = dict(batched=False, chunk=64, backend=backend)
    mesh_plan = eng.plan(3, 8, mesh=_grid(2, 4), mode=mode, **kw)
    single = eng.plan(3, 8, device=CPU, **kw)
    assert torch.equal(mesh_plan.grad(A, 1.5), single.grad(A, 1.5))
    T = torch.from_numpy(A).requires_grad_(True)
    (got,) = torch.autograd.grad(
        radic_det(T, mesh=_grid(2, 4), mode=mode, chunk=64,
                  backend=backend), T)
    assert torch.equal(got, single.grad(A, 1.0))
    np.testing.assert_allclose(got.numpy(), _ref_grad(A), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("backend,m,n", [("cuda", 16, 40), ("torch", 30, 70)])
def test_grains_grad_past_the_width_raises_at_first_grad(backend, m, n):
    """A grains plan has no width limit, but its pullback is the
    single-device plan's, whose guard raises at the first gradient."""
    plan = DetEngine().plan(m, n, batched=False, mesh=_grid(2, 4),
                            backend=backend)
    with pytest.raises(OverflowError):
        plan.grad(np.ones((m, n), np.float32), 1.0)
