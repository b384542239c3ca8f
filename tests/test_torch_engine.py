"""The port's DetEngine against the reference engine: plan-key hashing,
rank-space validation, LRU semantics, degenerate plans and routing."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import engine as ref_engine  # noqa: E402
from repro_torch.core import (DetEngine, default_engine, radic_det,  # noqa: E402
                              radic_det_batched, set_default_engine,
                              stable_key_hash, validate_rank_space)
from repro_torch.core.engine import BACKENDS, PlanKey  # noqa: E402
from repro_torch.core.pascal import comb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CPU = "cpu"
SHAPES = [(1, 5), (2, 6), (3, 8), (3, 3)]
RANK_SPACES = [(1, 5), (3, 8), (5, 24), (10, 34), (10, 43), (10, 44),
               (16, 40), (12, 40), (8, 60), (4, 2), (16, 16), (15, 60)]


# -------------------------------------------------------------- key hashing
@pytest.mark.parametrize("key", [
    (3, 8, 64, "float32", False),
    (np.int64(3), np.int32(8), 64, np.str_("float32"), np.bool_(False)),
    (2, 6, None, "float64", True),
    (1, 5, 8, "bfloat16", False, ("workers",), 0.5, np.float32(0.25)),
    tuple(PlanKey(3, 8, True, 16, "float32", "cuda", 2048, False, "cpu")),
])
def test_stable_key_hash_equals_reference(key):
    assert stable_key_hash(key) == ref_engine.stable_key_hash(key)


def test_stable_key_hash_is_canonical():
    assert stable_key_hash((np.int64(3), 8)) == stable_key_hash((3, 8))
    assert stable_key_hash((3, 8)) != stable_key_hash((8, 3))
    key = PlanKey(3, 8, True, 16, "float32", "cuda", 2048, False, "cpu")
    assert stable_key_hash(key) == stable_key_hash(tuple(key))


# ---------------------------------------------------------- rank validation
def _outcome(fn, *a, **kw):
    try:
        return fn(*a, **kw)
    except (OverflowError, ValueError) as e:
        return type(e)


@pytest.mark.parametrize("m,n", RANK_SPACES)
def test_cuda_validation_mirrors_reference_pallas(m, n):
    got = _outcome(validate_rank_space, m, n, backend="cuda")
    want = _outcome(ref_engine.validate_rank_space, m, n, backend="pallas")
    assert got == want   # no bound on m in either package


@pytest.mark.parametrize("m,n", RANK_SPACES)
def test_torch_validation_mirrors_reference_jnp_x64(m, n):
    """int64 ranks: the reference's jnp backend under x64."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want = _outcome(ref_engine.validate_rank_space, m, n)
    finally:
        jax.config.update("jax_enable_x64", before)
    assert _outcome(validate_rank_space, m, n, backend="torch") == want


def test_plan_time_guards():
    """The cuda backend answers what the reference's pallas backend
    answers and refuses what it refuses, with the same error type: m > 16
    plans (the warp kernels); int32 ranks and the int32 table's peak do
    not.  The port builds the table at plan time, so (33, 34) fails there;
    the reference's pallas plan builds it at its first call."""
    eng = DetEngine()
    ref = ref_engine.DetEngine()
    with pytest.raises(OverflowError):
        eng.plan(16, 40, backend="cuda", device=CPU)
    with pytest.raises(OverflowError):
        ref.plan(16, 40, backend="pallas")
    with pytest.raises(OverflowError):
        eng.plan(33, 34, backend="cuda", device=CPU)
    with pytest.raises(OverflowError):
        ref.plan(33, 34, backend="pallas")(jnp.ones((1, 33, 34)))
    for m, n in [(17, 20), (33, 33)]:
        got = eng.plan(m, n, backend="cuda", device=CPU)
        want = ref.plan(m, n, backend="pallas")
        assert got.total == want.total == comb(n, m)
    assert eng.plan(17, 20, backend="torch", device=CPU).total == \
        comb(20, 17)
    assert eng.cache_info()["size"] == 3


# ------------------------------------------------------------- routing
@pytest.mark.parametrize("cap", [1, 2, 8])
@pytest.mark.parametrize("m,n", SHAPES)
def test_backends_agree_and_replan_is_bit_identical(m, n, cap):
    As = torch.from_numpy(np.random.default_rng(m + n + cap).normal(
        size=(cap, m, n)).astype(np.float32))
    eng = DetEngine()
    k = eng.plan(m, n, capacity=cap, device=CPU)
    t = eng.plan(m, n, capacity=cap, backend="torch", chunk=64, device=CPU)
    got_k, got_t = k(As), t(As)
    assert got_k.shape == got_t.shape == (cap,)
    np.testing.assert_allclose(got_k.numpy(), got_t.numpy(), rtol=1e-3,
                               atol=1e-4)
    # the cuda route is the ops entry point, bit for bit
    want = ops.radic_det_batched_cuda(As, q_start=0, count=comb(n, m))
    assert torch.equal(got_k, want)
    eng.clear()
    assert torch.equal(eng.plan(m, n, capacity=cap, device=CPU)(As), got_k)


def test_plan_accepts_numpy_and_scalar_route():
    A = np.random.default_rng(5).normal(size=(2, 7)).astype(np.float32)
    plan = DetEngine().plan(2, 7, batched=False, device=CPU)
    want = ops.radic_det_cuda(torch.from_numpy(A), q_start=0,
                              count=comb(7, 2))
    assert torch.equal(plan(A), want)
    assert float(radic_det(torch.from_numpy(A))) == float(want)


# ---------------------------------------------------------- degenerate m > n
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_degenerate_plans_are_zeros_on_device(backend):
    eng = DetEngine()
    ev = eng.plan(4, 2, backend=backend, device=CPU)
    assert ev.degenerate
    out = ev(torch.ones(3, 4, 2))
    assert out.shape == (3,) and not out.any()
    out = eng.plan(4, 2, batched=False, backend=backend, device=CPU)(
        torch.ones(4, 2, dtype=torch.float64))
    assert out.shape == () and out.dtype == torch.float64 and float(out) == 0
    # m > n never reaches a width guard, even for huge (m, n)
    assert eng.plan(60, 44, backend=backend, device=CPU).degenerate


# ------------------------------------------------------------- cache
def test_plan_cache_hit_returns_same_plan():
    eng = DetEngine()
    p1 = eng.plan(2, 6, capacity=4, device=CPU)
    assert eng.plan(2, 6, capacity=4, device=CPU) is p1
    assert eng.cache_info()["hits"] == 1
    assert eng.plan(2, 6, capacity=8, device=CPU) is not p1
    assert eng.plan(2, 6, capacity=4, chunk=64, device=CPU) is not p1
    assert eng.plan(2, 6, capacity=4, backend="torch", device=CPU) \
        is not p1
    assert eng.plan(2, 6, device=CPU) is not p1


def test_lru_eviction_and_replan_bit_identity():
    eng = DetEngine(max_plans=2)
    rng = np.random.default_rng(0)
    inputs, before = {}, {}
    for m, n in [(1, 5), (2, 6), (3, 8)]:
        As = torch.from_numpy(rng.normal(size=(4, m, n)).astype(np.float32))
        inputs[(m, n)] = As
        before[(m, n)] = eng.plan(m, n, capacity=4, device=CPU)(As)
    info = eng.cache_info()
    assert info["size"] == 2 and info["evictions"] == 1
    assert (1, 5) not in [(k.m, k.n) for k in eng.cached_keys()]
    for m, n in [(1, 5), (2, 6), (3, 8)]:
        again = eng.plan(m, n, capacity=4, device=CPU)(inputs[(m, n)])
        assert torch.equal(again, before[(m, n)])
    assert eng.cache_info()["size"] == 2


def test_lru_order_refreshes_on_hit():
    eng = DetEngine(max_plans=2)
    eng.plan(1, 5, device=CPU)
    eng.plan(2, 6, device=CPU)
    eng.plan(1, 5, device=CPU)
    eng.plan(3, 8, device=CPU)
    keys = [(k.m, k.n) for k in eng.cached_keys()]
    assert (2, 6) not in keys and (1, 5) in keys and (3, 8) in keys


def test_engine_validation_errors():
    eng = DetEngine()
    for bad in ("jnp", "pallas", "triton"):
        with pytest.raises(ValueError, match="unknown backend"):
            eng.plan(2, 6, backend=bad, device=CPU)
    with pytest.raises(ValueError):
        eng.plan(2, 6, batched=True, kahan=True, device=CPU)
    with pytest.raises(ValueError):
        eng.plan(2, 6, batched=False, capacity=4, device=CPU)
    with pytest.raises(ValueError):
        DetEngine(max_plans=0)


def test_cuda_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        DetEngine().plan(2, 6)


def test_grad_is_the_next_slice():
    """DetPlan.grad, the slice after the value path, pulls cotangents back
    on both backends: the torch backend's replayed walk and the kernel's
    plain version agree, and a degenerate plan's pullback is zeros."""
    As = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 2, 6)).astype(np.float32))
    cts = torch.tensor([1.0, -0.5])
    got = {b: DetEngine().plan(2, 6, device=CPU, backend=b).grad(As, cts)
           for b in BACKENDS}
    assert got["cuda"].shape == (2, 2, 6)
    np.testing.assert_allclose(got["cuda"].numpy(), got["torch"].numpy(),
                               rtol=1e-4, atol=1e-5)
    zero = DetEngine().plan(3, 2, device=CPU).grad(torch.ones(2, 3, 2), cts)
    assert zero.shape == (2, 3, 2) and not zero.any()


def test_default_engine_is_shared_and_swappable():
    assert default_engine() is default_engine()
    custom = DetEngine(max_plans=4)
    set_default_engine(custom)
    try:
        assert default_engine() is custom
        radic_det(torch.ones(2, 5), chunk=16)
        radic_det_batched(torch.ones(3, 2, 5), backend="torch")
        assert custom.cache_info()["size"] == 2
    finally:
        set_default_engine(None)
    assert default_engine() is not custom


# ------------------------------------------------- the engine's exports
def test_core_exports_the_references_names():
    """``repro_torch.core`` exports every name ``repro.core`` does (the
    jnp helpers under their torch names), the mesh entries included, and
    ``Mesh``, the counterpart of ``jax.sharding.Mesh``."""
    import repro.core as ref_core
    import repro_torch.core as core
    want = {n.replace("_jnp", "_torch") for n in ref_core.__all__}
    assert want | {"Mesh"} == set(core.__all__)


@pytest.mark.parametrize("cap", [1, 2, 8])
def test_evaluator_backends_agree(cap):
    """The bound-shape evaluators agree across backends and with the
    reference's, and each is radic_det_batched bit for bit."""
    from repro.core import make_batched_evaluator as ref_evaluator
    from repro_torch.core import make_batched_evaluator
    m, n = 3, 8
    As = np.random.default_rng(cap).normal(size=(cap, m, n)).astype(
        np.float32)
    T = torch.from_numpy(As)
    ev_t = make_batched_evaluator(m, n, chunk=64, backend="torch",
                                  device=CPU)
    ev_c = make_batched_evaluator(m, n, device=CPU)
    got_t, got_c = ev_t(T), ev_c(T)
    np.testing.assert_allclose(got_c.numpy(), got_t.numpy(), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(
        got_c.numpy(), np.asarray(ref_evaluator(m, n, chunk=64)(
            jnp.asarray(As))), rtol=1e-3, atol=1e-4)
    assert torch.equal(got_c, radic_det_batched(T, device=CPU))
    assert torch.equal(got_t, radic_det_batched(T, chunk=64,
                                                backend="torch", device=CPU))


@pytest.mark.parametrize("backend", BACKENDS)
def test_plan_grad_aot_bit_identical_to_traced(backend):
    """The capacity-pinned plan's ``grad`` and autograd through
    ``radic_det_batched`` run the same backward, to the bit, with
    nonuniform cotangents; a ct = 0 slot is exact zeros; both are held
    to the reference's AOT plan."""
    from repro.core import aot_compile_batched as ref_aot
    from repro_torch.core import aot_compile_batched
    m, n, cap = 3, 7, 4
    plan = aot_compile_batched(m, n, cap, chunk=64, backend=backend,
                               device=CPU)
    As = np.random.default_rng(6).normal(size=(cap, m, n)).astype(
        np.float32)
    cts = np.array([1.0, -2.0, 0.5, 0.0], np.float32)
    T = torch.from_numpy(As).requires_grad_(True)
    aot = plan.grad(T.detach(), torch.from_numpy(cts))
    (traced,) = torch.autograd.grad(
        radic_det_batched(T, chunk=64, backend=backend, device=CPU), T,
        grad_outputs=torch.from_numpy(cts))
    assert torch.equal(aot, traced)
    assert not aot[3].any()
    assert torch.equal(plan(T.detach()),
                       radic_det_batched(T.detach(), chunk=64,
                                         backend=backend, device=CPU))
    want = np.asarray(ref_aot(m, n, cap, chunk=64).grad(
        jnp.asarray(As), jnp.asarray(cts)))
    np.testing.assert_allclose(aot.numpy(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_aot_plan_refuses_another_batch(backend):
    """A plan pinned to (capacity, m, n) refuses another batch size with
    TypeError, as the reference's compiled program does, and another
    dtype (the reference refuses one that reaches it, under x64; without
    it jnp casts float64 host data first); an m > n plan has nothing
    compiled and takes any batch."""
    from repro.core import aot_compile_batched as ref_aot
    from repro_torch.core import aot_compile_batched
    plan = aot_compile_batched(2, 5, 4, backend=backend, device=CPU)
    ref_plan = ref_aot(2, 5, 4)
    for shape, dtype in [((3, 2, 5), np.float32), ((4, 2, 6), np.float32),
                         ((4, 2, 5), np.float64)]:
        A = np.ones(shape, dtype)
        with pytest.raises(TypeError):
            plan(A)
        with pytest.raises(TypeError):
            plan.grad(A, np.ones(shape[0], dtype))
        if dtype == np.float32:
            with pytest.raises(TypeError):
                ref_plan(jnp.asarray(A))
    zeros = aot_compile_batched(4, 2, 4, backend=backend, device=CPU)
    assert zeros(np.ones((3, 4, 2), np.float32)).shape == (3,)


def test_exports_guard_the_rank_space_at_plan_time():
    """Binding an evaluator already fails for C(40, 16) > 2**31 on the
    cuda backend, as the reference's pallas one does."""
    from repro.core import make_batched_evaluator as ref_evaluator
    from repro_torch.core import aot_compile_batched, make_batched_evaluator
    with pytest.raises(OverflowError):
        ref_evaluator(16, 40, backend="pallas")
    with pytest.raises(OverflowError):
        make_batched_evaluator(16, 40, device=CPU)
    with pytest.raises(OverflowError):
        aot_compile_batched(16, 40, 4, device=CPU)


@pytest.mark.parametrize("backend", BACKENDS)
def test_degenerate_batched_evaluator_is_zeros_on_device(backend):
    from repro_torch.core import make_batched_evaluator
    ev = make_batched_evaluator(4, 2, backend=backend, device=CPU)
    out = ev(np.random.default_rng(0).normal(size=(3, 4, 2)).astype(
        np.float32))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.shape == (3,) and not out.any()


# ------------------------------------------- det / det_batched conveniences
@pytest.mark.parametrize("backend", BACKENDS)
def test_det_conveniences_are_the_plan_bit_for_bit(backend):
    """``DetEngine.det``/``det_batched`` plan for ``A.shape`` and execute
    (the reference's engine.py:409-423), on a mesh too."""
    from repro_torch.core import Mesh
    rng = np.random.default_rng(21)
    A = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    As = torch.from_numpy(rng.normal(size=(4, 3, 8)).astype(np.float32))
    eng = DetEngine()
    kw = dict(chunk=64, backend=backend)
    assert torch.equal(eng.det(A, **kw),
                       eng.plan(3, 8, batched=False, device=CPU, **kw)(A))
    assert torch.equal(eng.det_batched(As, **kw),
                       eng.plan(3, 8, device=CPU, **kw)(As))
    mesh = Mesh(np.full((2, 2), CPU, dtype=object), ("data", "model"))
    assert torch.equal(
        eng.det(A, mesh=mesh, mode="flat", **kw),
        eng.plan(3, 8, batched=False, mesh=mesh, mode="flat", **kw)(A))
    assert torch.equal(
        eng.det_batched(As, mesh=mesh, batch_axis="data", **kw),
        eng.plan(3, 8, mesh=mesh, batch_axis="data", **kw)(As))


def test_mesh_plans_are_cached_across_calls():
    """Equal meshes hash equal, so repeated distributed calls reuse one
    planned evaluator (grain starts unranked once, not per call)."""
    from repro_torch.core.distributed import _default_mesh
    eng = DetEngine()
    A = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 6)).astype(np.float32))
    got1 = eng.det(A, mesh=_default_mesh(CPU))
    got2 = eng.det(A, mesh=_default_mesh(CPU))
    info = eng.cache_info()
    assert info["misses"] == 1 and info["hits"] == 1
    assert torch.equal(got1, got2)
