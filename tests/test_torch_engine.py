"""The port's DetEngine against the reference engine: plan-key hashing,
rank-space validation, LRU semantics, degenerate plans and routing."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import engine as ref_engine  # noqa: E402
from repro_torch.core import (DetEngine, default_engine, radic_det,  # noqa: E402
                              radic_det_batched, set_default_engine,
                              stable_key_hash, validate_rank_space)
from repro_torch.core.engine import BACKENDS, CUDA_MAX_M, PlanKey  # noqa: E402
from repro_torch.core.pascal import INT32_MAX, comb  # noqa: E402
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
    if m > CUDA_MAX_M and m <= n and comb(n, m) <= INT32_MAX:
        assert got is ValueError   # the kernel's own bound on m
    else:
        assert got == want


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
    eng = DetEngine()
    with pytest.raises(OverflowError):
        eng.plan(16, 40, backend="cuda", device=CPU)
    with pytest.raises(ValueError, match=str(CUDA_MAX_M)):
        eng.plan(17, 20, backend="cuda", device=CPU)
    assert eng.plan(17, 20, backend="torch", device=CPU).total == \
        comb(20, 17)
    assert eng.cache_info()["size"] == 1


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
