"""The port's mesh (``repro_torch.core.distributed``) against the reference
and the oracle: grain planning, both scalar modes, rank × batch sharding
and its gradient on an in-process 8-slot CPU grid (the counterpart of the
reference's ``--xla_force_host_platform_device_count=8``), the engine's
mesh plans and the checks.  The reference's ``grains`` path fails on this
tree's jax (ROADMAP queue 3), so ``grains`` is held to the oracle and to
the port's single-device plans."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import distributed as ref_dist  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.runtime import elastic as ref_elastic  # noqa: E402
from repro_torch.core import (DetEngine, Mesh, comb,  # noqa: E402
                              make_batched_evaluator,
                              make_distributed_evaluator, plan_grains,
                              radic_det, radic_det_batched,
                              radic_det_batched_distributed,
                              radic_det_distributed, radic_det_oracle,
                              stable_key_hash, unrank_py,
                              validate_rank_space)
from repro_torch.core.distributed import (  # noqa: E402
    _default_mesh, make_batched_distributed_evaluator,
    make_batched_distributed_grad_evaluator)
from repro_torch.core.engine import BACKENDS, PlanKey  # noqa: E402
from repro_torch.runtime import build_mesh, choose_mesh  # noqa: E402

CPU = "cpu"
BIG = comb(70, 30)   # past int64: grains only


def grid(*shape, names=("data", "model")):
    """A grid of CPU slots (the one CPU repeated)."""
    return Mesh(np.full(shape, CPU, dtype=object), names[:len(shape)])


def close(got, want, tol=2e-3):
    return abs(float(got) - want) <= tol * max(1.0, abs(want))


# ------------------------------------------------------------ grain planning
@pytest.mark.parametrize("grains", [1, 3, 8, 13])
@pytest.mark.parametrize("total", [1, 7, 56, 1000, BIG])
def test_plan_grains_equals_reference(total, grains):
    starts, lengths = plan_grains(total, grains)
    assert (starts, lengths) == ref_dist.plan_grains(total, grains)
    assert starts[0] == 0 and sum(lengths) == total
    for s, n, s2 in zip(starts, lengths, starts[1:] + [total]):
        assert n >= 0 and s + n == s2


# ------------------------------------------------------ single device (CPU)
@pytest.mark.parametrize("mode,kw", [
    ("grains", dict(grains_per_device=1)),
    ("grains", dict(grains_per_device=4)),
    ("flat", dict(chunk=16, backend="torch")),
    ("flat", dict(chunk=16, backend="cuda")),
])
def test_single_device_modes(mode, kw, rng):
    A = rng.normal(size=(3, 8)).astype(np.float32)
    got = radic_det_distributed(torch.from_numpy(A), mode=mode, device=CPU,
                                **kw)
    assert got.shape == () and got.device.type == "cpu"
    assert close(got, radic_det_oracle(A))
    if mode == "flat":
        ref_kw = dict(kw, backend="pallas" if kw["backend"] == "cuda"
                      else "jnp")
        want = ref_dist.radic_det_distributed(jnp.asarray(A), mode="flat",
                                              **ref_kw)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-3,
                                   atol=1e-4)


def test_grains_survive_uneven_split(rng):
    """56 subsets over 5 grains -> uneven lengths; the combine is exact."""
    A = rng.normal(size=(5, 8)).astype(np.float32)
    ev = make_distributed_evaluator(5, 8, mesh=_default_mesh(CPU),
                                    grains_per_device=5)
    assert sorted(set(ev.grain_lengths)) == [11, 12]
    got = radic_det_distributed(torch.from_numpy(A), grains_per_device=5,
                                device=CPU)
    assert close(got, radic_det_oracle(A))


# ------------------------------------------------ an 8-slot CPU grid (2, 4)
@pytest.mark.parametrize("kw", [
    dict(mode="grains", grains_per_device=2),
    dict(mode="grains", grains_per_device=1),
    dict(mode="flat", chunk=32, backend="torch"),
    dict(mode="flat", chunk=32, backend="cuda"),
])
def test_eight_slot_grid(kw):
    A = np.random.default_rng(3).normal(size=(4, 10)).astype(np.float32)
    got = radic_det_distributed(torch.from_numpy(A), mesh=grid(2, 4), **kw)
    assert close(got, radic_det_oracle(A))


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_eight_slot_grid(backend):
    """Rank space over the whole grid (batch to every shard), and batch
    over ``data`` with the rank space over ``model``."""
    As = np.random.default_rng(5).normal(size=(6, 3, 9)).astype(np.float32)
    want = np.array([radic_det_oracle(a) for a in As])
    for batch_axis in (None, "data"):
        got = radic_det_batched_distributed(
            torch.from_numpy(As), mesh=grid(2, 4), batch_axis=batch_axis,
            chunk=16, backend=backend)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh_batched_grad_eight_slots(backend):
    """Autograd through the sharded forward runs the sharded cofactor
    VJP: held to the reference's single-device jnp ``jax.vjp`` (the
    reference's test_grad.py mesh leg)."""
    from repro.core import radic_det_batched as ref_batched
    As = np.random.default_rng(3).normal(size=(4, 3, 8)).astype(np.float32)
    cts = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    _, pull = jax.vjp(lambda M: ref_batched(M, chunk=16), jnp.asarray(As))
    (want,) = pull(jnp.asarray(cts))
    for batch_axis in (None, "data"):
        T = torch.from_numpy(As).requires_grad_(True)
        (got,) = torch.autograd.grad(
            radic_det_batched(T, mesh=grid(2, 4), batch_axis=batch_axis,
                              chunk=16, backend=backend),
            T, grad_outputs=torch.from_numpy(cts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fewer_ranks_than_shards(backend):
    """C(3, 2) = 3 ranks over 8 shards: five shards walk an empty range
    (one launch of count 0 each on the card) and add exact zeros."""
    rng = np.random.default_rng(7)
    A = rng.normal(size=(2, 3)).astype(np.float32)
    As = rng.normal(size=(4, 2, 3)).astype(np.float32)
    got = radic_det_distributed(torch.from_numpy(A), mesh=grid(2, 4),
                                mode="flat", backend=backend)
    assert close(got, radic_det_oracle(A))
    got = radic_det_distributed(torch.from_numpy(A), mesh=grid(2, 4))
    assert close(got, radic_det_oracle(A))
    got = radic_det_batched(torch.from_numpy(As), mesh=grid(2, 4),
                            backend=backend)
    np.testing.assert_allclose(got.numpy(),
                               [radic_det_oracle(a) for a in As],
                               rtol=2e-3, atol=2e-3)


# ------------------------------------------------- exactness inside the port
@pytest.mark.parametrize("backend", BACKENDS)
def test_one_slot_grid_is_the_single_device_plan(backend):
    """A (1,) grid runs the single-device program over the whole rank
    space: the same bits, value and gradient, scalar and batched."""
    rng = np.random.default_rng(11)
    A = torch.from_numpy(rng.normal(size=(3, 9)).astype(np.float32))
    As = torch.from_numpy(rng.normal(size=(5, 3, 9)).astype(np.float32))
    cts = torch.tensor([1.0, -2.0, 0.0, 0.5, 3.0])
    one = grid(1, names=("data",))
    kw = dict(chunk=32, backend=backend)
    assert torch.equal(
        radic_det_distributed(A, mesh=one, mode="flat", **kw),
        radic_det(A, device=CPU, **kw))
    assert torch.equal(radic_det_batched(As, mesh=one, **kw),
                       radic_det_batched(As, device=CPU, **kw))
    mesh_plan = DetEngine().plan(3, 9, mesh=one, **kw)
    plan = DetEngine().plan(3, 9, device=CPU, **kw)
    assert torch.equal(mesh_plan.grad(As, cts), plan.grad(As, cts))


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_only_grid_equals_single_device_slot_by_slot(backend):
    """A ("data",) grid splits the batch and walks every rank on each
    piece: each slot's value and gradient are the single-device plan's
    bits, and repeated calls give the same bits."""
    rng = np.random.default_rng(13)
    As = torch.from_numpy(rng.normal(size=(6, 3, 8)).astype(np.float32))
    cts = torch.tensor([1.0, -1.5, 0.0, 2.0, -0.25, 4.0])
    kw = dict(chunk=16, backend=backend)
    mesh = grid(2, names=("data",))
    eng = DetEngine()
    single = eng.plan(3, 8, device=CPU, **kw)
    sharded = eng.plan(3, 8, mesh=mesh, batch_axis="data", **kw)
    assert torch.equal(sharded(As), single(As))
    assert torch.equal(sharded.grad(As, cts), single.grad(As, cts))
    wide = eng.plan(3, 8, mesh=grid(2, 4), batch_axis="data", **kw)
    assert torch.equal(wide(As), wide(As))
    assert torch.equal(wide.grad(As, cts), wide.grad(As, cts))


def test_repeated_calls_are_bit_for_bit():
    A = torch.from_numpy(np.random.default_rng(17).normal(
        size=(4, 9)).astype(np.float32))
    for kw in (dict(mode="grains", grains_per_device=3),
               dict(mode="flat", backend="cuda"),
               dict(mode="flat", backend="torch")):
        first = radic_det_distributed(A, mesh=grid(2, 4), **kw)
        assert torch.equal(first, radic_det_distributed(A, mesh=grid(2, 4),
                                                        **kw))


def test_grains_past_int64_are_planned_not_walked():
    """C(70, 30) > 2**63: sixteen grain starts unranked with bigints at
    plan time, each the exact combination of its rank."""
    ev = make_distributed_evaluator(30, 70, mesh=grid(2, 4),
                                    grains_per_device=2)
    starts, lengths = plan_grains(BIG, 16)
    assert ev.grain_starts == starts and ev.grain_lengths == lengths
    assert ev.start_combos == [unrank_py(q, 70, 30) for q in starts]
    assert DetEngine().plan(30, 70, batched=False, mesh=grid(2, 4),
                            grains_per_device=2).total == BIG


# ----------------------------------------------------------------- the engine
@pytest.mark.parametrize("m,n", [(16, 40), (30, 70)])
def test_grains_mode_has_no_width_limit(m, n):
    assert validate_rank_space(m, n, mesh_grains=True) == comb(n, m) \
        == ref_engine.validate_rank_space(m, n, mesh_grains=True)
    with pytest.raises(OverflowError):
        DetEngine().plan(m, n, batched=False, mesh=grid(2, 4), mode="flat")


@pytest.mark.parametrize("backend", BACKENDS)
def test_degenerate_shapes_with_mesh_are_zeros_on_its_first_device(backend):
    out = make_batched_evaluator(4, 2, mesh=grid(2, 4), backend=backend)(
        np.random.default_rng(0).normal(size=(3, 4, 2)).astype(np.float32))
    assert out.device.type == "cpu" and out.shape == (3,) and not out.any()
    out = radic_det_distributed(np.ones((4, 2), np.float32),
                                mesh=grid(2, 4), backend=backend)
    assert out.device.type == "cpu" and float(out) == 0.0


def test_equal_meshes_plan_once():
    eng = DetEngine()
    A = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 6)).astype(np.float32))
    got1 = eng.det(A, mesh=grid(2, 4))
    got2 = eng.det(A, mesh=build_mesh(choose_mesh(8, max_model=4),
                                      [CPU] * 8))
    info = eng.cache_info()
    assert info["misses"] == 1 and info["hits"] == 1
    assert torch.equal(got1, got2)


def test_mesh_plans_are_not_stored(tmp_path):
    eng = DetEngine(persist_dir=str(tmp_path))
    eng.plan(2, 6, mesh=grid(2, 4), backend="torch")
    eng.plan(2, 6, device=CPU, backend="torch")
    eng.flush_store()
    assert eng.cache_info()["store_misses"] == 1
    keys = [f["key"] for f in eng.store.families()]
    assert keys == [DetEngine._key_meta(
        PlanKey(2, 6, True, None, "float32", "torch", 2048, False, CPU))]


def test_mesh_free_key_hash_is_unchanged():
    """A mesh-free key is the nine-field tuple it was before the mesh:
    its hash, the name of its plan-store record, is pinned to the value
    the port computed before, and equals the reference's on that tuple."""
    key = PlanKey(3, 8, True, 16, "float32", "cuda", 2048, False, CPU)
    assert len(key) == 9 and key.mesh is None and key.mode == "grains"
    assert stable_key_hash(key) == 14835639759078313344 \
        == ref_engine.stable_key_hash(tuple(key))
    meshed = PlanKey(*key, mesh=grid(2, 4), axis_names=("data",),
                     mode="flat", grains_per_device=2)
    assert len(meshed) == 14 and meshed.mesh == grid(2, 4)
    assert meshed[:9] == key and meshed != key


# ------------------------------------------------------------------ the checks
def test_batched_checks_raise_as_the_reference():
    mesh = grid(2, 4)
    with pytest.raises(ValueError, match="batch_axis"):
        make_batched_distributed_evaluator(3, 8, mesh=mesh,
                                           batch_axis="pod")
    with pytest.raises(ValueError, match="batch_axis"):
        make_batched_distributed_grad_evaluator(3, 8, mesh=mesh,
                                                batch_axis="pod")
    ref_mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    with pytest.raises(ValueError, match="batch_axis"):
        ref_dist.make_batched_distributed_evaluator(3, 8, mesh=ref_mesh,
                                                    batch_axis="pod")
    ev = make_batched_distributed_evaluator(3, 8, mesh=mesh,
                                            batch_axis="data")
    gr = make_batched_distributed_grad_evaluator(3, 8, mesh=mesh,
                                                 batch_axis="data")
    with pytest.raises(ValueError, match="not divisible"):
        ev(torch.ones(3, 3, 8))
    with pytest.raises(ValueError, match="not divisible"):
        gr(torch.ones(3, 3, 8), torch.ones(3))
    with pytest.raises(ValueError, match="expected"):
        ev(torch.ones(2, 3, 9))
    with pytest.raises(ValueError, match="expected"):
        ref_dist.make_batched_distributed_evaluator(3, 8, mesh=ref_mesh)(
            jnp.ones((2, 3, 9)))


def test_mesh_type():
    a = grid(2, 4)
    assert a == grid(2, 4) and hash(a) == hash(grid(2, 4))
    assert a != grid(4, 2) and a != grid(8, names=("data",))
    assert dict(a.shape) == {"data": 2, "model": 4} and a.size == 8
    assert a.devices.shape == (2, 4) and a.first_device == torch.device(CPU)
    assert all(isinstance(d, torch.device) for d in a.devices.flat)
    with pytest.raises(ValueError):
        a.devices[0, 0] = torch.device("meta")
    with pytest.raises(ValueError):
        Mesh([CPU] * 4, ("data", "model"))
    with pytest.raises(ValueError):
        Mesh(np.full((2, 2), CPU, dtype=object), ("data", "data"))


@pytest.mark.parametrize("n,kw", [(1, {}), (8, {}), (8, dict(max_model=4)),
                                  (6, dict(max_model=2)),
                                  (8, dict(max_model=2, want_pods=2))])
def test_build_mesh_gives_the_references_grid(n, kw):
    plan = choose_mesh(n, **kw)
    ref_plan = ref_elastic.choose_mesh(n, **kw)
    assert (plan.shape, plan.axis_names, plan.n_devices) == (
        ref_plan.shape, ref_plan.axis_names, ref_plan.n_devices)
    mesh = build_mesh(plan, [CPU] * n)
    assert mesh.axis_names == plan.axis_names
    assert mesh.devices.shape == plan.shape
    if plan.n_devices == 1:   # the reference's on this one jax device
        ref = ref_elastic.build_mesh(plan)
        assert mesh.axis_names == tuple(ref.axis_names)
        assert dict(mesh.shape) == dict(ref.shape)


def test_build_mesh_refuses_too_few_devices():
    with pytest.raises(AssertionError, match="not enough"):
        build_mesh(choose_mesh(8), [CPU] * 4)
    with pytest.raises(AssertionError, match="not enough"):
        ref_elastic.build_mesh(choose_mesh(8), jax.devices()[:1])


def test_default_meshes_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default devices exist")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_mesh(choose_mesh(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        _default_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        radic_det_distributed(np.ones((2, 3), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        radic_det(np.ones((2, 3), np.float32),
                  mesh=Mesh(["cuda:0"], ("data",)))
    assert _default_mesh(CPU) == grid(1, names=("workers",))
