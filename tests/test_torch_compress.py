"""The port's gradient compression (``repro_torch.parallel.compress``)
against the reference's ``repro.parallel.compress``: the three twins of
``test_substrates.py``'s compress legs, each also bit for bit with the
reference's function on the same inputs (float32 and bf16 leaves,
rounding ties included); ``psum_int8`` over the replicas of a (2, 2)
``("pod", "data")`` CPU grid equal to a numpy int32/float32 computation
of the reference's formula exactly (the reference's own multi-device
``psum_int8`` fails in ``compat.pvary`` on jax 0.9); and three broken
``psum_int8`` variants (a no-op, another replica order, no scale
average) that this check must catch."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.parallel import compress as ref  # noqa: E402
from repro_torch.core import Mesh  # noqa: E402
from repro_torch.models.convert import _to_numpy  # noqa: E402
from repro_torch.parallel import compress  # noqa: E402

AXES = ("pod", "data")


def _jnp(t: torch.Tensor):
    return jnp.asarray(_to_numpy(t))


def _same(got: torch.Tensor, want) -> bool:
    """Bit for bit: dtype, shape and every value's bits."""
    want = np.asarray(want)
    got = _to_numpy(got)
    return got.dtype == want.dtype and got.shape == want.shape and \
        got.tobytes() == want.tobytes()


def _leaves(rng):
    """float32 and bf16 gradient leaves, one with exact rounding ties
    (|x| / scale at k + 1/2: the scale is 1 in float32)."""
    ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5, 0.0])
    return {
        "w": torch.from_numpy(rng.normal(size=(48, 16)).astype(np.float32)),
        "b": torch.from_numpy(rng.normal(size=(256,)).astype(np.float32)
                              * 1e-3).to(torch.bfloat16),
        "ties": ties,
    }


# --------------------------------------- twins of test_substrates.py's legs
def test_int8_quantization_error_bound(rng):
    x = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, s = compress.quantize_int8(x)
    err = (compress.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-7
    rq, rs = ref.quantize_int8(_jnp(x))
    assert _same(q, rq) and _same(s, rs)
    assert _same(compress.dequantize_int8(q, s), ref.dequantize_int8(rq, rs))


def test_psum_int8_single_device_identity(rng):
    g = {"w": torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))}
    out = compress.psum_int8(g, axis_names=())  # no axes: quant round trip
    assert float((out["w"] - g["w"]).abs().max()) < 0.05
    assert _same(out["w"], ref.psum_int8({"w": _jnp(g["w"])}, ())["w"])


def test_topk_error_feedback_accumulates(rng):
    g = {"w": torch.from_numpy(rng.normal(size=(100,)).astype(np.float32))}
    mem = compress.init_error_feedback(g)
    rg = {"w": _jnp(g["w"])}
    rmem = ref.init_error_feedback(rg)
    total = np.zeros(100, np.float32)
    for _ in range(50):
        sg, mem = compress.topk_with_error_feedback(g, mem, frac=0.05)
        rsg, rmem = ref.topk_with_error_feedback(rg, rmem, frac=0.05)
        assert _same(sg["w"], rsg["w"]) and _same(mem["w"], rmem["w"])
        total += sg["w"].numpy()
    # error feedback => long-run average ≈ the true gradient direction
    corr = np.corrcoef(total, g["w"].numpy())[0, 1]
    assert corr > 0.99


# ------------------------------------------- bit for bit on more leaves
def test_quantize_and_round_trip_bit_for_bit_with_the_reference(rng):
    leaves = _leaves(rng)
    out = compress.psum_int8(leaves)
    want = ref.psum_int8({k: _jnp(v) for k, v in leaves.items()}, ())
    for k, v in leaves.items():
        q, s = compress.quantize_int8(v)
        rq, rs = ref.quantize_int8(_jnp(v))
        assert _same(q, rq) and _same(s, rs), k
        assert out[k].dtype == v.dtype and _same(out[k], want[k]), k
    q, _ = compress.quantize_int8(leaves["ties"])
    assert q.tolist() == [127, 0, 2, 2, 0, -4, 126, 0]  # half to even


def test_topk_bit_for_bit_with_the_reference(rng):
    leaves = _leaves(rng)
    mem = compress.init_error_feedback(leaves)
    rg = {k: _jnp(v) for k, v in leaves.items()}
    rmem = ref.init_error_feedback(rg)
    for frac in (0.01, 0.1, 0.5):
        sg, mem = compress.topk_with_error_feedback(leaves, mem, frac=frac)
        rsg, rmem = ref.topk_with_error_feedback(rg, rmem, frac=frac)
        for k in leaves:
            assert _same(sg[k], rsg[k]) and _same(mem[k], rmem[k]), (k, frac)


# ----------------------------------------------- psum_int8 over replicas
def _grid():
    return Mesh(np.full((2, 2), "cpu", dtype=object), AXES)


def _replicas(seed: int = 7):
    """Four replicas' trees.  Besides ``_leaves``, 12 small leaves: the
    order of the scale average changes the rounded mean for about a
    quarter of random scales, so some leaf shows a wrong order."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        tree = _leaves(rng)
        tree.update({f"v{i}": torch.from_numpy(
            rng.normal(size=(16,)).astype(np.float32)) for i in range(12)})
        out.append(tree)
    return out


def reference_formula(replicas, sizes, axes, axis_names) -> dict:
    """The reference's ``psum_int8`` in numpy: each replica's absmax int8
    quantization in float32, the int32 sum, the scales' ``pmean`` one
    axis at a time in ``axis_names`` order, ``acc * s / n``."""
    f32 = np.float32
    n = int(np.prod(sizes))
    out = {}
    for k, g0 in replicas[0].items():
        acc = None
        scales = []
        for r in replicas:
            xf = r[k].float().numpy()
            s = np.max(np.abs(xf)) / f32(127.0) + f32(1e-12)
            q = np.clip(np.round(xf / s), -127, 127).astype(np.int8)
            acc = q.astype(np.int32) if acc is None else \
                acc + q.astype(np.int32)
            scales.append(s)
        grid = np.array(scales, dtype=f32).reshape(sizes)
        for a in axis_names:
            d = axes.index(a)
            tot = np.take(grid, 0, axis=d)
            for i in range(1, sizes[d]):
                tot = tot + np.take(grid, i, axis=d)
            grid = np.broadcast_to(np.expand_dims(tot / f32(sizes[d]), d),
                                   sizes)
        s = grid.reshape(-1)[0]
        res = acc.astype(f32) * s / f32(n)
        assert res.dtype == f32
        out[k] = torch.from_numpy(res).to(g0.dtype)
    return out


def holds(fn, replicas, axis_names=AXES) -> bool:
    got = fn(replicas, axis_names, mesh=_grid())
    want = reference_formula(replicas, [2, 2], list(AXES), axis_names)
    return all(got[k].dtype == w.dtype and torch.equal(
        got[k].view(torch.int16) if w.dtype == torch.bfloat16 else got[k],
        w.view(torch.int16) if w.dtype == torch.bfloat16 else w)
        for k, w in want.items())


@pytest.mark.parametrize("axis_names", [AXES, AXES[::-1]],
                         ids=["pod-data", "data-pod"])
def test_psum_int8_over_replicas_equals_the_formula(axis_names):
    assert holds(compress.psum_int8, _replicas(), axis_names)


def _no_op(grads, axis_names, mesh):
    return grads[0]


def _column_major(grads, axis_names, mesh):
    return compress.psum_int8([grads[i] for i in (0, 2, 1, 3)], axis_names,
                              mesh=mesh)


def _no_scale_average(grads, axis_names, mesh):
    out = {}
    for k, g0 in grads[0].items():
        qs = [compress.quantize_int8(g[k]) for g in grads]
        acc = sum(q.to(torch.int32) for q, _ in qs)
        out[k] = (acc.to(torch.float32) * qs[0][1] / len(grads)).to(g0.dtype)
    return out


@pytest.mark.parametrize("broken", [_no_op, _column_major,
                                    _no_scale_average],
                         ids=["no-op", "column-major", "no-scale-average"])
def test_the_formula_check_catches_a_broken_psum(broken):
    replicas = _replicas()
    assert holds(compress.psum_int8, replicas)
    assert not holds(broken, replicas)


def test_psum_int8_replicas_on_one_axis_and_errors():
    """Over ``("data",)`` of a (2, 2) grid the replicas are the data
    positions at pod 0; a wrong tree count, a missing mesh or an axis
    the mesh lacks raise."""
    mesh = _grid()
    assert compress.replica_devices(mesh, ("data",)) == \
        [torch.device("cpu")] * 2
    two = _replicas()[:2]
    got = compress.psum_int8(two, ("data",), mesh=mesh)
    want = reference_formula(two, [2], ["data"], ["data"])
    assert all(torch.equal(got[k].float(), w.float())
               for k, w in want.items())
    with pytest.raises(ValueError):
        compress.psum_int8(_replicas()[:3], AXES, mesh=mesh)
    with pytest.raises(ValueError):
        compress.psum_int8(two, ("data",))
    with pytest.raises(ValueError):
        compress.psum_int8(two, ("model",), mesh=mesh)
