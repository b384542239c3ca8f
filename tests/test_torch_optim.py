"""The port's optimizer (``repro_torch.optim``) against the reference's
(``repro.optim``): the optim legs of ``tests/test_substrates.py`` on the
port (AdamW converges on a quadratic, clipping caps the update and
reports the raw norm, the warmup-cosine shape), then ``adamw_update`` on
the reference's random tree and gradients within ``rtol=1e-5,
atol=1e-7`` over several steps, the schedules over steps 0..120 within
``rtol=1e-6``, and ``global_norm`` in the reference's leaf order."""

import numpy as np
import pytest
import torch

from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               constant, global_norm, warmup_cosine)
from repro_torch.optim.adamw import reference_order


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, cfg)
    for _ in range(200):
        grads = {k: 2 * v for k, v in params.items()}
        params, state, _ = adamw_update(params, grads, state, cfg)
    assert float(params["x"].abs().max()) < 1e-2


def test_grad_clip_caps_update():
    cfg = AdamWConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0)
    params = {"x": torch.zeros(4)}
    state = adamw_init(params, cfg)
    _, _, metrics = adamw_update(params, {"x": torch.full((4,), 1e6)},
                                 state, cfg)
    assert float(metrics["grad_norm"]) > 1e5  # raw norm reported


def test_warmup_cosine_shape():
    f = warmup_cosine(1.0, 10, 100)
    assert float(f(torch.tensor(0))) == 0.0
    assert abs(float(f(torch.tensor(10))) - 1.0) < 0.11
    assert float(f(torch.tensor(100))) <= 0.11


def test_schedules_take_an_int_or_a_tensor_and_return_float32():
    for fn in (warmup_cosine(3e-4, 20, 100), constant(3e-4)):
        for step in (7, torch.tensor(7, dtype=torch.int32)):
            out = fn(step)
            assert isinstance(out, torch.Tensor)
            assert out.dtype == torch.float32 and out.shape == ()
    assert float(constant(0.5)(3)) == 0.5


@pytest.mark.parametrize("args", [(1e-3, 20, 100), (3e-4, 0, 50),
                                  (1.0, 10, 10), (2e-4, 30, 90, 0.05)])
def test_warmup_cosine_equals_the_reference(args):
    jnp = pytest.importorskip("jax.numpy")
    ref = pytest.importorskip("repro.optim")
    got = warmup_cosine(*args)
    want = ref.warmup_cosine(*args)
    for s in range(121):
        np.testing.assert_allclose(
            float(got(torch.tensor(s, dtype=torch.int32))),
            float(want(jnp.asarray(s, jnp.int32))), rtol=1e-6)


L = 2
PATHS = [("embed",), ("final_norm",), ("layers", "attn", "wo"),
         ("layers", "attn", "wq"), ("layers", "norm1"), ("lm_head",)]


def _ref_tree(rng, scale=1.0):
    """A reference-style float32 tree: top-level leaves and layer leaves
    stacked on a leading (L, ...) dim."""
    def f(*shape):
        return np.asarray(rng.normal(size=shape) * scale, np.float32)
    return {"embed": f(11, 4), "final_norm": f(4),
            "layers": {"attn": {"wq": f(L, 4, 6), "wo": f(L, 6, 4)},
                       "norm1": f(L, 4)},
            "lm_head": f(4, 11)}


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _named(tree) -> dict:
    """The tree's leaves keyed as the port names its params."""
    out = {}
    for path in PATHS:
        leaf = np.array(_leaf(tree, path))
        if path[0] == "layers":
            for i in range(L):
                out[".".join(("layers", str(i), *path[1:]))] = \
                    torch.from_numpy(leaf[i].copy())
        else:
            out[path[0]] = torch.from_numpy(leaf)
    return out


def _stacked(named, path):
    if path[0] == "layers":
        rest = ".".join(path[1:])
        return torch.stack([named[f"layers.{i}.{rest}"] for i in range(L)])
    return named[path[0]]


@pytest.mark.parametrize("sched", ["float", "warmup_cosine"])
def test_adamw_update_equals_the_reference(sched):
    """Four AdamW steps on the reference's random tree and gradients
    (clipping active on some steps, weight decay on): params, moments and
    metrics within rtol=1e-5, atol=1e-7."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    ref = pytest.importorskip("repro.optim")
    rng = np.random.default_rng(0)
    tree = _ref_tree(rng)
    lr_port = 3e-3 if sched == "float" else warmup_cosine(3e-3, 2, 6)
    lr_ref = 3e-3 if sched == "float" else ref.warmup_cosine(3e-3, 2, 6)
    cfg = AdamWConfig(lr=lr_port, weight_decay=0.1, grad_clip=1.0)
    rcfg = ref.AdamWConfig(lr=lr_ref, weight_decay=0.1, grad_clip=1.0)
    rp = jax.tree.map(jnp.asarray, tree)
    rstate = ref.adamw_init(rp, rcfg)
    named = _named(tree)
    state = adamw_init(named, cfg)
    for k, scale in enumerate((0.05, 3.0, 0.2, 10.0)):
        g = _ref_tree(rng, scale)
        rp, rstate, rmet = ref.adamw_update(
            rp, jax.tree.map(jnp.asarray, g), rstate, rcfg)
        named, state, met = adamw_update(named, _named(g), state, cfg)
        assert int(state["step"]) == int(rstate["step"]) == k + 1
        assert state["step"].dtype == torch.int32
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[key]), float(rmet[key]),
                                       rtol=1e-5, atol=1e-7)
        for path in PATHS:
            for got, want in ((named, rp), (state["mu"], rstate["mu"]),
                              (state["nu"], rstate["nu"])):
                np.testing.assert_allclose(
                    _stacked(got, path).numpy(),
                    np.asarray(_leaf(want, path)), rtol=1e-5, atol=1e-7,
                    err_msg=str(path))


def test_adamw_keeps_dtypes_and_updates_in_place():
    """A bf16 param is updated through float32 and cast back, in place;
    the moments stay in ``moment_dtype``."""
    p = torch.linspace(-1, 1, 8).to(torch.bfloat16)
    params = {"w": p}
    cfg = AdamWConfig(lr=1e-2)
    state = adamw_init(params, cfg)
    mu = state["mu"]["w"]
    g = torch.linspace(1, 2, 8).to(torch.bfloat16)
    before = p.clone()
    out, state, _ = adamw_update(params, {"w": g}, state, cfg)
    assert out["w"] is p and p.dtype == torch.bfloat16
    assert state["mu"]["w"] is mu and mu.dtype == torch.float32
    # the reference's arithmetic, written out for step 1
    gf = g.float() * min(1.0, 1.0 / (float(torch.linalg.vector_norm(
        g.float())) + 1e-9))
    m = 0.1 * gf
    v = (1 - 0.95) * gf * gf
    delta = (m / 0.1) / (torch.sqrt(v / (1 - 0.95)) + 1e-8) \
        + 0.1 * before.float()
    want = (before.float() - 1e-2 * delta).to(torch.bfloat16)
    assert torch.equal(p, want)


def test_global_norm_sums_in_the_reference_leaf_order():
    """Leaves group by their stacked reference path, in sorted path
    order, each group in layer order; the norm equals the reference's
    on the stacked tree."""
    names = ["embed", "final_norm", "lm_head", "layers.0.norm1",
             "layers.0.attn.wq", "layers.10.norm1", "layers.2.norm1",
             "layers.1.attn.wq", "layers.2.attn.wq", "layers.10.attn.wq",
             "layers.1.norm1"]
    assert reference_order(names) == [
        ["embed"], ["final_norm"],
        ["layers.0.attn.wq", "layers.1.attn.wq", "layers.2.attn.wq",
         "layers.10.attn.wq"],
        ["layers.0.norm1", "layers.1.norm1", "layers.2.norm1",
         "layers.10.norm1"],
        ["lm_head"]]
    jnp = pytest.importorskip("jax.numpy")
    jax = pytest.importorskip("jax")
    ref = pytest.importorskip("repro.optim")
    tree = _ref_tree(np.random.default_rng(3))
    named = _named(tree)
    np.testing.assert_allclose(
        float(global_norm(named)),
        float(ref.global_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)
    # the order is the names', not the dict's
    shuffled = dict(reversed(list(named.items())))
    assert torch.equal(global_norm(named), global_norm(shuffled))


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _noop_update(params, grads, state, cfg):
    step = state["step"] + 1
    return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}, \
        {"grad_norm": global_norm(grads), "lr": cfg.lr(step)}


def _unclipped_update(params, grads, state, cfg):
    return adamw_update(params, grads, state,
                        AdamWConfig(lr=cfg.lr, weight_decay=cfg.weight_decay,
                                    grad_clip=0.0))


def _no_decay_update(params, grads, state, cfg):
    return adamw_update(params, grads, state,
                        AdamWConfig(lr=cfg.lr, weight_decay=0.0,
                                    grad_clip=cfg.grad_clip))


@pytest.mark.parametrize("update,ok", [
    (adamw_update, True), (_noop_update, False), (_unclipped_update, False),
    (_no_decay_update, False)], ids=["adamw", "noop", "unclipped",
                                     "no-decay"])
def test_chip_smoke_adamw_hold_fails_a_broken_update(update, ok,
                                                     monkeypatch):
    """``chip_smoke.hold_adamw_step``, phase 18's float64 check of one
    AdamW update at full width, passes the port's update and fails a
    no-op, an unclipped and an undecayed one, on a bf16 matrix and a
    float32 vector at the phase's schedule (the global norm above the
    clip, so the scale acts)."""
    import repro_torch.optim
    hold = _chip_smoke().hold_adamw_step
    cfg = AdamWConfig(lr=warmup_cosine(1e-3, 20, 12), weight_decay=0.01)
    rng = np.random.default_rng(0)
    params = {"w": torch.as_tensor(0.02 * rng.standard_normal((64, 64)),
                                   dtype=torch.bfloat16),
              "n": torch.as_tensor(1 + 0.1 * rng.standard_normal(64),
                                   dtype=torch.float32)}
    state = adamw_init(params, cfg)

    def grads():
        return {k: torch.as_tensor(0.05 * rng.standard_normal(p.shape),
                                   dtype=p.dtype) for k, p in params.items()}

    for _ in range(3):
        params, state, _ = adamw_update(params, grads(), state, cfg)
    g = grads()
    assert float(global_norm(g)) > cfg.grad_clip
    monkeypatch.setattr(repro_torch.optim, "adamw_update", update)
    state, report = hold(params, g, state, cfg, names=("w", "n"))
    assert report["ok"] is ok, report
    assert int(state["step"]) == 4
    if ok:
        assert report["w"]["off"] == 0 and report["w"]["moved"] > 0.3
