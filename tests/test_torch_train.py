"""The port's training path against the reference's: ``CausalLM.loss``
(with ``_ce_chunked``), ``EncDecLM.loss``, remat, ``make_train_step`` /
``init_train_state`` and the train driver (``repro_torch.launch.train``),
on the CPU.

* Loss and gradient per family at narrow widths in float32 (dense, vlm
  with a prefix, moe under both dispatches with the aux term and a
  capacity that drops, ssm, hybrid, audio) against the reference's
  ``loss`` and ``jax.grad``: loss within 1e-5 relative, gradients within
  ``rtol=2e-3, atol=1e-5``, leaf for leaf through
  ``models.convert.tree_to_reference``.
* The loss knobs of ``tests/test_perf_knobs.py`` (chunked CE, its label
  mask, remat policies) on the port and against the reference.
* Remat recomputes only while autograd records (serving is unchanged),
  ``dots`` keeps the 2-d products; the embedding's and the MoE scatter
  dispatch's backwards give the same bits on every pass and add no
  scatter.
* Five steps of ``make_train_step`` against the reference's from its
  ``PRNGKey(0)`` params and batches; the optimizer state crosses both
  ways bit for bit.
* The driver: ``tests/test_drivers.py``'s train legs, a resume equal to
  the uninterrupted run bit for bit, each package resuming the other's
  checkpoint, the card as the default device, every param on
  ``--device`` under a one-device mesh line.

The reference's losses and gradients are computed once per module."""

import collections
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import ModelConfig as RefConfig  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.optim import AdamWConfig as RefAdamW  # noqa: E402
from repro.optim import warmup_cosine as ref_warmup  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.models.convert import (opt_state_from_reference,  # noqa
                                        opt_state_to_reference,
                                        params_from_reference,
                                        params_to_reference,
                                        tree_from_reference,
                                        tree_to_reference)
from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine  # noqa

CPU = "cpu"
B, S = 2, 12


def base_kw(family, **kw):
    base = dict(name="t", family=family, n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=97,
                dtype="float32", remat=False)
    base.update(kw)
    return base


MOE_DROPS = dict(n_experts=4, top_k=2, capacity_factor=0.5,
                 moe_group_size=16)
CASES = {
    "dense": ("dense", {}),
    "gemma-like": ("dense", dict(attn_window=4, local_global_period=2,
                                 attn_logit_softcap=50.0,
                                 final_logit_softcap=30.0,
                                 post_block_norm=True, scale_embeddings=True,
                                 act="gelu", tie_embeddings=True)),
    "vlm": ("vlm", dict(prefix_embeds=True, n_patches=4)),
    "moe-onehot-drops": ("moe", MOE_DROPS),
    "moe-scatter-drops": ("moe", dict(MOE_DROPS, moe_impl="scatter",
                                      dense_residual_ff=48)),
    "ssm": ("ssm", dict(n_heads=0, n_kv_heads=1, head_dim=0, d_ff=0,
                        ssm_state=16, ssm_head_dim=8, ssm_chunk=4)),
    "hybrid": ("hybrid", dict(ssm_state=16, ssm_head_dim=8, ssm_chunk=4,
                              attn_window=4, local_global_period=2)),
    "audio": ("audio", dict(n_enc_layers=2, enc_dec=True, n_frames=6,
                            act="gelu")),
}


def make_batch(fam, kw, seed=2):
    """tokens, labels (a masked span of -1) and the family's stand-in
    embeddings, from seeded numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 97, size=(B, S))
    labels = tok.copy()
    labels[:, 3:5] = -1
    batch = {"tokens": tok, "labels": labels}
    if kw.get("prefix_embeds"):
        batch["prefix_embeds"] = rng.standard_normal(
            (B, kw["n_patches"], 32)).astype(np.float32)
    if fam == "audio":
        batch["frame_embeds"] = (0.5 * rng.standard_normal(
            (B, kw["n_frames"], 32))).astype(np.float32)
    return batch


def port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference():
    """Each case's reference params, batch, loss and jax.grad."""
    out = {}
    for case, (fam, kw) in CASES.items():
        ref = ref_build(RefConfig(**base_kw(fam, **kw)))
        params = ref.init(jax.random.PRNGKey(1))
        batch = make_batch(fam, kw)
        loss, grads = jax.jit(jax.value_and_grad(ref.loss))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        out[case] = {"tree": jax.tree.map(np.asarray, params),
                     "batch": batch, "loss": float(loss),
                     "grads": jax.tree.map(np.asarray, grads)}
    return out


def port_of(case, tree, **extra):
    fam, kw = CASES[case]
    return params_from_reference(ModelConfig(**base_kw(fam, **kw, **extra)),
                                 tree, device=CPU)


def assert_tree_close(got, want, rtol=2e-3, atol=1e-5, where=""):
    assert sorted(got) == sorted(want), where
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_close(got[k], want[k], rtol, atol, f"{where}.{k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       atol=atol, err_msg=f"{where}.{k}")


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grad_match_reference(case, reference):
    r = reference[case]
    model = port_of(case, r["tree"])
    loss, grads = steps.value_and_grad(model, port_batch(r["batch"]))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - r["loss"]) <= 1e-5 * abs(r["loss"]), \
        (loss.item(), r["loss"])
    assert_tree_close(tree_to_reference(model, grads), r["grads"])
    # the params record gradients only inside the step
    assert not any(p.requires_grad for p in model.parameters())


def test_moe_aux_term_and_drops_are_in_the_loss(reference):
    """The moe cases' loss holds 0.01 * aux (the reference's), and the
    capacity drops tokens."""
    from repro_torch.models import moe
    r = reference["moe-onehot-drops"]
    model = port_of("moe-onehot-drops", r["tree"])
    b = port_batch(r["batch"])
    with torch.no_grad():
        logits, aux = model.forward(b["tokens"])
        from repro_torch.models.lm import cross_entropy
        s, n = cross_entropy(logits[:, :-1], b["labels"][:, 1:])
        assert aux.item() > 0
        np.testing.assert_allclose(
            model.loss(b).item(), (s / n + 0.01 * aux).item(), rtol=1e-6)
    G, Tg, C = moe._group(model.cfg, B * S)
    assert C < Tg * model.cfg.top_k / model.cfg.n_experts  # drops


# ------------------------------------------------------ the loss knobs
KNOB = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=97,
            dtype="float32")


@pytest.fixture(scope="module")
def knob():
    """test_perf_knobs.py's setup: its model's PRNGKey(1) params and
    seeded tokens, with the reference's full loss and gradient."""
    ref = ref_build(RefConfig(**KNOB, remat=False))
    params = ref.init(jax.random.PRNGKey(1))
    tok = np.random.default_rng(0).integers(0, 97, size=(2, 12))
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    loss, grads = jax.value_and_grad(ref.loss)(params, batch)
    return {"tree": jax.tree.map(np.asarray, params), "tok": tok,
            "loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
            "ref": ref, "params": params}


def knob_model(tree, **kw):
    return params_from_reference(ModelConfig(**KNOB, **kw), tree,
                                 device=CPU)


def test_chunked_ce_matches_full(knob):
    batch = {"tokens": torch.as_tensor(knob["tok"]),
             "labels": torch.as_tensor(knob["tok"])}
    full_model = knob_model(knob["tree"], remat=False)
    with torch.no_grad():
        full = float(full_model.loss(batch))
    assert abs(full - knob["loss"]) <= 1e-5 * abs(knob["loss"])
    for chunk in (1, 5, 12, 64):
        mc = knob_model(knob["tree"], remat=False, loss_chunk=chunk)
        with torch.no_grad():
            assert abs(float(mc.loss(batch)) - full) < 1e-4
    _, g1 = steps.value_and_grad(full_model, batch)
    _, g2 = steps.value_and_grad(
        knob_model(knob["tree"], remat=False, loss_chunk=5), batch)
    for name in g1:
        np.testing.assert_allclose(g1[name].numpy(), g2[name].numpy(),
                                   rtol=2e-3, atol=1e-5, err_msg=name)
    assert_tree_close(tree_to_reference(full_model, g2), knob["grads"])


def test_chunked_ce_respects_label_mask(knob):
    tok = knob["tok"]
    labels = tok.copy()
    labels[:, 3:6] = -1
    batch = {"tokens": torch.as_tensor(tok),
             "labels": torch.as_tensor(labels)}
    with torch.no_grad():
        full = float(knob_model(knob["tree"], remat=False).loss(batch))
        mc = knob_model(knob["tree"], remat=False, loss_chunk=4)
        assert abs(float(mc.loss(batch)) - full) < 1e-4
    want = float(knob["ref"].loss(knob["params"], {
        "tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)}))
    assert abs(full - want) <= 1e-5 * abs(want)


def test_remat_policies_match_no_remat(knob):
    batch = {"tokens": torch.as_tensor(knob["tok"]),
             "labels": torch.as_tensor(knob["tok"])}
    with torch.no_grad():
        want = float(knob_model(knob["tree"], remat=False).loss(batch))
    for pol in ("nothing", "dots"):
        mr = knob_model(knob["tree"], remat=True, remat_policy=pol)
        loss, g = steps.value_and_grad(mr, batch)
        assert abs(float(loss) - want) < 1e-5
        assert all(torch.isfinite(x).all() for x in g.values())
        assert_tree_close(tree_to_reference(mr, g), knob["grads"])


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_only_while_autograd_records(knob, monkeypatch):
    """Each block runs once in a forward under inference_mode or no_grad
    (serving is unchanged) and twice in a remat backward; ``dots``
    replays no 2-d product, ``nothing`` replays every one."""
    batch = {"tokens": torch.as_tensor(knob["tok"]),
             "labels": torch.as_tensor(knob["tok"])}
    mm = torch.ops.aten.mm.default
    backward_mm = {}
    for label, kw in (("none", dict(remat=False)),
                      ("nothing", dict(remat=True)),
                      ("dots", dict(remat=True, remat_policy="dots"))):
        model = knob_model(knob["tree"], **kw)
        calls = []
        block = model._block
        monkeypatch.setattr(model, "_block",
                            lambda *a: calls.append(1) or block(*a))
        with torch.inference_mode():
            model.forward(knob["tok"])
        with torch.no_grad():
            model.loss(batch)
        assert len(calls) == 4, label
        params = list(model.parameters())
        for p in params:
            p.requires_grad_(True)
        loss = model.loss(batch)
        calls.clear()
        counter = _CountOps()
        with counter:
            torch.autograd.grad(loss, params)
        backward_mm[label] = counter.calls[mm]
        assert len(calls) == (0 if label == "none" else 2), label
    assert backward_mm["dots"] == backward_mm["none"] < \
        backward_mm["nothing"], backward_mm


# ------------------------------------------- deterministic backward passes
def test_embedding_backward_is_bit_identical_across_passes():
    """Repeated token ids: two backward passes of the model's embedding
    give the same bits, each id's rows summed (the reference's scatter-
    add's values)."""
    model = knob_model(jax.tree.map(np.asarray, ref_build(RefConfig(
        **KNOB, remat=False)).init(jax.random.PRNGKey(2))), remat=False)
    tok = torch.as_tensor(np.random.default_rng(1).integers(0, 5, (4, 40)))
    ct = torch.randn(4, 40, 32, generator=torch.Generator().manual_seed(0))
    grads = []
    for _ in range(2):
        model.embed.requires_grad_(True)
        x = model._embed(model._cast(), tok)
        (g,) = torch.autograd.grad(x, model.embed, ct)
        model.embed.requires_grad_(False)
        grads.append(g)
    assert torch.equal(grads[0], grads[1])
    want = torch.zeros_like(grads[0])
    want.index_put_((tok.reshape(-1),), ct.reshape(-1, 32), accumulate=True)
    torch.testing.assert_close(grads[0], want, rtol=1e-6, atol=1e-6)


def test_moe_scatter_backward_is_bit_identical_and_accumulates_nothing():
    """The scatter dispatch's gradients (input, router, experts) are the
    same bits on two passes; its two gathers' backwards equal autograd's
    through plain indexing (k slot gradients added in slot order; a
    plain write to each kept (expert, slot))."""
    from repro_torch.models import moe
    cfg = ModelConfig(**base_kw("moe", **MOE_DROPS, moe_impl="scatter"))
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x0 = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(1))
    ct = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(2))
    leaves = [p["router"], p["w_gate"], p["w_up"], p["w_down"]]
    runs = []
    for _ in range(2):
        x = x0.clone().requires_grad_(True)
        for w in leaves:
            w.requires_grad_(True)
        y, _ = moe.moe_forward(p, x, cfg)
        runs.append(torch.autograd.grad(y, [x, *leaves], ct))
        for w in leaves:
            w.requires_grad_(False)
    for a, b in zip(*runs):
        assert torch.equal(a, b)

    k, G, Tg, D = 2, 2, 8, 32
    xs = torch.randn(G, Tg, D, generator=torch.Generator().manual_seed(3),
                     requires_grad=True)
    g = torch.randn(G, Tg * k, D, generator=torch.Generator().manual_seed(4))
    tok = torch.arange(Tg).repeat_interleave(k)
    (want,) = torch.autograd.grad(xs[:, tok], xs, g)
    (got,) = torch.autograd.grad(moe._RepeatTokens.apply(xs, k), xs, g)
    assert torch.equal(got, g.reshape(G, Tg, k, D)[:, :, 0]
                       + g.reshape(G, Tg, k, D)[:, :, 1])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)

    E, C = 4, 3
    y = torch.randn(G, E, C, D, generator=torch.Generator().manual_seed(5),
                    requires_grad=True)
    e_flat = torch.tensor([[0, 1, 0, 2, 3, 0], [1, 1, 2, 0, 3, 3]])
    slot = torch.tensor([[0, 0, 1, 0, 0, 3], [0, 1, 0, 0, 3, 3]])  # C: cut
    gidx = torch.arange(G)[:, None].expand(G, 6)
    gv = torch.randn(G, 6, D, generator=torch.Generator().manual_seed(6))
    ypad = torch.cat([y, torch.zeros(G, E, 1, D)], dim=2)
    (want,) = torch.autograd.grad(ypad[gidx, e_flat, slot], y, gv)
    (got,) = torch.autograd.grad(
        moe._GatherSlots.apply(y, gidx, e_flat, slot), y, gv)
    assert torch.equal(got, want)


# ------------------------------------------------------ the train step
def test_train_step_matches_reference():
    """Five steps of make_train_step from the reference's PRNGKey(0)
    params and data: losses within rtol=1e-4; params within rtol=1e-4,
    atol=1e-5 (the largest error read is 3.1e-6, while one step moves a
    param by up to lr = 1e-2); mu within rtol=1e-4, atol=1e-7 as
    test_adamw_update_equals_the_reference holds it, and nu, the
    squares, within rtol=1e-4, atol=1e-12 (largest relative error read
    8.5e-5)."""
    kw = base_kw("dense")
    opt_kw = dict(weight_decay=0.01)
    cfg, rcfg = ModelConfig(**kw), RefConfig(**kw)
    ref_opt = RefAdamW(lr=ref_warmup(1e-2, 2, 5), **opt_kw)
    opt_cfg = AdamWConfig(lr=warmup_cosine(1e-2, 2, 5), **opt_kw)
    rmodel, rparams, rstate = ref_steps.init_train_state(
        rcfg, ref_opt, jax.random.PRNGKey(0))
    rstep = jax.jit(ref_steps.make_train_step(rmodel, ref_opt))
    model = params_from_reference(cfg, jax.tree.map(np.asarray, rparams),
                                  device=CPU)
    state = adamw_init(dict(model.named_parameters()), opt_cfg)
    step = steps.make_train_step(model, opt_cfg)
    data = SyntheticLMData(DataConfig(vocab_size=97, seq_len=16,
                                      global_batch=4))
    losses, rlosses = [], []
    for s in range(5):
        batch = data.batch(s)
        rparams, rstate, rmet = rstep(
            rparams, rstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, met = step(state, port_batch(batch))
        rlosses.append(float(rmet["loss"]))
        losses.append(float(met["loss"]))
        np.testing.assert_allclose(float(met["lr"]), float(rmet["lr"]),
                                   rtol=1e-6)
    np.testing.assert_allclose(losses, rlosses, rtol=1e-4)
    assert_tree_close(params_to_reference(model),
                      jax.tree.map(np.asarray, rparams), rtol=1e-4,
                      atol=1e-5)
    assert int(state["step"]) == int(rstate["step"]) == 5
    # the state crosses to the reference's layout and back bit for bit
    ref_state = opt_state_to_reference(model, state)
    for part, atol in (("mu", 1e-7), ("nu", 1e-12)):
        assert_tree_close(ref_state[part],
                          jax.tree.map(np.asarray, rstate[part]),
                          rtol=1e-4, atol=atol, where=part)
    back = opt_state_from_reference(model, ref_state)
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 5
    for part in ("mu", "nu"):
        assert list(back[part]) == list(state[part])
        for name in state[part]:
            assert torch.equal(back[part][name], state[part][name])


def test_init_train_state_and_tree_round_trips():
    """init_train_state draws the params and zero AdamW state; a
    per-parameter tree crosses to the reference's stacked layout and back
    bit for bit, in named_parameters order, and a wrong tree is refused."""
    cfg = ModelConfig(**base_kw("moe", **MOE_DROPS, dense_residual_ff=48))
    model, state = steps.init_train_state(
        cfg, AdamWConfig(), torch.Generator().manual_seed(0), device=CPU)
    names = [n for n, _ in model.named_parameters()]
    assert list(state["mu"]) == list(state["nu"]) == names
    assert int(state["step"]) == 0 and state["step"].dtype == torch.int32
    assert all(not v.any() for v in state["mu"].values())
    assert any(p.abs().sum() > 0 for p in model.parameters())
    rand = {n: torch.randn(p.shape, generator=torch.Generator()
                           .manual_seed(i)) for i, (n, p)
            in enumerate(model.named_parameters())}
    tree = tree_to_reference(model, rand)
    assert tree["layers"]["moe"]["dense"]["w_gate"].shape[0] == 2
    back = tree_from_reference(model, tree)
    assert list(back) == names
    assert all(torch.equal(back[n], rand[n]) for n in names)
    bad = dict(tree, layers=dict(tree["layers"], norm1=tree["layers"][
        "norm1"][:1]))
    with pytest.raises(ValueError):
        tree_from_reference(model, bad)
    with pytest.raises(ValueError):
        tree_from_reference(model, {k: v for k, v in tree.items()
                                    if k != "embed"})


# ------------------------------------------------------------ the driver
SMOKE = ["--arch", "llama3-8b", "--smoke", "--device", "cpu"]


def test_train_loss_decreases(tmp_path):
    losses = train.main(SMOKE + [
        "--steps", "25", "--batch", "4", "--seq", "64", "--lr", "1e-3",
        "--ckpt", str(tmp_path), "--ckpt-every", "10"])
    assert losses[-1] < losses[0]


RESTART = ["--arch", "llama3-8b", "--smoke", "--batch", "2", "--seq", "32",
           "--ckpt-every", "10", "--lr", "1e-3"]


def test_train_restart_resumes(tmp_path):
    """Simulated failure: run 12 steps, 'crash', rerun — it resumes from
    the step-12 checkpoint, runs steps 12..19, and their losses equal an
    uninterrupted 20-step run's bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    args = RESTART + ["--device", "cpu"]
    train.main(args + ["--ckpt", a, "--steps", "12"])
    assert CheckpointManager(a).latest_step() == 12
    losses = train.main(args + ["--ckpt", a, "--steps", "20"])
    assert len(losses) == 8
    whole = train.main(args + ["--ckpt", b, "--steps", "20"])
    assert losses == whole[12:]


def test_checkpoints_cross_between_the_packages(tmp_path, capsys):
    """The reference's driver writes 12 steps; the port resumes a copy to
    20 with the reference's own resumed losses (rtol=1e-4); then the
    reference resumes the port's step-20 checkpoint to 22 as it resumes
    its own."""
    from repro.launch import train as ref_train
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ref_train.main(RESTART + ["--ckpt", a, "--steps", "12"])
    shutil.copytree(a, b)
    capsys.readouterr()
    port = train.main(RESTART + ["--ckpt", a, "--steps", "20",
                                 "--device", "cpu"])
    assert "resumed from step 12" in capsys.readouterr().out
    ref = ref_train.main(RESTART + ["--ckpt", b, "--steps", "20"])
    assert len(port) == len(ref) == 8
    np.testing.assert_allclose(port, ref, rtol=1e-4)
    got = ref_train.main(RESTART + ["--ckpt", a, "--steps", "22"])
    assert "resumed from step 20" in capsys.readouterr().out
    want = ref_train.main(RESTART + ["--ckpt", b, "--steps", "22"])
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_checkpoint_is_the_reference_layout(tmp_path):
    """The checkpoint's leaf names are the reference's: params and the
    AdamW state stacked over the layers."""
    import json
    train.main(RESTART + ["--ckpt", str(tmp_path), "--steps", "1",
                          "--device", "cpu"])
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        names = json.load(f)["names"]
    rcfg = RefConfig(**train.get_config("llama3-8b", smoke=True).__dict__)
    model, params, opt = ref_steps.init_train_state(
        rcfg, RefAdamW(), jax.random.PRNGKey(0))
    tree = {"params": params, "opt": opt}
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = ["/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in paths]
    assert names == want


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "llama3-8b", "--smoke", "--steps", "1"])


def test_params_live_on_the_mesh_first_device(monkeypatch, capsys):
    """The port has no sharded tensor type: every param of the trained
    model lies on ``--device``, the one device of the printed mesh (the
    reference places them by ``tree_param_shardings``), whatever
    ``--max-model-axis`` says."""
    seen = {}
    make = train.make_train_step

    def spy(model, opt_cfg):
        seen["devices"] = {p.device for p in model.parameters()}
        return make(model, opt_cfg)

    monkeypatch.setattr(train, "make_train_step", spy)
    train.main(SMOKE + ["--steps", "1", "--batch", "2", "--seq", "8",
                        "--max-model-axis", "4"])
    assert seen["devices"] == {torch.device("cpu")}
    assert "mesh: (1, 1) ('data', 'model') (1 devices)" in \
        capsys.readouterr().out


def test_layers_cuts_depth_only(monkeypatch):
    """``--layers N`` trains the config's first N layers at its width, as
    the serve driver's flag does."""
    seen = {}
    make = train.make_train_step

    def spy(model, opt_cfg):
        seen["cfg"] = model.cfg
        seen["layers"] = len(model.layers)
        return make(model, opt_cfg)

    monkeypatch.setattr(train, "make_train_step", spy)
    train.main(SMOKE + ["--steps", "1", "--batch", "2", "--seq", "8",
                        "--layers", "1"])
    full = train.get_config("llama3-8b", smoke=True)
    assert seen["layers"] == seen["cfg"].n_layers == 1
    assert seen["cfg"] == full.replace(n_layers=1)
