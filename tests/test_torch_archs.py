"""The port's arch registry and the per-arch smoke decode, against the
reference's ``tests/test_archs.py``: every arch's config equals the
reference's field for field (full, smoke and ``optimized=True``), and
all ten archs (every family: dense, vlm, moe, ssm, hybrid and audio)
prefill and decode at their smoke configs with the reference's params
carried across (port == reference on the logits) and with the port's
own init.  ``configs/radic_paper.py`` equals the reference's but for
its ``backend``."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import PORTED_FAMILIES, build_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

B, S = 2, 16
ARCHS = registry.list_archs()
PORTED = [a for a in ARCHS
          if registry.get_config(a).family in PORTED_FAMILIES + ("audio",)]


def test_registry_equals_the_reference():
    assert registry.ARCHS == ref_registry.ARCHS
    assert registry.OPTIMIZED_OVERRIDES == ref_registry.OPTIMIZED_OVERRIDES
    assert ARCHS == ref_registry.list_archs()
    assert PORTED == ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("gpt-5")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["full", "smoke", "optimized"])
def test_config_equals_the_reference(arch, kind):
    kw = {"full": {}, "smoke": dict(smoke=True),
          "optimized": dict(optimized=True)}[kind]
    got = registry.get_config(arch, **kw)
    want = ref_registry.get_config(arch, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("qdim", "kvdim", "d_inner", "ssm_heads", "conv_dim"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert [got.is_local_layer(i) for i in range(got.n_layers)] == \
        [want.is_local_layer(i) for i in range(want.n_layers)]
    assert str(got.pdtype).split(".")[-1] == str(want.pdtype)
    assert str(got.adtype).split(".")[-1] == str(want.adtype)


def _batch(cfg):
    """test_archs.py's batch, made from the same jax keys."""
    kt, kp = jax.random.split(jax.random.PRNGKey(7))
    batch = {"tokens": np.array(
        jax.random.randint(kt, (B, S), 0, cfg.vocab_size))}
    if cfg.prefix_embeds:
        batch["prefix_embeds"] = np.array(0.02 * jax.random.normal(
            kp, (B, cfg.n_patches, cfg.d_model), jnp.float32))
    if cfg.family == "audio":
        batch["frame_embeds"] = np.array(0.02 * jax.random.normal(
            kp, (B, cfg.n_frames, cfg.d_model), jnp.float32))
    return batch


def _port_steps(model, cfg, tb, max_len):
    """test_archs.py's smoke decode on the port: the prefill step (audio:
    the warm cross cache) and one decode step."""
    if cfg.family == "audio":
        cache = model.warm_cross_cache(model.init_cache(B, max_len),
                                       tb["frame_embeds"])
    else:
        _, cache = make_prefill_step(model, max_len)(tb)
        assert int(cache["pos"]) == max_len - 4
    return make_decode_step(model)(cache, {"tokens": tb["tokens"][:, :1]})


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_decode(arch):
    """test_archs.py's smoke decode on the port: the prefill step and a
    decode step give finite (B, V) logits, equal to the reference's on
    the same params and batch."""
    cfg = registry.get_config(arch, smoke=True)
    assert cfg.family == registry.get_config(arch).family
    ref = ref_build(ref_registry.get_config(arch, smoke=True))
    params = ref.init(jax.random.PRNGKey(0))
    model = params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    batch = _batch(cfg)
    max_len = S + (cfg.n_patches if cfg.prefix_embeds else 0) + 4
    rb = jax.tree.map(jnp.asarray, batch)
    if cfg.family == "audio":
        r_cache = ref.warm_cross_cache(params, ref.init_cache(B, max_len),
                                       rb["frame_embeds"])
    else:
        _, r_cache = ref_steps.make_prefill_step(ref, max_len)(params, rb)
    r_logits, _ = ref_steps.make_decode_step(ref)(
        params, r_cache, {"tokens": rb["tokens"][:, :1]})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        logits, _ = _port_steps(model, cfg, tb, max_len)
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_decode_from_the_ports_init(arch):
    """The same steps on params the port draws itself."""
    cfg = registry.get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    max_len = S + (cfg.n_patches if cfg.prefix_embeds else 0) + 4
    with torch.inference_mode():
        logits, cache = _port_steps(model, cfg, tb, max_len)
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert int(cache["pos"]) == (1 if cfg.family == "audio"
                                 else max_len - 3)


def test_radic_paper_config_equals_the_reference():
    """``RadicConfig`` copied as data: the reference's fields, defaults
    and smoke config, ``backend`` the one deliberate difference (the
    port's ``"cuda"`` for the reference's ``"pallas"``)."""
    import dataclasses as dc

    from repro.configs import radic_paper as ref_rp
    from repro_torch.configs import radic_paper as rp
    assert [f.name for f in dc.fields(rp.RadicConfig)] == \
        [f.name for f in dc.fields(ref_rp.RadicConfig)]
    got, want = dc.asdict(rp.CONFIG), dc.asdict(ref_rp.CONFIG)
    assert (got.pop("backend"), want.pop("backend")) == ("cuda", "pallas")
    assert got == want
    got, want = dc.asdict(rp.smoke()), dc.asdict(ref_rp.smoke())
    assert got.pop("backend") == "cuda" and want.pop("backend") == "pallas"
    assert got == want
    assert rp.RadicConfig.__dataclass_params__.frozen
