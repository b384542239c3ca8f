"""The port's model zoo (``repro_torch.models``) against the reference
(``repro.models``): the dense and vlm cases of ``tests/test_models.py``
(decode == forward, GQA == repeated MHA, the sliding window, the vlm
prefix) on the port, and port == reference for ``forward``, ``prefill``
(logits and cache) and each ``decode_step`` on the same numpy-seeded
tokens, the reference's params carried across by
``repro_torch.models.convert``; greedy tokens equal.  Floats between the
two backends: ``rtol=1e-3, atol=1e-4`` on float32 configs."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.models import ModelConfig as RefConfig  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.attention import attn_forward as ref_attn_forward  # noqa
from repro.models.attention import init_attn as ref_init_attn  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models.attention import attn_forward  # noqa: E402
from repro_torch.models.convert import (cache_from_reference,  # noqa: E402
                                        cache_to_reference,
                                        params_from_reference,
                                        params_to_reference)
from repro_torch.models.frontends import (synthetic_frame_embeds,  # noqa
                                          synthetic_patch_embeds)

RTOL, ATOL = 1e-3, 1e-4
CPU = "cpu"


def base_kw(family, **kw):
    base = dict(name="t", family=family, n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=97,
                dtype="float32", remat=False)
    base.update(kw)
    return base


# the dense entries of test_models.py's FAMS
DENSE_FAMS = [
    ("dense", {}),
    ("dense", dict(attn_window=4, local_global_period=2,
                   attn_logit_softcap=50.0, final_logit_softcap=30.0,
                   post_block_norm=True, scale_embeddings=True,
                   act="gelu", tie_embeddings=True)),
]


def pair(family, seed=1, **kw):
    """(reference model, its params, the port's model holding them)."""
    ref = ref_build(RefConfig(**base_kw(family, **kw)))
    params = ref.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    port = params_from_reference(ModelConfig(**base_kw(family, **kw)), tree,
                                 device=CPU)
    return ref, params, port


def tokens(shape, vocab=97, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("fam,kw", DENSE_FAMS, ids=["plain", "gemma-like"])
def test_decode_matches_forward(fam, kw):
    """test_models.py's rule on the port: prefill + decode logits equal
    the forward's at 2e-3."""
    _, _, model = pair(fam, **kw)
    B, S = 2, 10
    tok = tokens((B, S))
    with torch.inference_mode():
        full, _ = model.forward(tok)
        pre = S - 3
        lg, cache = model.prefill(tok[:, :pre], max_len=S)
        close(lg, full[:, pre - 1], 2e-3, 2e-3)
        for t in range(pre, S):
            lg, cache = model.decode_step(cache, tok[:, t:t + 1])
            close(lg, full[:, t], 2e-3, 2e-3, f"{fam} step {t}")


@pytest.mark.parametrize("fam,kw", DENSE_FAMS +
                         [("vlm", dict(prefix_embeds=True, n_patches=4))],
                         ids=["plain", "gemma-like", "vlm"])
def test_port_matches_reference(fam, kw):
    """forward, prefill (logits and cache) and every decode step of the
    port equal the reference's on the same params and tokens, and greedy
    decoding picks the same tokens."""
    ref, params, model = pair(fam, **kw)
    B, S, pre = 2, 10, 6
    tok = tokens((B, S))
    pe = None
    if kw.get("prefix_embeds"):
        pe = (0.1 * np.random.default_rng(3).standard_normal(
            (B, 4, 32))).astype(np.float32)
    rpe = None if pe is None else jnp.asarray(pe)
    tpe = None if pe is None else torch.from_numpy(pe)
    P = 0 if pe is None else 4
    r_full, r_aux = ref.forward(params, jnp.asarray(tok), rpe)
    with torch.inference_mode():
        t_full, t_aux = model.forward(tok, tpe)
    assert t_full.shape == r_full.shape and t_full.dtype == torch.float32
    close(t_full, r_full)
    assert float(t_aux) == float(r_aux) == 0.0
    r_lg, r_cache = ref.prefill(params, jnp.asarray(tok[:, :pre]),
                                max_len=S + P, prefix_embeds=rpe)
    with torch.inference_mode():
        t_lg, t_cache = model.prefill(tok[:, :pre], S + P, tpe)
    close(t_lg, r_lg)
    for key in ("k", "v"):
        assert t_cache[key].shape == r_cache[key].shape
        close(t_cache[key], r_cache[key])
    assert int(t_cache["pos"]) == int(r_cache["pos"]) == pre + P
    r_tok = jnp.argmax(r_lg, axis=-1)[:, None].astype(jnp.int32)
    t_tok = torch.argmax(t_lg, dim=-1)[:, None].int()
    for t in range(S - pre):
        assert np.array_equal(np.asarray(r_tok), t_tok.numpy()), t
        r_lg, r_cache = ref.decode_step(params, r_cache, r_tok)
        with torch.inference_mode():
            t_lg, t_cache = model.decode_step(t_cache, t_tok)
        close(t_lg, r_lg, msg=f"step {t}")
        close(t_cache["k"], r_cache["k"])
        close(t_cache["v"], r_cache["v"])
        assert int(t_cache["pos"]) == int(r_cache["pos"])
        r_tok = jnp.argmax(r_lg, axis=-1)[:, None].astype(jnp.int32)
        t_tok = torch.argmax(t_lg, dim=-1)[:, None].int()


def test_decode_continues_from_a_reference_cache():
    """A reference prefill's cache, carried across, decodes in the port
    as it does in the reference; the cache round trip is exact."""
    ref, params, model = pair("dense")
    tok = tokens((2, 9))
    _, r_cache = ref.prefill(params, jnp.asarray(tok[:, :7]), max_len=9)
    tree = jax.tree.map(np.asarray, r_cache)
    cache = cache_from_reference(tree, device=CPU)
    back = cache_to_reference(cache)
    for key in ("k", "v", "pos"):
        assert back[key].dtype == tree[key].dtype
        assert np.array_equal(back[key], tree[key])
    r_lg, _ = ref.decode_step(params, r_cache, jnp.asarray(tok[:, 7:8]))
    with torch.inference_mode():
        t_lg, _ = model.decode_step(cache, tok[:, 7:8])
    close(t_lg, r_lg)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_param_round_trip_is_exact(param_dtype):
    """params_to_reference(params_from_reference(t)) == t bit for bit, and
    the port's tree has the reference's structure and dtypes."""
    pytest.importorskip("ml_dtypes")
    kw = dict(DENSE_FAMS[1][1], param_dtype=param_dtype)
    ref = ref_build(RefConfig(**base_kw("dense", **kw)))
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(5)))
    model = params_from_reference(ModelConfig(**base_kw("dense", **kw)),
                                  tree, device=CPU)
    back = params_to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert model.layers[0].attn["wq"].dtype == getattr(torch, param_dtype)
    assert model.layers[0].norm1.dtype == torch.float32


def test_converter_refuses_a_mismatched_tree():
    ref, params, _ = pair("dense")
    tree = jax.tree.map(np.asarray, params)
    cfg = ModelConfig(**base_kw("dense", d_ff=48))
    with pytest.raises(ValueError, match="layers.mlp"):
        params_from_reference(cfg, tree, device=CPU)
    tree.pop("lm_head")
    with pytest.raises(ValueError, match="reference keys"):
        params_from_reference(ModelConfig(**base_kw("dense")), tree,
                              device=CPU)


def test_init_draws_the_reference_distribution():
    """The port's initializers: each weight a truncated normal on [-2, 2]
    times min(0.02, fan_in ** -0.5) (std about 0.88 of that), as the
    reference's init draws, norms zero; the same generator seed gives the
    same params."""
    cfg = ModelConfig(**base_kw("dense", d_model=64, d_ff=256,
                                vocab_size=512))
    a = build_model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    b = build_model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    ref = ref_build(RefConfig(**base_kw("dense", d_model=64, d_ff=256,
                                        vocab_size=512)))
    rt = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    pt = params_to_reference(a)
    for (path, want), got, same in zip(
            jax.tree_util.tree_flatten_with_path(rt)[0],
            jax.tree.leaves(pt), jax.tree.leaves(params_to_reference(b))):
        assert np.array_equal(got, same)
        assert got.shape == want.shape and got.dtype == want.dtype
        if want.ndim < 2 or "norm" in jax.tree_util.keystr(path):
            assert not got.any() and not want.any()
            continue
        assert abs(got.std() / want.std() - 1) < 0.1, path
        assert np.abs(got).max() <= np.abs(want).max() * 1.2 + 1e-6


def test_gqa_equals_mha_when_kv_repeated():
    """GQA with duplicated kv heads == MHA with those heads, on the port
    with the reference's init_attn weights."""
    cfg_g = ModelConfig(**base_kw("dense", n_heads=4, n_kv_heads=2))
    cfg_m = ModelConfig(**base_kw("dense", n_heads=4, n_kv_heads=4))
    p = {k: torch.from_numpy(np.array(v)) for k, v in ref_init_attn(
        jax.random.PRNGKey(0), RefConfig(**base_kw("dense"))).items()}
    wk = p["wk"].reshape(32, 2, 8)
    wv = p["wv"].reshape(32, 2, 8)
    pm = {"wq": p["wq"], "wo": p["wo"],
          "wk": torch.stack([wk[:, 0], wk[:, 0], wk[:, 1], wk[:, 1]],
                            dim=1).reshape(32, 32),
          "wv": torch.stack([wv[:, 0], wv[:, 0], wv[:, 1], wv[:, 1]],
                            dim=1).reshape(32, 32)}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 6, 32)).astype(np.float32))
    pos = torch.arange(6, dtype=torch.int32).expand(2, 6)
    out_g = attn_forward(p, x, cfg_g, positions=pos, is_local=False)
    out_m = attn_forward(pm, x, cfg_m, positions=pos, is_local=False)
    close(out_g, out_m, 1e-4, 1e-5)
    want = ref_attn_forward({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                            jnp.asarray(x.numpy()),
                            RefConfig(**base_kw("dense")),
                            positions=jnp.asarray(pos.numpy()),
                            is_local=False)
    close(out_g, want)


def test_sliding_window_blocks_distant_positions():
    """A token outside the window cannot influence the output."""
    _, _, model = pair("dense", seed=0, attn_window=3,
                       local_global_period=None)
    tok = tokens((1, 10), seed=1)
    tok2 = tok.copy()
    tok2[0, 0] = (tok[0, 0] + 1) % 97  # perturb pos 0
    with torch.inference_mode():
        l1, _ = model.forward(tok)
        l2, _ = model.forward(tok2)
    # influence can propagate ~window per layer; with 2 layers, safe at >=7
    close(l1[0, 7:], l2[0, 7:], 1e-4, 1e-5)
    assert not np.allclose(l1[0, 0].numpy(), l2[0, 0].numpy())


def test_vlm_prefix_changes_text_logits():
    _, _, model = pair("vlm", seed=0, prefix_embeds=True, n_patches=4)
    tok = tokens((1, 6), seed=1)
    e1 = synthetic_patch_embeds(torch.Generator().manual_seed(2), 1, 4, 32)
    e2 = synthetic_patch_embeds(torch.Generator().manual_seed(3), 1, 4, 32)
    assert e1.shape == (1, 4, 32) and 0.01 < float(e1.std()) < 0.04
    frames = synthetic_frame_embeds(torch.Generator().manual_seed(2), 2, 12,
                                    32)
    assert frames.shape == (2, 12, 32) and 0.01 < float(frames.std()) < 0.04
    with torch.inference_mode():
        l1, _ = model.forward(tok, e1)
        l2, _ = model.forward(tok, e2)
    assert l1.shape == (1, 10, 97)
    assert not np.allclose(l1[:, 4:].numpy(), l2[:, 4:].numpy())


def test_entries_default_to_the_card():
    cfg = ModelConfig(**base_kw("dense"))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    meta = build_model(cfg, device="meta")
    assert meta.embed.device.type == "meta"


def test_cache_layout_equals_the_reference():
    """init_cache and cache_logical_axes: the reference's shapes, dtypes
    and axes ((L, B, T, KVH, D) k and v in the activation dtype, a scalar
    int32 pos)."""
    ref, params, model = pair("dense")
    want = jax.tree.map(np.asarray, ref.init_cache(3, 11))
    got = model.init_cache(3, 11)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not got[key].any()
    assert model.cache_logical_axes(got) == ref.cache_logical_axes(want)


@pytest.mark.parametrize("mode", ["kv_ready", "read_only"])
def test_attn_decode_options_match_the_reference(mode):
    """attn_decode's ``kv_ready`` mask and ``write=False`` (a static
    cache read without RoPE or update), as the encoder-decoder uses
    them, against the reference's."""
    from repro.models.attention import attn_decode as ref_decode
    from repro_torch.models.attention import attn_decode
    kw = dict(attn_window=3, attn_logit_softcap=50.0)
    rcfg, cfg = RefConfig(**base_kw("dense", **kw)), \
        ModelConfig(**base_kw("dense", **kw))
    p = jax.tree.map(np.array, ref_init_attn(jax.random.PRNGKey(4), rcfg))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    ck = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    cv = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    pos = np.array([4, 4], np.int32)
    opts = {"kv_ready": dict(kv_ready=np.array(
        [[1, 1, 0, 1, 1, 1, 1], [0, 1, 1, 1, 1, 0, 1]], bool)),
        "read_only": dict(write=False)}[mode]
    want = ref_decode({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                      jnp.asarray(pos), rcfg, is_local=True,
                      **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                         else v for k, v in opts.items()})
    got = attn_decode({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), torch.from_numpy(ck),
                      torch.from_numpy(cv), torch.from_numpy(pos), cfg,
                      is_local=True,
                      **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                         else v for k, v in opts.items()})
    for g, w in zip(got, want):
        close(g, w)
    if mode == "read_only":
        assert np.array_equal(got[1].numpy(), ck)
