"""The port's model zoo (``repro_torch.models``) against the reference
(``repro.models``): the cases of ``tests/test_models.py`` (decode ==
forward per family, the MoE dispatches agreeing with and without drops,
SSD == its recurrence, GQA == repeated MHA, the sliding window, the vlm
prefix) on the port, and port == reference for ``forward`` (logits and
the MoE aux loss), ``prefill`` (logits and every cache leaf) and each
``decode_step`` on the same numpy-seeded tokens, for the dense, vlm,
moe (both dispatches, with and without drops), ssm and hybrid families,
the reference's params carried across by ``repro_torch.models.convert``;
greedy tokens equal.  Floats between the two backends: ``rtol=1e-3,
atol=1e-4`` on float32 configs; decode == forward at 2e-3; SSD == its
recurrence at 3e-3.  The MoE's deliberate differences (a stable top-k,
the k-ordered combine) and the nested trees' and caches' round trips
have tests of their own.  Each reference run is made once per module."""

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
# its moe, ssm and hybrid entries
MOE_KW = dict(n_experts=4, top_k=2, capacity_factor=8.0, moe_group_size=8)
SSM_KW = dict(n_heads=0, n_kv_heads=1, head_dim=0, d_ff=0, ssm_state=16,
              ssm_head_dim=8, ssm_chunk=4)
HYBRID_KW = dict(ssm_state=16, ssm_head_dim=8, ssm_chunk=4)
FAMS = [("moe", MOE_KW), ("ssm", SSM_KW), ("hybrid", HYBRID_KW)]
# port == reference: each dispatch with and without drops (capacity
# factor 0.5 over groups of 16 drops tokens), arctic's dense residual,
# a ragged last SSD chunk (S = 10 over chunks of 4), the hybrid window
DROPS = dict(n_experts=4, top_k=2, capacity_factor=0.5, moe_group_size=16)
CASES = {
    "moe-onehot": ("moe", MOE_KW),
    "moe-scatter-dense": ("moe", dict(MOE_KW, moe_impl="scatter",
                                      dense_residual_ff=48)),
    "moe-onehot-drops": ("moe", DROPS),
    "moe-scatter-drops": ("moe", dict(DROPS, moe_impl="scatter")),
    "ssm": ("ssm", SSM_KW),
    "hybrid": ("hybrid", dict(HYBRID_KW, attn_window=4,
                              local_global_period=2)),
}


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


@pytest.mark.parametrize("fam,kw", DENSE_FAMS + FAMS,
                         ids=["plain", "gemma-like", "moe", "ssm", "hybrid"])
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


# ------------------------------------------------- moe, ssm and hybrid
B_REF, S_REF, PRE_REF = 2, 10, 6


def _reference_run(fam, kw):
    """The reference's params, forward, prefill and teacher-forced decode
    steps on numpy-seeded tokens (computed once per case and module)."""
    ref = ref_build(RefConfig(**base_kw(fam, **kw)))
    params = ref.init(jax.random.PRNGKey(1))
    tok = tokens((B_REF, S_REF))
    full, aux = ref.forward(params, jnp.asarray(tok))
    lg, cache = ref.prefill(params, jnp.asarray(tok[:, :PRE_REF]),
                            max_len=S_REF)
    run = {"tree": jax.tree.map(np.asarray, params), "tok": tok,
           "full": np.asarray(full), "aux": float(aux),
           "prefill": (np.asarray(lg), jax.tree.map(np.asarray, cache)),
           "steps": []}
    for t in range(PRE_REF, S_REF):
        lg, cache = ref.decode_step(params, cache,
                                    jnp.asarray(tok[:, t:t + 1]))
        run["steps"].append((np.asarray(lg), jax.tree.map(np.asarray,
                                                          cache)))
    return run


@pytest.fixture(scope="module")
def reference_runs():
    return {name: _reference_run(*case) for name, case in CASES.items()}


def port_of(fam, kw, tree):
    return params_from_reference(ModelConfig(**base_kw(fam, **kw)), tree,
                                 device=CPU)


def _close_cache(got, want, msg):
    assert set(got) == set(want), msg
    for key in want:
        if key == "pos":
            assert int(got[key]) == int(want[key]), msg
            continue
        assert tuple(got[key].shape) == want[key].shape, (msg, key)
        close(got[key], want[key], msg=f"{msg} {key}")


@pytest.mark.parametrize("case", list(CASES))
def test_family_matches_reference(case, reference_runs):
    """forward (logits and aux), prefill (logits and every cache leaf)
    and each teacher-forced decode step (logits and cache) of the port
    equal the reference's, for each moe dispatch with and without drops,
    ssm and hybrid."""
    fam, kw = CASES[case]
    run = reference_runs[case]
    model = port_of(fam, kw, run["tree"])
    tok = run["tok"]
    with torch.inference_mode():
        full, aux = model.forward(tok)
        close(full, run["full"])
        close(aux, run["aux"], msg="aux")
        assert (float(aux) > 0) == (fam == "moe")
        lg, cache = model.prefill(tok[:, :PRE_REF], S_REF)
        close(lg, run["prefill"][0])
        _close_cache(cache, run["prefill"][1], "prefill")
        for t, (r_lg, r_cache) in zip(range(PRE_REF, S_REF), run["steps"]):
            lg, cache = model.decode_step(cache, tok[:, t:t + 1])
            close(lg, r_lg, msg=f"step {t}")
            _close_cache(cache, r_cache, f"step {t}")


def test_greedy_tokens_equal_the_reference(reference_runs):
    """Greedy decoding from the hybrid prefill picks the reference's
    tokens (its logits held at every step as above)."""
    fam, kw = CASES["hybrid"]
    run = reference_runs["hybrid"]
    ref = ref_build(RefConfig(**base_kw(fam, **kw)))
    params = jax.tree.map(jnp.asarray, run["tree"])
    model = port_of(fam, kw, run["tree"])
    r_lg, r_cache = ref.prefill(params, jnp.asarray(run["tok"][:, :4]),
                                max_len=9)
    with torch.inference_mode():
        t_lg, t_cache = model.prefill(run["tok"][:, :4], 9)
    for t in range(5):
        r_tok = np.asarray(jnp.argmax(r_lg, axis=-1))[:, None]
        t_tok = torch.argmax(t_lg, dim=-1)[:, None]
        assert np.array_equal(r_tok, t_tok.numpy()), t
        r_lg, r_cache = ref.decode_step(params, r_cache,
                                        jnp.asarray(r_tok, jnp.int32))
        with torch.inference_mode():
            t_lg, t_cache = model.decode_step(t_cache, t_tok)
        close(t_lg, r_lg, msg=f"step {t}")


def _moe_logits(impl, kw, tok):
    """test_models.py's MoE forward for one dispatch, on the port and the
    reference, with the same (reference-drawn) params."""
    ref = ref_build(RefConfig(**base_kw("moe", **kw, moe_impl=impl)))
    params = ref.init(jax.random.PRNGKey(1))
    model = port_of("moe", dict(kw, moe_impl=impl),
                    jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        got = model.forward(tok)[0].numpy()
    return got, np.asarray(ref.forward(params, jnp.asarray(tok))[0])


def test_moe_impls_agree_no_drop():
    tok = tokens((2, 12), seed=0)
    outs = {impl: _moe_logits(impl, MOE_KW, tok)
            for impl in ("onehot", "scatter")}
    close(outs["onehot"][0], outs["scatter"][0], 1e-4, 1e-4)
    for impl, (got, want) in outs.items():
        close(got, want, msg=impl)


def test_moe_drops_are_consistent_between_impls():
    """Under capacity pressure both dispatches drop the same tokens
    (arrival order within the group), and each drops the reference's:
    one layer's output equals the reference's, per dispatch, and the
    drops are real (some slot is over capacity)."""
    from repro.models.moe import _group as ref_group
    from repro.models.moe import _router as ref_router
    from repro.models.moe import moe_forward as ref_moe
    from repro_torch.models.moe import _group, _router, moe_forward
    tok = tokens((2, 16), seed=3)
    outs = {impl: _moe_logits(impl, DROPS, tok)
            for impl in ("onehot", "scatter")}
    close(outs["onehot"][0], outs["scatter"][0], 1e-4, 1e-4)
    for impl, (got, want) in outs.items():
        close(got, want, msg=impl)
    x = np.random.default_rng(4).standard_normal((2, 16, 32)).astype(
        np.float32)
    rcfg = RefConfig(**base_kw("moe", **DROPS))
    cfg = ModelConfig(**base_kw("moe", **DROPS))
    G, Tg, C = _group(cfg, 32)
    assert (G, Tg, C) == ref_group(rcfg, 32) == (2, 16, 8)
    tree = ref_build(rcfg).init(jax.random.PRNGKey(1))["layers"]["moe"]
    p_ref = jax.tree.map(lambda a: a[0], tree)
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    _, idx, _ = _router(p, torch.from_numpy(x).reshape(G, Tg, 32), cfg)
    _, r_idx, _ = ref_router(p_ref, jnp.asarray(x).reshape(G, Tg, 32),
                             rcfg)
    assert np.array_equal(idx.numpy(), np.asarray(r_idx))
    per_expert = torch.stack([torch.bincount(g.flatten(), minlength=4)
                              for g in idx])
    assert (per_expert > C).any()  # drops happen
    for impl in ("onehot", "scatter"):
        got, aux = moe_forward(p, torch.from_numpy(x),
                               cfg.replace(moe_impl=impl))
        want, r_aux = ref_moe(p_ref, jnp.asarray(x),
                              rcfg.replace(moe_impl=impl))
        close(got, want, msg=impl)
        close(aux, r_aux)


def test_ssd_matches_naive_recurrence():
    """Chunked SSD == step-by-step linear recurrence (the SSM's oracle),
    on the port, with a ragged last chunk; the chunked form equals the
    reference's."""
    from repro.models.ssm import init_ssm as ref_init_ssm
    from repro.models.ssm import ssm_forward as ref_ssm_forward
    from repro_torch.models.ssm import ssm_decode, ssm_forward
    kw = dict(SSM_KW, ssm_state=8)
    cfg, rcfg = ModelConfig(**base_kw("ssm", **kw)), \
        RefConfig(**base_kw("ssm", **kw))
    p_ref = ref_init_ssm(jax.random.PRNGKey(0), rcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    B, S, D = 2, 11, cfg.d_model
    x = (0.5 * np.random.default_rng(1).standard_normal((B, S, D))).astype(
        np.float32)
    xt = torch.from_numpy(x)
    y_chunked = ssm_forward(p, xt, cfg)
    close(y_chunked, ref_ssm_forward(p_ref, jnp.asarray(x), rcfg))
    conv = torch.zeros((B, cfg.ssm_conv - 1, cfg.conv_dim))
    state = torch.zeros((B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
    ys = []
    for t in range(S):
        y, conv, state = ssm_decode(p, xt[:, t:t + 1], conv, state, cfg)
        ys.append(y)
    close(y_chunked, torch.cat(ys, dim=1), 3e-3, 3e-3)
    # the prefill state continues the recurrence
    _, st = ssm_forward(p, xt, cfg, return_state=True)
    close(st["state"], state, 3e-3, 3e-3)
    close(st["conv"], conv, 0, 0)


@pytest.mark.parametrize("S", [2, 5])
def test_ssm_prefill_state_matches_the_reference(S):
    """``return_state``'s conv tail (zero-padded when S < K - 1) and final
    state equal the reference's."""
    from repro.models.ssm import init_ssm as ref_init_ssm
    from repro.models.ssm import ssm_forward as ref_ssm_forward
    from repro_torch.models.ssm import ssm_forward
    cfg, rcfg = ModelConfig(**base_kw("ssm", **SSM_KW)), \
        RefConfig(**base_kw("ssm", **SSM_KW))
    p_ref = ref_init_ssm(jax.random.PRNGKey(2), rcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    x = np.random.default_rng(S).standard_normal((2, S, 32)).astype(
        np.float32)
    y, st = ssm_forward(p, torch.from_numpy(x), cfg, return_state=True)
    r_y, r_st = ref_ssm_forward(p_ref, jnp.asarray(x), rcfg,
                                return_state=True)
    close(y, r_y)
    for key in ("conv", "state"):
        assert tuple(st[key].shape) == r_st[key].shape
        assert str(st[key].dtype).split(".")[-1] == str(r_st[key].dtype)
        close(st[key], r_st[key])
    if S < cfg.ssm_conv - 1:
        assert not st["conv"][:, :cfg.ssm_conv - 1 - S].any()


def test_scatter_combine_is_bit_identical_and_k_ordered():
    """The scatter dispatch's combine: two calls give the same bits, and
    the output is each token's k slots added in slot order from zero (the
    reference's scatter-add, with no atomics)."""
    from repro_torch.models import moe
    cfg = ModelConfig(**base_kw("moe", **DROPS, moe_impl="scatter"))
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(1))
    G, Tg, C = moe._group(cfg, 32)
    xg = x.reshape(G, Tg, 32)
    gates, idx, _ = moe._router(p, xg, cfg)
    a = moe._dispatch_scatter(p, xg, gates, idx, cfg, C)
    b = moe._dispatch_scatter(p, xg, gates, idx, cfg, C)
    assert torch.equal(a, b)
    # the same sum written out: token t's slot j, kept or dropped
    want = torch.zeros_like(a)
    for g in range(G):
        seen = torch.zeros(4, dtype=torch.long)
        slots = []
        for t in range(Tg):
            for j in range(2):
                e = int(idx[g, t, j])
                slots.append((t, j, e, int(seen[e])))
                seen[e] += 1
        buf = torch.zeros(4, C, 32)
        for t, j, e, pos in slots:
            if pos < C:
                buf[e, pos] = xg[g, t]
        y = moe._expert_glu(p, buf[None], cfg)[0]
        for t in range(Tg):
            acc = torch.zeros(32)
            for j in range(2):
                _, _, e, pos = slots[t * 2 + j]
                v = y[e, pos] * gates[g, t, j] if pos < C \
                    else torch.zeros(32)
                acc = acc + v
            want[g, t] = acc
    assert torch.equal(a, want)


def test_top_k_takes_the_lower_index_among_ties():
    """The port's top-k is lax.top_k's: the k largest, the lower index
    first among equal values (torch.topk promises no order there)."""
    from repro_torch.models.moe import top_k
    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.0],
                  [0.2, 0.2, 0.2, 0.2, 0.2],
                  [0.1, 0.3, 0.3, 0.3, 0.0]], np.float32)
    for k in (1, 2, 3):
        vals, idx = top_k(torch.from_numpy(x), k)
        r_vals, r_idx = jax.lax.top_k(jnp.asarray(x), k)
        assert np.array_equal(idx.numpy(), np.asarray(r_idx)), k
        assert np.array_equal(vals.numpy(), np.asarray(r_vals)), k


def test_router_runs_in_float32_from_bf16_weights():
    """A bf16 config casts the float32 router to bf16 (the reference's
    ``_cast``); the router then computes in float32 on the upcast values,
    as jnp's promotion does: the same expert ids and gates."""
    from repro.models.moe import _router as ref_router
    from repro_torch.models.moe import _router
    kw = dict(MOE_KW, dtype="bfloat16")
    rcfg, cfg = RefConfig(**base_kw("moe", **kw)), \
        ModelConfig(**base_kw("moe", **kw))
    router = jax.random.normal(jax.random.PRNGKey(0), (32, 4)).astype(
        jnp.bfloat16)
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 8, 32)).astype(
        jnp.bfloat16)
    r_gates, r_idx, r_aux = ref_router({"router": router}, x, rcfg)
    as_t = {"router": torch.from_numpy(np.asarray(router).astype(
        np.float32)).to(torch.bfloat16)}
    gates, idx, aux = _router(as_t, torch.from_numpy(np.asarray(x).astype(
        np.float32)).to(torch.bfloat16), cfg)
    assert gates.dtype == torch.float32
    assert np.array_equal(idx.numpy(), np.asarray(r_idx))
    close(gates, r_gates, 1e-6, 1e-7)
    close(aux, r_aux, 1e-6, 1e-7)


NESTED = {"moe-dense": ("moe", dict(MOE_KW, dense_residual_ff=48)),
          "ssm": ("ssm", SSM_KW), "hybrid": ("hybrid", HYBRID_KW)}


@pytest.mark.parametrize("case", list(NESTED))
def test_nested_param_round_trip_is_exact(case):
    """The nested trees (``layers.moe.dense.w_gate``,
    ``layers.mix.attn.wq``) cross both ways bit for bit in bf16, with
    the reference's structure and dtypes (the router, the SSM's vectors
    and the hybrid gate float32)."""
    pytest.importorskip("ml_dtypes")
    fam, kw = NESTED[case]
    kw = dict(kw, param_dtype="bfloat16")
    ref = ref_build(RefConfig(**base_kw(fam, **kw)))
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(5)))
    model = params_from_reference(ModelConfig(**base_kw(fam, **kw)), tree,
                                  device=CPU)
    back = params_to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    if fam == "moe":
        assert model.layers[1].get_parameter(
            "moe.dense.w_gate").dtype == torch.bfloat16
        assert model.layers[0].moe["router"].dtype == torch.float32
    if fam == "hybrid":
        assert model.layers[0].mix["gate"].dtype == torch.float32
        assert model.layers[0].mix["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["moe-onehot", "ssm", "hybrid"])
def test_cache_round_trip_per_layout(case, reference_runs):
    """A reference cache of each layout (k/v; conv/state; all four)
    crosses both ways bit for bit, and the port decodes on from it as
    the reference does; a layout of neither is refused."""
    fam, kw = CASES[case]
    run = reference_runs[case]
    tree = run["prefill"][1]
    cache = cache_from_reference(tree, device=CPU)
    back = cache_to_reference(cache)
    assert set(back) == set(tree)
    for key in tree:
        assert back[key].dtype == tree[key].dtype
        assert np.array_equal(back[key], tree[key])
    model = port_of(fam, kw, run["tree"])
    with torch.inference_mode():
        lg, _ = model.decode_step(cache, run["tok"][:, PRE_REF:PRE_REF + 1])
    close(lg, run["steps"][0][0])
    with pytest.raises(ValueError, match="layouts"):
        cache_from_reference({"k": tree.get("k", 0), "pos": 0}, device=CPU)


@pytest.mark.parametrize("fam", ["moe", "ssm", "hybrid"])
def test_family_cache_layout_equals_the_reference(fam):
    """init_cache and cache_logical_axes for each family: the reference's
    keys, shapes, dtypes (the ssm state float32) and axes."""
    kw = dict(FAMS)[fam]
    ref = ref_build(RefConfig(**base_kw(fam, **kw)))
    model = build_model(ModelConfig(**base_kw(fam, **kw)), device=CPU)
    want = jax.tree.map(np.asarray, ref.init_cache(3, 11))
    got = model.init_cache(3, 11)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not got[key].any()
    assert model.cache_logical_axes(got) == ref.cache_logical_axes(want)


@pytest.mark.parametrize("fam", ["moe", "ssm", "hybrid"])
def test_family_init_draws_the_reference_distribution(fam):
    """The port's init for each family: the reference's shapes, dtypes and
    structure, each weight the reference's truncated normal (std within
    10 %), the constants as the reference sets them (``A_log`` 0, ``D``
    1, ``dt_bias`` 0.5, zero ``conv_b``, ``norm_w``, norms and gate); the
    same seed gives the same params."""
    kw = dict(dict(FAMS)[fam], d_model=64, d_ff=256, vocab_size=512)
    if fam == "moe":
        kw["dense_residual_ff"] = 128
    cfg = ModelConfig(**base_kw(fam, **kw))
    a = build_model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    b = build_model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    ref = ref_build(RefConfig(**base_kw(fam, **kw)))
    rt = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    pt = params_to_reference(a)
    assert jax.tree.structure(pt) == jax.tree.structure(rt)
    consts = {"A_log": 0.0, "D": 1.0, "dt_bias": 0.5, "conv_b": 0.0,
              "norm_w": 0.0, "gate": 0.0}
    for (path, want), got, same in zip(
            jax.tree_util.tree_flatten_with_path(rt)[0],
            jax.tree.leaves(pt), jax.tree.leaves(params_to_reference(b))):
        name = jax.tree_util.keystr(path)
        assert np.array_equal(got, same)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        leaf = str(getattr(path[-1], "key", ""))
        if leaf in consts or "norm" in name:
            assert (got == consts.get(leaf, 0.0)).all(), name
            assert np.array_equal(got, want), name
            continue
        assert abs(got.std() / want.std() - 1) < 0.1, name
        assert np.abs(got).max() <= np.abs(want).max() * 1.2 + 1e-6


def test_models_use_no_order_dependent_scatter():
    """No model path adds floats by an order-dependent scatter
    (``index_add_``, ``index_put_(accumulate=True)``: atomics on a CUDA
    tensor)."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1] / "src/repro_torch/models"
    for path in sorted(root.glob("*.py")):
        text = path.read_text()
        assert "index_add" not in text and "accumulate=True" not in text, \
            path.name


def test_bf16_ssm_is_no_further_from_float32_than_the_reference():
    """The SSM mixer in bf16 computes its elementwise chains in float32
    (a deliberate difference; in float32 it is the reference's
    computation): its bf16 output stays at least as close to the float32
    result as the reference's own bf16 does, in the chunked forward and
    in the decode."""
    from repro.models.ssm import init_ssm as ref_init_ssm
    from repro.models.ssm import ssm_decode as ref_ssm_decode
    from repro.models.ssm import ssm_forward as ref_ssm_forward
    from repro_torch.models.ssm import ssm_decode, ssm_forward
    kw = dict(SSM_KW, n_layers=1, d_model=128, ssm_state=32,
              ssm_head_dim=32, ssm_chunk=16, dtype="bfloat16",
              param_dtype="bfloat16")
    rcfg, cfg = RefConfig(**base_kw("ssm", **kw)), \
        ModelConfig(**base_kw("ssm", **kw))
    r32 = rcfg.replace(dtype="float32", param_dtype="float32")
    p = ref_init_ssm(jax.random.PRNGKey(0), rcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 40, 128)).astype(
        jnp.bfloat16)

    def f32(a):
        return jax.tree.map(lambda t: t.astype(jnp.float32), a)

    def to_t(a):
        a = np.array(a.astype(jnp.float32))
        return torch.from_numpy(a).to(torch.bfloat16)

    tp = {k: to_t(v) if v.dtype == jnp.bfloat16 else torch.from_numpy(
        np.array(v)) for k, v in p.items()}

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    want = np.asarray(ref_ssm_forward(f32(p), x.astype(jnp.float32), r32))
    ref_bf = jax.jit(lambda p, x: ref_ssm_forward(p, x, rcfg))(p, x)
    got = ssm_forward(tp, to_t(x), cfg)
    assert got.dtype == torch.bfloat16
    e_port = rel(got.float().numpy(), want)
    e_ref = rel(np.asarray(ref_bf.astype(jnp.float32)), want)
    assert 0 < e_port <= e_ref, (e_port, e_ref)
    # one decode step from a random state
    xs = x[:, :1]
    conv = jax.random.normal(jax.random.PRNGKey(2), (2, 3, cfg.conv_dim)
                             ).astype(jnp.bfloat16)
    st = jax.random.normal(jax.random.PRNGKey(3), (2, cfg.ssm_heads, 32, 32))
    want = np.asarray(ref_ssm_decode(f32(p), xs.astype(jnp.float32),
                                     conv.astype(jnp.float32), st, r32)[0])
    ref_bf = ref_ssm_decode(p, xs, conv, st, rcfg)[0]
    got = ssm_decode(tp, to_t(xs), to_t(conv),
                     torch.from_numpy(np.array(st)), cfg)[0]
    e_port = rel(got.float().numpy(), want)
    e_ref = rel(np.asarray(ref_bf.astype(jnp.float32)), want)
    assert 0 < e_port <= e_ref, (e_port, e_ref)
