"""The serving knobs of ``tests/test_perf_knobs.py`` on the port: the
``dus`` cache update equals ``onehot`` (and the reference's), and the
KV-chunked online softmax equals dense attention, with the window and
the logit softcap too; on the hybrid, moe and audio families the two
knobs together equal the reference under the same knobs.  The loss
knobs wait for the training slice."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.models import ModelConfig as RefConfig  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models.convert import load_reference  # noqa: E402

BASE = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=97,
            dtype="float32", remat=False)


def port(tree, **kw):
    return load_reference(build_model(ModelConfig(**BASE, **kw),
                                      device="cpu"), tree)


@pytest.fixture(scope="module")
def setup():
    ref = ref_build(RefConfig(**BASE))
    params = ref.init(jax.random.PRNGKey(1))
    tok = np.random.default_rng(0).integers(0, 97, size=(2, 12))
    return ref, params, jax.tree.map(np.asarray, params), tok


def test_dus_cache_update_matches_onehot_and_forward(setup):
    ref, params, tree, tok = setup
    m, md = port(tree), port(tree, cache_update="dus")
    rd = ref_build(RefConfig(**BASE, cache_update="dus"))
    with torch.inference_mode():
        full, _ = m.forward(tok)
        lg, cache = m.prefill(tok[:, :9], max_len=12)
        lgd, cached = md.prefill(tok[:, :9], max_len=12)
        r_lg, r_cache = rd.prefill(params, jnp.asarray(tok[:, :9]),
                                   max_len=12)
        for t in range(9, 12):
            lg, cache = m.decode_step(cache, tok[:, t:t + 1])
            lgd, cached = md.decode_step(cached, tok[:, t:t + 1])
            r_lg, r_cache = rd.decode_step(params, r_cache,
                                           jnp.asarray(tok[:, t:t + 1]))
            np.testing.assert_allclose(lgd.numpy(), full[:, t].numpy(),
                                       rtol=2e-3, atol=2e-3)
            np.testing.assert_allclose(lgd.numpy(), np.asarray(r_lg),
                                       rtol=1e-3, atol=1e-4)
            # a one-hot blend and a slice write hold the same cache
            assert torch.equal(cached["k"], cache["k"])
            assert torch.equal(cached["v"], cache["v"])
            np.testing.assert_allclose(lgd.numpy(), lg.numpy(), rtol=1e-6,
                                       atol=1e-6)
    np.testing.assert_allclose(cached["k"].numpy(), np.asarray(r_cache["k"]),
                               rtol=1e-3, atol=1e-4)


def test_onehot_leaves_the_given_cache_and_dus_writes_it(setup):
    _, _, tree, tok = setup
    for mode, kept in (("onehot", True), ("dus", False)):
        m = port(tree, cache_update=mode)
        with torch.inference_mode():
            _, cache = m.prefill(tok[:, :9], max_len=12)
            before = cache["k"].clone()
            _, new = m.decode_step(cache, tok[:, 9:10])
        assert torch.equal(cache["k"], before) is kept, mode
        assert (new["k"] is cache["k"]) is not kept, mode
        assert int(new["pos"]) == 10 and int(cache["pos"]) == 9


@pytest.mark.parametrize("chunk", [4, 5, 12, 32])
def test_chunked_attention_matches_dense(setup, chunk):
    ref, params, tree, tok = setup
    with torch.inference_mode():
        full, _ = port(tree).forward(tok)
        lc, _ = port(tree, attn_chunk=chunk).forward(tok)
    np.testing.assert_allclose(full.numpy(), lc.numpy(), rtol=2e-4,
                               atol=2e-4)
    rc = ref_build(RefConfig(**BASE, attn_chunk=chunk))
    r_lc, _ = rc.forward(params, jnp.asarray(tok))
    np.testing.assert_allclose(lc.numpy(), np.asarray(r_lc), rtol=1e-3,
                               atol=1e-4)


def test_chunked_attention_with_window_softcap():
    kw = dict(attn_window=4, local_global_period=2, attn_logit_softcap=50.0)
    r1 = ref_build(RefConfig(**BASE, **kw))
    params = r1.init(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, params)
    tok = np.random.default_rng(0).integers(0, 97, size=(2, 13))
    with torch.inference_mode():
        l1, _ = port(tree, **kw).forward(tok)
        l2, _ = port(tree, attn_chunk=4, **kw).forward(tok)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=2e-4, atol=2e-4)
    r2 = ref_build(RefConfig(**BASE, attn_chunk=4, **kw))
    rl, _ = r2.forward(params, jnp.asarray(tok))
    np.testing.assert_allclose(l2.numpy(), np.asarray(rl), rtol=1e-3,
                               atol=1e-4)


def test_chunked_prefill_and_decode_match_forward():
    """The window masks past the window in a chunked prefill and in
    decode alike (the forward's ``rel < window`` against decode's
    ``tpos > pos - window``)."""
    kw = dict(attn_window=4, local_global_period=2, attn_logit_softcap=50.0,
              final_logit_softcap=30.0)
    tree = jax.tree.map(np.asarray, ref_build(RefConfig(**BASE, **kw)).init(
        jax.random.PRNGKey(2)))
    tok = np.random.default_rng(1).integers(0, 97, size=(2, 14))
    with torch.inference_mode():
        full, _ = port(tree, **kw).forward(tok)
        m = port(tree, attn_chunk=5, **kw)
        lg, cache = m.prefill(tok[:, :10], max_len=14)
        np.testing.assert_allclose(lg.numpy(), full[:, 9].numpy(),
                                   rtol=2e-3, atol=2e-3)
        for t in range(10, 14):
            lg, cache = m.decode_step(cache, tok[:, t:t + 1])
            np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                       rtol=2e-3, atol=2e-3)


FAMILY_KNOBS = {
    "hybrid": dict(family="hybrid", ssm_state=16, ssm_head_dim=8,
                   ssm_chunk=4, attn_window=4, local_global_period=2),
    "moe": dict(family="moe", n_experts=4, top_k=2, capacity_factor=8.0,
                moe_group_size=8, moe_impl="onehot"),
    "audio": dict(family="audio", n_enc_layers=2, enc_dec=True,
                  n_frames=6),
}


@pytest.mark.parametrize("fam", list(FAMILY_KNOBS))
def test_serving_knobs_per_family(fam):
    """The serving knobs of the registry's optimized sets on the other
    families: ``attn_chunk`` (the chunked online softmax; for audio the
    bidirectional encoder and the cross attention too) with ``dus``
    equals the reference under the same knobs, forward and decode."""
    kw = dict(BASE, **FAMILY_KNOBS[fam], attn_chunk=4, cache_update="dus")
    ref = ref_build(RefConfig(**kw))
    params = ref.init(jax.random.PRNGKey(3))
    m = load_reference(build_model(ModelConfig(**kw), device="cpu"),
                       jax.tree.map(np.asarray, params))
    tok = np.random.default_rng(2).integers(0, 97, size=(2, 9))
    args, r_args = (), ()
    if fam == "audio":
        fr = (0.5 * np.random.default_rng(3).standard_normal(
            (2, 6, 32))).astype(np.float32)
        args, r_args = (torch.from_numpy(fr),), (jnp.asarray(fr),)
    r_full, _ = ref.forward(params, jnp.asarray(tok), *r_args)
    with torch.inference_mode():
        full, _ = m.forward(tok, *args)
    np.testing.assert_allclose(full.numpy(), np.asarray(r_full), rtol=1e-3,
                               atol=1e-4)
    if fam == "audio":
        r_cache = ref.warm_cross_cache(params, ref.init_cache(2, 9),
                                       r_args[0])
        cache = m.warm_cross_cache(m.init_cache(2, 9), args[0])
        start = 0
    else:
        _, r_cache = ref.prefill(params, jnp.asarray(tok[:, :6]), max_len=9)
        with torch.inference_mode():
            _, cache = m.prefill(tok[:, :6], max_len=9)
        start = 6
    for t in range(start, 9):
        r_lg, r_cache = ref.decode_step(params, r_cache,
                                        jnp.asarray(tok[:, t:t + 1]))
        with torch.inference_mode():
            lg, cache = m.decode_step(cache, tok[:, t:t + 1])
        np.testing.assert_allclose(lg.numpy(), np.asarray(r_lg), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)
