"""The port's encoder–decoder (``repro_torch.models.encdec.EncDecLM``,
the audio family) against the reference's (``repro.models.encdec``):
``encode``, the teacher-forced ``forward``, ``warm_cross_cache`` and
each ``decode_step`` (logits and cache) equal the reference's at
``rtol=1e-3, atol=1e-4`` on a float32 config with the reference's params
carried across by ``repro_torch.models.convert``; the forced decode
equals the forward at 2e-3 (the reference's decode rule); the param tree
and the cache cross both ways bit for bit; the layout, the axes, the
initializers and the audio prefill step are the reference's.  The
reference runs once per module."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import ModelConfig as RefConfig  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import EncDecLM, ModelConfig, build_model  # noqa
from repro_torch.models.convert import (cache_from_reference,  # noqa: E402
                                        cache_to_reference,
                                        params_from_reference,
                                        params_to_reference)

RTOL, ATOL = 1e-3, 1e-4
CPU = "cpu"
KW = dict(name="t", family="audio", n_layers=2, n_enc_layers=2, d_model=32,
          n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=97,
          enc_dec=True, n_frames=6, act="gelu", dtype="float32",
          remat=False)
B, S = 2, 8


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def run():
    """The reference's params, encoder memory, forward, warm cache and
    forced decode steps on numpy-seeded frames and tokens."""
    ref = ref_build(RefConfig(**KW))
    params = ref.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    frames = (0.5 * rng.standard_normal((B, 6, 32))).astype(np.float32)
    tok = rng.integers(0, 97, size=(B, S))
    fr = jnp.asarray(frames)
    cache = ref.warm_cross_cache(params, ref.init_cache(B, S), fr)
    out = {"ref": ref, "params": params, "frames": frames, "tok": tok,
           "tree": jax.tree.map(np.asarray, params),
           "memory": np.asarray(ref.encode(ref._cast(params), fr)),
           "full": np.asarray(ref.forward(params, jnp.asarray(tok), fr)[0]),
           "warm": jax.tree.map(np.asarray, cache), "steps": []}
    for t in range(S):
        lg, cache = ref.decode_step(params, cache,
                                    jnp.asarray(tok[:, t:t + 1]))
        out["steps"].append((np.asarray(lg), jax.tree.map(np.asarray,
                                                          cache)))
    return out


@pytest.fixture(scope="module")
def model(run):
    return params_from_reference(ModelConfig(**KW), run["tree"], device=CPU)


def test_build_model_gives_the_encoder_decoder():
    cfg = ModelConfig(**KW)
    meta = build_model(cfg, device="meta")
    assert isinstance(meta, EncDecLM) and meta.embed.device.type == "meta"
    assert len(meta.enc_layers) == len(meta.dec_layers) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)


def test_encode_matches_reference(run, model):
    """The bidirectional encoder (``causal=False``) over the frames."""
    with torch.inference_mode():
        close(model.encode(torch.from_numpy(run["frames"])), run["memory"])


def test_forward_matches_reference(run, model):
    with torch.inference_mode():
        logits, aux = model.forward(run["tok"], torch.from_numpy(
            run["frames"]))
    assert logits.shape == (B, S, 97) and logits.dtype == torch.float32
    assert float(aux) == 0.0
    close(logits, run["full"])


def test_warm_cross_cache_matches_reference(run, model):
    """ck/cv from the encoder memory; k, v and pos left as they were."""
    with torch.inference_mode():
        empty = model.init_cache(B, S)
        cache = model.warm_cross_cache(empty, torch.from_numpy(
            run["frames"]))
    assert set(cache) == set(run["warm"])
    for key, want in run["warm"].items():
        assert tuple(cache[key].shape) == want.shape, key
        close(cache[key], want, msg=key)
    assert not empty["ck"].any()


def test_decode_steps_match_reference(run, model):
    """Each forced decode step's logits and cache (k/v written, ck/cv
    read) equal the reference's; greedy picks the same tokens."""
    with torch.inference_mode():
        cache = model.warm_cross_cache(model.init_cache(B, S),
                                       torch.from_numpy(run["frames"]))
        for t, (r_lg, r_cache) in enumerate(run["steps"]):
            lg, cache = model.decode_step(cache, run["tok"][:, t:t + 1])
            close(lg, r_lg, msg=f"step {t}")
            assert np.array_equal(torch.argmax(lg, -1).numpy(),
                                  np.argmax(r_lg, -1))
            for key, want in r_cache.items():
                if key == "pos":
                    assert int(cache[key]) == int(want) == t + 1
                else:
                    close(cache[key], want, msg=f"step {t} {key}")


@pytest.mark.parametrize("update", ["onehot", "dus"])
def test_forced_decode_matches_forward(run, update):
    """The reference's decode rule on the port: the warm cache plus a
    forced decode of the tokens gives the forward's logits at 2e-3, with
    either cache update."""
    m = params_from_reference(ModelConfig(**KW, cache_update=update),
                              run["tree"], device=CPU)
    frames = torch.from_numpy(run["frames"])
    with torch.inference_mode():
        full, _ = m.forward(run["tok"], frames)
        cache = m.warm_cross_cache(m.init_cache(B, S), frames)
        for t in range(S):
            lg, cache = m.decode_step(cache, run["tok"][:, t:t + 1])
            close(lg, full[:, t], 2e-3, 2e-3, f"step {t}")


def test_prefill_step_is_the_forwards_last_logits(run, model):
    """The audio prefill step: the teacher-forced forward's last logits
    over ``frame_embeds``, as the reference's step."""
    batch = {"tokens": run["tok"], "frame_embeds": run["frames"]}
    want = ref_steps.make_prefill_step(run["ref"], S + 4)(
        run["params"], jax.tree.map(jnp.asarray, batch))
    with torch.inference_mode():
        got = make_prefill_step(model, S + 4)(
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (B, 97)
    close(got, want)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_param_round_trip_is_exact(param_dtype):
    """enc_layers/dec_layers/enc_norm cross both ways bit for bit, with
    the reference's structure and dtypes."""
    pytest.importorskip("ml_dtypes")
    kw = dict(KW, param_dtype=param_dtype)
    tree = jax.tree.map(np.asarray, ref_build(RefConfig(**kw)).init(
        jax.random.PRNGKey(5)))
    m = params_from_reference(ModelConfig(**kw), tree, device=CPU)
    back = params_to_reference(m)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert m.dec_layers[1].cross["wq"].dtype == getattr(torch, param_dtype)
    assert m.enc_norm.dtype == torch.float32


def test_cache_layout_and_round_trip(run, model):
    """init_cache and cache_logical_axes are the reference's; a warm
    reference cache (k/v/ck/cv/pos) crosses both ways bit for bit and
    decodes on in the port as in the reference."""
    ref = run["ref"]
    want = jax.tree.map(np.asarray, ref.init_cache(3, 11))
    got = model.init_cache(3, 11)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
    assert model.cache_logical_axes(got) == ref.cache_logical_axes(want)
    tree = run["steps"][3][1]
    cache = cache_from_reference(tree, device=CPU)
    back = cache_to_reference(cache)
    assert set(back) == set(tree)
    for key in tree:
        assert back[key].dtype == tree[key].dtype
        assert np.array_equal(back[key], tree[key])
    with torch.inference_mode():
        lg, _ = model.decode_step(cache, run["tok"][:, 4:5])
    close(lg, run["steps"][4][0])


def test_logical_axes_equal_the_reference(run, model):
    assert model.logical_axes() == run["ref"].logical_axes()


def test_init_draws_the_reference_distribution():
    """Each weight the reference's truncated normal (std within 10 %),
    norms zero, the same seed the same params."""
    kw = dict(KW, d_model=64, d_ff=256, vocab_size=512)
    cfg = ModelConfig(**kw)
    a = build_model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    b = build_model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    rt = jax.tree.map(np.asarray, ref_build(RefConfig(**kw)).init(
        jax.random.PRNGKey(0)))
    pt = params_to_reference(a)
    assert jax.tree.structure(pt) == jax.tree.structure(rt)
    for (path, want), got, same in zip(
            jax.tree_util.tree_flatten_with_path(rt)[0],
            jax.tree.leaves(pt), jax.tree.leaves(params_to_reference(b))):
        assert np.array_equal(got, same)
        assert got.shape == want.shape and got.dtype == want.dtype
        if "norm" in jax.tree_util.keystr(path):
            assert not got.any() and not want.any()
            continue
        assert abs(got.std() / want.std() - 1) < 0.1, path
