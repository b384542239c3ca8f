"""The port's examples (``examples/quickstart_torch.py``,
``examples/retrieval_torch.py`` and ``examples/train_lm_torch.py``) on
the CPU, held as ``tests/test_examples.py`` holds the originals and to
the reference's own numbers: the quickstart's four determinants within
1e-3 of -1.1201943, the retrieval's batched-vs-loop parity within 1e-5
and its per-query verdicts and accuracy counts equal to the reference
script's at seed 0; the train example's ``OK`` lines at small flags, and
its determinant-regularized probe head on the reference's draws within
``rtol=1e-3`` of the reference's ``fit_head`` after 20 steps."""

import ast
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name[:-3]}", REPO / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(*args)
    return buf.getvalue()


def test_quickstart_smoke():
    out = _run(_load_example("quickstart_torch.py").main, CPU)
    assert "sum over C(9,4) = 126 signed minors" in out
    assert "B_49 via combinatorial addition: (2, 5, 6, 7, 8)" in out
    assert "grain 10^17 starts at (1, 2, 3, 4, 10, 11, 12, 13) ..." in out
    for label in ("oracle (numpy enumeration)", "flat torch (rank-parallel)",
                  "fused CUDA kernel", "mesh-distributed grains"):
        m = re.search(re.escape(label) + r"\s*: (-?[0-9.]+)", out)
        assert m, f"missing {label!r} line in:\n{out}"
        assert abs(float(m.group(1)) - (-1.1201943)) < 1e-3


def test_quickstart_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load_example("quickstart_torch.py").main([])


def _verdicts(out: str):
    parity = re.search(r"parity: worst \|diff\| = ([0-9.e+-]+)", out)
    counts = re.search(r"similarity (\d+)/12, gradient-refined (\d+)/12",
                       out)
    queries = re.findall(r"query from video.*", out)
    return parity, counts, queries


def test_retrieval_matches_the_reference():
    """The port's retrieval prints the reference's verdicts: the same
    similarity and refined pick for each query and the same counts."""
    pytest.importorskip("jax")
    ref = _load_example("retrieval.py")
    want_parity, want_counts, want_queries = _verdicts(_run(ref.main))
    out = _run(_load_example("retrieval_torch.py").main, CPU)
    parity, counts, queries = _verdicts(out)
    assert parity and float(parity.group(1)) <= 1e-5, out
    assert counts, f"no accuracy line in:\n{out}"
    assert counts.groups() == want_counts.groups()
    assert int(counts.group(2)) >= int(counts.group(1))
    assert int(counts.group(2)) >= 10
    assert queries == want_queries


def test_signature_matches_the_reference():
    """The one-dispatch signature equals the reference's and the port's
    scalar loop on feature matrices of different widths."""
    jnp = pytest.importorskip("jax.numpy")
    ref = _load_example("retrieval.py")
    port = _load_example("retrieval_torch.py")
    rng = np.random.default_rng(7)
    for n in (13, 20, 31):
        feats = rng.normal(size=(port.M, n)).astype(np.float32)
        t = torch.from_numpy(feats)
        with torch.no_grad():
            batched = port.signature(t).numpy()
        np.testing.assert_allclose(batched, port.signature_loop(t),
                                   atol=1e-5)
        np.testing.assert_allclose(
            batched, np.asarray(ref.signature(jnp.asarray(feats))),
            atol=1e-5)


def test_train_example_smoke(tmp_path):
    """The train example at small flags prints its two OK lines (the LM's
    loss decreases; the determinant regularizer keeps the head full-rank
    without wrecking the fit)."""
    out = _run(_load_example("train_lm_torch.py").main, CPU + [
        "--steps", "30", "--d-model", "64", "--layers", "1", "--vocab",
        "256", "--batch", "4", "--seq", "32", "--ckpt", str(tmp_path)])
    assert "OK: loss went from" in out, out
    assert "OK: determinant-regularized head stays full-rank" in out, out
    assert "probe head: mse" in out


def test_train_example_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load_example("train_lm_torch.py").main([])


def _reference_fit_head():
    """``fit_head`` as ``examples/train_lm.py`` defines it (the script
    trains at import, so the function is taken from its source)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import radic_det
    tree = ast.parse((REPO / "examples" / "train_lm.py").read_text())
    fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef)
              and node.name == "fit_head")
    ns = {"jax": jax, "jnp": jnp, "radic_det": radic_det, "K_HEAD": 3,
          "D_HEAD": 8}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "train_lm.py",
                 "exec"), ns)
    return ns["fit_head"]


@pytest.mark.parametrize("lam", [0.0, 0.02])
def test_fit_head_matches_the_reference(lam):
    """The port's probe head on the reference's draws (its ``fit_head``'s
    keys, with ``u`` and ``H0`` from the same key) lands within rtol=1e-3
    of the reference's head after 20 steps, with the same mse and target
    variance."""
    jax = pytest.importorskip("jax")
    ref_fit = _reference_fit_head()
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(0), 3)
    X = np.asarray(jax.random.normal(k0, (256, 8)))
    u = np.asarray(jax.random.normal(k1, (8,)))
    v = np.asarray(jax.random.normal(k2, (3,)))
    H0 = np.asarray(0.1 * jax.random.normal(k1, (3, 8)))
    want_H, want_mse, want_var = ref_fit(lam, 20)
    port = _load_example("train_lm_torch.py")
    H, mse, var = port.fit_head(lam, 20, data=(X, u, v, H0), device="cpu")
    np.testing.assert_allclose(H.numpy(), np.asarray(want_H), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(mse, want_mse, rtol=1e-3)
    np.testing.assert_allclose(var, want_var, rtol=1e-5)
