"""The port's examples (``examples/quickstart_torch.py`` and
``examples/retrieval_torch.py``) on the CPU, held as
``tests/test_examples.py`` holds the originals and to the reference's
own numbers: the quickstart's four determinants within 1e-3 of
-1.1201943, the retrieval's batched-vs-loop parity within 1e-5 and its
per-query verdicts and accuracy counts equal to the reference script's
at seed 0."""

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
