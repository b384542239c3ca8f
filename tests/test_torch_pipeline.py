"""The port's GPipe pipeline (``repro_torch.parallel.pipeline``) against
the reference's ``repro.parallel.pipeline``: the schedule and bubble
fraction over a sweep of (stages, microbatches); the twin of
``test_pipeline.py::test_pipeline_matches_sequential_4stage`` (S = 4,
M = 8, B = 2, D = 16) on a 4-slot CPU grid, held to the reference's
``pipeline_apply`` under 4 forced host devices (a subprocess) at
rtol = atol = 1e-5 and to the port's own microbatch-by-microbatch
sequential run bit for bit; and its gradient (input and stage params)
against the sequential run's at 1e-5."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import Mesh
from repro_torch.parallel import pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, B, D = 4, 8, 2, 16

REF_PIPE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.parallel.pipeline import pipeline_apply
    d = np.load(sys.argv[1])
    Ws, x = jnp.asarray(d["Ws"]), jnp.asarray(d["x"])
    mesh = Mesh(np.array(jax.devices()).reshape(4), ("stage",))
    def stage_fn(w, h):
        return jnp.tanh(h @ w)
    got = pipeline_apply(stage_fn, Ws, x, mesh=mesh, stage_axis="stage",
                         n_micro=x.shape[0])
    np.save(sys.argv[2], np.asarray(got))
    print("REF_PIPE_OK")
""")


def stage_fn(w, h):
    return torch.tanh(h @ w)


def sequential(Ws, x):
    """The same layers applied microbatch by microbatch."""
    outs = []
    for m in range(x.shape[0]):
        h = x[m]
        for s in range(Ws.shape[0]):
            h = stage_fn(Ws[s], h)
        outs.append(h)
    return torch.stack(outs)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    Ws = (rng.normal(size=(S, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(M, B, D)).astype(np.float32)
    return Ws, x


@pytest.fixture(scope="module")
def reference_out(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    np.savez(d / "in.npz", Ws=inputs[0], x=inputs[1])
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run(
        [sys.executable, "-c", REF_PIPE, str(d / "in.npz"),
         str(d / "out.npy")], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300)
    assert "REF_PIPE_OK" in out.stdout, out.stderr[-2000:]
    return np.load(d / "out.npy")


def grid():
    return Mesh(np.full((S,), "cpu", dtype=object), ("stage",))


@pytest.mark.parametrize("n_stages", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_micro", [1, 2, 5, 8, 16])
def test_schedule_and_bubble_equal_the_reference(n_stages, n_micro):
    ref = pytest.importorskip("repro.parallel.pipeline")
    assert pipeline.gpipe_schedule(n_stages, n_micro) == \
        ref.gpipe_schedule(n_stages, n_micro)
    assert pipeline.bubble_fraction(n_stages, n_micro) == \
        ref.bubble_fraction(n_stages, n_micro)


def test_pipeline_matches_the_reference_and_sequential(inputs,
                                                       reference_out):
    Ws, x = (torch.from_numpy(a) for a in inputs)
    got = pipeline.pipeline_apply(stage_fn, Ws, x, mesh=grid(),
                                  stage_axis="stage", n_micro=M)
    assert got.shape == (M, B, D) and got.device == torch.device("cpu")
    np.testing.assert_allclose(got.numpy(), reference_out, rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, sequential(Ws, x))


def test_pipeline_gradient_matches_sequential(inputs):
    ct = torch.from_numpy(np.random.default_rng(1).normal(
        size=(M, B, D)).astype(np.float32))

    def grads(fn):
        Ws, x = (torch.from_numpy(a).requires_grad_() for a in inputs)
        (fn(Ws, x) * ct).sum().backward()
        return Ws.grad, x.grad

    got = grads(lambda Ws, x: pipeline.pipeline_apply(
        stage_fn, Ws, x, mesh=grid(), stage_axis="stage", n_micro=M))
    want = grads(sequential)
    for g, w in zip(got, want):
        assert g is not None and bool(g.abs().sum() > 0)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_stage_params_live_on_their_stage_device():
    """Stage s runs on position s of the stage axis, index 0 elsewhere;
    a pytree of stage params (a dict) works as an array does."""
    mesh = Mesh(np.array([["cpu", "meta"], ["cpu", "meta"]], dtype=object),
                ("stage", "data"))
    assert pipeline.stage_devices(mesh, "stage") == [torch.device("cpu")] * 2
    mesh_t = Mesh(np.array([["cpu", "cpu"], ["meta", "meta"]],
                           dtype=object), ("data", "stage"))
    assert pipeline.stage_devices(mesh_t, "stage") == \
        [torch.device("cpu")] * 2
    seen = []

    def fn(p, h):
        seen.append(p["w"].device)
        return h @ p["w"] + p["b"]

    Ws = {"w": torch.eye(3).repeat(2, 1, 1), "b": torch.ones(2, 3)}
    x = torch.zeros(3, 1, 3)
    out = pipeline.pipeline_apply(fn, Ws, x, mesh=mesh, stage_axis="stage",
                                  n_micro=3)
    assert torch.equal(out, torch.full((3, 1, 3), 2.0))
    assert len(seen) == 2 * 3
