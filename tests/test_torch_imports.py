"""Import hygiene of the port: nothing under ``src/repro_torch``, no
``examples/*_torch.py`` and neither ``chip_smoke.py`` nor
``lm_precision.py`` imports jax or the JAX package ``repro``, and the
port imports, computes, trains and places (the dry run's modules, the
production mesh, the int8 round trip) with jax made unimportable."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    sorted((REPO / "examples").glob("*_torch.py")) + \
    [REPO / "chip_smoke.py", REPO / "lm_precision.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_port_runs_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np, torch\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.launch.det_serve, repro_torch.runtime\n"
        "import repro_torch.launch.det_front, repro_torch.launch.autoscale\n"
        "import repro_torch.checkpoint, repro_torch.core.distributed\n"
        "import repro_torch.models, repro_torch.configs\n"
        "import repro_torch.parallel.sharding, repro_torch.launch.serve\n"
        "import repro_torch.models.convert, repro_torch.launch.steps\n"
        "from repro_torch.core import radic_det_batched, radic_det_oracle\n"
        "As = np.random.default_rng(0).normal(size=(3, 3, 7))"
        ".astype(np.float32)\n"
        "got = radic_det_batched(As, device='cpu')\n"
        "want = [radic_det_oracle(a) for a in As]\n"
        "assert np.allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)\n"
        "from repro_torch.core import Mesh, radic_det_distributed\n"
        "from repro_torch.runtime import build_mesh, choose_mesh\n"
        "mesh = build_mesh(choose_mesh(4, max_model=2), ['cpu'] * 4)\n"
        "got = radic_det_distributed(As[0], mesh=mesh, mode='flat')\n"
        "assert abs(float(got) - want[0]) <= 2e-3 * max(1, abs(want[0]))\n"
        "from repro_torch.launch import serve\n"
        "for arch in ('gemma2-9b', 'mamba2-1.3b', 'whisper-medium'):\n"
        "    gen = serve.main(['--arch', arch, '--smoke', '--device',\n"
        "                      'cpu', '--batch', '1', '--prompt-len', '4',\n"
        "                      '--gen', '2'])\n"
        "    assert gen.shape == (1, 2)\n"
        "from repro_torch.launch import train\n"
        "import repro_torch.data, repro_torch.optim\n"
        "losses = train.main(['--arch', 'llama3-8b', '--smoke', '--device',\n"
        "                     'cpu', '--steps', '2', '--batch', '2',\n"
        "                     '--seq', '8'])\n"
        "assert len(losses) == 2\n"
        "import repro_torch.configs.shapes, repro_torch.launch.mesh\n"
        "import repro_torch.parallel.pipeline\n"
        "import repro_torch.parallel.compress, repro_torch.launch.dryrun\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "assert make_production_mesh(multi_pod=True).size == 512\n"
        "from repro_torch.parallel.compress import psum_int8\n"
        "g = {'w': torch.linspace(-1, 1, 9)}\n"
        "assert psum_int8(g)['w'].shape == (9,)\n"
        "from repro_torch.configs.shapes import param_count\n"
        "from repro_torch.configs import get_config\n"
        "assert param_count(get_config('llama3-8b')) == 8030261248\n"
        "from repro_torch.configs import radic_paper\n"
        "assert radic_paper.CONFIG.backend == 'cuda'\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
        "print('PORT_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=240)
    assert "PORT_OK" in out.stdout, out.stderr[-3000:]
