"""Settings of the benchmark's own tests: the ``card`` marker (a test
that needs an NVIDIA card; it skips without one, decided in the
``cuda_card`` fixture), the import path of the harness, and ``lm_bench``:
a copy of the benchmark that a language-model configuration joins as
new files and entries only (``fixtures/``)."""

import json
import shutil
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FIXTURES = Path(__file__).resolve().parent / "fixtures"
for p in (REPO, REPO / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (run on the chip: python -m "
        "pytest detbench/tests -m card)")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's kernels run only there")
    return torch.device("cuda")


def radic_mixes(root: Path = REPO / "detbench") -> list[str]:
    """The traffic mixes of the Radic queue (configurations without a
    ``driver``), which ``traffic.load_workload`` reads."""
    out = []
    for p in sorted((root / "workloads").glob("*.json")):
        cfg = json.loads(p.read_text())["config"]
        if "driver" not in json.loads(
                (root / "configs" / f"{cfg}.json").read_text()):
            out.append(p.stem)
    return out


def add_lm_fixture(tmp_path: Path) -> types.SimpleNamespace:
    """A checkout in ``tmp_path``: ``detbench/`` copied, the fixture's
    configurations, workloads and reference added as files, and its
    entries appended to a copy of BENCHMARK.json (its cells on
    ``idle_share``'s list, and ``mfu``)."""
    repo = tmp_path / "repo"
    root = repo / "detbench"
    shutil.copytree(REPO / "detbench", root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    added = []
    for sub in ("configs", "workloads", "references"):
        for f in sorted((FIXTURES / sub).iterdir()):
            dest = root / sub / f.name
            assert not dest.exists(), f"the fixture overwrites {dest}"
            dest.parent.mkdir(exist_ok=True)
            shutil.copy(f, dest)
            added.append(dest)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    extra = json.loads((FIXTURES / "bench.json").read_text())
    cells = [w["name"] for w in extra["workloads"]]
    bench["configs"] += extra["configs"]
    bench["workloads"] += extra["workloads"]
    for m in bench["per_layer"]:
        if m["name"] == "idle_share":
            m["workloads"] = m["workloads"] + cells
    bench["per_layer"] += extra["per_layer"]
    (repo / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return types.SimpleNamespace(repo=repo, root=root, bench=bench,
                                 added=added, cells=cells)


@pytest.fixture
def lm_bench(tmp_path):
    return add_lm_fixture(tmp_path)
