"""BENCHMARK.json against the benchmark's contract, and what the
harness imports."""

import ast
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DETBENCH = REPO / "detbench"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = ["narrow.values", "wide.values", "narrow.mixed"]
# every traffic mix kept, a cell's or one kept for a later cell
MIXES = sorted(p.stem for p in (DETBENCH / "workloads").glob("*.json"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_top_level_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "detbench/run.py"]
    assert BENCH["paths"] == ["detbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 10 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_name_and_unit_has_the_allowed_letters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for text in ([c["source"] for c in BENCH["configs"]]
                 + [x["why"] for x in BENCH["configs"] + BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_cells_in_order_on_one_chip_each_with_its_files():
    assert [w["name"] for w in BENCH["workloads"]] == CELLS
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and w["config"] in configs
        traffic = DETBENCH / "workloads" / f"{w['traffic']}.json"
        assert json.loads(traffic.read_text())["config"] == w["config"]
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    assert len({c["source"] for c in BENCH["configs"]}) == len(configs)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_reduced_lists_what_differs_from_the_source(cfg):
    data = json.loads((REPO / cfg["file"]).read_text())
    assert cfg["file"].startswith("detbench/configs/")
    assert data["source"] == cfg["source"]
    src = data["source_settings"]
    changed = {k for k in src if data.get(k) != src[k]}
    assert changed == set(cfg["reduced"])
    assert not any(k.endswith(("_dim", "_rank")) for k in cfg["reduced"])
    assert set(data["guarantees"]) >= {"value_err_rss", "grad_rel_err"}


@pytest.mark.parametrize("cell", MIXES)
def test_every_shape_lies_inside_the_source_s_ranges(cell):
    """A cut narrows a configuration's source and never widens it: every
    shape of a cell lies inside the configuration's ranges, and those
    inside the documented command's."""
    w = json.loads((DETBENCH / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((DETBENCH / "configs" / f"{w['config']}.json"
                      ).read_text())
    src = cfg["source_settings"]
    assert src["min_m"] <= cfg["min_m"] <= cfg["max_m"] <= src["max_m"]
    assert cfg["max_n"] <= src["max_n"]
    for m, n in w["shapes"]:
        assert cfg["min_m"] <= m <= cfg["max_m"]
        assert max(m, cfg["min_n"]) <= n <= cfg["max_n"]


def test_metrics_have_readers_and_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (DETBENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        assert (set(m.get("workloads", CELLS))
                <= set(moved.get("workloads", CELLS)))
    for cell in CELLS:
        reported = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", CELLS)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", CELLS)
                   for m in BENCH["per_layer"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len(layers) == 5


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_in_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(DETBENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not _imports(f) & FORBIDDEN, f


def test_the_reference_imports_torch_only():
    assert _imports(DETBENCH / "reference.py") <= {"__future__", "torch"}
    assert _imports(DETBENCH / "work.py") <= {"__future__", "functools",
                                              "math"}
