"""BENCHMARK.json against the benchmark's contract, and what the
harness imports.  The tests read the benchmark beside them (the
checkout's ``BENCHMARK.json`` and ``detbench/``), so a cell, a
configuration or a metric that a later change adds as files and
entries is held to the same rules without an edit here."""

import ast
import dataclasses
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DETBENCH = REPO / "detbench"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
# the cells accepted before any later change: they stay, first, in order
ACCEPTED = ["narrow.values", "wide.values", "narrow.mixed"]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# a configuration key that names a width, which no cut may change (how
# many heads, experts or vocabulary rows a chip holds may be cut)
WIDTH = re.compile(r"(hidden_size|intermediate|latent|state|proj|head_dim|"
                   r"head_size|expan|experts_per_tok|top_k|_dim$|_rank$)")


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def _config_of(name: str) -> dict:
    return _json(DETBENCH / "configs" / f"{name}.json")


def _driver_of_mix(path: Path) -> str | None:
    return _config_of(_json(path)["config"]).get("driver")


# every traffic mix kept, a cell's or one kept for a later cell; the
# Radic queue's (no driver) are the ones its loader reads
MIXES = sorted(p.stem for p in (DETBENCH / "workloads").glob("*.json")
               if _driver_of_mix(p) is None)


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
    assert len(set(CELLS)) == len(CELLS)
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for text in ([c["source"] for c in BENCH["configs"]]
                 + [x["why"] for x in BENCH["configs"] + BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_cells_in_order_on_one_chip_each_with_its_files():
    assert CELLS[:len(ACCEPTED)] == ACCEPTED
    assert 1 <= len(CELLS) <= 24 and 1 <= len(BENCH["configs"]) <= 24
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        if w["name"] in ACCEPTED:
            assert w["chips"] == 1
        traffic = DETBENCH / "workloads" / f"{w['traffic']}.json"
        assert _json(traffic)["config"] == w["config"]
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    assert len({c["source"] for c in BENCH["configs"]}) == len(configs)
    assert len({c["file"] for c in BENCH["configs"]}) == len(configs)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_reduced_lists_what_differs_from_the_source(cfg):
    data = _json(REPO / cfg["file"])
    assert cfg["file"].startswith("detbench/configs/")
    assert data["source"] == cfg["source"]
    src = data["source_settings"]
    changed = {k for k in src if data.get(k) != src[k]}
    assert changed == set(cfg["reduced"])
    assert not any(k.endswith(("_dim", "_rank")) for k in cfg["reduced"])
    assert len(cfg["reduced"]) <= 16
    driver = data.get("driver")
    if driver is None:     # the Radic queue's
        assert set(data["guarantees"]) >= {"value_err_rss", "grad_rel_err"}
        return
    assert driver == "lm_serve" and (DETBENCH / "drivers"
                                     / f"{driver}.py").is_file()
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.config import ModelConfig
    assert data["arch"] in ARCHS
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    assert set(data["overrides"]) <= fields
    assert not [k for k in cfg["reduced"] if WIDTH.search(k)]
    assert float(data["guarantees"]["logit_err"]) > 0
    ref = Path(data["reference"])
    assert not ref.is_absolute() and ".." not in ref.parts
    assert (DETBENCH / ref).is_file()
    assert data["deployment"] and data["dtype"]


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
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (DETBENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        # a per-layer metric names the cells it reads in
        assert m["workloads"]
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
    assert len(layers) >= 5


# every language-model configuration file that states its layers, the
# benchmark's and its tests' fixtures
LAYERED = sorted(p for d in (DETBENCH / "configs",
                             DETBENCH / "tests" / "fixtures" / "configs")
                 for p in d.glob("*.json") if "layers" in _json(p))
PATTERN_FIXTURE = (DETBENCH / "tests" / "fixtures" / "configs"
                   / "nemotron3_nano_13l.json")


@pytest.mark.parametrize("path", LAYERED,
                         ids=lambda p: str(p.relative_to(DETBENCH)))
def test_a_layers_block_names_keys_of_its_file(path):
    """Every size a part names is a top-level key of the file, every
    letter of the pattern has a kind, and the pattern as run is a
    contiguous slice of the published one, ``num_hidden_layers`` long."""
    from detbench import lm_work
    plan = lm_work.file_plan(_json(path), str(path))
    assert len(plan.layers) == _json(path)["num_hidden_layers"]


def _break_layers(d: dict, how: str) -> str:
    """Break the fixture's layers block one way → the message's words."""
    kinds = d["layers"]["kinds"]
    if how == "unknown_key":
        kinds["M"][0]["heads"] = "mamba_heads"
        return "no top-level key"
    if how == "letter_without_kind":
        del kinds["*"]
        return "have no kind"
    if how == "no_slice":
        d["hybrid_override_pattern"] = "MMEMEM*EMEMEM"
        return "no contiguous slice"
    if how == "other_depth":
        d["num_hidden_layers"] = 12
        return "num_hidden_layers"
    if how == "literal_width":
        kinds["E"][0]["width"] = 1856
        return "must name a top-level key"
    raise AssertionError(how)


@pytest.mark.parametrize("how", ["unknown_key", "letter_without_kind",
                                 "no_slice", "other_depth", "literal_width"])
def test_a_broken_layers_block_fails_with_its_path(tmp_path, how):
    from detbench import lm_work
    d = _json(PATTERN_FIXTURE)
    words = _break_layers(d, how)
    path = tmp_path / "configs" / PATTERN_FIXTURE.name
    path.parent.mkdir()
    path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match=re.escape(str(path))) as err:
        lm_work.file_plan(_json(path), str(path))
    assert words in str(err.value)


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
    assert _imports(DETBENCH / "lm_work.py") <= {"__future__",
                                                 "dataclasses"}
    for p in sorted((DETBENCH / "configs").glob("*.json")):
        ref = _json(p).get("reference")
        if ref is not None:
            assert _imports(DETBENCH / ref) <= {"__future__", "math",
                                                "torch"}, ref
