"""reprolint's concurrency passes over the port's serving tier.

``lock-discipline`` and ``wire-safety`` scope themselves by path
substrings (``repro/launch/``, ``repro/runtime/``) that do not match
``repro_torch/...``, so their ``applies()`` would skip every port file.
These tests build each file's ``FileContext`` themselves and run the two
passes' ``run()`` directly on every module of ``src/repro_torch/launch``
and ``src/repro_torch/runtime``, and ``lock-discipline`` on the plan
store and the engine, honouring the files' own suppression comments as
the lint runner does.
"""

import ast
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tools.lint.core import FileContext  # noqa: E402
from tools.lint.passes import LockDisciplinePass, WireSafetyPass  # noqa: E402

PORT = REPO / "src" / "repro_torch"
FILES = sorted((PORT / "launch").glob("*.py")) + \
    sorted((PORT / "runtime").glob("*.py"))
PASSES = (LockDisciplinePass(), WireSafetyPass())
LOCKED = [PORT / "checkpoint" / "plan_store.py", PORT / "core" / "engine.py"]


def _findings(path: pathlib.Path, source: str | None = None,
              passes=PASSES) -> list:
    source = path.read_text() if source is None else source
    norm = str(path).replace("\\", "/")
    ctx = FileContext(norm, source, ast.parse(source, filename=norm))
    return [f for p in passes for f in p.run(ctx)
            if not ctx.suppressions.is_suppressed(f.pass_id, f.line)]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(REPO)) for p in FILES])
def test_port_serving_tier_has_no_concurrency_findings(path):
    found = _findings(path)
    assert not found, "\n".join(f.render() for f in found)


def test_passes_cover_the_train_driver():
    """The train driver (its prefetcher and watchdog threads) is among
    the files both passes run on."""
    assert PORT / "launch" / "train.py" in FILES
    assert PORT / "launch" / "steps.py" in FILES


@pytest.mark.parametrize("path", LOCKED,
                         ids=[str(p.relative_to(REPO)) for p in LOCKED])
def test_plan_store_and_engine_keep_lock_discipline(path):
    """The plan store's write queue and the engine's cache and store
    counters are shared between threads: every touch under its lock."""
    found = _findings(path, passes=(LockDisciplinePass(),))
    assert not found, "\n".join(f.render() for f in found)


def test_port_declares_the_reference_registries():
    """The passes have something to check: every concurrent class the
    reference registers declares the same ``_GUARDED_BY`` registry in
    the port."""
    def registries(root):
        out = {}
        for path in sorted(root.rglob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.ClassDef):
                    reg = LockDisciplinePass._registry(node)
                    if reg:
                        out[node.name] = reg
        return out

    dirs = ("launch", "runtime", "checkpoint", "core")
    ref = REPO / "src" / "repro"
    port, want = {}, {}
    for d in dirs:
        port |= registries(PORT / d)
        want |= registries(ref / d)
    for name in ("DetFront", "DetQueue", "SocketLink", "ShmRing",
                 "ShmRingReader", "Autoscaler", "Watchdog", "PlanStore",
                 "DetEngine"):
        assert port[name] == want[name], name


@pytest.mark.parametrize("pass_id,old,new", [
    ("lock-discipline",
     "            front[\"cold_workers\"] = sorted(self._cold_wids)\n",
     None),
    ("wire-safety",
     "                    send((\"result\", seq, float(val)))\n",
     "                    send((\"result\", seq, np.float64(val)))\n"),
])
def test_passes_catch_a_fault_in_the_port(pass_id, old, new):
    """A guarded read moved outside its lock, and a numpy scalar built
    into a wire message, are found in the port's own files."""
    if pass_id == "lock-discipline":
        path = PORT / "launch" / "det_front.py"
        source = path.read_text()
        assert old in source
        source = source.replace(
            old, "").replace(
            "        return {\"front\": front, \"workers\": reports,\n",
            "        front[\"cold_workers\"] = sorted(self._cold_wids)\n"
            "        return {\"front\": front, \"workers\": reports,\n")
    else:
        path = PORT / "launch" / "transport.py"
        source = path.read_text()
        assert old in source
        source = source.replace(old, new)
    assert any(f.pass_id == pass_id for f in _findings(path, source))


@pytest.mark.parametrize("path,old", [
    (LOCKED[0], "        with self._cv:\n            return {\"entries\""),
    (LOCKED[1], "            with self._lock:\n"
                "                if built is not None:\n"),
], ids=["plan_store", "engine"])
def test_lock_discipline_catches_a_fault_in_the_store_and_engine(path, old):
    """A guarded counter read or written outside its lock is found."""
    source = path.read_text()
    assert old in source
    bad = source.replace(old, old.replace("with self._cv:", "if True:")
                         .replace("with self._lock:", "if True:"))
    assert any(f.pass_id == "lock-discipline"
               for f in _findings(path, bad, (LockDisciplinePass(),)))
