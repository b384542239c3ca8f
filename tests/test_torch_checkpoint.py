"""Twin of ``tests/test_checkpoint.py`` for the port's checkpoint package
(``repro_torch.checkpoint``) and the engine's plan store, on the CPU.

Every reference test with a meaning in the port has its twin here
(with ``tests/test_substrates.py``'s checkpoint legs): the
three manager regressions (typed restore mismatches, the stale-tmp
sweep, gc never deleting LATEST's target), bit identity, async overlap,
the elastic restore (a reference process on two XLA devices saves, the
port restores), the four ``PlanStore`` tests, the engine's warm start,
prefill and store-free behaviour.  The reference's XLA-compilation-cache
tests become the kernel library's: the store houses the library
(``kernels._build.use_store_dir``) and defers to one already loaded.
The two export-seam tests have no counterpart: the port serializes no
executable, so its store records are metadata only.

Added: the on-disk format is the reference's, so each restores what the
other saved, bit for bit (dicts with unsorted keys, nested lists, None
subtrees, float32/float64/int32/int64/bool leaves); bfloat16 round-trips
within the port; a CPU tensor saved asynchronously is snapshotted at the
call; the store's env stamp names the kernel sources.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, CheckpointMismatchError,
                                    PlanStore, sweep_stale_tmp)
from repro_torch.core.engine import DetEngine, plan_statics
from repro_torch.kernels import _build

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(autouse=True)
def _restore_kernel_store_dir(monkeypatch):
    """Opening a plan store points the kernel build at it, process-wide:
    put the setting back after every test."""
    monkeypatch.setattr(_build, "_store_dir", _build._store_dir)


def _tree_equal(a, b) -> None:
    """Same structure, dtypes and bits (tensors, arrays or scalars)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    elif a is None:
        assert b is None
    else:
        x = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.array(a))
        y = b if isinstance(b, torch.Tensor) else torch.as_tensor(
            np.array(b))
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


# ------------------------------------- the legs of test_substrates.py
def test_checkpoint_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3),
            "nested": {"s": torch.tensor(3)}}
    m.save(7, tree)
    step, out = m.restore(tree)
    assert step == 7
    _tree_equal(tree, out)


def test_checkpoint_keeps_last_and_latest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones(2)}
    for s in (1, 2, 3):
        m.save(s, {"w": tree["w"] * s})
    assert m.latest_step() == 3
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000002", "step_00000003"]
    step, out = m.restore(tree, step=2)
    assert float(out["w"][0]) == 2.0


def test_checkpoint_async_then_blocking_same_step(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = {"w": torch.ones(128, 128)}
    m.save_async(5, tree)
    m.save(5, tree)  # must not collide with the in-flight async write
    assert m.latest_step() == 5


def test_checkpoint_crash_atomicity(tmp_path):
    """A leftover tmp dir (simulated crash) never corrupts LATEST."""
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"w": torch.ones(2)})
    os.makedirs(os.path.join(str(tmp_path), ".tmp-step_00000002"))
    assert m.latest_step() == 1
    step, _ = m.restore({"w": torch.ones(2)})
    assert step == 1


# -------------------------------------------------- restore validation (fix 1)
def test_restore_name_mismatch_is_typed_error(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"w": torch.ones(2, 3), "b": torch.zeros(3)})
    with pytest.raises(CheckpointMismatchError):
        m.restore({"w": torch.ones(2, 3), "bias": torch.zeros(3)})


def test_restore_shape_mismatch_is_typed_error(tmp_path):
    """The transposed-leaf corruption: names agree, shapes do not."""
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"w": torch.arange(6.0).reshape(2, 3)})
    with pytest.raises(CheckpointMismatchError, match="shape"):
        m.restore({"w": torch.zeros(3, 2)})


def test_restore_dtype_mismatch_is_typed_error(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"w": torch.ones(4, dtype=torch.float32)})
    with pytest.raises(CheckpointMismatchError, match="dtype"):
        m.restore({"w": torch.ones(4, dtype=torch.int32)})


def test_restore_skips_bare_python_leaves(tmp_path):
    """Leaves without shape/dtype (plain python scalars) have nothing to
    validate and must not trip the check."""
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"w": torch.ones(2), "step": 7})
    step, out = m.restore({"w": torch.zeros(2), "step": 0})
    assert step == 1
    assert int(out["step"]) == 7


# -------------------------------------------------- crash atomicity (fix 2)
def test_crash_between_savez_and_replace_is_swept(tmp_path, monkeypatch):
    """Kill the save between ``np.savez`` and ``os.replace``: the
    published state is untouched and the leftover ``.tmp-`` dir is swept
    by the next manager init."""
    import repro_torch.checkpoint.manager as mgr_mod
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"w": torch.ones(2)})

    def crash_replace(src, dst):
        raise OSError("simulated crash before publish")

    monkeypatch.setattr(mgr_mod.os, "replace", crash_replace)
    with pytest.raises(OSError, match="simulated crash"):
        m.save(2, {"w": torch.full((2,), 2.0)})
    monkeypatch.undo()

    leftovers = [d for d in os.listdir(tmp_path) if d.startswith(".tmp-")]
    assert leftovers == [".tmp-step_00000002"]
    assert os.path.exists(os.path.join(tmp_path, ".tmp-step_00000002",
                                       "host_0.npz"))
    assert m.latest_step() == 1

    m2 = CheckpointManager(str(tmp_path))
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp-")]
    step, out = m2.restore({"w": torch.zeros(2)})
    assert step == 1
    assert torch.equal(out["w"], torch.ones(2))


def test_sweep_stale_tmp_reports_and_tolerates_missing_dir(tmp_path):
    os.makedirs(os.path.join(tmp_path, ".tmp-step_00000009"))
    assert sweep_stale_tmp(str(tmp_path)) == [".tmp-step_00000009"]
    assert sweep_stale_tmp(str(tmp_path / "nope")) == []


# ------------------------------------------------------ gc vs LATEST (fix 3)
def test_gc_never_deletes_latest_target_out_of_order(tmp_path):
    """A lower-step save landing after a higher step makes LATEST point
    at a lexically-early dir; gc must not delete it."""
    m = CheckpointManager(str(tmp_path), keep=1)
    m.save(5, {"w": torch.full((2,), 5.0)})
    m.save(3, {"w": torch.full((2,), 3.0)})  # out-of-order: LATEST -> 3
    assert m.latest_step() == 3
    assert os.path.isdir(os.path.join(tmp_path, "step_00000003"))
    step, out = m.restore({"w": torch.zeros(2)})
    assert step == 3
    assert torch.equal(out["w"], torch.full((2,), 3.0))
    m.save(6, {"w": torch.full((2,), 6.0)})
    assert m.latest_step() == 6


# ------------------------------------------------------------- battery: core
def test_save_restore_bit_identity_plan_meta_tree(tmp_path):
    """A grad-plan-shaped metadata tree (int32 rank table + float params
    + scalars) round-trips bit-identically, dtypes included."""
    total, table, chunk = plan_statics(3, 7, 128, backend="cuda")
    tree = {"table": table,
            "weights": torch.linspace(-1, 1, 12).reshape(3, 4),
            "meta": {"total": np.int32(total), "chunk": np.int32(chunk)}}
    m = CheckpointManager(str(tmp_path))
    m.save(11, tree)
    step, out = m.restore(tree)
    assert step == 11
    assert out["table"].dtype == torch.int32
    _tree_equal(tree, out)


def test_save_async_overlaps_with_blocking_save(tmp_path):
    """An async save still in flight serializes with the next blocking
    save, and both steps stay restorable."""
    m = CheckpointManager(str(tmp_path))
    m.save_async(5, {"w": torch.full((64, 64), 5.0)})
    m.save(6, {"w": torch.full((64, 64), 6.0)})
    m.wait()
    assert m.latest_step() == 6
    for step, val in ((5, 5.0), (6, 6.0)):
        got, out = m.restore({"w": torch.zeros(64, 64)}, step=step)
        assert got == step
        assert float(out["w"][0, 0]) == val


def test_save_async_snapshots_a_cpu_tensor_at_the_call(tmp_path):
    """``.cpu()`` of a CPU tensor shares its storage: the save clones it,
    so an in-place update right after ``save_async`` never reaches the
    file."""
    w = torch.full((256, 256), 1.0)
    m = CheckpointManager(str(tmp_path))
    m.save_async(1, {"w": w})
    w.add_(1.0)
    m.wait()
    _, out = m.restore({"w": torch.zeros(256, 256)})
    assert torch.equal(out["w"], torch.full((256, 256), 1.0))


def test_elastic_restore_across_device_counts(tmp_path):
    """A checkpoint written by a reference process on two XLA devices (a
    sharded array) restores in the port: the manifest stores only the
    logical tree, so the device is a restore-time choice."""
    pytest.importorskip("jax")
    script = (
        "import numpy as np, jax\n"
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P\n"
        "from repro.checkpoint import CheckpointManager\n"
        "devs = jax.devices()\n"
        "assert len(devs) == 2, devs\n"
        "mesh = Mesh(np.array(devs), ('d',))\n"
        "x = jax.device_put(jax.numpy.arange(8.0).reshape(4, 2),\n"
        "                   NamedSharding(mesh, P('d', None)))\n"
        f"CheckpointManager({str(tmp_path)!r}).save(3, {{'w': x}})\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=2").strip()
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    step, out = CheckpointManager(str(tmp_path)).restore(
        {"w": torch.zeros(4, 2)}, device=CPU)
    assert step == 3
    assert out["w"].device.type == "cpu"
    assert torch.equal(out["w"], torch.arange(8.0).reshape(4, 2))


# --------------------------------------------- the reference's format
def _mixed_tree(seed: int) -> dict:
    """Unsorted dict keys, nested lists, a None subtree and every dtype
    both sides store as numpy."""
    rng = np.random.default_rng(seed)
    return {
        "zeta": rng.normal(size=(3, 4)).astype(np.float32),
        "alpha": [rng.normal(size=(5,)),                       # float64
                  {"y": rng.integers(-9, 9, size=(2, 2)).astype(np.int32),
                   "b": rng.integers(-2**40, 2**40, size=(3,))},  # int64
                  None],
        "mid": {"flags": rng.random(6) < 0.5,
                "k": [np.float32(1.5), rng.normal(size=(1, 2))]},
    }


def _as_port(tree):
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_port(v) for v in tree]
    return None if tree is None else torch.from_numpy(np.array(tree))


def test_port_restores_what_the_reference_saved(tmp_path):
    ref = pytest.importorskip("repro.checkpoint")
    tree = _mixed_tree(0)
    ref.CheckpointManager(str(tmp_path)).save(4, tree)
    step, out = CheckpointManager(str(tmp_path)).restore(_as_port(tree))
    assert step == 4
    _tree_equal(tree, out)


def test_reference_restores_what_the_port_saved(tmp_path):
    jax = pytest.importorskip("jax")
    ref = pytest.importorskip("repro.checkpoint")
    tree = _mixed_tree(1)
    CheckpointManager(str(tmp_path)).save(9, _as_port(tree))
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)  # or jnp casts 64-bit leaves
    try:
        step, out = ref.CheckpointManager(str(tmp_path)).restore(tree)
        out = jax.tree.map(np.asarray, out)
    finally:
        jax.config.update("jax_enable_x64", before)
    assert step == 9
    _tree_equal(tree, out)
    with pytest.raises(ref.CheckpointMismatchError):
        ref.CheckpointManager(str(tmp_path)).restore(
            {**tree, "zeta": np.zeros((4, 3), np.float32)})


def test_bfloat16_round_trips_within_the_port(tmp_path):
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    tree = {"w": w.to(torch.bfloat16), "h": w.to(torch.float16)}
    m = CheckpointManager(str(tmp_path))
    m.save(2, tree)
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        assert json.load(f)["dtypes"] == ["float16", "bfloat16"]
    _, out = m.restore(tree)
    _tree_equal(tree, out)


# -------------------------------------------------------------- plan store
def test_plan_store_roundtrip_atomic(tmp_path):
    s = PlanStore(str(tmp_path), env={"torch": "x", "device": "cpu"})
    s.put(0xABC, {"key": {"m": 2, "n": 5}}, {"fwd": b"\x00\x01bytes"})
    meta, blobs = s.get(0xABC)
    assert meta == {"key": {"m": 2, "n": 5}}
    assert blobs == {"fwd": b"\x00\x01bytes"}
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp-")]
    assert s.get(0xDEF) is None
    assert s.families() == [{"key": {"m": 2, "n": 5}}]
    assert s.stats()["entries"] == 1


def test_plan_store_env_and_schema_invalidation(tmp_path):
    """A manifest written under another env stamp or schema version is a
    miss — never an error, never a cross-version restore."""
    a = PlanStore(str(tmp_path), env={"torch": "2.11", "device": "cpu"})
    a.put(1, {"key": {"m": 1, "n": 1}}, {"fwd": b"z"})
    b = PlanStore(str(tmp_path), env={"torch": "2.13", "device": "cpu"})
    assert b.get(1) is None and b.families() == []
    assert a.get(1) is not None
    entry = os.path.join(tmp_path, PlanStore.entry_name(1))
    with open(os.path.join(entry, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["schema"] = 99
    with open(os.path.join(entry, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    assert a.get(1) is None and a.families() == []


def test_plan_store_deferred_blobs_and_flush(tmp_path):
    """Blob values may be zero-arg callables (evaluated on the writer
    thread); one returning None publishes the entry metadata-only."""
    s = PlanStore(str(tmp_path))
    s.put_async(7, {"key": {"m": 3, "n": 7}},
                {"fwd": lambda: b"exported", "grad": lambda: None})
    s.flush()
    meta, blobs = s.get(7)
    assert blobs == {"fwd": b"exported"}
    stats = s.stats()
    assert stats["written"] == 1 and stats["pending"] == 0
    s.close()


def test_plan_store_sweeps_stale_tmp_and_missing_blob_is_miss(tmp_path):
    os.makedirs(os.path.join(tmp_path, ".tmp-plan_crashed"))
    s = PlanStore(str(tmp_path))
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp-")]
    s.put(9, {"key": {}}, {"fwd": b"x"})
    os.remove(os.path.join(tmp_path, PlanStore.entry_name(9), "fwd.bin"))
    assert s.get(9) is None  # manifest promises a blob that is gone


def test_plan_store_reads_the_reference_stores_entries(tmp_path):
    """The layout is the reference's: each store reads what the other
    published under the same env stamp."""
    ref = pytest.importorskip("repro.checkpoint")
    env = {"torch": "x"}
    ref.PlanStore(str(tmp_path), env=env).put(5, {"key": {"m": 2}},
                                              {"fwd": b"r"})
    PlanStore(str(tmp_path), env=env).put(6, {"key": {"m": 3}})
    assert PlanStore(str(tmp_path), env=env).get(5) == (
        {"key": {"m": 2}}, {"fwd": b"r"})
    assert ref.PlanStore(str(tmp_path), env=env).families() == [
        {"key": {"m": 2}}, {"key": {"m": 3}}]


# ------------------------------------------------- engine store warm start
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_engine_store_warm_start_bit_identical(backend, tmp_path, rng):
    """An engine restarted onto a populated store restores the plan
    (store hit) and produces bit-identical batched results."""
    As = torch.from_numpy(rng.normal(size=(4, 2, 5)).astype(np.float32))
    e1 = DetEngine(persist_dir=str(tmp_path))
    p1 = e1.plan(2, 5, batched=True, capacity=4, chunk=128, backend=backend,
                 device=CPU)
    want = p1(As)
    e1.flush_store()
    info1 = e1.cache_info()
    assert info1["store_misses"] == 1 and info1["store_hits"] == 0
    assert e1.store.stats()["entries"] == 1

    e2 = DetEngine(persist_dir=str(tmp_path))
    p2 = e2.plan(2, 5, batched=True, capacity=4, chunk=128, backend=backend,
                 device=CPU)
    info2 = e2.cache_info()
    assert info2["store_hits"] == 1 and info2["store_misses"] == 0
    assert torch.equal(p2(As), want)  # bit identity, no tolerance
    assert torch.equal(p2.grad(As, torch.ones(4)), p1.grad(As, torch.ones(4)))


def test_engine_prefill_from_store(tmp_path):
    e1 = DetEngine(persist_dir=str(tmp_path))
    e1.plan(2, 5, batched=True, capacity=4, chunk=128, device=CPU)
    e1.flush_store()

    e3 = DetEngine(persist_dir=str(tmp_path))
    assert e3.prefill() == 1
    info = e3.cache_info()
    assert info["size"] == 1 and info["store_hits"] == 1
    # the prefilled family is a plain cache hit for real traffic
    e3.plan(2, 5, batched=True, capacity=4, chunk=128, device=CPU)
    info = e3.cache_info()
    assert info["hits"] == 1 and info["misses"] == 1
    # entries that do not decode are skipped, as the reference's
    assert e3.prefill([{"m": 2}, "junk", None]) == 0


def test_engine_without_store_unchanged(tmp_path):
    e = DetEngine()
    e.plan(2, 5, batched=True, capacity=4, chunk=128, device=CPU)
    info = e.cache_info()
    assert info["store_hits"] == info["store_misses"] == 0
    assert e.store is None
    e.flush_store()  # no-op, must not raise
    assert e.prefill() == 0


def test_store_from_other_kernel_sources_is_a_miss(tmp_path, monkeypatch):
    """The env stamp carries the kernel sources' hash (and the torch and
    CUDA versions and the card): edited kernels make every record a
    miss, never a plan bound to the old library."""
    e1 = DetEngine(persist_dir=str(tmp_path))
    assert e1.store.env["kernels"] == _build._digest()
    assert e1.store.env["device"] == "cpu"
    e1.plan(2, 5, device=CPU)
    e1.flush_store()
    monkeypatch.setattr(_build, "_digest", lambda: "0" * 16)
    e2 = DetEngine(persist_dir=str(tmp_path))
    # before e2 writes anything: no record of the old sources is planned
    assert e2.prefill() == 0
    e2.plan(2, 5, device=CPU)
    assert e2.cache_info()["store_misses"] == 1
    # the miss wrote its family under the new stamp (write-behind): once
    # it has landed, an engine of the same sources warms it
    e2.flush_store()
    e3 = DetEngine(persist_dir=str(tmp_path))
    assert e3.prefill() == 1


# ------------------------------------------------- the kernel library
_LIBRARY_SCRIPT = """
import os, sys, types
from pathlib import Path
from repro_torch.kernels import _build

mode, store, build = sys.argv[1], Path(sys.argv[2]), Path(sys.argv[3])
_build.BUILD_DIR = build
compiled = []

def fake_compile(out):  # nvcc's stand-in: a file at the path asked for
    compiled.append(str(out))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(b"library " + _build._digest().encode())
    return "", {}

_build._compile = fake_compile
_build._bind = lambda lib: lib
_build.ctypes = types.SimpleNamespace(CDLL=lambda path: path)
if mode != "nostore":
    from repro_torch.core.engine import DetEngine
    DetEngine(persist_dir=str(store))
_build.load()
info = _build.build_info()
print(info["origin"], info["built"], info["path"], len(compiled))
"""


def _library_run(mode, store, build):
    out = subprocess.run(
        [sys.executable, "-c", _LIBRARY_SCRIPT, mode, str(store),
         str(build)], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    origin, built, path, compiled = out.stdout.split()
    return origin, built == "True", Path(path), int(compiled)


@pytest.mark.parametrize("case", ["built", "loaded", "copied"])
def test_store_houses_the_kernel_library(case, tmp_path):
    """A store built into holds the library under ``kernels/``; a process
    whose checkout never built loads it from there without compiling; a
    library already in ``build/`` is copied into a new store, not
    rebuilt.  Each case in a fresh interpreter (the setting is
    process-global)."""
    store, build = tmp_path / "store", tmp_path / "build"
    name = f"libradic_{_build._digest()}.so"
    if case == "built":
        got = _library_run("store", store, build)
        assert got == ("built", True, store / "kernels" / name, 1)
        assert not (build / name).exists()
    elif case == "loaded":
        _library_run("store", store, tmp_path / "other-checkout")
        got = _library_run("store", store, build)
        assert got == ("loaded", False, store / "kernels" / name, 0)
        assert not build.exists()
    else:
        assert _library_run("nostore", store, build) == (
            "built", True, build / name, 1)
        got = _library_run("store", store, build)
        assert got == ("copied", False, store / "kernels" / name, 0)
        assert (store / "kernels" / name).read_bytes() == \
            (build / name).read_bytes()
    assert [p.name for p in (store / "kernels").iterdir()] == [name]


def test_use_store_dir_defers_to_a_loaded_library(tmp_path, monkeypatch):
    """Once the library is loaded a store changes nothing (False), as the
    reference's cache defers to a configured one; before it, the first
    store named keeps the library."""
    monkeypatch.setattr(_build, "_store_dir", None)
    monkeypatch.setattr(_build, "_lib", object())
    assert _build.use_store_dir(tmp_path / "a") is False
    DetEngine(persist_dir=str(tmp_path / "b"))
    assert _build._store_dir is None
    assert not (tmp_path / "b" / "kernels").exists()
    monkeypatch.setattr(_build, "_lib", None)
    assert _build.use_store_dir(tmp_path / "a") is True
    assert _build.use_store_dir(tmp_path / "b") is True
    assert _build._store_dir == tmp_path / "a" / "kernels"
