"""The port's det_serve CLI against the reference CLI: the same seed
gives the same requests and the same determinants.  The front legs twin
``tests/test_det_serve_cli.py``'s: ``--workers``, ``--workers --shm`` and
``--listen``/``--connect``, each run as the real CLI in a subprocess on
the CPU (``--device cpu``)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.launch import det_serve as ref_serve  # noqa: E402
from repro_torch.launch import det_serve  # noqa: E402

ARGS = ["--num", "24", "--verify"]


def test_random_queue_equals_reference():
    for seed in (0, 1):
        for got, want in zip(det_serve._random_queue(40, 5, 12, seed),
                             ref_serve._random_queue(40, 5, 12, seed)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("extra,ref_extra", [
    ([], []),
    (["--sync"], ["--sync"]),
    (["--backend", "torch"], []),
    (["--policy", "merge"], ["--policy", "merge"]),
])
def test_main_matches_reference_dets(extra, ref_extra, capsys):
    dets, stats = det_serve.main([*ARGS, "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert re.search(r"^total,24 mats,[0-9.]+s,[0-9.]+ mats/s$", out,
                     re.MULTILINE)
    assert re.search(r"verify: worst rel err [0-9.e+-]+", out)
    want, _ = ref_serve.main([*ARGS, *ref_extra])
    capsys.readouterr()
    assert len(dets) == len(want) == 24
    np.testing.assert_allclose(dets, want, rtol=1e-3, atol=1e-4)


def test_async_stats_and_shedding(capsys):
    dets, stats = det_serve.main(["--num", "24", "--device", "cpu",
                                  "--max-pending", "5"])
    capsys.readouterr()
    assert stats["shed"] == 19 and sum(d is None for d in dets) == 19
    assert stats["completed"] == 5


@pytest.mark.parametrize("argv", [["--backend", "pallas"],
                                  ["--backend", "jnp"],
                                  ["--plan-store", "STORE", "--prefill"]])
def test_cli_rejects_reference_only_flags(argv, tmp_path, monkeypatch,
                                          capsys):
    """The JAX backends do not exist in the port.  The plan store's flags
    serve on the CPU, and a second run over the same store plans every
    family from it."""
    if "--plan-store" not in argv:
        with pytest.raises(SystemExit):
            det_serve.main(["--device", "cpu", *argv])
        return
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "_store_dir", _build._store_dir)
    argv = [str(tmp_path) if a == "STORE" else a for a in argv]
    first, cold = det_serve.main([*ARGS, "--device", "cpu", *argv])
    second, warm = det_serve.main([*ARGS, "--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert re.search(r"store_hits=0 store_misses=[1-9]", out)
    families = cold["plan_cache"]["misses"]
    assert cold["plan_cache"]["store_misses"] == families > 0
    assert warm["plan_cache"]["store_hits"] == families
    assert warm["plan_cache"]["store_misses"] == 0
    assert second == first
    assert len(os.listdir(tmp_path)) == families  # one record a family


def test_grad_mix_equals_reference_and_verifies(capsys):
    """--grad-frac submits the reference's value/grad mix for the seed; the
    verify leg checks every gradient against float64 autograd."""
    argv = ["--num", "24", "--grad-frac", "0.25", "--verify"]
    dets, stats = det_serve.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"verify: worst rel err [0-9.e+-]+, worst grad rel "
                     r"err [0-9.e+-]+", out)
    want, ref_stats = ref_serve.main(argv)
    capsys.readouterr()
    mix = det_serve._grad_mix(24, 0.25, 0)
    grng = np.random.default_rng(1)
    assert mix == [(bool(grng.random() < 0.25), 1.0) for _ in range(24)]
    assert sum(g for g, _ in mix) == stats["grad_dispatches"] > 0
    for (g, _), got, ref_got in zip(mix, dets, want):
        if g:
            assert isinstance(got, np.ndarray) and got.shape == ref_got.shape
            np.testing.assert_allclose(got, ref_got, rtol=1e-3, atol=1e-4)
        else:
            np.testing.assert_allclose(got, ref_got, rtol=1e-3, atol=1e-4)


def test_trace_out_records_the_queue_threads(tmp_path, capsys):
    """--trace-out writes a trace of every thread: the stager's
    ``queue.pack`` lies on a thread other than the main one, and the
    stats line carries the pipeline's readings."""
    import json
    import threading
    path = tmp_path / "trace.json"
    det_serve.main(["--num", "24", "--device", "cpu", "--trace-out",
                    str(path)])
    out = capsys.readouterr().out
    assert re.search(r"stage_busy_ms=[0-9.]+ stage_cpu_share=[0-9.]+% "
                     r"complete_host_ms=[0-9.]+ backlog_ms=[0-9.]+$", out,
                     re.MULTILINE)
    events = json.loads(path.read_text())["traceEvents"]
    packs = {e["tid"] for e in events if e.get("name") == "queue.pack"}
    assert packs and threading.get_native_id() not in packs
    with pytest.raises(SystemExit):
        det_serve.main(["--device", "cpu", "--sync", "--trace-out",
                        str(path)])


def test_grad_frac_is_async_only():
    with pytest.raises(SystemExit):
        det_serve.main(["--device", "cpu", "--grad-frac", "0.5", "--sync"])
    with pytest.raises(SystemExit):
        det_serve.main(["--device", "cpu", "--grad-frac", "1.5"])


# ------------------------------------------------------------ front legs
REPO = Path(__file__).resolve().parents[1]
COMMON = ["--num", "12", "--max-m", "3", "--max-n", "8", "--seed", "1",
          "--device", "cpu"]


def _run(*extra, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.det_serve", *COMMON,
         *extra], capture_output=True, text=True, timeout=timeout,
        cwd=REPO, env=env)


def _check_front_output(stdout: str, workers: int, label: str):
    m = re.search(r"^total,(\d+) mats,([0-9.]+)s,([0-9.]+) mats/s$",
                  stdout, re.MULTILINE)
    assert m and int(m.group(1)) == 12, stdout
    assert f"det_serve[{label}" in stdout
    m = re.search(r"^front: workers=(\d+)/(\d+) rerouted=(\d+) "
                  r"worker_deaths=(\d+) shed=(\d+)", stdout, re.MULTILINE)
    assert m, f"no front stats line in:\n{stdout}"
    assert m.group(1) == m.group(2) == str(workers)
    assert m.group(4) == "0"  # a clean run kills nobody
    # one per-worker stats row each, all requests accounted for
    rows = re.findall(r"^(\d+),(\d+),(\d+),(\d+),(\d+),(\d+),(\d+),"
                      r"(\d+),(\d+)$", stdout, re.MULTILINE)
    assert len(rows) == workers
    assert sum(int(x[2]) for x in rows) == 12  # completed column
    assert re.search(r"verify: worst rel err [0-9.e+-]+, worst grad rel "
                     r"err [0-9.e+-]+", stdout)


@pytest.mark.parametrize("workers", [1, 2])
def test_cli_front_smoke(workers):
    r = _run("--workers", str(workers), "--grad-frac", "0.25", "--verify")
    assert r.returncode == 0, r.stderr
    _check_front_output(r.stdout, workers, f"front x{workers}@local")


@pytest.mark.parametrize("workers", [1, 2])
def test_cli_front_shm_smoke(workers):
    """``--workers N --shm``: the shared-memory ring end to end through
    the CLI — exit 0, shm label in the report, every request completed
    and verified."""
    r = _run("--workers", str(workers), "--shm", "--grad-frac", "0.25",
             "--verify")
    assert r.returncode == 0, r.stderr
    _check_front_output(r.stdout, workers, f"front x{workers}@shm")


@pytest.mark.parametrize("workers", [1, 2])
def test_cli_listen_connect_loopback(workers):
    """The two-command multi-host recipe, loopback edition: worker
    daemons (``--listen``, separate processes) + a front (``--connect``)
    — exit 0 on both sides, stats parsed, results verified."""
    from repro_torch.launch.transport import spawn_worker_daemon
    daemons = []
    try:
        for _ in range(workers):
            daemons.append(spawn_worker_daemon(device="cpu"))
        addrs = ",".join(a for _, a in daemons)
        r = _run("--connect", addrs, "--grad-frac", "0.25", "--verify")
        assert r.returncode == 0, r.stderr
        _check_front_output(r.stdout, workers, f"front x{workers}@socket")
        for proc, _ in daemons:
            assert proc.wait(timeout=120) == 0  # --serve-once: clean exit
    finally:
        for proc, _ in daemons:
            proc.kill()
            proc.wait(timeout=30)


def test_cli_front_autoscale_and_accept(capsys):
    """``--autoscale`` and ``--accept`` through ``main``: the front
    report carries the autoscaler's line, every request is answered and
    equals the in-process queue's answer for the same command line."""
    argv = [*COMMON, "--grad-frac", "0.25"]
    want, _ = det_serve.main(argv)
    dets, stats = det_serve.main([*argv, "--workers", "1", "--autoscale",
                                  "2", "--accept", "127.0.0.1:0"])
    out = capsys.readouterr().out
    assert re.search(r"^autoscale: up=\d+ down=\d+ stalls=0$", out,
                     re.MULTILINE)
    assert stats["front"]["accept_address"].startswith("127.0.0.1:")
    assert stats["front"]["completed"] == 12
    for got, ref_got in zip(dets, want):
        np.testing.assert_array_equal(got, ref_got)
