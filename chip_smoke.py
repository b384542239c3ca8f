#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100, for the ``sm_90a`` kernels) and ``nvcc``.
It builds the kernels from ``src/repro_torch/kernels/csrc/`` and runs five
phases, each printing its lines:

1. device: the card's name and power limit, torch/CUDA versions, build
   time and the compiler's register/spill report;
2. K1 (``radic_batched_partial_cuda``) against its plain torch version in
   float64 on the card: shapes, batch sizes, partial rank ranges, singular
   minors, the top ranks of C(43, 10) just under 2**31, the plan-time
   guards, determinism and batch-slot independence;
3. K2 (``radic_partial_cuda``) against its plain version: the paper's
   (5, 24) over its full rank space, and ranks [6e7, 6.4e7) of (10, 34);
4. serving end to end: ``repro_torch.launch.det_serve.main`` on 512
   requests up to (8, 32) through the async DetQueue, every result held
   against the plain version in float64, K1's launch count equal to the
   queue's dispatch count; then a second, uncounted pass under
   ``torch.profiler`` for the card's busy share of the serving wall;
5. times: each kernel's ms beside its bound and its plain version's ms.

Every check holds ``|got - want| <= 2e-3 * max(1, |want|)`` (the
reference's tolerance against its oracles), ``want`` from the plain
version in float64.  Any failed check raises, and the script exits
non-zero.  The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.  Without a
card, or without ``src/repro_torch`` beside it, it exits non-zero and
prints no result.  It imports neither jax nor the JAX package ``repro``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = 2e-3
# Peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet): float32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SERVE_ARGS = ["--num", "512", "--max-m", "8", "--max-n", "32",
              "--max-batch", "64"]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(1, |want|) over the elements."""
    got = got.double().reshape(-1)
    want = want.double().reshape(-1)
    return ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.double().reshape(-1)
            - want.double().reshape(-1)).abs().max().item()


def ge_flops(m: int) -> int:
    """Float operations of one signed minor in the kernel: elimination
    (a division and m-1-k multiply-adds per row below pivot k), the
    diagonal product, the sign and the accumulation."""
    return sum(j * (1 + 2 * j) for j in range(1, m)) + (m - 1) + 2


def bound_ms(B: int, m: int, n: int, count: int) -> tuple[float, str]:
    """Least time for the work on one H100: the larger of its float32
    operations over the float32 peak and its bytes (each input read once,
    each output written once) over the memory rate."""
    ops = count * B * ge_flops(m)
    nbytes = 4 * (B * m * n + (n + 1) * (m + 1) + B)
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, min_reps: int = 3, min_s: float = 0.2) -> float:
    """Mean ms per call over CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    reps, total_ms = 0, 0.0
    while reps < min_reps or total_ms < min_s * 1e3:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total_ms += start.elapsed_time(end)
        reps += 1
    return total_ms / reps


class Errors:
    """Largest absolute and relative error seen per kernel."""

    def __init__(self):
        self.abs = {"K1": 0.0, "K2": 0.0}

    def hold(self, kernel: str, label: str, got, want,
             tol: float = TOL, track: bool = True) -> None:
        """Check one comparison; ``track=False`` keeps it out of the
        kernel's ``max_abs_err`` (a bf16 result's error is its rounding)."""
        r, a = rel_err(got, want), abs_err(got, want)
        if track:
            self.abs[kernel] = max(self.abs[kernel], a)
        print(f"{kernel} {label}: rel_err={r:.3e} abs_err={a:.3e} "
              f"(tol {tol:g})", flush=True)
        check(r <= tol, f"{kernel} {label}: rel_err {r:.3e} > {tol:g}")


def phase_device() -> None:
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    _build.load()
    info = _build.build_info()
    print(f"build: {info['seconds']:.1f} s (built={info['built']}) "
          f"{info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())


def phase_k1(errs: Errors, gen: torch.Generator) -> None:
    from repro_torch.core.engine import DetEngine, rank_table
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import ops
    from repro_torch.kernels.radic_fused import (
        radic_batched_partial_cuda as k1, radic_batched_partial_plain,
        radic_partial_cuda as k2)

    def plain64(As, q0, cnt):
        m, n = As.shape[1:]
        table = rank_table(n, m, backend="cuda", device="cuda")
        return radic_batched_partial_plain(As, table, q0, cnt,
                                           dtype=torch.float64,
                                           chunk=1 << 16)

    for m, n in [(1, 5), (2, 6), (3, 3), (3, 7), (4, 9), (5, 24), (8, 16),
                 (16, 20)]:
        total = comb(n, m)
        for B in (1, 3, 64):
            As = torch.randn(B, m, n, device="cuda", generator=gen)
            got = ops.radic_det_batched_cuda(As)
            torch.cuda.synchronize()
            errs.hold("K1", f"({m},{n}) B={B} full C={total}", got,
                      plain64(As, 0, total))

    # partial ranges: inside one tile, straddling tiles, q_start > 0
    m, n = 8, 16
    As = torch.randn(5, m, n, device="cuda", generator=gen)
    for q0, cnt in [(0, 1), (255, 2), (100, 1000), (3000, 1283),
                    (12000, 870)]:
        got = ops.radic_det_batched_cuda(As, q0, cnt)
        errs.hold("K1", f"(8,16) ranks [{q0},{q0 + cnt})", got,
                  plain64(As, q0, cnt))

    # duplicate and zero columns: many singular minors, det 0 not NaN
    As = torch.randn(3, 4, 9, device="cuda", generator=gen)
    As[:, :, 1] = As[:, :, 0]
    As[:, :, 3] = 2 * As[:, :, 0]
    As[:, :, 5] = 0
    got = ops.radic_det_batched_cuda(As)
    check(bool(torch.isfinite(got).all()), "singular minors gave non-finite")
    errs.hold("K1", "(4,9) duplicate+zero columns", got,
              plain64(As, 0, comb(9, 4)))
    sing = torch.randn(2, 5, 9, device="cuda", generator=gen)
    sing[:, 4] = sing[:, 0]   # equal rows: every minor is singular
    got = ops.radic_det_batched_cuda(sing)
    errs.hold("K1", "(5,9) equal rows", got, plain64(sing, 0, comb(9, 5)))

    # bf16 input: computed in float32, returned as bf16, whose 8
    # significant bits round by up to 2**-8 of the value (tolerance 1e-2)
    As = torch.randn(3, 3, 7, device="cuda", generator=gen)
    got = ops.radic_det_batched_cuda(As.to(torch.bfloat16))
    check(got.dtype == torch.bfloat16, f"bf16 in, {got.dtype} out")
    errs.hold("K1", "(3,7) bf16 input", got,
              plain64(As.to(torch.bfloat16), 0, comb(7, 3)), tol=1e-2,
              track=False)

    # the top ranks just under 2**31
    m, n = 10, 43
    total = comb(n, m)
    check(total == 1_917_334_783, f"C(43,10) = {total}")
    As = torch.randn(3, m, n, device="cuda", generator=gen)
    got = ops.radic_det_batched_cuda(As, total - 5000, 5000)
    errs.hold("K1", "(10,43) top 5000 ranks", got,
              plain64(As, total - 5000, 5000))

    # plan-time guards and m > n
    for fn in (lambda: DetEngine().plan(10, 44, backend="cuda"),
               lambda: ops.radic_det_batched_cuda(
                   torch.zeros(2, 10, 44, device="cuda"))):
        try:
            fn()
        except OverflowError as e:
            print(f"K1 (10,44): OverflowError at plan time: {e}")
        else:
            raise AssertionError("(10,44) did not raise OverflowError")
    before = k1.launches
    z = ops.radic_det_batched_cuda(torch.randn(3, 5, 4, device="cuda",
                                               generator=gen))
    check(z.shape == (3,) and not bool(z.any()) and k1.launches == before,
          "m > n must return zeros without a launch")
    print("K1 m>n: zeros, no launch")

    # determinism and batch independence (bit-identical)
    m, n = 6, 18
    As = torch.randn(64, m, n, device="cuda", generator=gen)
    first = ops.radic_det_batched_cuda(As)
    again = ops.radic_det_batched_cuda(As)
    check(torch.equal(first, again), "K1 repeat is not bit-identical")
    alone = ops.radic_det_batched_cuda(As[37:38].clone())
    check(torch.equal(alone[0], first[37]),
          "K1 slot 37 of 64 differs from the matrix alone")
    scalar = ops.radic_det_cuda(As[37].clone())
    check(torch.equal(scalar, first[37]), "K2 differs from K1 at B=1")
    check(k2.launches > 0, "K2 entry did not launch")
    print("K1 determinism: repeat, slot 37/64 vs alone and K2: bit-identical")


def phase_k2(errs: Errors, gen: torch.Generator) -> dict:
    from repro_torch.core import radic_det
    from repro_torch.core.engine import rank_table
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import ops, reset_launch_counts
    from repro_torch.kernels.radic_fused import (
        radic_batched_partial_cuda as k1, radic_partial_cuda as k2,
        radic_partial_plain)

    def plain64(A, q0, cnt):
        m, n = A.shape
        table = rank_table(n, m, backend="cuda", device="cuda")
        return radic_partial_plain(A, table, q0, cnt, dtype=torch.float64,
                                   chunk=1 << 19)

    paper = torch.randn(5, 24, device="cuda", generator=gen)
    big = torch.randn(10, 34, device="cuda", generator=gen)
    # the scalar path, with counts zeroed just before and read just after
    reset_launch_counts()
    got_paper = radic_det(paper, backend="cuda")
    got_full = radic_det(big, backend="cuda")
    torch.cuda.synchronize()
    launches = {"K1": k1.launches, "K2": k2.launches}
    print(f"scalar path launches: {launches}")
    check(launches["K2"] == 2, "radic_det did not go through K2")
    errs.hold("K2", "paper (5,24) full C=42504", got_paper,
              plain64(paper, 0, comb(24, 5)))
    check(bool(torch.isfinite(got_full)), "(10,34) full is not finite")
    got = ops.radic_det_cuda(big, 60_000_000, 4_000_000)
    errs.hold("K2", "(10,34) ranks [6e7,6.4e7)", got,
              plain64(big, 60_000_000, 4_000_000))
    return {"launches": launches["K2"], "big": big}


def phase_serve(errs: Errors) -> dict:
    from repro_torch.core.engine import rank_table
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.radic_fused import (
        radic_batched_partial_cuda as k1, radic_batched_partial_plain)
    from repro_torch.launch import det_serve

    reset_launch_counts()
    t0 = time.perf_counter()
    dets, stats = det_serve.main(SERVE_ARGS)
    wall = time.perf_counter() - t0
    launches = k1.launches
    print(f"serve: dispatches={stats['dispatches']} K1 launches={launches} "
          f"wall={wall:.3f}s")
    check(launches == stats["dispatches"] and launches > 0,
          f"K1 launches {launches} != dispatches {stats['dispatches']}")
    check(stats["completed"] == 512 and all(d is not None for d in dets),
          "serving left a request unanswered")

    mats = det_serve._random_queue(512, 8, 32, 0)
    by_shape: dict[tuple[int, int], list[int]] = {}
    for i, A in enumerate(mats):
        by_shape.setdefault(A.shape, []).append(i)
    worst, minors = 0.0, 0
    for (m, n), idxs in sorted(by_shape.items()):
        As = torch.from_numpy(np.stack([mats[i] for i in idxs])).cuda()
        table = rank_table(n, m, backend="cuda", device="cuda")
        chunk = max(1, (1 << 27) // (len(idxs) * m * m))
        want = radic_batched_partial_plain(
            As, table, 0, comb(n, m), dtype=torch.float64, chunk=chunk)
        got = torch.tensor([dets[i] for i in idxs], dtype=torch.float64)
        errs.abs["K1"] = max(errs.abs["K1"], abs_err(got, want.cpu()))
        worst = max(worst, rel_err(got, want.cpu()))
        minors += comb(n, m) * len(idxs)
    print(f"K1 serving: all 512 results vs plain float64: "
          f"rel_err={worst:.3e} (tol {TOL:g}), {minors} minors")
    check(worst <= TOL, f"serving rel_err {worst:.3e} > {TOL:g}")
    print(f"serve: {512 / wall:.1f} mats/s, {stats['ranks'] / wall:.4e} "
          f"ranks/s (queue ranks {stats['ranks']}, exact-shape minors "
          f"{minors})")
    return {"launches": launches, "stats": stats}


def serve_trace() -> None:
    """Where the serving time goes: a second, uncounted serving pass under
    ``torch.profiler``; device busy time is the union of the card's
    kernel and copy intervals, against the host's wall clock."""
    import contextlib
    import io

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import det_serve

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            det_serve.main(SERVE_ARGS)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print("serve trace: the profiler saw no device activity "
              "(device busy share not measured)")
        return
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in dev):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    k1 = [e for e in dev if "radic_partial_kernel" in e.name]
    k1_us = sum(e.time_range.elapsed_us() for e in k1)
    print(f"serve trace: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({busy / wall_us:.2%}, idle "
          f"{1 - busy / wall_us:.2%}); K1 kernel {k1_us / 1e3:.3f} ms in "
          f"{len(k1)} launches; {len(dev)} device events")


def phase_times(gen: torch.Generator, serve: dict, k2_big) -> list[dict]:
    from repro_torch.core import radic_det
    from repro_torch.core.engine import rank_table
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import ops
    from repro_torch.kernels.radic_fused import (
        radic_batched_partial_plain, radic_partial_plain)

    # K1 at the serving bucket that holds the most ranks
    (m, n), b = max(serve["stats"]["buckets"].items(),
                    key=lambda kv: kv[1]["ranks"])
    B = min(b["count"], 64)
    total = comb(n, m)
    As = torch.randn(B, m, n, device="cuda", generator=gen)
    table = rank_table(n, m, backend="cuda", device="cuda")
    k1_ms = cuda_ms(lambda: ops.radic_det_batched_cuda(As, table=table))
    k1_plain = cuda_ms(lambda: radic_batched_partial_plain(
        As, table, 0, total, chunk=1 << 18), min_reps=1, min_s=0)
    k1_bound, k1_by = bound_ms(B, m, n, total)
    print(f"time K1 ({B},{m},{n}) C={total}: kernel {k1_ms:.4f} ms, "
          f"bound {k1_bound:.4f} ms ({k1_by}), plain {k1_plain:.4f} ms, "
          "library: no single PyTorch call computes this function")

    m, n = k2_big.shape
    total = comb(n, m)
    table = rank_table(n, m, backend="cuda", device="cuda")
    k2_ms = cuda_ms(lambda: radic_det(k2_big, backend="cuda"))
    k2_plain = cuda_ms(lambda: radic_partial_plain(
        k2_big, table, 0, total, chunk=1 << 20), min_reps=1, min_s=0)
    k2_bound, k2_by = bound_ms(1, m, n, total)
    print(f"time K2 ({m},{n}) C={total}: radic_det {k2_ms:.4f} ms, "
          f"bound {k2_bound:.4f} ms ({k2_by}), plain {k2_plain:.4f} ms, "
          "library: no single PyTorch call computes this function")
    return [
        {"ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "shape": [B, *As.shape[1:]]},
        {"ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "shape": [1, m, n]},
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = Errors()
    t0 = time.perf_counter()

    def done(phase: str) -> None:
        print(f"phase {phase} passed at {time.perf_counter() - t0:.1f} s",
              flush=True)

    phase_device()
    done("1 device")
    phase_k1(errs, gen)
    done("2 K1")
    k2 = phase_k2(errs, gen)
    done("3 K2")
    serve = phase_serve(errs)
    serve_trace()
    done("4 serving")
    times = phase_times(gen, serve, k2["big"])
    done("5 times")
    src = "src/repro_torch/kernels/csrc/radic_fused.cu"
    rows = []
    for name, kernel, replaces, launches, t in [
            ("radic_batched_partial_cuda", "K1",
             "src/repro/kernels/radic_fused.py:156", serve["launches"],
             times[0]),
            ("radic_partial_cuda", "K2",
             "src/repro/kernels/radic_fused.py:39", k2["launches"],
             times[1])]:
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": errs.abs[kernel], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None,
                     "timed_shape": t["shape"]})
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
