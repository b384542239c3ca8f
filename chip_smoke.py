#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100, for the ``sm_90a`` kernels) and ``nvcc``.
It builds the kernels from ``src/repro_torch/kernels/csrc/`` (one ``nvcc``
per source, all at once) and runs these phases, each printing its lines:

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
5. K3 (``radic_batched_grad_partial_cuda``, the backward kernel) against
   its plain version in float64, by the serving verify's rule for
   gradients (``grad_rel_err``): shapes, batch sizes and cotangents with
   zeros and negatives, partial rank ranges, the top ranks of C(43, 10),
   the four singular inputs (zero column, duplicate columns, rank 1,
   exact integers), stacks with a duplicate or a zero column at (8, 16)
   and (16, 20), m > n, the plan-time guard, determinism, batch-slot
   independence and the B = 1 entry (``radic_grad_partial_cuda``); the
   torch backend's gradient on the card, bit-identical across runs and
   batch slots;
6. autograd: ``torch.autograd.grad(radic_det(A), A)`` equals
   ``plan.grad(A, 1.0)`` bit for bit through one K3 launch;
7. gradient serving: ``det_serve.main`` on the same 512 requests with
   ``--grad-frac 0.25 --verify`` (every value and gradient checked in
   float64 on another code path), K3's launches equal to the queue's
   gradient dispatches and K1's to its value dispatches; then an
   uncounted pass under ``torch.profiler``, as in phase 4;
8. K4 (``radic_batched_partial_bygrid_cuda``) equal to K1 bit for bit,
   K5 (``unrank_cuda``) equal to its plain version on every rank of
   C(24, 12), K6 (``minor_det_cuda``) against its plain version in
   float64, singular and row-permuted matrices included; each entry is
   driven with the counts set to 0 just before and read just after;
9. times: each kernel's device time per call (``torch.profiler``, the
   host's share left out) beside its bound, its plain version's wall time
   per call and, for K6, ``torch.linalg.det``'s device time.

Every check holds ``|got - want| <= 2e-3 * max(1, |want|)`` (the
reference's tolerance against its oracles), ``want`` from the plain
version in float64, unless it names another tolerance.  Any failed check
raises, and the script exits non-zero.  The line before the last is a JSON object with one entry per
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
# 32-bit integer operations issue at half the float32 rate on Hopper (64
# INT32 lanes per SM and clock against 128 FP32; architecture white paper)
PEAK_INT32_OPS = PEAK_F32_FLOPS / 2
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


def grad_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The serving verify's rule for a gradient: per matrix of a
    ``(..., m, n)`` stack, max |got - want| / max(1, max |want|).  Its
    entries are sums with heavy cancellation, so an entry can be far
    smaller than the matrix's scale: per entry, even the plain float32
    version misses 2e-3 at (16, 20)."""
    m, n = want.shape[-2:]
    got = got.double().reshape(-1, m * n)
    want = want.double().reshape(-1, m * n)
    return ((got - want).abs().amax(1)
            / want.abs().amax(1).clamp(min=1.0)).max().item()


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.double().reshape(-1)
            - want.double().reshape(-1)).abs().max().item()


def ge_flops(m: int) -> int:
    """Float operations of one signed minor in the kernel: elimination
    (a division and m-1-k multiply-adds per row below pivot k), the
    diagonal product, the sign and the accumulation."""
    return sum(j * (1 + 2 * j) for j in range(1, m)) + (m - 1) + 2


def grad_flops(m: int) -> int:
    """Float operations of one (rank, matrix) pair in the backward kernel
    (nonsingular branch): the LU (a division and m-1-k multiply-adds per
    row below pivot k), det(U)·U⁻¹ (products of the other pivots, then a
    back-substitution), the product with L⁻¹, the m² scaled cofactors and
    the m² adds of the scatter."""
    lu = sum(j * (1 + 2 * j) for j in range(1, m))
    pivots = m * (m - 1)
    back = sum(2 * (c - r) + 1 for c in range(m) for r in range(c))
    linv = m * m * (m - 1)
    return lu + pivots + back + linv + 2 + 2 * m * m


def det_flops(m: int) -> int:
    """Float operations of one determinant in the K6 kernel: elimination,
    the diagonal product and the sign."""
    return sum(j * (1 + 2 * j) for j in range(1, m)) + (m - 1) + 1


def roofline(ops: float, nbytes: float,
             peak_ops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time on one H100, ms: the larger of the operations over
    their peak rate and the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound_ms(B: int, m: int, n: int, count: int) -> tuple[float, str]:
    """K1's (and K2's, K4's) least time: float32 operations of the signed
    minors, bytes of the stack, the table and the (B,) result."""
    return roofline(count * B * ge_flops(m),
                    4 * (B * m * n + (n + 1) * (m + 1) + B))


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


def busy_us(events) -> float:
    """The union of the device events' intervals, µs."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


def device_ms(fn, reps: int = 10) -> float:
    """Mean device time per call, ms: ``reps`` calls after a warm-up
    under ``torch.profiler``, the union of the card's kernel, copy and
    fill intervals over ``reps``.  The host's share of each call (casts,
    allocations, the ctypes call) is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(dev), "the profiler saw no device activity")
    return busy_us(dev) / reps / 1e3


class Errors:
    """Largest absolute and relative error seen per kernel."""

    def __init__(self):
        self.abs = {k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5", "K6")}

    def hold(self, kernel: str, label: str, got, want,
             tol: float = TOL, track: bool = True) -> None:
        """Check one comparison; ``track=False`` keeps it out of the
        kernel's ``max_abs_err`` (a bf16 result's error is its rounding).
        K3's gradients are held by :func:`grad_rel_err`."""
        r = grad_rel_err(got, want) if kernel == "K3" else rel_err(got, want)
        a = abs_err(got, want)
        if track:
            self.abs[kernel] = max(self.abs[kernel], a)
        print(f"{kernel} {label}: rel_err={r:.3e} abs_err={a:.3e} "
              f"(tol {tol:g})", flush=True)
        check(r <= tol, f"{kernel} {label}: rel_err {r:.3e} > {tol:g}")


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel family of ``nvcc -Xptxas -v``'s report:
    registers (and spill stores, where any) by template instance."""
    import re
    fams: dict[str, list[str]] = {}
    fam = inst = ""
    for line in log.splitlines():
        hit = re.search(r"entry function '_ZN5radic(\d+)(\w+)'", line)
        if hit:
            size, rest = int(hit.group(1)), hit.group(2)
            fam = rest[:size]
            args = re.match(r"I((?:Li\d+E|[fd])+)E", rest[size:])
            inst = "<" + ",".join(
                a or b for a, b in re.findall(r"Li(\d+)E|([fd])",
                                              args.group(1))) + ">" \
                if args else ""
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and int(spill.group(1)):
            fams.setdefault(fam, []).append(
                f"{inst} spills {spill.group(1)} B")
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            fams.setdefault(fam, []).append(f"{inst}{regs.group(1)}r")
    return [f"{f}: {' '.join(v)}" for f, v in sorted(fams.items())]


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
    for line in ptxas_summary(info["log"]):
        print("ptxas:", line)
    lib = _build.load()
    print(f"K3 rank tiles for m = 1..16: "
          f"{[lib.radic_grad_tile(m) for m in range(1, 17)]}")


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


def serve_trace(extra: tuple[str, ...] = ()) -> None:
    """Where the serving time goes: a second, uncounted serving pass
    (``SERVE_ARGS`` plus ``extra``) under ``torch.profiler``; device busy
    time is the union of the card's kernel and copy intervals, against
    the host's wall clock."""
    import contextlib
    import io

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import det_serve

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            det_serve.main([*SERVE_ARGS, *extra])
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print("serve trace: the profiler saw no device activity "
              "(device busy share not measured)")
        return
    busy = busy_us(dev)
    kernels = []
    for label, name in [("K1", "radic_partial_kernel"),
                        ("K3", "radic_grad_partial_kernel")]:
        evs = [e for e in dev if name in e.name]
        if evs:
            us = sum(e.time_range.elapsed_us() for e in evs)
            kernels.append(f"{label} kernel {us / 1e3:.3f} ms in "
                           f"{len(evs)} launches")
    print(f"serve trace{' ' + ' '.join(extra) if extra else ''}: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({busy / wall_us:.2%}, idle {1 - busy / wall_us:.2%}); "
          f"{'; '.join(kernels)}; {len(dev)} device events")

def _singular_inputs() -> dict[str, torch.Tensor]:
    """A zero column, duplicate columns, rank 1 (true gradient 0), exact
    integers with two equal columns — minors with exactly zero pivots."""
    rng = np.random.default_rng(0)
    zero = rng.normal(size=(3, 5))
    zero[:, 2] = 0
    dup = rng.normal(size=(3, 6))
    dup[:, 1] = dup[:, 0]
    dup[:, 3] = 2 * dup[:, 0]
    rank1 = np.outer(rng.normal(size=3), rng.normal(size=6))
    ints = rng.integers(-3, 4, size=(3, 5)).astype(np.float64)
    ints[:, 3] = ints[:, 1]
    return {k: torch.tensor(v, dtype=torch.float32, device="cuda")
            for k, v in [("zero column", zero), ("duplicate columns", dup),
                         ("rank 1", rank1), ("integer duplicate", ints)]}


def phase_k3(errs: Errors, gen: torch.Generator) -> None:
    from repro_torch.core.engine import DetEngine, rank_table
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import ops
    from repro_torch.kernels.radic_fused import (
        radic_batched_grad_partial_cuda as k3,
        radic_batched_grad_partial_plain, radic_grad_partial_cuda as k3one)

    def plain64(As, cts, q0, cnt):
        m, n = As.shape[1:]
        table = rank_table(n, m, backend="cuda", device="cuda")
        chunk = max(1, (1 << 22) // (As.shape[0] * m * m))
        return radic_batched_grad_partial_plain(
            As, cts, table, q0, cnt, dtype=torch.float64, chunk=chunk)

    def cotangents(B):
        cts = torch.randn(B, device="cuda", generator=gen)
        if B > 1:
            cts[0] = 0.0
            cts[1] = -abs(float(cts[1])) - 0.5
        return cts

    for m, n in [(1, 5), (2, 6), (3, 3), (3, 7), (4, 9), (5, 24), (8, 16),
                 (16, 20)]:
        total = comb(n, m)
        for B in (1, 3, 64):
            As = torch.randn(B, m, n, device="cuda", generator=gen)
            cts = cotangents(B)
            got = ops.radic_det_batched_grad_cuda(As, cts)
            torch.cuda.synchronize()
            check(got.shape == (B, m, n), f"K3 shape {tuple(got.shape)}")
            errs.hold("K3", f"({m},{n}) B={B} full C={total}", got,
                      plain64(As, cts, 0, total))
            if B > 1:
                check(not bool(got[0].any()), "K3: ct = 0 is not exactly 0")

    # partial ranges: inside one tile, straddling tiles and blocks
    m, n = 8, 16
    As = torch.randn(5, m, n, device="cuda", generator=gen)
    cts = cotangents(5)
    for q0, cnt in [(0, 1), (127, 2), (100, 1000), (3000, 1283),
                    (12000, 870)]:
        got = ops.radic_det_batched_grad_cuda(As, cts, q0, cnt)
        errs.hold("K3", f"(8,16) ranks [{q0},{q0 + cnt})", got,
                  plain64(As, cts, q0, cnt))

    # the top ranks just under 2**31
    m, n = 10, 43
    total = comb(n, m)
    As = torch.randn(3, m, n, device="cuda", generator=gen)
    cts = cotangents(3)
    got = ops.radic_det_batched_grad_cuda(As, cts, total - 5000, 5000)
    errs.hold("K3", "(10,43) top 5000 ranks", got,
              plain64(As, cts, total - 5000, 5000))

    # exactly zero pivots: the explicit-cofactor branch
    for name, A in _singular_inputs().items():
        got = ops.radic_det_grad_cuda(A, 1.0)
        check(bool(torch.isfinite(got).all()), f"K3 {name}: non-finite")
        errs.hold("K3", f"{name} {tuple(A.shape)}", got,
                  plain64(A[None], torch.ones(1, device="cuda"), 0,
                          comb(A.shape[1], A.shape[0]))[0])
    # the same branch at large m (at m = 14..16 in its own translation
    # unit): stacks with a duplicate or a zero column, nonzero cotangents
    for m, n in [(8, 16), (16, 20)]:
        for name, col in [("duplicate column", 1), ("zero column", 5)]:
            As = torch.randn(3, m, n, device="cuda", generator=gen)
            As[:, :, col] = As[:, :, 0] if col == 1 else 0.0
            cts = torch.tensor([1.0, -0.75, 2.5], device="cuda")
            got = ops.radic_det_batched_grad_cuda(As, cts)
            check(bool(torch.isfinite(got).all()),
                  f"K3 ({m},{n}) {name}: non-finite")
            errs.hold("K3", f"({m},{n}) B=3 {name}", got,
                      plain64(As, cts, 0, comb(n, m)))
    zeros = torch.zeros(4, 3, 7, device="cuda")
    got = ops.radic_det_batched_grad_cuda(zeros, torch.ones(4,
                                                            device="cuda"))
    check(not bool(got.any()), "K3: zero matrices must give exact zeros")

    # m > n and the plan-time guard
    before = k3.launches
    z = ops.radic_det_batched_grad_cuda(
        torch.randn(3, 5, 4, device="cuda", generator=gen), [1.0] * 3)
    check(z.shape == (3, 5, 4) and not bool(z.any())
          and k3.launches == before, "K3 m > n must return zeros, no launch")
    try:
        DetEngine().plan(10, 44, backend="cuda", device="cuda").grad(
            torch.zeros(1, 10, 44, device="cuda"), [1.0])
    except OverflowError as e:
        print(f"K3 (10,44): OverflowError at plan time: {e}")
    else:
        raise AssertionError("(10,44) did not raise OverflowError")
    print("K3 m>n: zeros, no launch")

    # determinism, batch independence and the B = 1 entry (bit-identical)
    m, n = 6, 18
    As = torch.randn(64, m, n, device="cuda", generator=gen)
    cts = cotangents(64)
    first = ops.radic_det_batched_grad_cuda(As, cts)
    again = ops.radic_det_batched_grad_cuda(As, cts)
    check(torch.equal(first, again), "K3 repeat is not bit-identical")
    alone = ops.radic_det_batched_grad_cuda(As[37:38].clone(),
                                            cts[37:38].clone())
    check(torch.equal(alone[0], first[37]),
          "K3 slot 37 of 64 differs from the matrix alone")
    scalar = ops.radic_det_grad_cuda(As[37].clone(), float(cts[37]))
    check(torch.equal(scalar, first[37]),
          "K3's B = 1 entry differs from the batched entry")
    check(k3one.launches > 0, "K3's B = 1 entry did not launch")
    print("K3 determinism: repeat, slot 37/64 vs alone and the B = 1 "
          "entry: bit-identical")

    # the torch backend's gradient on the card: a fixed-order scatter, so
    # the same bits again and alone as at slot 37 of 64
    plan = DetEngine().plan(m, n, backend="torch", device="cuda")
    tfirst = plan.grad(As, cts)
    check(torch.equal(tfirst, plan.grad(As, cts)),
          "torch backend gradient repeat is not bit-identical")
    check(torch.equal(plan.grad(As[37:38].clone(), cts[37:38].clone())[0],
                      tfirst[37]),
          "torch backend gradient: slot 37 of 64 differs from alone")
    err = grad_rel_err(tfirst, first)
    check(err <= TOL, f"torch backend gradient vs K3: {err:.3e}")
    print(f"torch backend gradient: repeat and slot 37/64 vs alone "
          f"bit-identical; against K3 rel_err={err:.3e}")


def phase_autograd(gen: torch.Generator) -> dict:
    from repro_torch.core import radic_det
    from repro_torch.core.engine import default_engine
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.radic_fused import (
        radic_batched_grad_partial_cuda as k3,
        radic_grad_partial_cuda as k3one)

    A = torch.randn(6, 20, device="cuda", generator=gen)
    plan = default_engine().plan(6, 20, batched=False, dtype=A.dtype,
                                 backend="cuda", device="cuda")
    want = plan.grad(A, 1.0)
    T = A.clone().requires_grad_(True)
    reset_launch_counts()
    (got,) = torch.autograd.grad(radic_det(T, backend="cuda"), T)
    torch.cuda.synchronize()
    launches = k3one.launches + k3.launches
    print(f"autograd: radic_det (6,20) backward through "
          f"{k3one.launches} K3 launch(es) at B = 1, {k3.launches} batched")
    check(k3one.launches == 1 and k3.launches == 0,
          f"autograd made {launches} K3 launches, not one")
    check(torch.equal(got, want),
          "autograd differs from plan.grad(A, 1.0) bit for bit")
    print("autograd: equal to plan.grad(A, 1.0) bit for bit")
    return {"launches": k3one.launches, "A": A}


def phase_grad_serve() -> dict:
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.radic_fused import (
        radic_batched_grad_partial_cuda as k3,
        radic_batched_partial_cuda as k1)
    from repro_torch.launch import det_serve

    reset_launch_counts()
    t0 = time.perf_counter()
    dets, stats = det_serve.main([*SERVE_ARGS, "--grad-frac", "0.25",
                                  "--verify"])
    wall = time.perf_counter() - t0
    grads, values = stats["grad_dispatches"], \
        stats["dispatches"] - stats["grad_dispatches"]
    print(f"grad serve: dispatches={stats['dispatches']} "
          f"(grad {grads}, value {values}), K3 launches={k3.launches}, "
          f"K1 launches={k1.launches}, wall {wall:.3f}s with --verify")
    check(k3.launches == grads > 0,
          f"K3 launches {k3.launches} != grad dispatches {grads}")
    check(k1.launches == values > 0,
          f"K1 launches {k1.launches} != value dispatches {values}")
    n_grad = sum(isinstance(d, np.ndarray) for d in dets)
    check(stats["completed"] == 512 and all(d is not None for d in dets),
          "gradient serving left a request unanswered")
    print(f"grad serve: all 512 answered and verified ({n_grad} gradients, "
          f"{512 - n_grad} values)")
    return {"launches": k3.launches, "stats": stats}


def phase_k456(errs: Errors, gen: torch.Generator) -> dict:
    from repro_torch.core.engine import rank_table
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import ops, reset_launch_counts
    from repro_torch.kernels.minor_det import minor_det_cuda, minor_det_plain
    from repro_torch.kernels.radic_fused import (
        radic_batched_partial_bygrid_cuda as k4, radic_batched_partial_plain)
    from repro_torch.kernels.unrank_kernel import unrank_cuda, unrank_plain

    launches = {}
    # K4 == K1 bit for bit on the parity shapes and partial ranges
    cases = []
    for m, n in [(2, 6), (3, 7), (1, 5), (3, 3), (4, 9)]:
        for cap in (1, 2, 8):
            cases.append((torch.randn(cap, m, n, device="cuda",
                                      generator=gen), 0, comb(n, m)))
    As = torch.randn(4, 3, 9, device="cuda", generator=gen)
    cases += [(As, q0, cnt) for q0, cnt in [(0, 84), (10, 40), (60, 24)]]
    As = torch.randn(5, 8, 16, device="cuda", generator=gen)
    cases += [(As, q0, cnt) for q0, cnt in [(100, 1000), (3000, 1283),
                                            (12000, 870)]]
    reset_launch_counts()
    got = [ops.radic_det_batched_cuda_bygrid(A, q0, cnt)
           for A, q0, cnt in cases]
    torch.cuda.synchronize()
    launches["K4"] = k4.launches
    check(k4.launches == len(cases), f"K4 launches {k4.launches}")
    for (A, q0, cnt), g in zip(cases, got):
        check(torch.equal(g, ops.radic_det_batched_cuda(A, q0, cnt)),
              f"K4 differs from K1 on {tuple(A.shape)} [{q0},{q0 + cnt})")
        m, n = A.shape[1:]
        want = radic_batched_partial_plain(
            A, rank_table(n, m, device="cuda"), q0, cnt, dtype=torch.float64)
        errs.abs["K4"] = max(errs.abs["K4"], abs_err(g, want))
        check(rel_err(g, want) <= TOL, "K4 disagrees with its plain version")
    print(f"K4: equal to K1 bit for bit on {len(cases)} cases, max abs err "
          f"{errs.abs['K4']:.3e} against plain float64")

    # K5 on every rank of C(24, 12)
    n, m = 24, 12
    qs = torch.arange(comb(n, m), dtype=torch.int32, device="cuda")
    reset_launch_counts()
    combos = ops.unrank(qs, n, m)
    torch.cuda.synchronize()
    launches["K5"] = unrank_cuda.launches
    check(unrank_cuda.launches == 1, "K5 did not launch once")
    want = unrank_plain(qs, n, m, rank_table(n, m, device="cuda"))
    check(torch.equal(combos, want),
          "K5 differs from its plain version on C(24,12)")
    print(f"K5: all {len(qs)} ranks of C(24,12) equal to the plain version")

    # K6 at (2048, 8, 8): random, singular (equal rows) and row-permuted
    M = torch.randn(2048, 8, 8, device="cuda", generator=gen)
    M[1::4, 5] = M[1::4, 2]
    M[2::4] = M[0::4][:, torch.tensor([1, 0, 2, 3, 4, 5, 6, 7])]
    M[3::4, :, 4] = 0
    reset_launch_counts()
    got32 = ops.minor_det(M)
    got64 = ops.minor_det(M.double())
    torch.cuda.synchronize()
    launches["K6"] = minor_det_cuda.launches
    check(minor_det_cuda.launches == 2, "K6 did not launch twice")
    want = minor_det_plain(M.double())
    errs.abs["K6"] = abs_err(got32, want)
    print(f"K6 (2048,8,8) float32: rel_err={rel_err(got32, want):.3e} "
          f"abs_err={errs.abs['K6']:.3e} (tol 5e-4)")
    check(rel_err(got32, want) <= 5e-4, "K6 float32 beyond 5e-4")
    check(rel_err(got64, want) <= 1e-10, "K6 float64 beyond 1e-10")
    check(not bool(got32[1::4].any() | got32[3::4].any()),
          "K6: singular matrices must give exactly 0")
    check(torch.equal(got64[2::4], -got64[0::4]),
          "K6: one row swap must negate the determinant exactly")
    print(f"K6 float64: rel_err={rel_err(got64, want):.3e}; singular rows "
          "give 0, a row swap negates")
    return launches


def phase_times(gen: torch.Generator, serve: dict, k2_big,
                grad_A: torch.Tensor) -> dict:
    from repro_torch.core import radic_det
    from repro_torch.core.engine import rank_table
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import ops
    from repro_torch.kernels.minor_det import minor_det_plain
    from repro_torch.kernels.radic_fused import (
        radic_batched_grad_partial_plain, radic_batched_partial_plain,
        radic_grad_partial_plain, radic_partial_plain)
    from repro_torch.kernels.unrank_kernel import unrank_cuda, unrank_plain

    times = {}

    def record(kernel, label, shape, call, plain, bound, library=None):
        """``ms`` (and ``library_ms``) is the device time of one call,
        from the profiler; the call's wall time, host included, is
        printed beside it.  ``plain`` is the plain version's wall time."""
        ms, wall = device_ms(call), cuda_ms(call)
        lib_ms = device_ms(library) if library is not None else None
        times[kernel] = {"ms": ms, "plain_ms": plain, "bound_ms": bound[0],
                         "bound_by": bound[1], "library_ms": lib_ms,
                         "shape": list(shape)}
        lib = (f"library {lib_ms:.4f} ms on the device, "
               f"{cuda_ms(library):.4f} ms a call" if library is not None
               else "library: no single PyTorch call computes this function")
        print(f"time {kernel} {label}: kernel {ms:.4f} ms on the device "
              f"({wall:.4f} ms a call), bound {bound[0]:.4f} ms "
              f"({bound[1]}), plain {plain:.4f} ms, {lib}", flush=True)

    # K1, K3 and K4 at the serving bucket that holds the most ranks
    (m, n), b = max(serve["stats"]["buckets"].items(),
                    key=lambda kv: kv[1]["ranks"])
    B = min(b["count"], 64)
    total = comb(n, m)
    As = torch.randn(B, m, n, device="cuda", generator=gen)
    cts = torch.randn(B, device="cuda", generator=gen)
    table = rank_table(n, m, backend="cuda", device="cuda")
    label = f"({B},{m},{n}) C={total}"
    plain_ms = cuda_ms(lambda: radic_batched_partial_plain(
        As, table, 0, total, chunk=1 << 18), min_reps=1, min_s=0)
    record("K1", label, (B, m, n),
           lambda: ops.radic_det_batched_cuda(As, table=table),
           plain_ms, bound_ms(B, m, n, total))
    record("K3", label, (B, m, n),
           lambda: ops.radic_det_batched_grad_cuda(As, cts, table=table),
           cuda_ms(lambda: radic_batched_grad_partial_plain(
               As, cts, table, 0, total, chunk=1 << 16), min_reps=1,
               min_s=0),
           roofline(total * B * grad_flops(m),
                    4 * (2 * B * m * n + B + (n + 1) * (m + 1))))
    record("K4", label, (B, m, n),       # K4's plain version is K1's
           lambda: ops.radic_det_batched_cuda_bygrid(As, table=table),
           plain_ms, bound_ms(B, m, n, total))

    m, n = k2_big.shape
    total = comb(n, m)
    table = rank_table(n, m, backend="cuda", device="cuda")
    record("K2", f"({m},{n}) C={total} through radic_det", (1, m, n),
           lambda: radic_det(k2_big, backend="cuda"),
           cuda_ms(lambda: radic_partial_plain(
               k2_big, table, 0, total, chunk=1 << 20), min_reps=1, min_s=0),
           bound_ms(1, m, n, total))

    # K3's B = 1 entry at the autograd phase's matrix
    m, n = grad_A.shape
    total = comb(n, m)
    table = rank_table(n, m, backend="cuda", device="cuda")
    one = torch.ones((), device="cuda")
    record("K3 B=1", f"({m},{n}) C={total}", (1, m, n),
           lambda: ops.radic_det_grad_cuda(grad_A, one, table=table),
           cuda_ms(lambda: radic_grad_partial_plain(
               grad_A, 1.0, table, 0, total, chunk=1 << 16), min_reps=1,
               min_s=0),
           roofline(total * grad_flops(m),
                    4 * (2 * m * n + 1 + (n + 1) * (m + 1))))

    # K5 at 4096 ranks of (24, 12), K6 at (2048, 8, 8): the JAX package's
    # bench shapes (benchmarks/run.py:50,67)
    n, m, B = 24, 12, 4096
    table = rank_table(n, m, backend="cuda", device="cuda")
    qs = torch.randint(0, comb(n, m), (B,), dtype=torch.int32, device="cuda",
                       generator=gen)
    steps = int(ops.unrank(qs, n, m)[:, -1].sum())  # the walk's last value
    record("K5", f"{B} ranks of ({n},{m})", (B, m, n),
           lambda: unrank_cuda(qs, n, m, table),
           cuda_ms(lambda: unrank_plain(qs, n, m, table), min_reps=1,
                   min_s=0),
           roofline(2 * steps, 4 * (B + B * m + (n + 1) * (m + 1)),
                    PEAK_INT32_OPS))
    B, m = 2048, 8
    M = torch.randn(B, m, m, device="cuda", generator=gen)
    record("K6", f"({B},{m},{m}) float32", (B, m, m),
           lambda: ops.minor_det(M),
           cuda_ms(lambda: minor_det_plain(M), min_reps=1, min_s=0),
           roofline(B * det_flops(m), 4 * (B * m * m + B)),
           library=lambda: torch.linalg.det(M))
    return times


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
    phase_k3(errs, gen)
    done("5 K3")
    autograd = phase_autograd(gen)
    done("6 autograd")
    grad_serve = phase_grad_serve()
    serve_trace(("--grad-frac", "0.25"))
    done("7 gradient serving")
    k456 = phase_k456(errs, gen)
    done("8 K4 K5 K6")
    times = phase_times(gen, serve, k2["big"], autograd["A"])
    done("9 times")
    csrc = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    rows = []
    for name, kernel, source, replaces, launches, timed in [
            ("radic_batched_partial_cuda", "K1", "radic_fused.cu",
             "radic_fused.py:156", serve["launches"], "K1"),
            ("radic_partial_cuda", "K2", "radic_fused.cu",
             "radic_fused.py:39", k2["launches"], "K2"),
            ("radic_batched_grad_partial_cuda", "K3", "radic_grad.cu",
             "radic_fused.py:201", grad_serve["launches"], "K3"),
            ("radic_grad_partial_cuda", "K3", "radic_grad.cu",
             "radic_fused.py:201", autograd["launches"], "K3 B=1"),
            ("radic_batched_partial_bygrid_cuda", "K4", "radic_fused.cu",
             "radic_fused.py:92", k456["K4"], "K4"),
            ("unrank_cuda", "K5", "unrank.cu", "unrank_kernel.py:23",
             k456["K5"], "K5"),
            ("minor_det_cuda", "K6", "minor_det.cu", "minor_det.py:23",
             k456["K6"], "K6")]:
        t = times[timed]
        check(launches > 0, f"{name} was not launched on its path")
        rows.append({"name": name, "route": "cuda", "source": csrc + source,
                     "replaces": ref + replaces, "launches": launches,
                     "max_abs_err": errs.abs[kernel], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
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
