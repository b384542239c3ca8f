#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100, for the ``sm_90a`` kernels) and ``nvcc``.
It builds the kernels from ``src/repro_torch/kernels/csrc/`` (one ``nvcc``
per source, all at once) and runs these phases, each printing its lines:

1. device: the card's name and power limit, torch/CUDA versions, build
   time and the compiler's register/spill report (the warp kernels'
   instances included), K3's rank tile for each m, the shared memory per
   block of K1 and K3 at a few shapes (wide ones too), and static
   SASS instruction counts by opcode of both kernels at m = 8 and of
   their warp kernels at m = 20 (``cuobjdump``, where the toolkit has
   it);
2. K1 (``radic_batched_partial_cuda``) against its plain torch version in
   float64 on the card: shapes, batch sizes, partial rank ranges (shorter
   than one thread's run, straddling runs, tiles and blocks; n = m, m = 1,
   m = 16), singular minors, the top ranks of C(43, 10) just under 2**31,
   the plan-time guards, determinism and batch-slot independence;
3. K2 (``radic_partial_cuda``) against its plain version: the paper's
   (5, 24) over its full rank space, ranks [6e7, 6.4e7) of (10, 34), and
   short ranges of (10, 34) that straddle runs and tiles or end at its
   last rank;
4. serving end to end: ``repro_torch.launch.det_serve.main`` on 512
   requests up to (8, 32) through the async DetQueue, every result held
   against the plain version in float64, K1's launch count equal to the
   queue's dispatch count; then a second, uncounted pass under
   ``torch.profiler`` for the card's busy share of the serving wall;
5. K3 (``radic_batched_grad_partial_cuda``, the backward kernel) against
   its plain version in float64, by the serving verify's rule for
   gradients (``grad_rel_err``): shapes, batch sizes and cotangents with
   zeros and negatives, m = 13, 14 and 16, shapes and ranges whose column
   lists hold (nearly) the whole tile, wide n at m = 1, 2 and 4 (column
   tables of up to T·m slots), partial rank ranges, the top ranks of
   C(43, 10),
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
   C(24, 12) and on ranks of C(20000, 2) (a table too large to stage),
   K6 (``minor_det_cuda``) against its plain version in float64 at
   m = 8, 12 and 16 (staged tiles, and the unstaged read at m = 16 in
   float64), singular and row-permuted matrices included; each entry is
   driven with the counts set to 0 just before and read just after;
9. times: each kernel's device time per call (``torch.profiler``, the
   host's share left out) beside its bound, its plain version's wall time
   per call and, for K6, ``torch.linalg.det``'s device time; also K5 on
   every rank of C(32, 8), K6 at (2**20, 8, 8) in float32 and float64, and
   the warp kernels: K1, K4 at (3, 20, 30), K2 at (20, 30), K3 at
   (3, 20, 26) and K6 at (65536, m, m), m = 32, 17 and 24; K6 above
   m = 32 at (16384, 33, 33) and (4096, 64, 64) in float32 (the warp
   kernel at two rows a lane) and at (256, 250, 250) in float64 (the
   block kernel on a global copy); and one shard of phase 14's grid: K2
   at an eighth of (10, 34)'s ranks, K1 and K3 at (32, 8, 31) over a
   quarter of its ranks.  A profiler window counts toward a kernel's
   time only if it recorded that kernel's own launches, and the phase
   fails when fewer than three of eight windows did.
   It runs after 10 to 14, so that every kernel it times has passed
   its checks, and before 15 and 16 (timed after them once, it saw no
   record of K3's B = 1 launches in six profiler windows; the script
   ends with a probe of that, printed, not held);
10. the wide path (m >= 17): the warp kernels of K1, K2 and K4 against
   float64 plain at (3, 17, 20), (2, 20, 22), (3, 24, 26), (1, 33, 33),
   (2, 32, 33) and ranges of (3, 20, 30), K4 == K1, the B = 1 entry ==
   K1's slot, batch-slot independence and repeats bit for bit; K3 on the
   same shapes and on stacks with a duplicate or a zero column at
   (3, 20, 24), each run twice; K1, K4 and K3 at every m = 17..33 with
   n = m and m + 1 (but the table's (33, 34)); K6 at m = 17, 24, 32, 33,
   64 and 250 in float32 and float64 (one row a lane, two rows a lane,
   the block kernel with its matrix on a global copy), each m's launches
   counted for its row of the kernels line, singular matrices exactly 0,
   a row swap an exact negation, and at every m = 17..70 against float64
   plain; the block kernel with its side arrays in global memory too, at
   odd m (1703 in float64, 3215 in float32; rows of matrices near the
   identity in a random order);
   NaN input (a NaN column or row for K1 and K3 at (3, 20, 24), K6 at
   m = 20, 40 and 250) answered NaN as the plain versions do, its batch
   neighbours as alone, and a clean launch after it; m = 0 through
   ``radic_det``, ``radic_det_batched``, their gradients, the by-grid
   entry and a ``cuda`` plan: 1.0 (gradients of shape (0, n)) with no
   launch counted;
11. the wide cell: ``det_serve.main`` on 256 requests up to (24, 26),
   values and then ``--grad-frac 0.25``, both ``--verify``, launches equal
   to dispatches and the warp kernels launched; then uncounted passes of
   the values and of the mixed cell under ``torch.profiler``;
12. the front (``repro_torch.launch.det_front``), every leg with the
   ``merge`` bucket policy: the mixed requests of phase 7 through
   ``det_serve.main`` with ``--workers 2``, ``--workers 2 --shm`` and
   ``--connect`` to two ``--listen`` daemons, and the wide values of
   phase 11 through ``--workers 2``, each ``--verify`` and each bit for
   bit equal to the in-process queue's answers to the same command line;
   ``DetFront(workers=2)`` with one worker SIGKILLed right after the
   submit and then grown back to two by the ``Autoscaler`` mid-run, bit
   for bit; and a front over two in-process daemons
   (``ThreadedWorkerServer``), whose K1 and K3 launches, counted in this
   process, equal the workers' value and gradient dispatches, then an
   uncounted pass of it under ``torch.profiler`` for the card's busy
   share of the front's wall;
13. warm start (the plan store): the mixed cell of phase 12 through
   ``det_serve.main --plan-store S --verify`` in a fresh interpreter into
   an empty store (the kernel library copied into ``S/kernels/``), then
   again in a fresh interpreter from a copy of ``src/repro_torch`` whose
   ``build/`` is empty (the library loaded from the store with no
   ``nvcc``, every family a store hit, none a miss), then through
   ``--workers 2 --prefill`` (store hits on every worker, no miss) and a
   ``DetFront`` admitting a joiner (``run_worker_client``) that warms the
   shipped families from the store before it answers ready; every answer
   bit for bit the in-process queue's; each pass's wall time to its first
   answer and the library's copy or load time; ``aot_compile_batched`` at
   (64, 8, 20) and (16, 20, 24), value and gradient bit for bit
   ``radic_det_batched``'s with one K1 and one K3 launch each, a batch of
   another size refused; a checkpoint of card tensors (float32, float64,
   int32, bfloat16) restored on the card and on the CPU bit for bit;
14. the mesh (``repro_torch.core.distributed``) on a (2, 4) ``("data",
   "model")`` grid over ``cuda:0`` repeated (``build_mesh``), and on (1,)
   and (2,) ``("data",)`` grids, each entry driven with the launch counts
   set to 0 just before it and read just after: the scalar ``flat`` mode
   on (10, 34) f32 (eight K2 launches, within ``TOL`` of the single-device
   plan and of float64 plain; the (1,) grid bit for bit the single-device
   plan; repeats bit for bit), a rank space smaller than the grid (launches
   over empty ranges); batched values at (64, 8, 31) and (4, 20, 26) with
   the batch over ``data`` and with the ranks over the whole grid (eight
   K1 launches, within ``TOL`` of the single-device plan and of float64
   plain; the (2,) grid bit for bit slot by slot); their gradients through
   ``torch.autograd.grad`` with zero and negative cotangents (eight K3
   launches within ``grad_rel_err`` ``TOL`` of the single-device gradient,
   the (2,) grid bit for bit); the scalar mesh plan's gradient at (6, 20)
   (one K3 launch at B = 1, bit for bit the single-device ``plan.grad``);
   ``grains`` on (5, 24) f64 with 64 grains a slot (512 grains, 84
   lock-step steps) against the oracle, 5 grains of (5, 8) on the default
   mesh, and the bigint grain starts of C(70, 30) (planned, not walked);
   ``drain_queue`` and a ``DetQueue`` (batch over ``data``, pinned
   capacity) on the grid serving phase 4's 512 requests, K1 launches eight
   a dispatch, every answer within ``TOL`` of float64 plain, and both
   again on one device; each leg's wall beside the single-device wall of
   the same shape and phase 4's;
15. LM serving (``repro_torch.launch.serve``): llama3-8b at full width in
   bf16 (32 layers, 4096 wide, 128,256 vocab; random weights from a seed),
   4 prompts of 16 tokens and 32 greedy steps, its prefill ms, decode ms
   per step and tok/s beside the decode bound (the layer and head weights
   read once at 3.35 TB/s); a decode step back to back by CUDA events and
   by the profiler's device time (the host's share) and a warm prefill;
   the head's product at a decode step (bf16 operands, float32 output)
   against float32 operands from a copy of the head, device times and
   agreement within ``TOL``; a float32 copy of the same weights whose
   prefill and decode logits equal its forward's within 2e-3 (|d| <= 2e-3
   (1 + |f|), the reference's decode rule), and the bf16 served logits
   against that float32 forward by relative Frobenius error (<= 5e-2),
   with cuBLAS's reduced-precision bf16 reductions on (the serve path:
   torch's default) and off; an EOS leg whose live count drops; then
   gemma2-9b at full width cut to 2 layers (one local, one global) in
   float32 on a 4,160-token prompt: ``attn_chunk=1024`` against dense
   within ``TOL``, the window masking real positions (the logits past
   4,096 move without it, those before stay bit for bit), and prefill + 4
   decode steps against the forward within 2e-3, dense and chunked; the
   memory freed after each model;
16. the examples (``examples/quickstart_torch.py`` and
   ``retrieval_torch.py``) run in this process on the card, each with
   the launch counts set to 0 just before it and read just after: the
   quickstart's four determinants within 1e-3 of -1.1201943 through K2,
   the retrieval's parity within 1e-5 and its accuracy lines, K1 and K3
   launched; then K1 and K3 (random cotangents) on each library video's
   window stack, the (7..17, 4, 6) shapes the retrieval launches them
   at, against float64 plain, with the counts set to 0 and read around
   that check too.
17. LM families (after the profiler probe; CUDA events only, no
   profiler window): mamba2-1.3b (ssm, 48 layers, a 300-token prompt:
   SSD across chunks of 256 with a ragged last one), hymba-1.5b (hybrid,
   32 layers, 1,100 tokens: past the 1,024 window), whisper-medium (audio,
   24 + 24 layers, 1,500 stand-in frames, 16 tokens forced), grok-1-314b
   (moe, scatter, 8 experts, 2 layers) and arctic-480b (moe, scatter, 128
   experts and the dense residual, 1 layer), each at its published width
   in bf16 (random weights from a seed; grok-1 and arctic cut in depth
   only) with its parameter count held, served through
   ``repro_torch.launch.serve.run`` (B = 4, 32 greedy steps): prefill
   ms, decode ms per step, tok/s, a step back to back, the decode bound
   (every layer and head weight read once at 3.35 TB/s; for moe also at
   the experts this run's steps route to); then the same model made its
   own float32 copy tensor by tensor: its prefill + decode logits equal
   its forward's within 2e-3 (moe at ``capacity_factor = n_experts /
   top_k``, C = Tg: no drops), and the bf16 served logits within 5e-2
   relative Frobenius of the float32 teacher-forced logits (moe at the
   published capacity on the served run's expert choices; beside it the
   error on the copy's own choices, the share of (token, layer) choices
   bf16 and float32 make alike, and each differing choice held to a
   float32 tie within the router logits' difference between the runs);
   grok-1's scatter path bit for bit the same in two calls and its
   ``onehot`` dispatch within 1e-4 of ``scatter`` at no drops;
   whisper's EOS leg ending slot 0; the phase's wall.
18. training (``repro_torch.launch.train`` and ``steps``): llama3-8b at
   its published width cut to 2 layers, bf16, remat on, B = 2 and
   S = 2,048 from the synthetic pipeline: one train step run twice from
   the same state (a fresh draw from the same seed) bit for bit in loss,
   gradient norm and params; six more steps timed by CUDA events (their
   median, and of their halves: the loss and its gradient, AdamW; then
   the loss's forward alone), tokens/s and peak memory beside the
   step's bound (model FLOPs at 989 TFLOP/s bf16 dense plus AdamW's
   bytes at 3.35 TB/s); the
   bf16 loss and gradient against a float32 copy of the same params made
   in place (loss within 1e-2 relative, the gradient within 5e-2
   relative Frobenius error); on that copy the chunked CE
   (``loss_chunk=1024``: two chunks, one pad position) against the full
   CE (loss within 1e-4, gradients ``rtol=2e-3, atol=1e-5``) and remat
   ``nothing`` and ``dots`` against none (loss within 1e-5, gradients
   finite); 12 steps of ``train.main`` decreasing the loss; then
   ``examples/train_lm_torch.py`` at its defaults in this process (its
   ``OK`` lines, K2 and K3 at B = 1 launched by its determinant-
   regularized head, then both held against float64 plain on the head's
   final ``H``), and at the example's width a run of 12 steps with a
   checkpoint resumed to 20 whose 8 losses equal an uninterrupted run's
   bit for bit; the phase's wall.

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
# float64 on the tensor cores (DMMA), the card's peak for the type (data
# sheet); elimination outside them runs at half that, 34 TFLOP/s
PEAK_F64_FLOPS = 67e12
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


def profile_window(fn, reps: int) -> dict[str, list[float]]:
    """``reps`` calls of ``fn`` under ``torch.profiler``: the durations, in
    us, of the device events (kernels, copies, fills) it recorded, by
    name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return by_name


def holds(by_name: dict[str, list[float]], kernel: str | None) -> bool:
    """Whether a window recorded ``kernel`` (a part of its name; any
    device event where ``kernel`` is None)."""
    return any(kernel is None or kernel in name for name in by_name)


def device_ms(fn, reps: int = 10, windows: int = 3,
              kernel: str | None = None) -> float:
    """Device time per call, ms: the median over ``windows`` windows of
    ``reps`` calls under ``torch.profiler`` (after a warm-up) of, for each
    device event name (kernel, copy or fill), the mean duration of its
    recorded events times the number of them a call makes.  The host's
    share of each call (casts, allocations, the ctypes call) is left out.
    The profiler drops records of the kernels this library launches (6 or
    8 of 10 kept in most windows, none in a few), so a sum over a window
    divided by ``reps`` reads low; a mean over the recorded events does
    not depend on how many were kept, and the median sets aside a window
    that read wrong all the same (one in about thirty did).  A window
    counts only if it recorded ``kernel``, the timed kernel's own name
    (any device event for a library call or a model step, where it is
    None): one that lost it would read the rest of the call (a fill's
    0.02 ms for K1's 1 ms) as the kernel's time.  Of those, only the
    windows that saw the most event names count, so a lost reduction does
    not read low either.  It takes windows until ``windows`` of them
    recorded the kernel, and fails when ``8 * windows`` did not (K3 wide
    recorded in 2 of 8 windows once, so 8 were too few to draw from)."""
    fn()
    torch.cuda.synchronize()
    per_call, kept, names, lost = [], [], [], 0
    for _ in range(8 * windows):
        by_name = profile_window(fn, reps)
        if not holds(by_name, kernel):
            lost += 1
            continue
        per_call.append(sum(-(-len(d) // reps) * sum(d) / len(d)
                            for d in by_name.values()))
        kept.append(sum(len(d) for d in by_name.values()))
        names.append(len(by_name))
        if len(per_call) == windows:
            break
    check(len(per_call) == windows,
          f"the profiler recorded {kernel or 'no device event'} in only "
          f"{len(per_call)} of {len(per_call) + lost} windows")
    if lost or any(k % reps for k in kept):
        print(f"device_ms: the profiler kept {kept} device events of "
              f"{reps} calls a window ({names} names); {lost} windows "
              f"without {kernel or 'device events'} set aside; means over "
              f"those", flush=True)
    full = sorted(t for t, n in zip(per_call, names) if n == max(names))
    return full[len(full) // 2] / 1e3


def kernel_name(key: str, m: int) -> str:
    """The CUDA kernel that a ``kernels`` row (``K1`` .. ``K6``, with any
    suffix) launches at ``m``: the register kernels up to 16, the warp
    kernels above (K6's up to 64, its block kernel past that)."""
    fam = key[:2]
    if fam == "K5":
        return "unrank_kernel"
    if fam == "K6":
        return ("minor_det_kernel" if m <= 16 else "minor_det_warp_kernel"
                if m <= 64 else "minor_det_block_kernel")
    if fam == "K3":
        return "radic_grad_partial_kernel" if m <= 16 \
            else "radic_grad_warp_kernel"
    return "radic_partial_kernel" if m <= 16 else "radic_warp_partial_kernel"


class Errors:
    """Largest absolute and relative error seen per kernel."""

    def __init__(self):
        self.abs = {k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5", "K6",
                                     "K1 wide", "K2 wide", "K3 wide",
                                     "K4 wide", "K6 wide", "K6 above 32",
                                     "K1 mesh", "K2 mesh", "K3 mesh")}

    def hold(self, kernel: str, label: str, got, want,
             tol: float = TOL, track: bool = True) -> None:
        """Check one comparison; ``track=False`` keeps it out of the
        kernel's ``max_abs_err`` (a bf16 result's error is its rounding).
        K3's gradients are held by :func:`grad_rel_err`."""
        r = grad_rel_err(got, want) if kernel.startswith("K3") \
            else rel_err(got, want)
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
            args = re.match(r"I((?:Li\d+E|Lb[01]E|[fd])+)E", rest[size:])
            # K1's flag says whether a block stages its slice; K6 wide's
            # whether m is the instance's own or taken at run time
            flag = ({"0": "m run time", "1": "exact"}
                    if fam.startswith("minor_det_warp")
                    else {"0": "global", "1": "staged"})
            inst = "<" + ",".join(
                a or flag.get(b) or c
                for a, b, c in re.findall(r"Li(\d+)E|Lb([01])E|([fd])",
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


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def phase_device() -> None:
    from repro_torch.kernels import _build
    print(card_line(), flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    _build.load()
    info = _build.build_info()
    print(f"build: {info['seconds']:.1f} s (built={info['built']}) "
          f"{info['path']}", flush=True)
    print("build: compile seconds by source: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(info.get("each", {}).items(),
                                           key=lambda kv: -kv[1])))
    for line in ptxas_summary(info["log"]):
        print("ptxas:", line)
    lib = _build.load()
    print(f"K3 rank tiles for m = 1..16: "
          f"{[lib.radic_grad_tile(m) for m in range(1, 17)]}")
    print(f"K3 rank tiles for m = 17..33 (warp kernel): "
          f"{[lib.radic_grad_tile(m) for m in range(17, 34)]}")
    for B, m, n in [(3, 8, 31), (1, 10, 34), (64, 6, 18), (64, 16, 20),
                    (16, 5, 193), (3, 4, 477), (1, 1, 10 ** 6),
                    (3, 20, 30), (64, 24, 26), (16, 32, 33), (1, 33, 33)]:
        print(f"shared memory per block at ({B},{m},{n}): K1 "
              f"{lib.radic_partial_smem_bytes(B, m, n)} B, K3 "
              f"{lib.radic_grad_smem_bytes(B, m, n)} B")
    # the Python twins of the warp kernels' shared memory (held within a
    # block's 227 KB at every m by the CPU tests) against the library's
    from repro_torch.kernels import radic_fused as rf
    for m in range(17, 34):
        check(lib.radic_grad_tile(m) == rf.warp_grad_tile(m) and
              lib.radic_grad_smem_bytes(16, m, 33) ==
              rf.warp_grad_smem_bytes(m) and
              lib.radic_partial_smem_bytes(16, m, 33) ==
              rf.warp_partial_smem_bytes(16, m, 33),
              f"the warp kernels' shared memory at m = {m} differs from "
              "its Python twin")
    print("warp kernels' shared memory per block at m = 17..33: K1 "
          f"{[rf.warp_partial_smem_bytes(16, m, 33) for m in range(17, 34)]}"
          f" B (16, m, 33), K3 "
          f"{[rf.warp_grad_smem_bytes(m) for m in range(17, 34)]} B; the "
          "library's own counts equal")
    for line in sass_counts(info["path"]):
        print(line)


SASS_OPS = ("FFMA", "FMUL", "FADD", "FSEL", "SEL", "MUFU", "LDS", "LDG",
            "STS", "BAR", "ATOMS", "SHFL", "REDUX")
# K1 at m = 8 (the staged instance where the kernel has one) and K3 at m = 8,
# and the warp kernels of both at m = 20 (their cross-lane traffic: SHFL
# and REDUX against LDS and STS)
SASS_KERNELS = {"K1 radic_partial_kernel<8>":
                r"radic20radic_partial_kernelILi8E(Lb1E)?E",
                "K3 radic_grad_partial_kernel<8,T>":
                r"radic25radic_grad_partial_kernelILi8ELi\d+EE",
                "K1 wide radic_warp_partial_kernel<20>":
                r"radic25radic_warp_partial_kernelILi20EE",
                "K3 wide radic_grad_warp_kernel<20>":
                r"radic22radic_grad_warp_kernelILi20EE"}


def sass_counts(lib_path: str) -> list[str]:
    """Static SASS instruction counts of K1's and K3's kernels at m = 8
    and of their warp kernels at m = 20, by opcode, from ``cuobjdump
    -sass`` of the built library (the evidence the card gives without
    ``ncu``); a line saying so where the toolkit has no ``cuobjdump``."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return ["sass: no cuobjdump on this machine (not measured)"]
    dump = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout
    lines = []
    for label, pattern in SASS_KERNELS.items():
        body = None
        for part in dump.split("Function : ")[1:]:
            if re.search(pattern, part.split(None, 1)[0]):
                body = part
                break
        if body is None:
            lines.append(f"sass {label}: not found")
            continue
        ops = [re.sub(r"^@!?U?P\w+\s+", "", line.split("*/", 1)[1].strip())
               .split(None, 1)[0].split(".")[0]
               for line in body.splitlines()
               if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)]
        counts = {op: sum(o == op for o in ops) for op in SASS_OPS}
        lines.append(f"sass {label}: {len(ops)} instructions, " + ", ".join(
            f"{op} {c}" for op, c in counts.items()))
    return lines


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

    # partial ranges: inside one run of 8 ranks, straddling runs, tiles
    # (2,048 ranks) and blocks, q_start > 0; n = m (one rank), m = 1, and
    # m = 16 at (16, 20) across a tile boundary
    m, n = 8, 16
    As = torch.randn(5, m, n, device="cuda", generator=gen)
    for q0, cnt in [(0, 1), (3, 5), (6, 3), (255, 2), (100, 1000),
                    (2045, 10), (2040, 4100), (3000, 1283), (12000, 870)]:
        got = ops.radic_det_batched_cuda(As, q0, cnt)
        errs.hold("K1", f"(8,16) ranks [{q0},{q0 + cnt})", got,
                  plain64(As, q0, cnt))
    for (m, n), (q0, cnt) in [((16, 20), (2040, 20)), ((16, 20), (7, 4000)),
                              ((1, 5000), (2047, 2)), ((1, 5000), (5, 4990)),
                              ((6, 6), (0, 1)), ((16, 16), (0, 1))]:
        As = torch.randn(3, m, n, device="cuda", generator=gen)
        got = ops.radic_det_batched_cuda(As, q0, cnt)
        errs.hold("K1", f"({m},{n}) ranks [{q0},{q0 + cnt})", got,
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
    # ranges shorter than a run, straddling runs and tiles
    for q0, cnt in [(0, 1), (1, 6), (2046, 5), (131_128_139, 1),
                    (131_120_000, 8140)]:
        got = ops.radic_det_cuda(big, q0, cnt)
        errs.hold("K2", f"(10,34) ranks [{q0},{q0 + cnt})", got,
                  plain64(big, q0, cnt))
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
    want = np.zeros(len(mats))
    minors = 0
    for (m, n), idxs in sorted(by_shape.items()):
        As = torch.from_numpy(np.stack([mats[i] for i in idxs])).cuda()
        table = rank_table(n, m, backend="cuda", device="cuda")
        chunk = max(1, (1 << 27) // (len(idxs) * m * m))
        want[idxs] = radic_batched_partial_plain(
            As, table, 0, comb(n, m), dtype=torch.float64,
            chunk=chunk).cpu().numpy()
        minors += comb(n, m) * len(idxs)
    worst = hold_served(errs, "K1", "K1 serving", dets, want)
    print(f"K1 serving: {minors} minors")
    print(f"serve: {512 / wall:.1f} mats/s, {stats['ranks'] / wall:.4e} "
          f"ranks/s (queue ranks {stats['ranks']}, exact-shape minors "
          f"{minors})")
    return {"launches": launches, "stats": stats, "wall": wall,
            "mats": mats, "want": want, "worst": worst}


def hold_served(errs: Errors, kernel: str, label: str, dets,
                want: np.ndarray) -> float:
    """Every served value against its float64 plain answer: the worst
    relative error, checked against ``TOL``."""
    got = torch.tensor(dets, dtype=torch.float64)
    ref = torch.from_numpy(want)
    worst = rel_err(got, ref)
    errs.abs[kernel] = max(errs.abs[kernel], abs_err(got, ref))
    print(f"{label}: all {len(dets)} results vs plain float64: "
          f"rel_err={worst:.3e} (tol {TOL:g})", flush=True)
    check(worst <= TOL, f"{label} rel_err {worst:.3e} > {TOL:g}")
    return worst


def traced(fn) -> tuple[float, list]:
    """Run ``fn`` under ``torch.profiler``: its host wall clock, µs, and
    the card's events (kernels and copies) it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    return wall_us, [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA]


def serve_trace(extra: tuple[str, ...] = (),
                base: list[str] | None = None) -> None:
    """Where the serving time goes: a second, uncounted serving pass
    (``base``, by default ``SERVE_ARGS``, plus ``extra``) under
    ``torch.profiler``; device busy time is the union of the card's kernel
    and copy intervals, against the host's wall clock."""
    import contextlib
    import io

    from repro_torch.launch import det_serve

    args = [*(SERVE_ARGS if base is None else base), *extra]

    def serve():
        with contextlib.redirect_stdout(io.StringIO()):
            det_serve.main(args)

    wall_us, dev = traced(serve)
    if not dev:
        print("serve trace: the profiler saw no device activity "
              "(device busy share not measured)")
        return
    busy = busy_us(dev)
    kernels = []
    for label, name in [("K1", "radic_partial_kernel"),
                        ("K3", "radic_grad_partial_kernel"),
                        ("K1 wide", "radic_warp_partial_kernel"),
                        ("K3 wide", "radic_grad_warp_kernel")]:
        evs = [e for e in dev if name in e.name]
        if evs:
            us = sum(e.time_range.elapsed_us() for e in evs)
            kernels.append(f"{label} kernel {us / 1e3:.3f} ms in "
                           f"{len(evs)} launches")
    shown = args if base is not None else list(extra)
    print(f"serve trace{' ' + ' '.join(shown) if shown else ''}: wall "
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

    # m = 13 and 14 (the two translation units, both under the dynamic
    # shared-memory opt-in), and columns held by (nearly) every rank of a
    # tile, which loads their column lists with the whole tile: n = m + 1,
    # and the first ranks of (6, 40), where columns 0..4 are in every rank
    for m, n, B, q0, cnt in [(13, 16, 1, 0, None), (13, 16, 3, 0, None),
                             (14, 17, 1, 0, None), (14, 17, 3, 0, None),
                             (8, 9, 3, 0, None), (16, 17, 3, 0, None),
                             (6, 40, 3, 0, 128), (6, 40, 3, 0, 4096)]:
        cnt = comb(n, m) if cnt is None else cnt
        As = torch.randn(B, m, n, device="cuda", generator=gen)
        cts = cotangents(B)
        got = ops.radic_det_batched_grad_cuda(As, cts, q0, cnt)
        errs.hold("K3", f"({m},{n}) B={B} ranks [{q0},{q0 + cnt})", got,
                  plain64(As, cts, q0, cnt))

    # partial ranges: inside one tile, straddling tiles and blocks; wide n
    # (column tables of up to T·m slots) at m = 1, 2 and 4
    for m, n, q0, cnt in [(1, 100_000, 3, 70_000), (2, 700, 5000, 7000),
                          (4, 477, 10 ** 6, 5000)]:
        As = torch.randn(3, m, n, device="cuda", generator=gen)
        cts = cotangents(3)
        got = ops.radic_det_batched_grad_cuda(As, cts, q0, cnt)
        errs.hold("K3", f"({m},{n}) ranks [{q0},{q0 + cnt})", got,
                  plain64(As, cts, q0, cnt))
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
    # a table too large to stage in shared memory: the unstaged kernel
    n, m = 20000, 2
    qs = torch.randint(0, comb(n, m), (5000,), dtype=torch.int32,
                       device="cuda", generator=gen)
    combos = ops.unrank(qs, n, m)
    check(torch.equal(combos, unrank_plain(qs, n, m,
                                           rank_table(n, m, device="cuda"))),
          "K5 differs from its plain version on C(20000,2)")
    print("K5: 5000 ranks of C(20000,2) (table not staged) equal to the "
          "plain version")

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
    # m = 12 and 16: the staged tile in float32 and at m = 12 in float64,
    # the unstaged read where the tile passes the staging budget (m = 16 in
    # float64)
    for m in (12, 16):
        M = well_conditioned(512, m, gen)
        M[1::4, 5] = M[1::4, 2]
        M[2::4] = M[0::4][:, swapped_rows(m)]
        M[3::4, :, 4] = 0
        want = minor_det_plain(M)
        for dt, tol in ((torch.float32, 1e-3), (torch.float64, 1e-9)):
            got = ops.minor_det(M.to(dt))
            r = rel_to_det(got, want, [0, 2])
            print(f"K6 (512,{m},{m}) {str(dt)[6:]}: relative err {r:.3e} "
                  f"(tol {tol:g})")
            check(r <= tol, f"K6 m={m} {dt}: relative err {r:.3e}")
            check(not bool(got[1::4].any() | got[3::4].any()),
                  f"K6 m={m} {dt}: singular matrices must give exactly 0")
            check(torch.equal(got[2::4], -got[0::4]),
                  f"K6 m={m} {dt}: a row swap must negate exactly")
    return launches


def well_conditioned(B: int, m: int, gen: torch.Generator) -> torch.Tensor:
    """B float64 matrices Q diag(d): Q orthogonal (the QR of a Gaussian),
    d in [e^-0.5, e^0.5], so |det| = prod d, the condition number at most
    e, and partial pivoting still swaps rows."""
    Q = torch.linalg.qr(torch.randn(B, m, m, device="cuda", generator=gen,
                                    dtype=torch.float64)).Q
    d = torch.rand(B, 1, m, device="cuda", generator=gen,
                   dtype=torch.float64)
    return Q * torch.exp(d - 0.5)


def permuted_near_identity(B: int, m: int,
                           gen: torch.Generator) -> torch.Tensor:
    """B float64 matrices P (I + G / (2 sqrt(m))): G Gaussian, P a random
    row order.  Partial pivoting swaps rows at nearly every step, and
    every pivot stays near 1, so the running product of the pivots, which
    det_ge takes in step order, stays in float32's range at any m (on
    ``well_conditioned``'s Q diag(d) the early pivots are far below 1, and
    at m in the thousands that product leaves float32's range, in the
    plain version as in the kernel)."""
    eye = torch.eye(m, device="cuda", dtype=torch.float64)
    N = eye + torch.randn(B, m, m, device="cuda", generator=gen,
                          dtype=torch.float64) / (2 * m ** 0.5)
    order = torch.stack([torch.randperm(m, device="cuda", generator=gen)
                         for _ in range(B)])
    return torch.gather(N, 1, order[:, :, None].expand(B, m, m))


def swapped_rows(m: int) -> torch.Tensor:
    """The row order of a matrix with rows 0 and 1 exchanged."""
    swap = torch.arange(m, device="cuda")
    swap[0], swap[1] = 1, 0
    return swap


def rel_to_det(got: torch.Tensor, want: torch.Tensor, keep) -> float:
    """max |got - want| / |want| over the matrices whose index mod 4 is
    in ``keep`` (the non-singular ones of a check's stack)."""
    idx = torch.arange(want.numel(), device=want.device)
    sel = (idx % 4 == keep[0]) | (idx % 4 == keep[1])
    return ((got.double() - want).abs() / want.abs())[sel].max().item()


WIDE_SHAPES = [(3, 17, 20), (2, 20, 22), (3, 24, 26), (1, 33, 33),
               (2, 32, 33)]
# partial ranges of (3, 20, 30): inside one warp's run of 8 ranks,
# straddling runs, tiles (64 ranks) and blocks, and its last ranks
WIDE_RANGES = [(0, 1), (3, 6), (60, 9), (1000, 5000), (123_456, 20_000),
               (30_045_015 - 3000, 3000)]


# K6's m of phase 10 whose launches are counted, each for the row of the
# kernels line timed at that m (phase 9), and the sources above m = 32
K6_COUNTED_M = (17, 24, 32, 33, 64, 250)
K6_ABOVE_32_SOURCES = [(33, "minor_det_warp.cuh"),
                       (64, "minor_det_warp.cuh"), (250, "minor_det.cu")]


def phase_wide(errs: Errors, gen: torch.Generator) -> dict:
    """The warp kernels (m >= 17) against their plain versions in float64
    on the card, each wrapper's wide launches counted."""
    from repro_torch.core import radic_det
    from repro_torch.core.engine import rank_table
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import ops, reset_launch_counts
    from repro_torch.kernels.minor_det import minor_det_cuda, minor_det_plain
    from repro_torch.kernels.radic_fused import (
        radic_batched_grad_partial_cuda as k3,
        radic_batched_grad_partial_plain, radic_batched_partial_bygrid_cuda
        as k4, radic_batched_partial_cuda as k1, radic_batched_partial_plain,
        radic_grad_partial_cuda as k3one, radic_partial_cuda as k2)

    def plain64(As, q0, cnt):
        B, m, n = As.shape
        return radic_batched_partial_plain(
            As, rank_table(n, m, device="cuda"), q0, cnt,
            dtype=torch.float64, chunk=max(1, (1 << 22) // (B * m * m)))

    def grad64(As, cts, q0, cnt):
        B, m, n = As.shape
        return radic_batched_grad_partial_plain(
            As, cts, rank_table(n, m, device="cuda"), q0, cnt,
            dtype=torch.float64, chunk=max(1, (1 << 20) // (B * m * m)))

    cases = []
    for B, m, n in WIDE_SHAPES:
        cases.append((torch.randn(B, m, n, device="cuda", generator=gen), 0,
                      comb(n, m)))
    big = torch.randn(3, 20, 30, device="cuda", generator=gen)
    cases += [(big, q0, cnt) for q0, cnt in WIDE_RANGES]

    # K1 and K4 (the same warp kernel at one matrix per block), K2 at B = 1
    reset_launch_counts()
    for As, q0, cnt in cases:
        B, m, n = As.shape
        label = f"({B},{m},{n}) ranks [{q0},{q0 + cnt})"
        got = ops.radic_det_batched_cuda(As, q0, cnt)
        torch.cuda.synchronize()
        errs.hold("K1 wide", label, got, plain64(As, q0, cnt))
        four = ops.radic_det_batched_cuda_bygrid(As, q0, cnt)
        check(torch.equal(four, got), f"K4 differs from K1 on {label}")
        errs.abs["K4 wide"] = max(errs.abs["K4 wide"],
                                  errs.abs["K1 wide"])
        one = ops.radic_det_cuda(As[B - 1].clone(), q0, cnt)
        check(torch.equal(one, got[B - 1]),
              f"K2 differs from K1 at B = 1 on {label}")
    print("wide K1/K4/K2: K4 == K1 and the B = 1 entry == K1's slot, bit "
          f"for bit, on {len(cases)} cases")
    # batch-slot independence and repeats (bit-identical)
    As = torch.randn(64, 20, 22, device="cuda", generator=gen)
    first = ops.radic_det_batched_cuda(As)
    check(torch.equal(first, ops.radic_det_batched_cuda(As)),
          "wide K1 repeat is not bit-identical")
    check(torch.equal(ops.radic_det_batched_cuda(As[37:38].clone())[0],
                      first[37]),
          "wide K1 slot 37 of 64 differs from the matrix alone")
    # the scalar path (radic_det -> K2) on a wide matrix
    A = torch.randn(20, 24, device="cuda", generator=gen)
    before = k2.wide_launches
    got = radic_det(A, backend="cuda")
    check(k2.wide_launches == before + 1, "radic_det did not launch K2 wide")
    errs.hold("K2 wide", "(20,24) through radic_det", got,
              plain64(A[None], 0, comb(24, 20))[0])
    launches = {"K1 wide": k1.wide_launches, "K2 wide": k2.wide_launches,
                "K4 wide": k4.wide_launches}
    print(f"wide forward launches: {launches}; slot 37/64 vs alone and "
          "repeat: bit-identical")
    check(all(v > 0 for v in launches.values()), "a wide entry did not "
          "launch its warp kernel")

    # K3 on the same shapes, partial ranges of (3, 20, 30) (fewer ranks:
    # the float64 pullback is costly), and stacks with a duplicate or a
    # zero column (exactly zero pivots: the explicit-cofactor branch)
    gcases = [(As, q0, cnt) for As, q0, cnt in cases if As is not big]
    gcases += [(big, q0, min(cnt, 2000)) for q0, cnt in WIDE_RANGES]
    for name, col in [("duplicate column", 1), ("zero column", 5)]:
        S = torch.randn(3, 20, 24, device="cuda", generator=gen)
        S[:, :, col] = S[:, :, 0] if col == 1 else 0.0
        gcases.append((S, 0, comb(24, 20)))
    for As, q0, cnt in gcases:
        B, m, n = As.shape
        cts = torch.randn(B, device="cuda", generator=gen)
        if B > 1:
            cts[0] = 0.0
        label = f"({B},{m},{n}) ranks [{q0},{q0 + cnt})"
        got = ops.radic_det_batched_grad_cuda(As, cts, q0, cnt)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K3 wide {label}: "
              "non-finite")
        errs.hold("K3 wide", label, got, grad64(As, cts, q0, cnt))
        check(torch.equal(got, ops.radic_det_batched_grad_cuda(As, cts, q0,
                                                               cnt)),
              f"K3 wide {label}: a repeat is not bit-identical")
        if B > 1:
            check(not bool(got[0].any()), "K3 wide: ct = 0 is not 0")
        one = ops.radic_det_grad_cuda(As[B - 1].clone(), float(cts[B - 1]),
                                      q0, cnt)
        check(torch.equal(one, got[B - 1]),
              f"K3 wide {label}: the B = 1 entry differs")
    As = torch.randn(64, 20, 22, device="cuda", generator=gen)
    cts = torch.randn(64, device="cuda", generator=gen)
    first = ops.radic_det_batched_grad_cuda(As, cts)
    check(torch.equal(ops.radic_det_batched_grad_cuda(
        As[37:38].clone(), cts[37:38].clone())[0], first[37]),
        "K3 wide slot 37 of 64 differs from the matrix alone")
    launches["K3 wide"] = k3.wide_launches
    check(k3.wide_launches > 0 and k3one.wide_launches > 0,
          "K3's entries did not launch the warp kernel")
    print("wide K3: repeats, slot 37/64 vs alone and the B = 1 entry "
          "bit-identical")

    # K6 for every m: the warp kernel at one row a lane (17, 24, 32) and
    # two (33, 64), the block kernel on a global copy (250), each m's
    # launches counted for its row of the kernels line; well-conditioned
    # matrices (|det| between e^-m/2 and e^m/2, condition at most e), so
    # float32 is held relative to |det| at every m; singular (equal rows,
    # a zero column) and row-swapped matrices
    for m in K6_COUNTED_M:
        B = 64 if m <= 64 else 8
        before = minor_det_cuda.launches
        M = well_conditioned(B, m, gen)
        M[1::4, 5] = M[1::4, 2]
        M[2::4] = M[0::4][:, swapped_rows(m)]
        M[3::4, :, 4] = 0
        want = minor_det_plain(M)
        for dt, tol in ((torch.float32, 5e-4), (torch.float64, 1e-9)):
            got = ops.minor_det(M.to(dt))
            torch.cuda.synchronize()
            check(got.dtype == dt, f"K6 m={m}: {got.dtype} out")
            if dt == torch.float32:
                errs.hold("K6 wide" if m <= 32 else "K6 above 32",
                          f"m={m} float32", got, want, tol=tol)
                r = rel_to_det(got, want, [0, 2])
                print(f"K6 wide m={m} float32: relative err {r:.3e} "
                      "(tol 1e-3)")
                check(r <= 1e-3, f"K6 m={m} float32 relative {r:.3e}")
            else:
                r = rel_to_det(got, want, [0, 2])
                print(f"K6 wide m={m} float64: relative err {r:.3e} "
                      f"(tol {tol:g})")
                check(r <= tol, f"K6 m={m} float64 relative err {r:.3e}")
            check(not bool(got[1::4].any() | got[3::4].any()),
                  f"K6 m={m} {dt}: singular matrices must give exactly 0")
            check(torch.equal(got[2::4], -got[0::4]),
                  f"K6 m={m} {dt}: a row swap must negate exactly")
        launches[f"K6 m={m}"] = minor_det_cuda.launches - before
    check(minor_det_cuda.wide_launches == 2 * len(K6_COUNTED_M),
          "K6's wide kernels did not launch twice at each m")
    print(f"K6 wide: m = {K6_COUNTED_M} in float32 and float64; singular "
          "give 0, a row swap negates")
    # the block kernel with the panel's multipliers in global memory too
    # (past 227 KB of them: m >= 1702 in float64, 3215 in float32), at an
    # odd m, where a matrix's copy is no whole number of 16-byte vectors
    for m, dt, tol in ((1703, torch.float64, 1e-9),
                       (3215, torch.float32, 1e-3)):
        M = permuted_near_identity(2, m, gen)
        want = minor_det_plain(M)
        got = ops.minor_det(M.to(dt))
        torch.cuda.synchronize()
        r = ((got.double() - want).abs() / want.abs()).max().item()
        print(f"K6 (2,{m},{m}) {str(dt)[6:]} (side arrays in global "
              f"memory): relative err {r:.3e} (tol {tol:g})")
        check(r <= tol, f"K6 m={m} {dt}: relative err {r:.3e} > {tol:g}")
    # every m of the warp kernels (one instance a value at m <= 33; the
    # register widths 40..64 of minor_det_warp_hi.cu and _top.cu take m at
    # run time)
    # and of the block kernel just past them, in both types, relative to
    # |det| (well-conditioned matrices)
    worst = {}
    for m in range(17, 71):
        M = well_conditioned(4, m, gen)
        want = minor_det_plain(M)
        for dt, tol in ((torch.float32, 1e-3), (torch.float64, 1e-9)):
            got = ops.minor_det(M.to(dt))
            r = ((got.double() - want).abs() / want.abs()).max().item()
            worst[str(dt)[6:]] = max(worst.get(str(dt)[6:], 0.0), r)
            check(r <= tol, f"K6 m={m} {dt}: relative err {r:.3e} > {tol:g}")
    print(f"K6 at every m = 17..70: largest relative err {worst} (tol 1e-3 "
          "float32, 1e-9 float64)")
    phase_wide_every_m(errs, gen, plain64, grad64)
    phase_wide_nan(errs, gen, plain64, grad64)
    return launches


def phase_wide_every_m(errs: Errors, gen: torch.Generator, plain64,
                       grad64) -> None:
    """K1 (with K4 == K1) and K3 at every m of the warp kernels, n = m and
    m + 1, against float64 plain (K3 reads U's and L's rows in 16-byte
    groups, the last of which ends m mod 4 columns in; m = 33 keeps two
    rows in lane 0); (33, 34) is refused by the int32 table in both
    packages."""
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import ops

    for m in range(17, 34):
        for n in (m, m + 1):
            if (m, n) == (33, 34):
                continue
            As = torch.randn(2, m, n, device="cuda", generator=gen)
            cts = torch.tensor([1.5, -0.75], device="cuda")
            label = f"every m (2,{m},{n})"
            got = ops.radic_det_batched_cuda(As)
            torch.cuda.synchronize()
            errs.hold("K1 wide", label, got, plain64(As, 0, comb(n, m)))
            check(torch.equal(ops.radic_det_batched_cuda_bygrid(As), got),
                  f"K4 differs from K1 on {label}")
            g = ops.radic_det_batched_grad_cuda(As, cts)
            torch.cuda.synchronize()
            errs.hold("K3 wide", label, g, grad64(As, cts, 0, comb(n, m)))
    print("wide every m: K1, K4 and K3 at m = 17..33, n = m and m + 1 "
          "(but (33, 34)), against float64 plain")


def phase_wide_nan(errs: Errors, gen: torch.Generator, plain64,
                   grad64) -> None:
    """A NaN column on the wide path: the matrix that holds it answers
    NaN, as det_ge and the plain versions do, its neighbours in the batch
    answer as alone, and the card still runs the next launch."""
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import ops
    from repro_torch.kernels.minor_det import minor_det_plain

    As = torch.randn(3, 20, 24, device="cuda", generator=gen)
    As[0, :, 3] = float("nan")
    As[1, 7, :] = float("nan")  # a NaN row: every minor holds it
    got = ops.radic_det_batched_cuda(As)
    alone = ops.radic_det_batched_cuda(As[2:].clone())
    torch.cuda.synchronize()
    check(bool(torch.isnan(got[:2]).all()), f"K1 wide: {got[:2].tolist()} "
          "for the NaN matrices, not NaN")
    check(torch.equal(got[2], alone[0]), "K1 wide: the clean matrix beside "
          "NaN ones differs from it alone")
    errs.hold("K1 wide", "(3,20,24) beside NaN matrices", got[2:],
              plain64(As[2:], 0, comb(24, 20)))
    cts = torch.randn(3, device="cuda", generator=gen)
    g = ops.radic_det_batched_grad_cuda(As, cts)
    g_alone = ops.radic_det_batched_grad_cuda(As[2:].clone(),
                                              cts[2:].clone())
    torch.cuda.synchronize()
    want = grad64(As, cts, 0, comb(24, 20))
    check(bool(torch.isnan(g[:2]).any(dim=(1, 2)).all()),
          "K3 wide: no NaN in the gradient of a NaN matrix")
    check(torch.equal(torch.isnan(g[:2]), torch.isnan(want[:2])),
          "K3 wide: the gradient's NaN entries differ from plain's")
    check(torch.equal(g[2], g_alone[0]), "K3 wide: the clean matrix beside "
          "NaN ones differs from it alone")
    errs.hold("K3 wide", "(3,20,24) beside NaN matrices", g[2:], want[2:])
    # K6: the warp kernel (20), the block kernel in shared memory (40) and
    # on a global copy (250)
    for m in (20, 40, 250):
        M = well_conditioned(5, m, gen)
        M[0, :, 3] = float("nan")
        M[1, 0, 0] = float("nan")  # on the first pivot's place
        M[2, 5, 0] = float("nan")  # below it, never a pivot
        want = minor_det_plain(M)
        for dt in (torch.float32, torch.float64):
            got = ops.minor_det(M.to(dt))
            torch.cuda.synchronize()
            check(bool(torch.isnan(got[:3]).all()),
                  f"K6 m={m} {dt}: {got[:3].tolist()} for NaN input")
            check(bool(torch.isnan(want[:3]).all()), "K6 plain: not NaN")
            r = ((got[3:].double() - want[3:]).abs()
                 / want[3:].abs()).max().item()
            check(r <= (1e-3 if dt == torch.float32 else 1e-9),
                  f"K6 m={m} {dt}: relative err {r:.3e} beside NaN input")
    # the context still launches: a clean call after the NaN ones
    B = torch.randn(2, 20, 22, device="cuda", generator=gen)
    check(bool(torch.isfinite(ops.radic_det_batched_cuda(B)).all()),
          "wide K1 after NaN input: not finite")
    torch.cuda.synchronize()
    print("wide NaN input: K1, K3 and K6 (m = 20, 40, 250) answer NaN for "
          "the NaN matrices, their neighbours as alone; the card still "
          "launches")


WIDE_SERVE_ARGS = ["--num", "256", "--max-m", "24", "--max-n", "26",
                   "--max-batch", "64"]


def phase_empty_minor() -> None:
    """m = 0 on the card: the ``cuda`` entries answer the empty minor's
    determinant, 1.0 (and a gradient of shape (0, n)), as the float64
    oracle does, before any table, launch or build; no launch counted."""
    from repro_torch.core import radic_det, radic_det_batched
    from repro_torch.core.engine import DetEngine
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts

    reset_launch_counts()
    A = torch.zeros(0, 5, device="cuda", requires_grad=True)
    d = radic_det(A, backend="cuda")
    (g,) = torch.autograd.grad(d, A)
    check(d.shape == () and float(d.detach()) == 1.0,
          f"m = 0: radic_det gave {d}")
    check(g.shape == (0, 5), f"m = 0: radic_det's gradient {g.shape}")
    As = torch.zeros(3, 0, 5, device="cuda", requires_grad=True)
    d = radic_det_batched(As, backend="cuda")
    (g,) = torch.autograd.grad(d.sum(), As)
    check(torch.equal(d.detach(), torch.ones(3, device="cuda")),
          f"m = 0: radic_det_batched gave {d}")
    check(g.shape == (3, 0, 5), f"m = 0: the batched gradient {g.shape}")
    X = torch.zeros(2, 0, 5, device="cuda")
    for name, got, shape in [
            ("radic_det_cuda", ops.radic_det_cuda(X[0]), ()),
            ("radic_det_batched_cuda", ops.radic_det_batched_cuda(X), (2,)),
            ("radic_det_batched_cuda_bygrid",
             ops.radic_det_batched_cuda_bygrid(X), (2,)),
            ("DetEngine.plan(0, 5)", DetEngine().plan(
                0, 5, backend="cuda", device="cuda")(X), (2,))]:
        check(got.shape == shape and bool((got == 1.0).all()),
              f"m = 0: {name} gave {got}")
    for name, got, shape in [
            ("radic_det_grad_cuda", ops.radic_det_grad_cuda(X[0], 1.0),
             (0, 5)),
            ("radic_det_batched_grad_cuda",
             ops.radic_det_batched_grad_cuda(X, torch.ones(2, device="cuda")),
             (2, 0, 5))]:
        check(got.shape == shape, f"m = 0: {name} gave {got.shape}")
    launched = launch_counts()
    check(not any(launched.values()), f"m = 0 launched a kernel: {launched}")
    print("m = 0: radic_det, radic_det_batched, their gradients, the "
          "by-grid entry and a cuda plan answer 1.0 (gradients (0, 5)) "
          "with no launch")


def phase_wide_serve() -> dict:
    """The wide cell: 256 requests up to (24, 26) through the async queue,
    values and then the mixed cell, each verified by ``--verify`` (another
    code path in float64), launches equal to dispatches."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.radic_fused import (
        radic_batched_grad_partial_cuda as k3,
        radic_batched_partial_cuda as k1)
    from repro_torch.launch import det_serve

    reset_launch_counts()
    t0 = time.perf_counter()
    dets, stats = det_serve.main([*WIDE_SERVE_ARGS, "--verify"])
    wall = time.perf_counter() - t0
    print(f"wide serve: dispatches={stats['dispatches']} K1 launches="
          f"{k1.launches} (warp kernel {k1.wide_launches}), ranks "
          f"{stats['ranks']}, wall {wall:.3f}s with --verify")
    check(k1.launches == stats["dispatches"] and k1.wide_launches > 0,
          "wide serve: K1 launches != dispatches, or no warp launch")
    check(stats["completed"] == 256 and all(d is not None for d in dets),
          "wide serving left a request unanswered")
    out = {"K1 wide": k1.wide_launches, "stats": stats}

    reset_launch_counts()
    t0 = time.perf_counter()
    dets, stats = det_serve.main([*WIDE_SERVE_ARGS, "--grad-frac", "0.25",
                                  "--verify"])
    wall = time.perf_counter() - t0
    grads = stats["grad_dispatches"]
    values = stats["dispatches"] - grads
    print(f"wide grad serve: dispatches={stats['dispatches']} (grad "
          f"{grads}, value {values}), K3 launches={k3.launches} (warp "
          f"kernel {k3.wide_launches}), K1 launches={k1.launches}, wall "
          f"{wall:.3f}s with --verify")
    check(k3.launches == grads > 0 and k3.wide_launches > 0,
          "wide grad serve: K3 launches != grad dispatches, or no warp "
          "launch")
    check(k1.launches == values > 0, "wide grad serve: K1 launches != "
          "value dispatches")
    check(stats["completed"] == 256 and all(d is not None for d in dets),
          "wide gradient serving left a request unanswered")
    out["K3 wide"] = k3.wide_launches
    return out


def same_answers(got: list, want: list) -> bool:
    """Bit for bit: every value and every gradient array."""
    return len(got) == len(want) and all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(got, want))


def phase_front() -> None:
    """The front: the serving tier of ``DetFront`` over every transport,
    each answer bit for bit the in-process queue's on the same requests,
    the kernels' launches counted where the workers run in this process.

    Every leg buckets with ``--policy merge`` (each shape always goes to
    its canonical bucket): under ``auto`` a bucket merges or not by the
    depth of the queue's snapshot, which differs between one queue and a
    worker that holds part of the requests, and a merged bucket sums its
    minors in another order."""
    import contextlib
    import io
    import multiprocessing

    from repro_torch.kernels.radic_fused import (
        radic_batched_grad_partial_cuda as k3,
        radic_batched_partial_cuda as k1)
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import det_serve
    from repro_torch.launch import transport as T
    from repro_torch.launch.autoscale import Autoscaler
    from repro_torch.launch.det_front import DetFront
    from repro_torch.launch.det_queue import BucketPolicy

    print(card_line(), flush=True)
    mixed = [*SERVE_ARGS, "--grad-frac", "0.25", "--policy", "merge"]
    wide = [*WIDE_SERVE_ARGS, "--policy", "merge"]
    with contextlib.redirect_stdout(io.StringIO()):
        want = det_serve.main(mixed)[0]
        wide_want = det_serve.main(wide)[0]
    mixed.append("--verify")

    def leg(label: str, argv: list[str], ref: list) -> None:
        t0 = time.perf_counter()
        dets, stats = det_serve.main(argv)
        total = time.perf_counter() - t0
        f = stats["front"]
        per = ", ".join(
            f"{wid}: {s['dispatches']} ({s['grad_dispatches']} grad)"
            for wid, s in sorted(stats["workers"].items()))
        print(f"front {label}: wall {f['wall_s']:.4f} s, "
              f"{len(ref) / f['wall_s']:.1f} mats/s; dispatches by worker "
              f"{per}; {total:.1f} s with start-up and --verify",
              flush=True)
        check(f["completed"] == len(ref) and f["errors"] == 0
              and f["worker_deaths"] == 0 and not f["degraded"],
              f"front {label}: {f}")
        check(same_answers(dets, ref),
              f"front {label}: not bit-identical to the in-process queue")

    leg("local x2", [*mixed, "--workers", "2"], want)
    leg("shm x2", [*mixed, "--workers", "2", "--shm"], want)
    daemons = []
    try:
        for _ in range(2):
            daemons.append(T.spawn_worker_daemon(device="cuda",
                                                 timeout=300))
        leg("socket x2", [*mixed, "--connect",
                          ",".join(a for _, a in daemons)], want)
        for proc, _ in daemons:
            check(proc.wait(timeout=120) == 0,
                  "a --listen --serve-once daemon exited non-zero")
    finally:
        for proc, _ in daemons:
            proc.kill()
            proc.wait(timeout=30)
            proc.stdout.close()
    leg("wide local x2", [*wide, "--workers", "2", "--verify"], wide_want)

    mats = det_serve._random_queue(512, 8, 32, 0)
    grads = det_serve._grad_mix(512, 0.25, 0)
    policy = BucketPolicy(max_batch=64, mode="merge")
    with DetFront(workers=2, policy=policy, device="cuda") as front:
        front.snapshot(timeout=300)
        victim = front.owner_of(mats[0].shape)
        futs = front.submit_many(mats, grads)
        front.kill_worker(victim)
        got = [f.result(timeout=300) for f in futs]
        f = front.snapshot()["front"]
        print(f"front kill: worker {victim} SIGKILLed right after the "
              f"submit; {f['rerouted']} requests re-routed, "
              f"{f['completed']} answered", flush=True)
        check(f["worker_deaths"] == 1 and f["completed"] == 512,
              f"front kill: {f}")
        check(same_answers(got, want),
              "front kill: not bit-identical to the in-process queue")

        scaler = Autoscaler(front, min_workers=1, max_workers=2,
                            up_ticks=2, cooldown_s=5.0)
        busy = {"front": {"workers_alive": 1, "pending": {0: 64},
                          "shed": 0, "submitted": 64,
                          "latency_ema_s": {}, "plan_load": {}}}
        futs = front.submit_many(mats[:256], grads[:256])
        check(scaler.tick(busy, now=0.0) == "hold"
              and scaler.tick(busy, now=1.0) == "up",
              "front autoscale: no scale-up on a breach")
        deadline = time.monotonic() + 120
        while len(front.alive_workers) != 2:
            check(time.monotonic() < deadline,
                  "front autoscale: the grown worker never came up")
            time.sleep(0.05)
        futs += front.submit_many(mats[256:], grads[256:])
        got = [f.result(timeout=300) for f in futs]
        snap = front.snapshot()
        print(f"front autoscale: grew to workers {front.alive_workers} "
              f"mid-run; routed {snap['front']['routed']}", flush=True)
        check(same_answers(got, want),
              "front autoscale: not bit-identical to the in-process queue")

    servers = [T.ThreadedWorkerServer(max_sessions=1) for _ in range(2)]
    try:
        transport = T.SocketTransport([s.address for s in servers])
        with DetFront(transport=transport, policy=policy,
                      device="cuda") as front:
            front.snapshot(timeout=300)
            reset_launch_counts()
            t0 = time.perf_counter()
            got = [f.result(timeout=300)
                   for f in front.submit_many(mats, grads)]
            wall = time.perf_counter() - t0
            launched = (k1.launches, k3.launches)
            snap = front.snapshot()
            check(same_answers(got, want), "front in-process daemons: not "
                  "bit-identical to the in-process queue")
            grads_d = sum(s["grad_dispatches"]
                          for s in snap["workers"].values())
            values = sum(s["dispatches"]
                         for s in snap["workers"].values()) - grads_d
            print(f"front in-process daemons x2: wall {wall:.4f} s, "
                  f"{512 / wall:.1f} mats/s; K1 launches {launched[0]} "
                  f"(value dispatches {values}), K3 launches "
                  f"{launched[1]} (grad dispatches {grads_d})", flush=True)
            check(launched == (values, grads_d) and values > 0
                  and grads_d > 0,
                  f"front: launches {launched} != dispatches "
                  f"{(values, grads_d)}")

            def serve():
                for f in front.submit_many(mats, grads):
                    f.result(timeout=300)

            wall_us, dev = traced(serve)
        if dev:
            busy = busy_us(dev)
            print(f"front trace (in-process daemons x2, mixed): wall "
                  f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
                  f"({busy / wall_us:.2%}, idle {1 - busy / wall_us:.2%}); "
                  f"{len(dev)} device events", flush=True)
        else:
            print("front trace: the profiler saw no device activity "
                  "(device busy share not measured)")
    finally:
        for s in servers:
            s.close(timeout=10)
    left = multiprocessing.active_children()
    check(not left, f"the front left worker processes behind: {left}")


# One serving pass in a fresh interpreter over a plan store: the mixed
# cell through ``det_serve.main`` (argv after the output path), its answers
# pickled to that path, and on the last line its plan-cache counts, the
# store's entries, the kernel library's origin and seconds, and the wall
# time from the script's start (before torch is imported) to the first
# answer.
WARM_PASS_SCRIPT = r"""
import time
T0 = time.perf_counter()
import json, pickle, sys
import repro_torch
from repro_torch.checkpoint import PlanStore
from repro_torch.kernels import _build
from repro_torch.launch import det_queue, det_serve

first = []
submit_many = det_queue.DetQueue.submit_many


def timed_submit_many(self, *args, **kwargs):
    futs = submit_many(self, *args, **kwargs)
    for f in futs:  # callbacks run on the completer thread, one at a time
        f.add_done_callback(
            lambda _: first or first.append(time.perf_counter()))
    return futs


det_queue.DetQueue.submit_many = timed_submit_many
out_path, argv = sys.argv[1], sys.argv[2:]
dets, stats = det_serve.main(argv)
with open(out_path, "wb") as f:
    pickle.dump(dets, f)
store = argv[argv.index("--plan-store") + 1]
info = {k: v for k, v in _build.build_info().items() if k != "log"}
print(json.dumps({"package": repro_torch.__file__, "build": info,
                  "plan_cache": stats["plan_cache"],
                  "entries": PlanStore(store).stats()["entries"],
                  "first_answer_s": first[0] - T0,
                  "wall_s": time.perf_counter() - T0}))
"""


def warm_pass(src: Path, argv: list[str], out: Path) -> tuple[dict, list]:
    """Run ``WARM_PASS_SCRIPT`` with ``src`` as the only source of
    ``repro_torch``; returns its summary and its answers."""
    import os
    import pickle
    env = {**os.environ, "PYTHONPATH": str(src)}
    proc = subprocess.run(
        [sys.executable, "-c", WARM_PASS_SCRIPT, str(out), *argv],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=src.parent)
    check(proc.returncode == 0,
          f"warm-start pass failed:\n{proc.stdout[-3000:]}\n"
          f"{proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(out, "rb") as f:
        return summary, pickle.load(f)


def phase_warm_start(gen: torch.Generator) -> None:
    """Phase 13: the plan store and warm starts on the card, then the
    capacity-pinned plans and checkpoints of tensors on the card."""
    import contextlib
    import io
    import shutil
    import tempfile
    import threading

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import aot_compile_batched, radic_det_batched
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.radic_fused import (
        radic_batched_grad_partial_cuda as k3,
        radic_batched_partial_cuda as k1)
    from repro_torch.launch import det_serve
    from repro_torch.launch import transport as T
    from repro_torch.launch.det_front import DetFront
    from repro_torch.launch.det_queue import BucketPolicy

    print(card_line(), flush=True)
    mixed = [*SERVE_ARGS, "--grad-frac", "0.25", "--policy", "merge"]
    with contextlib.redirect_stdout(io.StringIO()):
        want = det_serve.main(mixed)[0]  # the in-process queue, no store
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        store = tmp / "store"
        argv = [*mixed, "--verify", "--plan-store", str(store)]
        cold, cold_dets = warm_pass(ROOT / "src", argv, tmp / "cold.pkl")
        pc = cold["plan_cache"]
        families = pc["misses"]
        print(f"warm start, cold pass: {families} families, store_misses "
              f"{pc['store_misses']}, store_hits {pc['store_hits']}, "
              f"evictions {pc['evictions']} (LRU of {pc['max_plans']}), "
              f"{cold['entries']} entries written; kernel library "
              f"{cold['build']['origin']} into the store in "
              f"{cold['build']['seconds']:.3f} s; first answer "
              f"{cold['first_answer_s']:.3f} s after the interpreter "
              f"started (wall {cold['wall_s']:.3f} s)", flush=True)
        check(pc["store_misses"] == families > 0 and pc["store_hits"] == 0
              and cold["entries"] == families,
              f"cold pass: {pc}, {cold['entries']} entries")
        check(cold["build"]["origin"] == "copied" and Path(
              cold["build"]["path"]).parent == store / "kernels",
              f"cold pass: the library was not copied into the store: "
              f"{cold['build']}")
        check(same_answers(cold_dets, want),
              "cold pass: not bit-identical to the in-process queue")

        # a checkout that never built: only the sources of the package
        copy = tmp / "checkout" / "src"
        shutil.copytree(ROOT / "src" / "repro_torch", copy / "repro_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        warm, warm_dets = warm_pass(copy, argv, tmp / "warm.pkl")
        pc = warm["plan_cache"]
        print(f"warm start, warm pass (from {warm['package']}): "
              f"{pc['misses']} families, store_hits {pc['store_hits']}, "
              f"store_misses {pc['store_misses']}; kernel library "
              f"{warm['build']['origin']} from the store in "
              f"{warm['build']['seconds']:.3f} s; first answer "
              f"{warm['first_answer_s']:.3f} s after the interpreter "
              f"started (wall {warm['wall_s']:.3f} s)", flush=True)
        check(warm["package"].startswith(str(copy)),
              f"warm pass imported {warm['package']}")
        check(warm["build"]["origin"] == "loaded"
              and not warm["build"]["built"]
              and not (tmp / "checkout" / "build").exists(),
              f"warm pass: the library did not load from the store: "
              f"{warm['build']}")
        check(pc["misses"] == families and pc["store_hits"] == families
              and pc["store_misses"] == 0,
              f"warm pass: {pc} against {families} families")
        check(same_answers(warm_dets, cold_dets),
              "warm pass: not bit-identical to the cold pass")

        with contextlib.redirect_stdout(io.StringIO()):
            dets, stats = det_serve.main(
                [*argv, "--workers", "2", "--prefill"])
        per = {wid: s["plan_cache"] for wid, s in stats["workers"].items()}
        print(f"warm start, front x2: prefill {stats['front']['prefill']}; "
              "store hits/misses by worker " + ", ".join(
                  f"{wid}: {c['store_hits']}/{c['store_misses']}"
                  for wid, c in sorted(per.items())), flush=True)
        check(stats["front"]["prefill"] is True and len(per) == 2 and all(
              c["store_hits"] >= 1 and c["store_misses"] == 0
              for c in per.values()), f"warm start, front: {per}")
        check(same_answers(dets, want),
              "warm start, front: not bit-identical to the in-process queue")

        mats = det_serve._random_queue(512, 8, 32, 0)
        grads = det_serve._grad_mix(512, 0.25, 0)
        policy = BucketPolicy(max_batch=64, mode="merge")
        with DetFront(workers=1, policy=policy, device="cuda",
                      persist_dir=str(store), accept="127.0.0.1:0") as front:
            got = [f.result(timeout=300)
                   for f in front.submit_many(mats[:256], grads[:256])]
            entries = front._prefill_entries()
            check(bool(entries), "warm start, join: no live families")
            joiner = threading.Thread(
                target=T.run_worker_client, args=(front.accept_address,),
                kwargs={"log": lambda *a, **k: None}, daemon=True)
            t0 = time.perf_counter()
            joiner.start()
            deadline = time.monotonic() + 120
            while len(front.alive_workers) != 2:
                check(time.monotonic() < deadline,
                      "warm start, join: the joiner was never admitted")
                time.sleep(0.05)
            admitted = time.perf_counter() - t0
            snap = front.snapshot(timeout=60)
            wid = [w for w in front.alive_workers if w != 0][0]
            jpc = snap["workers"][wid]["plan_cache"]
            print(f"warm start, join: {len(entries)} families shipped; the "
                  f"joiner admitted {admitted:.3f} s after it dialed, its "
                  f"first snapshot: {jpc['size']} plans, store_hits "
                  f"{jpc['store_hits']}, store_misses "
                  f"{jpc['store_misses']}", flush=True)
            check(jpc["store_hits"] >= 1 and jpc["size"] == len(entries),
                  f"warm start, join: {jpc}")
            got += [f.result(timeout=300)
                    for f in front.submit_many(mats[256:], grads[256:])]
        joiner.join(timeout=60)
        check(not joiner.is_alive(), "warm start, join: the joiner hangs")
        check(same_answers(got, want),
              "warm start, join: not bit-identical to the in-process queue")

    for B, m, n in [(64, 8, 20), (16, 20, 24)]:
        plan = aot_compile_batched(m, n, B)
        As = torch.randn(B, m, n, device="cuda", generator=gen)
        cts = torch.randn(B, device="cuda", generator=gen)
        reset_launch_counts()
        value, grad = plan(As), plan.grad(As, cts)
        launched = (k1.launches, k3.launches)
        T_ = As.clone().requires_grad_(True)
        ref = radic_det_batched(T_)
        (ref_grad,) = torch.autograd.grad(ref, T_, grad_outputs=cts)
        torch.cuda.synchronize()
        print(f"aot_compile_batched({m}, {n}, {B}): K1 {launched[0]} and "
              f"K3 {launched[1]} launches (wide {k1.wide_launches}/"
              f"{k3.wide_launches} of all four); value and grad equal "
              "radic_det_batched's bit for bit", flush=True)
        check(launched == (1, 1) and k1.launches == k3.launches == 2
              and k1.wide_launches == k3.wide_launches == 2 * (m > 16),
              f"aot ({m}, {n}): launches {launched}, then "
              f"{(k1.launches, k3.launches)}")
        check(torch.equal(value, ref.detach()) and torch.equal(grad,
                                                                 ref_grad),
              f"aot ({m}, {n}): not bit-identical to radic_det_batched")
        try:
            plan(As[:-1])
            check(False, f"aot ({m}, {n}) took a batch of another size")
        except TypeError:
            pass

    with tempfile.TemporaryDirectory() as tmp:
        tree = {"w": torch.randn(64, 33, device="cuda", generator=gen),
                "opt": [torch.randn(7, device="cuda", generator=gen).double(),
                        torch.arange(-5, 5, device="cuda",
                                     dtype=torch.int32)],
                "h": torch.randn(16, 16, device="cuda",
                                 generator=gen).to(torch.bfloat16)}
        manager = CheckpointManager(tmp)
        manager.save_async(3, tree)
        for device in ("cuda", "cpu"):
            step, out = manager.restore(tree, device=device)
            ok = step == 3 and all(
                a.dtype == b.dtype and b.device.type == device
                and torch.equal(a.cpu(), b.cpu())
                for a, b in zip((tree["w"], *tree["opt"], tree["h"]),
                                (out["w"], *out["opt"], out["h"])))
            check(ok, f"checkpoint restored on {device}: not bit for bit")
        print("checkpoint: cuda tensors (float32, float64, int32, bfloat16) "
              "saved asynchronously, restored on cuda and on cpu bit for "
              "bit", flush=True)


def phase_mesh(errs: Errors, gen: torch.Generator, serve: dict) -> dict:
    """The mesh (``repro_torch.core.distributed``) on a (2, 4)
    ``("data", "model")`` grid over ``cuda:0`` repeated, and on (1,) and
    (2,) ``("data",)`` grids: each entry driven with the launch counts set
    to 0 just before it and read just after, after one uncounted call that
    plans it; walls are medians of three warm calls, host clock."""
    from repro_torch.core import (Mesh, default_engine,
                                  make_distributed_evaluator, plan_grains,
                                  radic_det, radic_det_batched,
                                  radic_det_distributed, radic_det_oracle,
                                  unrank_py)
    from repro_torch.core.engine import rank_table
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.radic_fused import (
        radic_batched_grad_partial_cuda as k3,
        radic_batched_partial_cuda as k1, radic_batched_partial_plain,
        radic_grad_partial_cuda as k3b1, radic_partial_cuda as k2,
        radic_partial_plain)
    from repro_torch.launch import det_serve
    from repro_torch.launch.det_queue import BucketPolicy, DetQueue
    from repro_torch.runtime import build_mesh, choose_mesh

    print(card_line())
    grid = build_mesh(choose_mesh(8, max_model=4), ["cuda:0"] * 8)
    one = Mesh(["cuda:0"], ("data",))
    pair = Mesh(["cuda:0"] * 2, ("data",))
    check(dict(grid.shape) == {"data": 2, "model": 4},
          f"build_mesh gave {dict(grid.shape)}")

    def launches() -> dict:
        return {"K1": k1.launches, "K2": k2.launches, "K3": k3.launches,
                "K3 B=1": k3b1.launches}

    def leg(label: str, fn, reps: int = 3):
        """``fn``'s result, its launches (the first counted call) and its
        median wall, ms."""
        fn()
        torch.cuda.synchronize()
        reset_launch_counts()
        walls, counts = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            counts = counts or launches()
        wall = sorted(walls)[len(walls) // 2]
        print(f"mesh {label}: wall {wall:.3f} ms, launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        return out, counts, wall

    def expect(counts: dict, label: str, want: dict) -> None:
        got = {k: counts[k] for k in want}
        check(got == want, f"{label}: launches {counts}, want {want}")

    # 1. scalar flat on the paper's (10, 34): one K2 launch a shard
    m, n = 10, 34
    total = comb(n, m)
    big = torch.randn(m, n, device="cuda", generator=gen)
    table = rank_table(n, m, backend="cuda", device="cuda")
    single, c, w_single = leg("(10,34) single-device plan",
                              lambda: radic_det(big, backend="cuda"))
    expect(c, "single", {"K2": 1})
    got, c, w_flat = leg("(10,34) flat on (2,4)",
                         lambda: radic_det_distributed(
                             big, mesh=grid, mode="flat", backend="cuda"))
    expect(c, "flat (2,4)", {"K1": 0, "K2": 8})
    k2_launches = c["K2"]
    errs.hold("K2 mesh", "(10,34) flat (2,4) vs the single-device plan",
              got, single)
    errs.hold("K2 mesh", "(10,34) flat (2,4) vs float64 plain", got,
              radic_partial_plain(big, table, 0, total,
                                  dtype=torch.float64, chunk=1 << 19))
    check(torch.equal(got, radic_det_distributed(
        big, mesh=grid, mode="flat", backend="cuda")),
        "(10,34) flat (2,4): a second call moved a bit")
    got, c, _ = leg("(10,34) flat on (1,)", lambda: radic_det_distributed(
        big, mesh=one, mode="flat", backend="cuda"))
    expect(c, "flat (1,)", {"K2": 1})
    check(torch.equal(got, single),
          "(10,34) flat (1,) is not the single-device plan bit for bit")
    # fewer ranks than shards: five of eight launches walk no rank
    A23 = torch.randn(2, 3, device="cuda", generator=gen)
    S23 = torch.randn(4, 2, 3, device="cuda", generator=gen)
    got, c, _ = leg("(2,3) flat on (2,4), 3 ranks", lambda:
                    radic_det_distributed(A23, mesh=grid, mode="flat",
                                          backend="cuda"), reps=1)
    expect(c, "(2,3) flat", {"K2": 8})
    errs.hold("K2 mesh", "(2,3) flat (2,4) vs the oracle", got.cpu(),
              torch.tensor(radic_det_oracle(A23.cpu().numpy())))
    got, c, _ = leg("(4,2,3) on (2,4), 3 ranks", lambda: radic_det_batched(
        S23, mesh=grid, batch_axis="data", backend="cuda"), reps=1)
    expect(c, "(4,2,3)", {"K1": 8})
    errs.hold("K1 mesh", "(4,2,3) on (2,4) vs the oracle", got.cpu(),
              torch.tensor([radic_det_oracle(a) for a in S23.cpu().numpy()]))

    # 2. batched values: batch over "data", ranks over "model"
    walls = {"(10,34) single-device": w_single, "(10,34) flat (2,4)": w_flat}
    k1_shapes = {}
    for B, m, n in ((64, 8, 31), (4, 20, 26)):
        total = comb(n, m)
        table = rank_table(n, m, backend="cuda", device="cuda")
        As = torch.randn(B, m, n, device="cuda", generator=gen)
        if m > 16:
            As /= m ** 0.5
        tag = f"({B},{m},{n})"
        single, c, w_single = leg(f"{tag} single-device plan",
                                  lambda: radic_det_batched(As,
                                                            backend="cuda"))
        got, c, w_mesh = leg(f"{tag} batch over data on (2,4)",
                             lambda: radic_det_batched(
                                 As, mesh=grid, batch_axis="data",
                                 backend="cuda"))
        expect(c, tag, {"K1": 8})
        errs.hold("K1 mesh", f"{tag} (2,4) vs the single-device plan", got,
                  single)
        errs.hold("K1 mesh", f"{tag} (2,4) vs float64 plain", got,
                  radic_batched_partial_plain(
                      As, table, 0, total, dtype=torch.float64,
                      chunk=max(1, (1 << 27) // (B * m * m))))
        got, c, w_all = leg(f"{tag} ranks over all of (2,4)",
                            lambda: radic_det_batched(As, mesh=grid,
                                                      backend="cuda"))
        expect(c, f"{tag} ranks over all", {"K1": 8})
        errs.hold("K1 mesh", f"{tag} ranks over (2,4) vs single", got,
                  single)
        got, c, _ = leg(f"{tag} on (2,) data", lambda: radic_det_batched(
            As, mesh=pair, batch_axis="data", backend="cuda"))
        expect(c, f"{tag} (2,)", {"K1": 2})
        check(torch.equal(got, single),
              f"{tag} on (2,) is not the single-device plan slot by slot")
        walls[f"{tag} single-device"] = w_single
        walls[f"{tag} batch over data (2,4)"] = w_mesh
        walls[f"{tag} ranks over all of (2,4)"] = w_all
        k1_shapes[tag] = (As, table, total)

        # 3. the batched gradient, cotangents with zeros and negatives
        cts = torch.randn(B, device="cuda", generator=gen)
        cts[::3] = 0.0

        def grad(mesh=None, **kw):
            T = As.detach().clone().requires_grad_(True)
            return torch.autograd.grad(
                radic_det_batched(T, mesh=mesh, backend="cuda", **kw), T,
                cts)[0]

        want, c, w_single = leg(f"{tag} gradient, single-device", grad)
        got, c, w_mesh = leg(f"{tag} gradient, batch over data on (2,4)",
                             lambda: grad(grid, batch_axis="data"))
        expect(c, f"{tag} gradient", {"K1": 8, "K3": 8})
        if m <= 16:   # the shape the kernels line times
            k1_shapes["cts"], k3_launches = cts, c["K3"]
        errs.hold("K3 mesh", f"{tag} gradient (2,4) vs single", got, want)
        got, c, _ = leg(f"{tag} gradient on (2,)",
                        lambda: grad(pair, batch_axis="data"))
        expect(c, f"{tag} gradient (2,)", {"K3": 2})
        check(torch.equal(got, want),
              f"{tag} gradient on (2,) is not the single-device one")
        walls[f"{tag} gradient single-device"] = w_single
        walls[f"{tag} gradient batch over data (2,4)"] = w_mesh

    # the scalar mesh plan's gradient: one K3 launch at B = 1
    A6 = torch.randn(6, 20, device="cuda", generator=gen)
    plan_m = default_engine().plan(6, 20, batched=False, backend="cuda",
                                   mesh=grid)
    plan_s = default_engine().plan(6, 20, batched=False, backend="cuda")
    got, c, _ = leg("(6,20) scalar mesh plan's gradient",
                    lambda: plan_m.grad(A6, 1.0))
    expect(c, "(6,20) plan.grad", {"K3 B=1": 1, "K2": 0})
    check(torch.equal(got, plan_s.grad(A6, 1.0)),
          "(6,20): the mesh plan's gradient is not the single-device one")
    T = A6.clone().requires_grad_(True)
    reset_launch_counts()
    (g,) = torch.autograd.grad(radic_det(T, mesh=grid, mode="flat",
                                         backend="cuda"), T)
    torch.cuda.synchronize()
    expect(launches(), "(6,20) autograd", {"K2": 8, "K3 B=1": 1})
    check(torch.equal(g, plan_s.grad(A6, 1.0)),
          "(6,20) autograd through the mesh is not plan.grad")

    # 4. grains: 512 grains of the paper's (5, 24) in float64
    A5 = torch.randn(5, 24, dtype=torch.float64, device="cuda",
                     generator=gen)
    ev = make_distributed_evaluator(5, 24, mesh=grid, grains_per_device=64)
    check(len(ev.grain_lengths) == 512 and max(ev.grain_lengths) == 84,
          f"(5,24): {len(ev.grain_lengths)} grains, "
          f"{max(ev.grain_lengths)} steps")
    got, c, w_grains = leg("(5,24) f64 grains 64 a slot on (2,4)", lambda:
                           radic_det_distributed(A5, mesh=grid,
                                                 grains_per_device=64))
    check(not any(c.values()), f"grains launched kernels: {c}")
    want = radic_det_oracle(A5.cpu().numpy())
    r = abs(float(got) - want) / max(1.0, abs(want))
    print(f"mesh grains (5,24) vs oracle: {float(got)!r} {want!r} "
          f"rel_err={r:.3e}")
    check(r <= TOL, f"grains (5,24) rel_err {r:.3e} > {TOL:g}")
    walls["(5,24) f64 grains 512 on (2,4)"] = w_grains
    A58 = torch.randn(5, 8, device="cuda", generator=gen)
    got = radic_det_distributed(A58, grains_per_device=5)   # every card
    want = radic_det_oracle(A58.cpu().numpy())
    r = abs(float(got) - want) / max(1.0, abs(want))
    print(f"mesh grains (5,8) over 5 grains: rel_err={r:.3e}")
    check(r <= TOL, f"grains (5,8) rel_err {r:.3e} > {TOL:g}")
    t0 = time.perf_counter()
    ev = make_distributed_evaluator(30, 70, mesh=grid, grains_per_device=2)
    starts, lengths = plan_grains(comb(70, 30), 16)
    check(ev.grain_starts == starts and ev.grain_lengths == lengths
          and ev.start_combos == [unrank_py(q, 70, 30) for q in starts],
          "C(70,30): the grain starts are not the bigint unranking")
    print(f"mesh grains C(70,30) = {comb(70, 30)} (past int64): 16 grain "
          f"starts planned in {(time.perf_counter() - t0) * 1e3:.3f} ms")

    # 5. serving over the mesh: phase 4's 512 requests, each leg beside
    # the same leg on one device (its plans warm from phase 4)
    mats, want = serve["mats"], serve["want"]
    for mesh, shards in ((None, 1), (grid, 8)):
        where = "(2,4)" if mesh is not None else "one device"
        reset_launch_counts()
        t0 = time.perf_counter()
        dets, stats = det_serve.drain_queue(mats, max_batch=64, mesh=mesh)
        w_drain = (time.perf_counter() - t0) * 1e3
        dispatches = sum(s["dispatches"] for s in stats.values())
        expect(launches(), f"drain_queue on {where}",
               {"K1": shards * dispatches})
        hold_served(errs, "K1 mesh", f"drain_queue on {where}", dets, want)
        reset_launch_counts()
        t0 = time.perf_counter()
        batch_axis = None if mesh is None else "data"
        with DetQueue(mesh=mesh, batch_axis=batch_axis,
                      policy=BucketPolicy(max_batch=64,
                                          pin_capacity=True)) as q:
            dets, q_stats = q.serve(mats, timeout=600)
        w_queue = (time.perf_counter() - t0) * 1e3
        if mesh is not None:   # the mesh path's serving launches
            k1_serving = k1.launches
        expect(launches(), f"DetQueue on {where}",
               {"K1": shards * q_stats["dispatches"]})
        hold_served(errs, "K1 mesh", f"DetQueue on {where}, pinned "
                    "capacity", dets, want)
        print(f"mesh serving, 512 requests on {where}: drain_queue "
              f"{w_drain:.3f} ms in {dispatches} dispatches; DetQueue "
              f"(batch over data on the grid), pinned capacity "
              f"{w_queue:.3f} ms in {q_stats['dispatches']} dispatches",
              flush=True)
        walls[f"serving drain_queue {where}"] = w_drain
        walls[f"serving DetQueue pinned {where}"] = w_queue
    walls["serving one queue (phase 4)"] = serve["wall"] * 1e3
    print("mesh walls, ms: " + json.dumps(walls))
    As, table, total = k1_shapes["(64,8,31)"]
    return {"K1": k1_serving, "K2": k2_launches, "K3": k3_launches,
            "As": As, "cts": k1_shapes["cts"], "table": table,
            "total": total}


# --------------------------------------------------------------- LM serving
LM_SERVE_ARGS = ["--arch", "llama3-8b", "--batch", "4", "--prompt-len", "16",
                 "--gen", "32"]
LM_PARAMS = 8_030_261_248      # llama3_8b.py's CONFIG, embed and head apart
GEMMA_PROMPT = 4160            # past gemma2's 4,096 window
GEMMA_GEN = 4


def decode_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (1 + |want|): at most ``tol`` exactly where
    ``assert_allclose(got, want, rtol=tol, atol=tol)`` passes, the
    reference's decode == forward rule at ``tol = 2e-3``."""
    got, want = got.double(), want.double()
    return ((got - want).abs() / (1 + want.abs())).max().item()


def rel_fro(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want||_F / ||want||_F."""
    got, want = got.double(), want.double()
    return (torch.linalg.vector_norm(got - want)
            / torch.linalg.vector_norm(want)).item()


def free_card() -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def teacher_forced(model, prompts: torch.Tensor, gen: torch.Tensor,
                   max_len: int, frames: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """Prefill the prompts, then decode ``gen``'s tokens one a step: the
    (B, 1 + G, V) float32 logits of the prefill and of each step.  With
    ``frames`` (the encoder-decoder) the prefill is the serve driver's:
    the warm cross cache, then the prompt forced through decode."""
    with torch.inference_mode():
        if frames is None:
            logits, cache = model.prefill(prompts, max_len)
        else:
            cache = model.warm_cross_cache(
                model.init_cache(prompts.shape[0], max_len), frames)
            for t in range(prompts.shape[1]):
                logits, cache = model.decode_step(cache,
                                                  prompts[:, t:t + 1])
        out = [logits]
        for t in range(gen.shape[1]):
            logits, cache = model.decode_step(cache, gen[:, t:t + 1])
            out.append(logits)
        return torch.stack(out, 1)


def with_cfg(model, cfg):
    """``model`` under another config of the same shapes, sharing its
    params (a knob of the forward, such as ``attn_chunk``)."""
    import copy
    twin = copy.copy(model)
    twin.cfg = cfg
    return twin


def phase_lm_serve() -> dict:
    """Phase 15: ``repro_torch.launch.serve`` on llama3-8b at full width
    in bf16, held against a float32 copy of the same weights; its EOS leg;
    then gemma2-9b at full width cut to two layers on a prompt past its
    window."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    print(card_line(), flush=True)
    reduced = torch.backends.cuda.matmul.\
        allow_bf16_reduced_precision_reduction
    torch.cuda.reset_peak_memory_stats()
    out = serve.run(LM_SERVE_ARGS)
    model = out["model"]
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == (32, 4096, 128256)
          and model.embed.dtype == cfg.adtype == torch.bfloat16,
          f"llama3-8b is not at full width in bf16: {cfg}")
    check(n_params == LM_PARAMS, f"{n_params} params, not {LM_PARAMS}")
    served = torch.stack(out["logits"], 1)                  # (B, 33, V)
    check(bool(torch.isfinite(served).all()), "served logits not finite")
    B, P, G = 4, 16, 32
    gen = torch.as_tensor(out["tokens"], device="cuda").int()
    prompts = torch.as_tensor(out["prompts"], device="cuda")
    check(tuple(gen.shape) == (B, G), f"generated {tuple(gen.shape)}")
    check(bool((gen.long() == served[:, :G].argmax(-1)).all()),
          "served tokens are not the argmax of the served logits")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.layers.parameters()) + \
        model.lm_head.numel() * model.lm_head.element_size()
    bound = weight_bytes / PEAK_BYTES * 1e3
    print(f"LM serve llama3-8b bf16 (B={B}, prompt {P}, gen {G}): "
          f"{n_params} params; prefill {out['prefill_ms']:.3f} ms, decode "
          f"{out['decode_ms']:.3f} ms/step, {out['tok_s']:.1f} tok/s; "
          f"decode bound {bound:.3f} ms ({weight_bytes / 1e9:.3f} GB of "
          f"layer and head weights at {PEAK_BYTES / 1e12:.2f} TB/s); "
          f"allow_bf16_reduced_precision_reduction={reduced}", flush=True)
    with torch.inference_mode():
        _, cache = model.prefill(prompts, P + G)
        tok = gen[:, :1]
        step_ms = cuda_ms(lambda: model.decode_step(cache, tok), min_reps=5)
        dev_ms = device_ms(lambda: model.decode_step(cache, tok), reps=5)
        del cache
        pre_ms = cuda_ms(lambda: model.prefill(prompts, P + G))
    print(f"LM decode step back to back (no per-step host sync): "
          f"{step_ms:.3f} ms (CUDA events), {dev_ms:.3f} ms of device "
          f"time (profiler): the host's share {1 - dev_ms / step_ms:.1%}; "
          f"bound {bound:.3f} ms; a warm prefill {pre_ms:.3f} ms (the same "
          f"bytes bound)", flush=True)

    # the head at a decode step: bf16 operands with float32 output (the
    # serve path) against float32 operands, a float32 copy of the bf16
    # head made each call (this slice's first head), on the same x
    from repro_torch.models.lm import f32_product
    w = model.lm_head
    hx = torch.randn(B, 1, cfg.d_model, device="cuda", generator=torch.
                     Generator("cuda").manual_seed(3)).to(cfg.adtype)

    def copied():
        return torch.matmul(hx.float(), w.float())

    with torch.inference_mode():
        head_ms = device_ms(lambda: f32_product(hx, w), reps=5)
        copy_ms = device_ms(copied, reps=5)
        r = rel_err(f32_product(hx, w), copied())
    head_bound = w.numel() * w.element_size() / PEAK_BYTES * 1e3
    print(f"LM head at a decode step ({B} x {cfg.d_model} @ {cfg.d_model}"
          f" x {cfg.vocab_size} bf16): float32 output from bf16 operands "
          f"{head_ms:.4f} ms of device time, float32 operands from a copy "
          f"{copy_ms:.4f} ms ({copy_ms - head_ms:.4f} ms more, "
          f"{(copy_ms - head_ms) / (dev_ms + copy_ms - head_ms):.1%} of a "
          f"step that made the copy); bound {head_bound:.4f} ms (the head "
          f"read once); rel_err {r:.3e} (tol {TOL:g})", flush=True)
    check(r <= TOL, f"LM head: bf16 operands vs float32 {r:.3e} > {TOL:g}")
    del hx

    bf_on = teacher_forced(model, prompts, gen, P + G)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        not reduced
    bf_off = teacher_forced(model, prompts, gen, P + G)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced
    print(f"LM teacher-forced bf16 == served logits bit for bit: "
          f"{torch.equal(bf_on, served)}", flush=True)

    # a float32 copy of the same weights (bf16 -> float32 is exact)
    m32 = build_model(cfg.replace(param_dtype="float32", dtype="float32"))
    with torch.no_grad():
        for (n32, p32), (n16, p16) in zip(m32.named_parameters(),
                                          model.named_parameters()):
            check(n32 == n16, f"{n32} != {n16}")
            p32.copy_(p16)
    seq = torch.cat([prompts, gen.long()], 1)               # (B, P + G)
    with torch.inference_mode():
        full32 = m32.forward(seq)[0][:, P - 1:]             # (B, G + 1, V)
    dec32 = teacher_forced(m32, prompts, gen, P + G)
    e = decode_err(dec32, full32)
    print(f"LM float32 copy: prefill + {G} decode steps vs forward: "
          f"max |d|/(1+|f|) = {e:.3e} (tol 2e-3)", flush=True)
    check(e <= 2e-3, f"float32 decode vs forward {e:.3e} > 2e-3")
    errs = {"served": rel_fro(served, full32),
            f"reduced={reduced}": rel_fro(bf_on, full32),
            f"reduced={not reduced}": rel_fro(bf_off, full32)}
    agree = (full32[:, :G].argmax(-1) == gen.long()).float().mean().item()
    print(f"LM bf16 vs float32 forward, relative Frobenius error (tol "
          f"5e-2): " + ", ".join(f"{k} {v:.4e}" for k, v in errs.items())
          + f"; float32 greedy picks the served token at {agree:.1%} of "
          f"steps; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB", flush=True)
    check(errs["served"] <= 5e-2,
          f"bf16 served logits vs float32: {errs['served']:.4e} > 5e-2")
    first = out["tokens"]
    result = {"prefill_ms": out["prefill_ms"], "decode_ms": out["decode_ms"],
              "tok_s": out["tok_s"], "bound_ms": bound, "step_ms": step_ms,
              "warm_prefill_ms": pre_ms, "head_ms": head_ms,
              "head_copy_ms": copy_ms,
              "device_ms": dev_ms, "rel_fro": errs, "decode_err": e}
    del out, model, m32, served, bf_on, bf_off, full32, dec32
    free_card()

    # the EOS leg: the token slot 0 emits at step 1 ends slot 0 there
    # (serve checks each decode step's token; the prefill's is never EOS)
    eos = int(first[0, 1])
    leg = serve.run(LM_SERVE_ARGS + ["--eos", str(eos)])
    got = leg["tokens"]
    stop = 1
    print(f"LM EOS leg (--eos {eos}): live={leg['live']}/{B}, "
          f"{leg['n_live_tokens']} live tokens of {B * G}", flush=True)
    check(leg["live"] < B and leg["n_live_tokens"] < B * G,
          "the EOS leg's live count did not drop")
    check(np.array_equal(got[0, :stop + 1], first[0, :stop + 1])
          and bool((got[0, stop:] == eos).all()),
          "slot 0 does not end at its EOS")
    del leg
    free_card()
    phase_gemma_window()
    return result


def phase_gemma_window() -> None:
    """gemma2-9b at full width cut to two layers (local, then global),
    float32, batch 1, a prompt of 4,160 tokens: the dense forward against
    ``attn_chunk=1024`` and against prefill + decode, and the window
    masking real positions."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("gemma2-9b").replace(n_layers=2, param_dtype="float32",
                                          dtype="float32")
    check(cfg.is_local_layer(0) and not cfg.is_local_layer(1)
          and cfg.attn_window == 4096, "gemma2's layers are not local, "
          "global")
    model = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    S, G = GEMMA_PROMPT, GEMMA_GEN
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, S + G)), device="cuda")
    with torch.inference_mode():
        full = model.forward(toks)[0]                       # (1, S + G, V)
        check(bool(torch.isfinite(full).all()), "gemma2 logits not finite")
        chunked = with_cfg(model, cfg.replace(attn_chunk=1024)).forward(
            toks)[0]
        r = rel_err(chunked, full)
        del chunked
        nowin = with_cfg(model, cfg.replace(attn_window=None)).forward(
            toks)[0]
        inside = torch.equal(nowin[:, :4096], full[:, :4096])
        moved = (nowin[:, 4096:] - full[:, 4096:]).abs().max().item()
        del nowin
    print(f"gemma2-9b (2 layers, f32, prompt {S}): attn_chunk=1024 vs dense"
          f" rel_err={r:.3e} (tol {TOL:g}); without the window the first "
          f"4096 positions are bit for bit the same: {inside}, the later "
          f"ones move by up to {moved:.3e}", flush=True)
    check(r <= TOL, f"gemma2 chunked vs dense {r:.3e} > {TOL:g}")
    check(inside and moved > 0, "the window does not mask real positions")
    for chunk in (0, 1024):
        m = with_cfg(model, cfg.replace(attn_chunk=chunk))
        dec = teacher_forced(m, toks[:, :S], toks[:, S:], S + G)[:, :G]
        e = decode_err(dec, full[:, S - 1:S + G - 1])
        print(f"gemma2-9b prefill (attn_chunk={chunk}) + {G} decode steps"
              f" vs forward: max |d|/(1+|f|) = {e:.3e} (tol 2e-3)",
              flush=True)
        check(e <= 2e-3, f"gemma2 decode vs forward {e:.3e} > 2e-3")
    del model, full
    free_card()


# ---------------------------------------------------------- LM families
# (arch, layers kept: None for all, params of what runs (the reference's
# eval_shape, all leaves), prompt tokens): grok-1 (about 633 GB in bf16)
# and arctic (about 957 GB) are cut in depth only
LM_FAMILIES = (
    ("mamba2-1.3b", None, 1_343_740_928, 300),
    ("hymba-1.5b", None, 1_640_872_384, 1100),
    ("whisper-medium", None, 1_012_314_112, 16),
    ("grok-1-314b", 2, 11_450_578_944, 16),
    ("arctic-480b", 1, 14_119_490_560, 16),
)
FAMILY_BATCH, FAMILY_GEN = 4, 32


class RouterLog:
    """Wraps ``repro_torch.models.moe._router`` (which ``moe_forward``
    looks up at each call).  ``record(fn)`` runs ``fn`` and keeps each
    router call's expert ids and float32 router logits, on the CPU, in
    call order (a call a layer a prefill or step); ``forced(fn, calls)``
    runs ``fn`` with each call's expert ids replaced by a recorded run's,
    the gates renormalized from this run's own probabilities."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe._router
        self.calls, self.replay = None, None

        def wrapped(p, xf, cfg):
            gates, idx, aux = self.orig(p, xf, cfg)
            logits = xf.float() @ p["router"].float()
            if self.replay is not None:
                idx = next(self.replay).to(idx.device).reshape(idx.shape)
                probs = torch.softmax(logits, dim=-1)
                gates = torch.gather(probs, -1, idx)
                gates = gates / torch.sum(gates, dim=-1, keepdim=True)
            if self.calls is not None:
                self.calls.append((idx.reshape(-1, idx.shape[-1]).cpu(),
                                   logits.reshape(-1, logits.shape[-1])
                                   .cpu()))
            return gates, idx, aux
        moe._router = wrapped

    def record(self, fn):
        self.calls = []
        try:
            return fn(), self.calls
        finally:
            self.calls = None

    def forced(self, fn, calls):
        self.replay = iter([idx for idx, _ in calls])
        try:
            return fn()
        finally:
            self.replay = None

    def close(self) -> None:
        self.moe._router = self.orig


def route_flips(bf_calls, f32_calls) -> dict:
    """bf16 against float32 routing, (token, layer) choice by choice: the
    share with the same top-k set; the largest router-logit difference
    between the runs (eps, and as a share of the largest logit); and
    whether each differing choice sits within 2 eps of a tie in the
    float32 logits, as a top-k of logits perturbed by at most eps must
    (a choice off by more is no rounding)."""
    same, explained, eps_max, rel_max = [], True, 0.0, 0.0
    for (ib, lb), (i32, l32) in zip(bf_calls, f32_calls):
        eps = (lb - l32).abs().max().item()
        eps_max = max(eps_max, eps)
        rel_max = max(rel_max, eps / l32.abs().max().item())
        agree = (torch.sort(ib, -1).values
                 == torch.sort(i32, -1).values).all(-1)
        same.append(agree)
        kth = torch.gather(l32, -1, i32).min(-1).values
        for t in torch.nonzero(~agree).flatten().tolist():
            extra = [e for e in ib[t].tolist() if e not in i32[t].tolist()]
            gap = (kth[t] - l32[t, extra].max()).item()
            explained &= gap <= 2 * eps
    same = torch.cat(same)
    return {"router_agree": same.float().mean().item(),
            "router_flips": int((~same).sum()), "router_eps": eps_max,
            "router_eps_rel": rel_max, "flips_within_eps": explained}


def to_float32(model) -> None:
    """Make ``model`` its own float32 copy, tensor by tensor: each bf16
    param's float32 twin is made, then the bf16 one freed, so the two
    whole copies never coexist (arctic's float32 layer alone is 56.5
    GB)."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype != torch.float32:
                p.data = p.data.float()
                if p.numel() >= 1 << 26:
                    torch.cuda.empty_cache()
    model.cfg = model.cfg.replace(param_dtype="float32", dtype="float32")


def decode_weight_bytes(model, active: float | None = None) -> int:
    """The weight bytes a decode step reads at least once: every layer
    (the decoder's, for the encoder-decoder) and the head; with
    ``active``, the expert stacks counted at that many experts a layer."""
    cfg = model.cfg
    layers = model.dec_layers if cfg.family == "audio" else model.layers
    total = 0
    for name, p in layers.named_parameters():
        n = p.numel()
        if active is not None and name.split(".")[1:] in (
                ["moe", "w_gate"], ["moe", "w_up"], ["moe", "w_down"]):
            n = n * active / cfg.n_experts
        total += n * p.element_size()
    head = model.embed if cfg.tie_embeddings else model.lm_head
    return int(total + head.numel() * head.element_size())


def serve_family(arch: str, layers, want_params: int, prompt: int) -> dict:
    """One arch of phase 17: serve it in bf16 through
    ``repro_torch.launch.serve.run``, then hold it against its own float32
    copy (made in place, tensor by tensor)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    B, P, G = FAMILY_BATCH, prompt, FAMILY_GEN
    argv = ["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
            "--gen", str(G)] + ([] if layers is None
                                else ["--layers", str(layers)])
    torch.cuda.reset_peak_memory_stats()
    t_arch = time.perf_counter()
    out = serve.run(argv)
    model = out["model"]
    cfg = model.cfg
    full = get_config(arch)
    moe = cfg.family == "moe"
    audio = cfg.family == "audio"
    n_params = sum(p.numel() for p in model.parameters())
    check(cfg == full.replace(n_layers=cfg.n_layers)
          and cfg.n_layers == (layers or full.n_layers)
          and model.embed.dtype == cfg.adtype == torch.bfloat16,
          f"{arch} is not at full width in bf16: {cfg}")
    check(n_params == want_params,
          f"{arch}: {n_params} params, not {want_params}")
    served = torch.stack(out["logits"], 1)                  # (B, 1 + G, V)
    gen = torch.as_tensor(out["tokens"], device="cuda").int()
    prompts = torch.as_tensor(out["prompts"], device="cuda")
    frames = out["frame_embeds"]
    check(bool(torch.isfinite(served).all()), f"{arch}: logits not finite")
    check(tuple(gen.shape) == (B, G)
          and bool((gen.long() == served[:, :G].argmax(-1)).all()),
          f"{arch}: served tokens are not the argmax of the served logits")
    seq = torch.cat([prompts, gen.long()], 1)               # (B, P + G)
    fwd_args = (frames,) if audio else ()
    res = {"arch": arch, "family": cfg.family, "layers": cfg.n_layers,
           "params": n_params, "prefill_ms": out["prefill_ms"],
           "decode_ms": out["decode_ms"], "tok_s": out["tok_s"]}
    cut = "" if layers is None else \
        f", cut to {layers} of {full.n_layers} layers at full width"
    res["bound_ms"] = decode_weight_bytes(model) / PEAK_BYTES * 1e3

    # a decode step back to back (no host sync a step), CUDA events
    with torch.inference_mode():
        if audio:
            cache = model.warm_cross_cache(model.init_cache(B, P + G), frames)
        else:
            _, cache = model.prefill(prompts, P + G)
        tok = gen[:, :1]
        res["step_ms"] = cuda_ms(lambda: model.decode_step(cache, tok),
                                 min_reps=5)
        del cache
    log = RouterLog() if moe else None
    try:
        if moe:
            bf_tf, bf_routes = log.record(
                lambda: teacher_forced(model, prompts, gen, P + G))
            steps = bf_routes[cfg.n_layers:]                # decode steps
            active = sum(len(torch.unique(idx)) for idx, _ in steps) / \
                len(steps)
            res["active_experts"] = active
            res["active_bound_ms"] = decode_weight_bytes(
                model, active) / PEAK_BYTES * 1e3
            with torch.inference_mode():
                once = model.forward(seq)[0]
                twice = model.forward(seq)[0]
            res["scatter_bitwise"] = torch.equal(once, twice)
            check(cfg.moe_impl == "scatter" and res["scatter_bitwise"],
                  f"{arch}: two calls of the scatter path differ")
            del once, twice
        else:
            bf_tf = teacher_forced(model, prompts, gen, P + G, frames)
        res["tf_equals_served"] = torch.equal(bf_tf, served)
        print(f"LM family {cfg.family} {arch} bf16 (B={B}, prompt {P}, gen "
              f"{G}{cut}): {n_params} params; prefill "
              f"{out['prefill_ms']:.3f} ms"
              + (" (warm cross cache + forced prompt)" if audio else "")
              + f", decode {out['decode_ms']:.3f} ms/step, "
              f"{out['tok_s']:.1f} tok/s; a step back to back "
              f"{res['step_ms']:.3f} ms; decode bound {res['bound_ms']:.3f}"
              f" ms (every layer and head weight at "
              f"{PEAK_BYTES / 1e12:.2f} TB/s)"
              + (f", {res['active_bound_ms']:.3f} ms at the "
                 f"{res['active_experts']:.2f} experts a layer this run's "
                 f"steps route to" if moe else "")
              + f"; teacher-forced == served bit for bit: "
              f"{res['tf_equals_served']}", flush=True)

        # the float32 copy of the same weights (bf16 -> float32 is exact)
        to_float32(model)
        cfg32 = model.cfg
        if moe:
            f32_tf, f32_routes = log.record(
                lambda: teacher_forced(model, prompts, gen, P + G))
            check(len(bf_routes) == len(f32_routes), "router call counts")
            res.update(route_flips(bf_routes, f32_routes))
            # the float32 copy on the served run's expert choices: bf16's
            # arithmetic apart from its routing flips
            forced = log.forced(
                lambda: teacher_forced(model, prompts, gen, P + G),
                bf_routes)
            res["rel_fro_own_routes"] = rel_fro(served, f32_tf)
            res["rel_fro"] = rel_fro(served, forced)
            del forced
        else:
            f32_tf = teacher_forced(model, prompts, gen, P + G, frames)
            res["rel_fro"] = rel_fro(served, f32_tf)
        # decode == forward; moe at C = Tg (no drops: the forward routes
        # B·S tokens a group, a decode step B)
        nodrop = with_cfg(model, cfg32.replace(
            capacity_factor=cfg.n_experts / cfg.top_k)) if moe else model
        with torch.inference_mode():
            full32 = nodrop.forward(seq, *fwd_args)[0][:, P - 1:]
        dec32 = f32_tf if not moe else teacher_forced(nodrop, prompts, gen,
                                                      P + G)
        res["decode_err"] = decode_err(dec32, full32)
        if moe and arch.startswith("grok"):
            with torch.inference_mode():
                onehot = with_cfg(model, nodrop.cfg.replace(
                    moe_impl="onehot")).forward(seq)[0][:, P - 1:]
            res["onehot_vs_scatter"] = rel_err(onehot, full32)
            del onehot
    finally:
        if log is not None:
            log.close()
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"LM family {arch} float32 copy: prefill + {G} decode steps vs "
          f"forward max |d|/(1+|f|) = {res['decode_err']:.3e} (tol 2e-3"
          + (", capacity_factor = n_experts / top_k: no drops" if moe
             else "") + "); bf16 served vs float32 teacher-forced "
          + (f"(published capacity) on its own routes "
             f"{res['rel_fro_own_routes']:.4e} relative Frobenius, on the"
             f" served run's routes {res['rel_fro']:.4e} (tol 5e-2); "
             f"bf16 and float32 route {res['router_agree']:.2%} of "
             f"(token, layer) choices alike ({res['router_flips']} "
             f"differ, each within 2 eps of a float32 tie: "
             f"{res['flips_within_eps']}; router logits differ by up to "
             f"eps {res['router_eps']:.3e}, {res['router_eps_rel']:.2e} "
             f"of the largest)" if moe else
             f"relative Frobenius {res['rel_fro']:.4e} (tol 5e-2)")
          + (f"; onehot vs scatter at no drops rel_err "
             f"{res['onehot_vs_scatter']:.3e} (tol 1e-4)"
             if "onehot_vs_scatter" in res else "")
          + f"; peak memory {res['peak_gb']:.2f} GB", flush=True)
    check(res["decode_err"] <= 2e-3,
          f"{arch}: float32 decode vs forward {res['decode_err']:.3e} > 2e-3")
    check(res["rel_fro"] <= 5e-2,
          f"{arch}: bf16 served logits vs float32 {res['rel_fro']:.4e} > "
          "5e-2")
    if moe:
        check(res["flips_within_eps"], f"{arch}: a routing choice differs "
              "by more than the router logits' bf16 perturbation")
    if "onehot_vs_scatter" in res:
        check(res["onehot_vs_scatter"] <= 1e-4,
              f"{arch}: onehot vs scatter {res['onehot_vs_scatter']:.3e}")
    first = out["tokens"]
    del out, model, nodrop, served, bf_tf, f32_tf, full32, dec32
    free_card()
    if audio:
        # the EOS leg: the token slot 0 emits at step 1 ends slot 0 there
        eos = int(first[0, 1])
        leg = serve.run(argv + ["--eos", str(eos)])
        got = leg["tokens"]
        print(f"LM family {arch} EOS leg (--eos {eos}): live={leg['live']}/"
              f"{B}, {leg['n_live_tokens']} live tokens of {B * G}",
              flush=True)
        check(leg["live"] < B and leg["n_live_tokens"] < B * G,
              f"{arch}: the EOS leg's live count did not drop")
        check(np.array_equal(got[0, :2], first[0, :2])
              and bool((got[0, 1:] == eos).all()),
              f"{arch}: slot 0 does not end at its EOS")
        del leg
        free_card()
    res["wall_s"] = time.perf_counter() - t_arch
    return res


def phase_lm_families() -> list:
    """Phase 17: the moe, ssm, hybrid and audio families served at their
    published widths in bf16 (grok-1 and arctic cut in depth), each held
    against its float32 copy.  Timed by CUDA events; opens no profiler
    window."""
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    results = [serve_family(*row) for row in LM_FAMILIES]
    print(f"LM families: {json.dumps(results)}", flush=True)
    print(f"LM families: phase wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    return results


# ---------------------------------------------------------------- training
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 12
TRAIN_ARGS = ["--arch", "llama3-8b", "--layers", "2", "--batch",
              str(TRAIN_B), "--seq", str(TRAIN_S), "--steps",
              str(TRAIN_STEPS), "--lr", "1e-3", "--device", "cuda"]
# peak of one H100 SXM for dense bf16 on the tensor cores (data sheet)
PEAK_BF16_FLOPS = 989e12


def grads_rel_fro(got: dict, want: dict) -> float:
    """The global gradient's ||got - want||_F / ||want||_F over every
    leaf, in float64."""
    num = den = 0.0
    for name, w in want.items():
        num += torch.linalg.vector_norm(got[name].float() - w.float(),
                                        dtype=torch.float64).item() ** 2
        den += torch.linalg.vector_norm(w, dtype=torch.float64).item() ** 2
    return (num / den) ** 0.5


def grads_allclose(got: dict, want: dict, rtol: float, atol: float
                   ) -> float:
    """max over leaves of max(|got - want| - rtol |want|) - atol: at most
    0 exactly where ``assert_allclose(got, want, rtol, atol)`` passes
    for every leaf."""
    worst = float("-inf")
    for name, w in want.items():
        d = (got[name].double() - w.double()).abs() - rtol * w.double().abs()
        worst = max(worst, d.max().item() - atol)
    return worst


def train_bound_ms(model, tokens: int) -> tuple[float, float, float, float]:
    """(bound, its FLOP term, its bytes term, remat's recompute) of one
    train step, ms.  The bound counts only the work a step needs: the
    matmul params' 6 FLOPs a token and causal attention's lower half of
    the S x S products forward and backward (6·B·H·S²·D a layer) at 989
    TFLOP/s; and AdamW reading each param, gradient and moment once and
    writing each param and moment once at 3.35 TB/s.  Remat's recompute
    of the layers' forward (2 FLOPs a layer param a token, 2·B·H·S²·D a
    layer) is returned apart, outside the bound."""
    cfg = model.cfg
    layer_mm = sum(p.numel() for p in model.layers.parameters()
                   if p.ndim >= 2)
    head_mm = model.lm_head.numel()
    attn_fwd = 2 * TRAIN_B * cfg.n_heads * TRAIN_S ** 2 * cfg.head_dim \
        * cfg.n_layers
    flops = 6 * (layer_mm + head_mm) * tokens + 3 * attn_fwd
    recompute = 2 * layer_mm * tokens + attn_fwd
    moment = 4                                   # float32 mu and nu
    nbytes = sum(p.numel() * (3 * p.element_size() + 4 * moment)
                 for p in model.parameters())
    t_flops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_flops + t_bytes, t_flops, t_bytes,
            recompute / PEAK_BF16_FLOPS * 1e3)


ADAMW_HELD = ("layers.0.attn.wq", "layers.1.mlp.w_down", "layers.1.norm2",
              "final_norm")


def hold_adamw_step(params: dict, grads: dict, opt: dict, opt_cfg,
                    names=ADAMW_HELD) -> tuple[dict, dict]:
    """One ``adamw_update`` on the card, with ``names``' params, moments
    and the update recomputed in float64 by the reference's formula
    from the same gradients, moments and step (the clip scale from a
    float64 global norm).  Returns (the new state, a report); the
    report's ``ok`` holds:

    * the gradient norm within 1e-5 relative of float64's;
    * mu and nu within 1e-4 of the magnitude of their two terms
      (``b·m + (1 - b)·g``) plus 1e-37 (float32's subnormals): float32
      rounding, where a no-op or wrong update is off by the whole new
      term;
    * a float32 param within float32's error: 4 float32 ulps of ``|p|``,
      1e-5 of its update ``lr·|delta|`` (the float32 bias corrections
      and quotient) and ``lr`` times mu's rounding (8 ulps of its two
      terms) carried through ``delta`` (where mu's terms cancel, that
      rounding is most of a small ``delta``);
    * a bf16 param equal to the float64 result rounded to float32 then
      bf16 (the card's chain) at all but 1e-3 of its elements, none off
      by more than 1 bf16 ulp plus float32's error (where ``p`` and its
      update cancel, that error exceeds the result's ulp); ``moved`` is
      the share the step changed.
    """
    from repro_torch.optim import adamw_update
    gnorm = sum(torch.linalg.vector_norm(g, dtype=torch.float64).item() ** 2
                for g in grads.values()) ** 0.5
    t = int(opt["step"]) + 1
    lr = float(opt_cfg.lr(opt["step"] + 1))
    snap = {n: (params[n].detach().double(), grads[n].double(),
                opt["mu"][n].double(), opt["nu"][n].double())
            for n in names}
    _, opt, m = adamw_update(params, grads, opt, opt_cfg)
    b1, b2, eps, wd = opt_cfg.b1, opt_cfg.b2, opt_cfg.eps, \
        opt_cfg.weight_decay
    scale = min(1.0, opt_cfg.grad_clip / (gnorm + 1e-9))
    r_gnorm = abs(m["grad_norm"].item() - gnorm) / gnorm
    report = {"step": t, "lr": lr, "grad_norm": gnorm, "rel_gnorm": r_gnorm,
              "lr_card": m["lr"].item()}
    ok = r_gnorm <= 1e-5 and m["lr"].item() == lr
    eps32 = 2.0 ** -24
    for n, (p0, g, mu0, nu0) in snap.items():
        g = g * scale
        mu = b1 * mu0 + (1 - b1) * g
        nu = b2 * nu0 + (1 - b2) * g * g
        delta = (mu / (1 - b1 ** t)) / ((nu / (1 - b2 ** t)).sqrt() + eps) \
            + wd * p0
        p = p0 - lr * delta
        w_mu = ((opt["mu"][n].double() - mu).abs()
                - 1e-4 * (b1 * mu0.abs() + (1 - b1) * g.abs())
                - 1e-37).max().item()
        w_nu = ((opt["nu"][n].double() - nu).abs()
                - 1e-4 * (b2 * nu0 + (1 - b2) * g * g) - 1e-37).max().item()
        got = params[n].detach()
        row = {"w_mu": w_mu, "w_nu": w_nu}
        mu_err = 8 * eps32 * (b1 * mu0.abs() + (1 - b1) * g.abs())
        err32 = 4 * eps32 * p0.abs() + lr * (
            1e-5 * delta.abs()
            + mu_err / (1 - b1 ** t) / ((nu / (1 - b2 ** t)).sqrt() + eps))
        if got.dtype == torch.float32:
            w_p = (got.double() - p).abs() - err32
            i = int(w_p.argmax())
            row["w_p"] = w_p.flatten()[i].item()
            row["worst"] = [t_.flatten()[i].item() for t_ in
                            (p0, g, mu0, nu0, p, got.double(), err32)]
            good = row["w_p"] <= 0
        else:
            want = p.float().to(got.dtype)
            off = got != want
            ulp = (got.double() - p).abs() - 2.0 ** -7 * p.abs() - err32
            row["off"] = off.double().mean().item()
            row["w_ulp"] = ulp.max().item()
            good = row["off"] <= 1e-3 and row["w_ulp"] <= 0
        row["moved"] = (got.double() != p0).double().mean().item()
        ok &= good and w_mu <= 0 and w_nu <= 0
        report[n] = row
    report["ok"] = ok
    return opt, report


def phase_train(errs: Errors, gen: torch.Generator) -> dict:
    """Phase 18: the training path on the card: a full-width llama3-8b
    step (2 layers, bf16) against its float32 copy, the chunked CE and
    remat, two steps bit for bit, the driver's loss decreasing; the
    train example with its K2/K3 head; a resume bit for bit."""
    import statistics
    from repro_torch.configs.registry import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch import train
    from repro_torch.launch.steps import (init_train_state, make_train_step,
                                          value_and_grad)
    from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    cfg = get_config("llama3-8b").replace(n_layers=2)
    check(cfg.remat and cfg.adtype == cfg.pdtype == torch.bfloat16,
          f"llama3-8b is not bf16 with remat: {cfg}")
    opt_cfg = AdamWConfig(lr=warmup_cosine(1e-3, 20, TRAIN_STEPS),
                          weight_decay=0.01)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_S, global_batch=TRAIN_B))
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in data.batch(s).items()} for s in range(7)]
    tokens = TRAIN_B * TRAIN_S

    def fresh():
        return init_train_state(cfg, opt_cfg,
                                torch.Generator("cuda").manual_seed(0))

    # one step twice from the same state: bit for bit
    model, opt = fresh()
    n_params = sum(p.numel() for p in model.parameters())
    opt, m1 = make_train_step(model, opt_cfg)(opt, batches[0])
    first = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss1, gn1 = m1["loss"].clone(), m1["grad_norm"].clone()
    del model, opt, m1
    free_card()
    model, opt = fresh()
    step = make_train_step(model, opt_cfg)
    opt, m2 = step(opt, batches[0])
    same = (torch.equal(loss1, m2["loss"])
            and torch.equal(gn1, m2["grad_norm"])
            and all(torch.equal(first[n], p)
                    for n, p in model.named_parameters()))
    print(f"train llama3-8b 2 layers bf16: {n_params} params; one step "
          f"twice from the same state: loss {loss1.item():.6f}, grad_norm "
          f"{gn1.item():.6f}, bit for bit {same}", flush=True)
    check(same, "two train steps from the same state differ")
    del first

    # six more steps, timed by CUDA events: the step's two halves (the
    # loss and its gradient; AdamW), then the loss's forward alone
    torch.cuda.reset_peak_memory_stats()
    params = dict(model.named_parameters())
    times, halves, losses = [], [], [m2["loss"].item()]
    for b in batches[1:]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss, grads = value_and_grad(model, b)
        ev[1].record()
        _, opt, m = adamw_update(params, grads, opt, opt_cfg)
        ev[2].record()
        ev[2].synchronize()
        del grads
        times.append(ev[0].elapsed_time(ev[2]))
        halves.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
        losses.append(loss.item())
    step_ms = statistics.median(times)
    grad_ms = statistics.median(h[0] for h in halves)
    adamw_ms = statistics.median(h[1] for h in halves)
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model.loss(batches[1]), min_reps=3)
    bound, t_flops, t_bytes, t_remat = train_bound_ms(model, tokens)
    print(f"train step (B={TRAIN_B}, S={TRAIN_S}, remat nothing): "
          f"{step_ms:.3f} ms median of {len(times)} (CUDA events; "
          f"{', '.join(f'{t:.3f}' for t in times)}), "
          f"{tokens / step_ms * 1e3:.1f} tokens/s, peak memory {peak:.2f} "
          f"GB; bound {bound:.3f} ms ({t_flops:.3f} ms of FLOPs at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s + {t_bytes:.3f} ms of "
          f"AdamW bytes at {PEAK_BYTES / 1e12:.2f} TB/s; remat's "
          f"recompute, outside it, {t_remat:.3f} ms), "
          f"{bound / step_ms:.1%} of it; losses {losses}", flush=True)
    print(f"train step halves (medians): loss and gradient {grad_ms:.3f} "
          f"ms against {t_flops:.3f} ms of FLOPs; AdamW {adamw_ms:.3f} ms "
          f"against {t_bytes:.3f} ms of bytes; the loss's forward alone "
          f"(no autograd) {fwd_ms:.3f} ms", flush=True)
    # one more step, its AdamW update held against float64
    loss, grads = value_and_grad(model, batches[0])
    opt, held = hold_adamw_step(params, grads, opt, opt_cfg)
    print(f"train AdamW step against float64 (the reference's formula on "
          f"the same gradients and moments): {json.dumps(held)}", flush=True)
    check(held["ok"], f"the AdamW update disagrees with float64: {held}")
    del opt, step, m, m2, params, grads
    free_card()

    # the bf16 loss and gradient against a float32 copy of the params
    batch = batches[0]
    loss16, g16 = value_and_grad(model, batch)
    to_float32(model)
    loss32, g32 = value_and_grad(model, batch)
    r_loss = abs(loss16.item() - loss32.item()) / abs(loss32.item())
    r_grad = grads_rel_fro(g16, g32)
    print(f"train bf16 vs float32 copy: loss {loss16.item():.6f} vs "
          f"{loss32.item():.6f} (rel {r_loss:.3e}, tol 1e-2); gradient "
          f"relative Frobenius error {r_grad:.4e} (tol 5e-2)", flush=True)
    check(r_loss <= 1e-2, f"bf16 loss vs float32 {r_loss:.3e} > 1e-2")
    check(r_grad <= 5e-2, f"bf16 gradient vs float32 {r_grad:.4e} > 5e-2")
    del g16

    # the chunked CE and remat on the float32 copy
    cfg32 = model.cfg
    lossc, gc = value_and_grad(with_cfg(model, cfg32.replace(
        loss_chunk=1024)), batch)
    dc = abs(lossc.item() - loss32.item())
    wc = grads_allclose(gc, g32, 2e-3, 1e-5)
    print(f"train chunked CE (loss_chunk=1024, 2 chunks, 1 pad) vs full: "
          f"|d loss| {dc:.3e} (tol 1e-4); gradients max(|d| - 2e-3 |f|) "
          f"- 1e-5 = {wc:.3e} (<= 0), relative Frobenius "
          f"{grads_rel_fro(gc, g32):.3e}", flush=True)
    check(dc < 1e-4, f"chunked CE loss off by {dc:.3e}")
    check(wc <= 0, "chunked CE gradients outside rtol=2e-3, atol=1e-5")
    del gc, g32
    remats = {"nothing": loss32.item()}
    finite = True
    for name, kw in (("none", dict(remat=False)),
                     ("dots", dict(remat_policy="dots"))):
        lr_, gr = value_and_grad(with_cfg(model, cfg32.replace(**kw)),
                                 batch)
        remats[name] = lr_.item()
        finite &= all(bool(torch.isfinite(g).all()) for g in gr.values())
        del gr
    dr = max(abs(v - remats["none"]) for v in remats.values())
    print(f"train remat: losses {remats} (max |d| vs none {dr:.3e}, tol "
          f"1e-5), gradients finite {finite}", flush=True)
    check(dr < 1e-5 and finite, f"remat changes the loss by {dr:.3e}")
    del model
    free_card()

    # the train driver, 12 steps at full width
    t_main = time.perf_counter()
    run = train.main(TRAIN_ARGS)
    print(f"train.main {' '.join(TRAIN_ARGS)}: losses {run} in "
          f"{time.perf_counter() - t_main:.1f} s", flush=True)
    check(len(run) == TRAIN_STEPS and run[-1] < run[0],
          "the train driver's loss did not decrease")
    free_card()
    result = {"params": n_params, "step_ms": step_ms, "bound_ms": bound,
              "grad_ms": grad_ms, "adamw_ms": adamw_ms, "fwd_ms": fwd_ms,
              "tokens_s": tokens / step_ms * 1e3, "peak_gb": peak,
              "rel_loss": r_loss, "rel_grad": r_grad, "chunk_dloss": dc,
              "remat_dloss": dr, "remat_ms": t_remat, "losses": run}
    result |= phase_train_example(errs, gen)
    print(f"train: phase wall {time.perf_counter() - t0:.1f} s", flush=True)
    return result


def phase_train_example(errs: Errors, gen: torch.Generator) -> dict:
    """Phase 18's example legs: ``examples/train_lm_torch.py`` with the
    launch counts set to 0 just before it and read just after, K2 and K3
    at B = 1 on its head against float64 plain, and a resume at its
    width bit for bit."""
    import tempfile
    from repro_torch.core.engine import rank_table
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels.radic_fused import (radic_grad_partial_plain,
                                                 radic_partial_plain)
    from repro_torch.launch import train
    reset_launch_counts()
    out, example = run_example("train_lm_torch.py", [])
    counts = launch_counts()
    check("OK: loss went from" in out
          and "OK: determinant-regularized head stays full-rank" in out,
          "the train example's OK lines are missing")
    k2, k3 = counts["radic_partial_cuda"], counts["radic_grad_partial_cuda"]
    shown = {k: v for k, v in counts.items() if v}
    print(f"train example launches {json.dumps(shown)}", flush=True)
    check(k2 > 0 and k3 > 0, "the train example's head launched no K2 or "
          "no K3 at B = 1")
    m, n = example.K_HEAD, example.D_HEAD
    table = rank_table(n, m, backend="cuda", device="cuda")
    total = comb(n, m)
    reset_launch_counts()
    for label in ("H_reg", "H_plain"):
        H = example.result[label].detach()
        ct = torch.randn((), device="cuda", generator=gen)
        errs.hold("K2", f"train head {label} ({m},{n})",
                  ops.radic_det_cuda(H, table=table),
                  radic_partial_plain(H, table, 0, total,
                                      dtype=torch.float64))
        errs.hold("K3", f"train head {label} B=1 ({m},{n})",
                  ops.radic_det_grad_cuda(H, ct, table=table),
                  radic_grad_partial_plain(H, ct, table, 0, total,
                                           dtype=torch.float64))
    print(f"train example: K2 and K3 held on the head (launches "
          f"{json.dumps({k: v for k, v in launch_counts().items() if v})},"
          f" not counted above)", flush=True)

    # a resume at the example's width equals an uninterrupted run
    args = ["--arch", example.ARCH, "--batch", "8", "--seq", "128",
            "--ckpt-every", "10", "--lr", "1e-3", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        train.main(args + ["--ckpt", a, "--steps", "12"])
        resumed = train.main(args + ["--ckpt", a, "--steps", "20"])
        whole = train.main(args + ["--ckpt", b, "--steps", "20"])
    print(f"train resume at the example's width: resumed at 12 "
          f"{resumed}; uninterrupted steps 12..19 {whole[12:]}; bit for "
          f"bit {resumed == whole[12:]}", flush=True)
    check(len(resumed) == 8 and resumed == whole[12:],
          "the resumed run's losses differ from the uninterrupted run's")
    return {"K2": k2, "K3": k3}


# ------------------------------------------------------------ the examples
QUICKSTART_LABELS = ("oracle (numpy enumeration)",
                     "flat torch (rank-parallel)", "fused CUDA kernel",
                     "mesh-distributed grains")


def run_example(name: str, argv: list[str]):
    """Run ``examples/<name>``'s ``main(argv)`` in this process (so the
    launch counts see its kernels): what it printed, and the module (its
    ``result`` what ``main`` returned)."""
    import contextlib
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        f"example_{name[:-3]}", ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.result = mod.main(argv)
    print(buf.getvalue(), end="", flush=True)
    return buf.getvalue(), mod


def phase_examples(errs: Errors, gen: torch.Generator) -> dict:
    """Phase 16: the port's two examples on the card, each driven with
    the launch counts set to 0 just before it and read just after; then
    K1 and K3 at the retrieval's shapes against float64 plain."""
    import re
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out, _ = run_example("quickstart_torch.py", [])
    quick = launch_counts()
    for label in QUICKSTART_LABELS:
        m = re.search(re.escape(label) + r"\s*: (-?[0-9.]+)", out)
        check(bool(m) and abs(float(m.group(1)) + 1.1201943) < 1e-3,
              f"quickstart's {label!r} line is off")
    check(quick["radic_partial_cuda"] > 0, "the quickstart launched no K2")
    reset_launch_counts()
    out, retrieval = run_example("retrieval_torch.py", [])
    retr = launch_counts()
    parity = re.search(r"parity: worst \|diff\| = ([0-9.e+-]+)", out)
    acc = re.search(r"similarity (\d+)/12, gradient-refined (\d+)/12", out)
    check(bool(parity) and float(parity.group(1)) <= 1e-5,
          "retrieval's parity line is off")
    check(bool(acc) and int(acc.group(2)) >= max(10, int(acc.group(1))),
          "retrieval degraded")
    check(retr["radic_batched_partial_cuda"] > 0
          and retr["radic_batched_grad_partial_cuda"] > 0,
          "retrieval launched no K1 or no K3")
    shown = {k: v for k, v in retr.items() if v}
    print(f"examples: quickstart K2 launches {quick['radic_partial_cuda']};"
          f" retrieval launches {json.dumps(shown)}", flush=True)
    reset_launch_counts()
    held = hold_retrieval_shapes(errs, gen, retrieval)
    print(f"examples: K1 and K3 held at the retrieval's window stacks "
          f"{held} (launches {json.dumps(launch_counts())}, not counted "
          f"above)", flush=True)
    return {"K2": quick["radic_partial_cuda"],
            "K1": retr["radic_batched_partial_cuda"],
            "K3": retr["radic_batched_grad_partial_cuda"]}


def profiler_probe(grad_A: torch.Tensor) -> None:
    """After the LM phases: six profiler windows of ten launches of K3's
    B = 1 entry at phase 9's matrix, and how many launches each recorded.
    Printed, not held (phase 9 times before the LM phases: timed after
    them once, it found no record of these launches in six windows)."""
    from repro_torch.core.engine import rank_table
    from repro_torch.kernels import ops
    m, n = grad_A.shape
    table = rank_table(n, m, backend="cuda", device="cuda")
    one = torch.ones((), device="cuda")

    def call():
        return ops.radic_det_grad_cuda(grad_A, one, table=table)

    call()
    torch.cuda.synchronize()
    name = kernel_name("K3", m)
    seen = [(sum(len(d) for k, d in w.items() if name in k),
             sum(len(d) for d in w.values()))
            for w in (profile_window(call, 10) for _ in range(6))]
    print(f"profiler after the LM phases: K3 B=1 ({m},{n}), 10 launches a "
          f"window; {name} records, of all device records, per window: "
          f"{seen}", flush=True)


def hold_retrieval_shapes(errs: Errors, gen: torch.Generator,
                          retrieval) -> list:
    """K1 and K3 (random cotangents) on the window stack of each video of
    the retrieval example's library, the (K, 4, 6) shapes its signatures
    and refinement launch them at, against float64 plain."""
    from repro_torch.core.engine import rank_table
    from repro_torch.core.pascal import comb
    from repro_torch.kernels import launch_counts, ops
    from repro_torch.kernels.radic_fused import (
        radic_batched_grad_partial_plain, radic_batched_partial_plain)

    rng = np.random.default_rng(0)       # the example's library, seed 0
    library = [rng.normal(size=(retrieval.M, rng.integers(18, 40)))
               .astype(np.float32) for _ in range(12)]
    shapes = []
    for feats in library:
        As = retrieval.window_stack(torch.from_numpy(feats).cuda())
        B, m, n = As.shape
        total = comb(n, m)
        table = rank_table(n, m, backend="cuda", device="cuda")
        cts = torch.randn(B, device="cuda", generator=gen)
        label = f"retrieval ({B},{m},{n}) C={total}"
        errs.hold("K1", label, ops.radic_det_batched_cuda(As),
                  radic_batched_partial_plain(As, table, 0, total,
                                              dtype=torch.float64))
        errs.hold("K3", label, ops.radic_det_batched_grad_cuda(As, cts),
                  radic_batched_grad_partial_plain(As, cts, table, 0, total,
                                                   dtype=torch.float64))
        shapes.append((B, m, n))
    counts = launch_counts()
    check(counts["radic_batched_partial_cuda"] >= len(library)
          and counts["radic_batched_grad_partial_cuda"] >= len(library),
          f"K1 or K3 did not launch at the retrieval's shapes: {counts}")
    return sorted(set(shapes))


def phase_times(gen: torch.Generator, serve: dict, k2_big,
                grad_A: torch.Tensor, mesh: dict) -> dict:
    from repro_torch.core import plan_grains, radic_det
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
        ms = device_ms(call, kernel=kernel_name(kernel, shape[1]))
        wall = cuda_ms(call)
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

    # one shard of phase 14's (2, 4) grid: K2 at the first eighth of
    # (10, 34)'s ranks, K1 and K3 at a batch piece of (64, 8, 31) over the
    # first quarter of its ranks
    cnt = plan_grains(total, 8)[1][0]
    record("K2 mesh", f"({m},{n}) ranks [0,{cnt}), one of 8 shards",
           (1, m, n), lambda: ops.radic_det_cuda(k2_big, 0, cnt, table=table),
           cuda_ms(lambda: radic_partial_plain(
               k2_big, table, 0, cnt, chunk=1 << 20), min_reps=1, min_s=0),
           bound_ms(1, m, n, cnt))
    As, cts, table = mesh["As"][:32], mesh["cts"][:32], mesh["table"]
    B, m, n = As.shape
    cnt = plan_grains(mesh["total"], 4)[1][0]
    label = f"({B},{m},{n}) ranks [0,{cnt}), one of 8 shards"
    record("K1 mesh", label, (B, m, n),
           lambda: ops.radic_det_batched_cuda(As, 0, cnt, table=table),
           cuda_ms(lambda: radic_batched_partial_plain(
               As, table, 0, cnt, chunk=1 << 16), min_reps=1, min_s=0),
           bound_ms(B, m, n, cnt))
    record("K3 mesh", label, (B, m, n),
           lambda: ops.radic_det_batched_grad_cuda(As, cts, 0, cnt,
                                                   table=table),
           cuda_ms(lambda: radic_batched_grad_partial_plain(
               As, cts, table, 0, cnt, chunk=1 << 13), min_reps=1, min_s=0),
           roofline(cnt * B * grad_flops(m),
                    4 * (2 * B * m * n + B + (n + 1) * (m + 1))))

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

    # the redesigned K5 and K6 at shapes whose bound is far above a
    # launch: every rank of C(32, 8) (the values cell's largest bucket)
    # and 2**20 matrices of 8 x 8 in float32 and float64
    n, m = 32, 8
    B = comb(n, m)
    table = rank_table(n, m, backend="cuda", device="cuda")
    qs = torch.arange(B, dtype=torch.int32, device="cuda")
    steps = int(ops.unrank(qs, n, m)[:, -1].sum())
    record("K5 C(32,8)", f"all {B} ranks of ({n},{m})", (B, m, n),
           lambda: unrank_cuda(qs, n, m, table),
           cuda_ms(lambda: unrank_plain(qs, n, m, table), min_reps=1,
                   min_s=0),
           roofline(2 * steps, 4 * (B + B * m + (n + 1) * (m + 1)),
                    PEAK_INT32_OPS))
    del qs
    B, m = 1 << 20, 8
    M = torch.randn(B, m, m, device="cuda", generator=gen)
    for dt, size in ((torch.float32, 4), (torch.float64, 8)):
        X = M.to(dt)
        record(f"K6 2^20 {str(dt)[6:]}", f"({B},{m},{m}) {str(dt)[6:]}",
               (B, m, m), lambda: ops.minor_det(X),
               cuda_ms(lambda: minor_det_plain(X), min_reps=1, min_s=0),
               roofline(B * det_flops(m), size * (B * m * m + B),
                        PEAK_F32_FLOPS if size == 4 else PEAK_F64_FLOPS),
               library=lambda: torch.linalg.det(X))
    del M, X

    # the warp kernels (m >= 17) at shapes whose bound is well above a
    # launch
    B, m, n = 3, 20, 30
    total = comb(n, m)
    As = torch.randn(B, m, n, device="cuda", generator=gen)
    table = rank_table(n, m, backend="cuda", device="cuda")
    label = f"({B},{m},{n}) C={total}"
    plain_ms = cuda_ms(lambda: radic_batched_partial_plain(
        As, table, 0, total, chunk=1 << 16), min_reps=1, min_s=0)
    record("K1 wide", label, (B, m, n),
           lambda: ops.radic_det_batched_cuda(As, table=table),
           plain_ms, bound_ms(B, m, n, total))
    record("K4 wide", label, (B, m, n),   # K4's plain version is K1's
           lambda: ops.radic_det_batched_cuda_bygrid(As, table=table),
           plain_ms, bound_ms(B, m, n, total))
    A = As[0].clone()
    record("K2 wide", f"({m},{n}) C={total} through radic_det", (1, m, n),
           lambda: radic_det(A, backend="cuda"),
           cuda_ms(lambda: radic_partial_plain(A, table, 0, total,
                                               chunk=1 << 18),
                   min_reps=1, min_s=0),
           bound_ms(1, m, n, total))
    B, m, n = 3, 20, 26
    total = comb(n, m)
    As = torch.randn(B, m, n, device="cuda", generator=gen)
    cts = torch.randn(B, device="cuda", generator=gen)
    table = rank_table(n, m, backend="cuda", device="cuda")
    record("K3 wide", f"({B},{m},{n}) C={total}", (B, m, n),
           lambda: ops.radic_det_batched_grad_cuda(As, cts, table=table),
           cuda_ms(lambda: radic_batched_grad_partial_plain(
               As, cts, table, 0, total, chunk=1 << 14), min_reps=1,
               min_s=0),
           roofline(total * B * grad_flops(m),
                    4 * (2 * B * m * n + B + (n + 1) * (m + 1))))
    B = 65536
    for m, key in ((32, "K6 wide"), (17, "K6 wide m=17"),
                   (24, "K6 wide m=24")):
        M = torch.randn(B, m, m, device="cuda", generator=gen) / m ** 0.5
        record(key, f"({B},{m},{m}) float32", (B, m, m),
               lambda: ops.minor_det(M),
               cuda_ms(lambda: minor_det_plain(M), min_reps=1, min_s=0),
               roofline(B * det_flops(m), 4 * (B * m * m + B)),
               library=lambda: torch.linalg.det(M))
    # K6 above m = 32: at m = 33 (71 MB), at m = 64 (a matrix in shared
    # memory) and on the global copy at m = 250 in float64
    for B, m, dt in ((16384, 33, torch.float32), (4096, 64, torch.float32),
                     (256, 250, torch.float64)):
        M = (torch.randn(B, m, m, device="cuda", generator=gen)
             / m ** 0.5).to(dt)
        size = M.element_size()
        record(f"K6 m={m}", f"({B},{m},{m}) {str(dt)[6:]}", (B, m, m),
               lambda: ops.minor_det(M),
               cuda_ms(lambda: minor_det_plain(M), min_reps=1, min_s=0),
               roofline(B * det_flops(m), size * (B * m * m + B),
                        PEAK_F32_FLOPS if size == 4 else PEAK_F64_FLOPS),
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
    wide = phase_wide(errs, gen)
    phase_empty_minor()
    done("10 wide kernels")
    wide_serve = phase_wide_serve()
    serve_trace(base=WIDE_SERVE_ARGS)
    serve_trace(("--grad-frac", "0.25"), base=WIDE_SERVE_ARGS)
    done("11 wide serving")
    phase_front()
    done("12 the front")
    phase_warm_start(gen)
    done("13 warm start")
    mesh = phase_mesh(errs, gen, serve)
    done("14 the mesh")
    times = phase_times(gen, serve, k2["big"], autograd["A"], mesh)
    done("9 times")
    phase_lm_serve()
    done("15 LM serving")
    phase_examples(errs, gen)
    done("16 the examples")
    profiler_probe(autograd["A"])
    phase_lm_families()
    done("17 LM families")
    free_card()
    phase_train(errs, gen)
    done("18 training")
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
             k456["K6"], "K6"),
            ("unrank_cuda", "K5", "unrank.cu", "unrank_kernel.py:23",
             k456["K5"], "K5 C(32,8)"),
            ("minor_det_cuda", "K6", "minor_det.cu", "minor_det.py:23",
             k456["K6"], "K6 2^20 float32"),
            ("minor_det_cuda", "K6", "minor_det.cu", "minor_det.py:23",
             k456["K6"], "K6 2^20 float64"),
            ("radic_batched_partial_cuda", "K1 wide", "radic_warp.cu",
             "radic_fused.py:156", wide_serve["K1 wide"], "K1 wide"),
            ("radic_partial_cuda", "K2 wide", "radic_warp.cu",
             "radic_fused.py:39", wide["K2 wide"], "K2 wide"),
            ("radic_batched_grad_partial_cuda", "K3 wide",
             "radic_warp_grad.cuh", "radic_fused.py:201",
             wide_serve["K3 wide"], "K3 wide"),
            ("radic_batched_partial_bygrid_cuda", "K4 wide", "radic_warp.cu",
             "radic_fused.py:92", wide["K4 wide"], "K4 wide"),
            *(("minor_det_cuda", "K6 wide", "minor_det_warp.cuh",
               "minor_det.py:23", wide[f"K6 m={m}"], timed)
              for m, timed in ((32, "K6 wide"), (17, "K6 wide m=17"),
                               (24, "K6 wide m=24"))),
            *(("minor_det_cuda", "K6 above 32", source, "minor_det.py:23",
               wide[f"K6 m={m}"], f"K6 m={m}")
              for m, source in K6_ABOVE_32_SOURCES),
            ("radic_partial_cuda", "K2 mesh", "radic_fused.cu",
             "radic_fused.py:39", mesh["K2"], "K2 mesh"),
            ("radic_batched_partial_cuda", "K1 mesh", "radic_fused.cu",
             "radic_fused.py:156", mesh["K1"], "K1 mesh"),
            ("radic_batched_grad_partial_cuda", "K3 mesh", "radic_grad.cu",
             "radic_fused.py:201", mesh["K3"], "K3 mesh")]:
        t = times[timed]
        check(launches > 0, f"{name} was not launched on its path")
        rows.append({"name": name, "route": "cuda", "source": csrc + source,
                     "replaces": ref + replaces, "launches": launches,
                     "max_abs_err": errs.abs[kernel], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "timed": timed, "timed_shape": t["shape"]})
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
