"""Same-process A/B timing of kernel design choices on the card.

Each experiment names variants of the kernel sources in ``csrc/``, each a
set of text edits (a choice switched off or changed) or of launch
parameters of ``radic_fused`` (``PY``), and the shapes at which K1
(``radic_batched_partial``; at m ≥ 17 the prefix walk or the warp
kernel, as the dispatch routes (m, n)), K4 (``radic_bygrid_partial``), K3
(``radic_batched_grad_partial``), K5 (``radic_unrank``) or K6
(``radic_minor_det``, float32; ``K6d``: float64) is timed.
``--baseline DIR`` adds one more variant, ``base``: the sources of
another checkout's ``csrc`` directory as they are (the parent commit's,
to time a redesigned kernel against its old self in one call), launched
with the grids of the ``radic_fused.py`` beside it where there is one,
and each ``diag_`` variant built on them too (``base+<variant>``).  The
checkout's sources (``cur``) and every variant are compiled in parallel
into ``build/kernel_ab/``, loaded side by side, and timed on the same
inputs in alternating order (cur, variants, reversed, ...), each time a
CUDA-event window over back-to-back calls: the calls run for
milliseconds, so the window holds device time (K5 and K6, whose small
shapes run for microseconds, are also timed by the profiler).  Every
variant's result must equal ``cur``'s bit for bit (no choice here moves
arithmetic), but for ``diag_`` variants, which take a phase out,
variants of launch parameters alone or of a run length or dispatch
threshold with the source constant it mirrors (``_REORDERING``), which
change a reduction's order or the kernel, whose difference is printed;
``base`` too must equal ``cur``; ptxas's registers and spills are
printed for the kernels timed.

    python -m repro_torch.kernels.kernel_ab [--baseline DIR] [EXPERIMENT ...]

(``PYTHONPATH=src``, from the root of a checkout, on a machine with a
card and ``nvcc``).  The last line of its output is one JSON object with
every time.  Without a card it exits with an error.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.pascal import binom_table, comb
from repro_torch.kernels import _build
from repro_torch.kernels import radic_fused as rf

OUT = _build.BUILD_DIR.parent / "kernel_ab"
FUSED = "radic_fused.cu"

# K5's walk and store (csrc/unrank.cu), and the diagnostics that take
# each out
K5_WALK = """    int pos = 0;
    for (int v = 1; v <= n && pos < m; ++v) {
      const int cnt = Staged ? tab[(n - v) * (m + 1) + (m - 1 - pos)]
                             : __ldg(&tab[(n - v) * (m + 1) + (m - 1 - pos)]);
      if (q < cnt) {
        row[pos] = v;
        ++pos;
      } else {
        q -= cnt;
      }
    }"""
K5_NO_WALK = """    int pos = 0;
    for (; pos < m; ++pos) row[pos] = q + pos;"""
K5_STORE = "      dst[e] = buf[t * stride + p];"
K5_NO_STORE = "      if (buf[t * stride + p] == -7) dst[e] = 0;"
# K6's staging budget (csrc/minor_det.cu), and the K6 shapes timed: large
# stacks at m = 8, 12 and 16 in float32 (K6) and float64 (K6d), and the
# launch-bound (2048, 8, 8)
K6_BUDGET = "constexpr int kDetStageBytes = 232448;"
K6_SHAPES = [("K6", 1 << 20, 8, 8), ("K6d", 1 << 20, 8, 8),
             ("K6", 1 << 19, 12, 12), ("K6d", 1 << 19, 12, 12),
             ("K6", 1 << 18, 16, 16), ("K6d", 1 << 18, 16, 16),
             ("K6", 2048, 8, 8)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
# The warp kernels' phases (csrc/warp.cuh, csrc/radic_warp_grad.cuh) and
# the edits that take each out, as {old: new} for the sources of the
# earlier K3 (X and Z through shared memory) and of this one, so that the
# same diagnostics run on a baseline checkout's kernels; exactly one
# `old` must be in the file, once.
WARP_GRAD = "radic_warp_grad.cuh"
PY = "py"  # an edit of a launch parameter of radic_fused.py, not a source
_SEARCH_INLINE = """    // this lane's best eligible row (bits, key); a lane with none keeps
    // (0, 1 << 30), which the row at place k always beats
    decltype(abs_bits(T())) best = 0;
    int key = 1 << 30;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (warp_row(lane, s) < M && place[s] >= k) {
        const auto cap = place[s] == k ? ~decltype(best)(0) : inf_bits<T>();
        const auto u = abs_bits(a[s][k]);
        const int kk = place[s] * 64 + warp_row(lane, s);
        if (s == 0) {
          best = u < cap ? u : cap;
          key = kk;
        } else {
          pivot_max(best, key, u < cap ? u : cap, kk);
        }
      }
    }
    if constexpr (sizeof(T) == 4) {
      // two warp reductions: the largest bits, then the smallest key
      // among their holders
      const unsigned top = __reduce_max_sync(kFullMask, best);
      key = static_cast<int>(__reduce_min_sync(
          kFullMask, best == top ? static_cast<unsigned>(key) : ~0u));
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const auto ob = __shfl_xor_sync(kFullMask, best, off);
        const int ok = __shfl_xor_sync(kFullMask, key, off);
        pivot_max(best, key, ob, ok);
      }
    }
"""
# the search as a function of its own (warp_pivot_search), rows past m
# left out, and float64's three reductions in place of a butterfly
_SEARCH_FN = _SEARCH_INLINE.replace("\n    ", "\n  ").replace(
    "  if (warp_row(lane, s) < M && place[s] >= k) {",
    "  if (warp_row(lane, s) < m && place[s] >= k) {")[2:]
_SEARCH_FN_64 = """    // the 64 bits in two halves: the largest high word, the largest low
    // word among its holders, then the smallest key among theirs (three
    // reductions, the same winner as a butterfly of pivot_max)
    const unsigned hi = static_cast<unsigned>(best >> 32);
    const unsigned lo = static_cast<unsigned>(best);
    const unsigned top_hi = __reduce_max_sync(kFullMask, hi);
    const unsigned top_lo =
        __reduce_max_sync(kFullMask, hi == top_hi ? lo : 0u);
    key = static_cast<int>(__reduce_min_sync(
        kFullMask, hi == top_hi && lo == top_lo ? static_cast<unsigned>(key)
                                                : ~0u));
"""
_SEARCH_FN = _SEARCH_FN[:_SEARCH_FN.index("#pragma unroll\n    for (int off")] \
    + _SEARCH_FN_64 + "  }\n"
WARP_SEARCH = {
    _SEARCH_INLINE: "    int key = k * 64 + k;  // diag: no search\n",
    _SEARCH_FN: "  int key = k * 64 + k;  // diag: no search\n"}
# float64's search by the butterfly of shuffles it took before
K6_SEARCH_64 = {_SEARCH_FN_64: """#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const auto ob = __shfl_xor_sync(kFullMask, best, off);
      const int ok = __shfl_xor_sync(kFullMask, key, off);
      pivot_max(best, key, ob, ok);
    }
"""}
# the row's columns past the pivot from the lane's own row (the pivot
# itself still broadcast, so that every lane takes the same branches)
WARP_BCAST = {"      const T top = col(j);\n":
              "      const T top = a[0][j];  // diag: no broadcast\n"}
K3_X = {
    "  for (int c0 = 0; c0 < M; c0 += 32) {":
    "  for (int c0 = M; c0 < M; c0 += 32) {",
    "  float x[R][M];\n#pragma unroll\n  for (int r = M - 1; r >= 0; --r) {":
    "  float x[R][M];\n  for (int r = 0; r < M; ++r)\n"
    "    for (int s = 0; s < R; ++s) x[s][r] = dg[s];  // diag: no X\n"
    "  for (int r = M - 1; r >= M; --r) {"}
K3_Z = {"      for (int i = M - 2; i >= 0; --i) {":
        "      for (int i = -1; i >= 0; --i) {",
        "  for (int i = M - 2; i >= 0; --i) {\n    float lc[BR];":
        "  for (int i = M - 2; i >= M; --i) {\n    float lc[BR];"}
K3_SCATTER = {
    "      for (int e = tid; e < mn; e += kGradWarpThreads) {\n"
    "        const int c = e / M;":
    "      for (int e = mn; e < mn; e += kGradWarpThreads) {\n"
    "        const int c = e / M;"}
K3_BAR_NEXT = {
    "      if (bb > 0) __syncthreads();  // the owners are done with cof_s\n":
    "\n"}
# K6 wide's global load (csrc/minor_det_warp.cu): each lane's row made
# from the matrix's index and the lane instead (small integers, live
# through the elimination, so nothing folds), which leaves the
# elimination and the store of the result
K6_LOAD = {
    "  for (int j = 0; j < M; ++j) a[0][j] = lane < M ? src[lane * M + j] "
    ": T(0);":
    "  for (int j = 0; j < M; ++j)\n"
    "    a[0][j] = lane < M ? T(static_cast<int>((b * 7 + lane * 13 + j * 5)"
    " & 15) - 7) : T(0);  // diag: no load",
    None: None}
K6_STAGE = {
    "        if (c < m) copy_async_elem(buf + r * (M | 1) + c, src + r * m + "
    "c);":
    "        if (c < m)\n"
    "          buf[r * (M | 1) + c] = T(static_cast<int>((reinterpret_cast<"
    "size_t>(src) / sizeof(T) + r * 7 + c * 13) & 15) - 7);  // diag: no "
    "load",
    None: None}
K6_ROWS_LOAD = {
    "      a[s][j] = r < m && j < m ? src[r * stride + j] : T(0);":
    "      a[s][j] = r < m && j < m ? T(static_cast<int>((reinterpret_cast<"
    "size_t>(src) / sizeof(T) + r * 13 + j * 5) & 15) - 7) : T(0);  // diag: "
    "no load", None: None}
# the block kernel's panel (csrc/minor_det.cu det_panel) of 8 or of 16
# steps at every m, and its blocks an SM
_K6_PANEL = "constexpr int det_panel(int m) { return m < 128 ? 8 : 16; }"
K6_PANEL8 = {_K6_PANEL: "constexpr int det_panel(int m) { return 8; }"}
K6_PANEL16 = {_K6_PANEL: "constexpr int det_panel(int m) { return 16; }"}


def _k6_min_blocks(n: int) -> dict:
    return {"__global__ void __launch_bounds__(kDetBlockThreads)\n"
            "    minor_det_block_kernel(":
            f"__global__ void __launch_bounds__(kDetBlockThreads, {n})\n"
            "    minor_det_block_kernel("}


# K6 wide's staging (csrc/minor_det_warp.cuh det_staged) at no m, and at
# every m
K6_ALL_DIRECT = {"constexpr bool det_staged() {\n":
                 "constexpr bool det_staged() {\n  if (true) return false;\n"}
K6_ALL_STAGED = {"constexpr bool det_staged() {\n":
                 "constexpr bool det_staged() {\n  if (true) return true;\n"}
K3_BAR_DONE = {
    f"{tail}      __syncthreads();\n": tail for tail in (
        "                            x_s + warp * M * S, perm_s + warp * M, "
        "lane);\n",
        "                            lt_s + warp * M * BR, perm_s + warp * BR, "
        "lane);\n")}

# The prefix walk (csrc/radic_prefix.cuh, radic_prefix.cu): its dispatch
# threshold, run length, registered and snapshotted levels, each a
# constant of the source and its twin in radic_fused.py, and its register
# cap; and the edits
# that take out its pivot search (the pivot at index 0), its pivot
# column's shuffles and its multipliers (each lane uses its own column)
# and its restarts (every level built from the staged columns, no step)
PREFIX_CU = "radic_prefix.cu"
PREFIX_CUH = "radic_prefix.cuh"


def _prefix_const(fn: str, c: str, py: str, old, new) -> list:
    """A variant setting ``constexpr ... c = old`` in ``fn`` and its twin
    ``py`` in radic_fused.py to ``new``."""
    kind = "long long" if c == "kPrefixRunsWanted" else "int"
    return [(fn, f"constexpr {kind} {c} = {old};",
             f"constexpr {kind} {c} = {new};"), (PY, py, new)]


_WARP_ONLY = _prefix_const(PREFIX_CU, "kPrefixMinGap", "PREFIX_MIN_GAP", 6,
                           99)
_PREFIX_ALL = _prefix_const(PREFIX_CU, "kPrefixMinGap", "PREFIX_MIN_GAP", 6,
                            0)


_PREFIX_MIN_BLOCKS = "constexpr int kPrefixMinBlocks = 2;"
# the step (prefix_step: every level's here, only the deep levels' in a
# baseline that still has the pivot lane's record): its search, its pivot
# column's shuffles (in prefix_column here, in a baseline's step) and its
# quotients
PREFIX_STEP_NO_SEARCH = {"    const bool later = kr > key;":
                         "    const bool later = false;  // diag: no search"}
PREFIX_STEP_NO_BCAST = [
    {"  for (int r = 0; r < N; ++r) u[r] = __shfl_sync(kFullMask, v[r], src);":
     "  for (int r = 0; r < N; ++r) u[r] = v[r];  // diag: no broadcast",
     "  for (int r = 0; r < L; ++r) u[r] = __shfl_sync(kFullMask, v[r], src);":
     "  for (int r = 0; r < L; ++r) u[r] = v[r];  // diag: no broadcast"},
    {"    const float f = quotient(above ? u[r] : u[r + 1], safe, inv);":
     "    const float f = above ? u[r] : u[r + 1];  // diag: no multipliers"}]
PREFIX_NO_RESTART = {"        for (int k = from; k < K0; ++k) {":
                     "        for (int k = K0; k < K0; ++k) {  // diag: no "
                     "restart"}
# the shapes: the warp kernels' m sweep (wide_m), the kernel table's
# (3, 20, 30) for K1 and K4 and K1 at B = 1 (K2's launch); and for the
# dispatch, chip_smoke.py's WIDE_SHAPES and n - m = 0 .. 6 at m = 17, 20
# and 24 on stacks of at least a few hundred thousand minors (the walk has
# no instance above m = 27)
PREFIX_SHAPES = [
    *(("K1", B, m, n) for B, m, n in [
        (3, 17, 26), (3, 20, 28), (3, 22, 30), (16, 24, 30), (16, 26, 32),
        (16, 28, 33), (64, 30, 33)]),
    ("K1", 3, 20, 30), ("K4", 3, 20, 30), ("K1", 1, 20, 30)]
PREFIX_EDGE_SHAPES = [
    *(("K1", B, m, n) for B, m, n in [
        (3, 17, 20), (2, 20, 22), (3, 24, 26), (1, 33, 33), (2, 32, 33)]),
    *(("K1", max(64, min(4096, 400_000 // comb(m + g, m))), m, m + g)
      for m in range(17, rf.PREFIX_MAX_M + 1) for g in range(7)
      if m + g <= 33 and (g >= 2 or m in (17, 20, 24))),
    # the gap that won at B = 64 and one each side, at B = 2, where a
    # short range is latency-bound
    *(("K1", 2, m, m + g) for m in range(17, rf.PREFIX_MAX_M + 1)
      for g in range(2, 7) if m + g <= 33
      and abs(g - (3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5)[m - 17]) <= 1)]
# each m's widest n whose C(n, m) falls short of 2**18 ranks and its
# narrowest n past them, at B = 2 and 64 (a rule by the rank count, which
# these ruled out: n - m separates the winners better)
PREFIX_RANK_SHAPES = [
    ("K1", B, m, n) for B in (2, 64)
    for m in range(17, rf.PREFIX_MAX_M + 1) for n in range(m, 34)
    if comb(n, m) < 1 << 18 <= comb(n + 1, m) or
    comb(n - 1, m) < 1 << 18 <= comb(n, m)]

# name -> (variants {name: [(file, old, new), ...]}, shapes [(kernel, B, m, n)])
EXPERIMENTS = {
    # K1's batch slice of A and Pascal table staged in shared memory
    # (cp.async) against the gather through L1 that wide n takes
    "k1_stage": ({
        "global": [(FUSED, "if (!staged(M, n)) {", "if (true) {")],
    }, [("K1", 3, 8, 31), ("K1", 1, 10, 34), ("K1", 3, 6, 30)]),
    # K1's register cap: two blocks per SM at m = 9..11, at no m, and at
    # every m >= 9
    "k1_min_blocks": ({
        "one": [(FUSED, "return (M >= 9 && M <= 11) ? 2 : 1;", "return 1;")],
        "two_from_9": [(FUSED, "return (M >= 9 && M <= 11) ? 2 : 1;",
                        "return M >= 9 ? 2 : 1;")],
    }, [("K1", 1, 9, 34), ("K1", 1, 10, 34), ("K1", 1, 11, 30),
        ("K1", 3, 9, 30), ("K1", 3, 10, 28), ("K1", 3, 11, 26),
        ("K1", 1, 12, 30), ("K1", 1, 16, 26)]),
    # diagnostics, not designs (their output differs by construction): K5
    # without its walk, and without its stores, to see which phase holds
    # it back
    "k5_diag": ({
        "diag_no_walk": [("unrank.cu", K5_WALK, K5_NO_WALK)],
        "diag_no_store": [("unrank.cu", K5_STORE, K5_NO_STORE)],
    }, [("K5", 10_518_300, 8, 32)]),
    # the register kernels at the shapes chip_smoke.py times: K1, K4 and
    # K3 at (3, 8, 31), K1 at B = 1 (K2's kernel) at (1, 10, 34); no
    # variants of their own (with --baseline, against the baseline's)
    "k1_k3": ({}, [("K1", 3, 8, 31), ("K4", 3, 8, 31), ("K3", 3, 8, 31),
                   ("K1", 1, 10, 34)]),
    # K5 on every rank of C(32, 8) and on 4,096 ranks of (24, 12) (B, m,
    # n), K6 on 2**20 and on 2,048 matrices of 8 x 8 and at m = 12 and 16
    # (B, m, m): no variants of their own; with --baseline, against the
    # baseline's kernels (also timed by the profiler, for the small shapes'
    # sake)
    "k5_k6": ({}, [("K5", 10_518_300, 8, 32), *K6_SHAPES,
                   ("K5", 4096, 12, 24)]),
    # the warp kernels (m >= 17) at the shapes chip_smoke.py times: K1 and
    # K4 at (3, 20, 30), K3 at (3, 20, 26), K6 at (65536, 32, 32) in
    # float32 and float64; no variants of their own (with --baseline,
    # against the baseline's)
    "wide": ({}, [("K1", 3, 20, 30), ("K4", 3, 20, 30), ("K3", 3, 20, 26),
                  ("K6", 65536, 32, 32), ("K6d", 65536, 32, 32)]),
    # diagnostics of K6 wide (m = 17..32), each taking one phase out (with
    # --baseline, of the baseline's kernel too): its global load, its
    # pivot-row shuffles (the parent's in warp.cuh's warp_lu, this tree's
    # in minor_det_warp.cuh) and its pivot search (warp.cuh, shared with
    # K1 wide)
    "k6_wide_diag": ({
        "diag_no_load": [("minor_det_warp.cu", K6_LOAD),
                         ("minor_det_warp.cuh", K6_STAGE),
                         ("minor_det_warp.cuh", K6_ROWS_LOAD)],
        "diag_no_bcast": [("warp.cuh", WARP_BCAST),
                          ("minor_det_warp.cuh", {**WARP_BCAST, None: None})],
        "diag_no_search": [("warp.cuh", WARP_SEARCH)],
    }, [("K6", 65536, 32, 32), ("K6d", 65536, 32, 32),
        ("K6", 65536, 17, 17)]),
    # K6 wide in float32 (K6) and float64 (K6d) at m = 17, 20, 24, 28 and
    # 32, 65,536 matrices a call (76 MB and more); no variants of their
    # own (with --baseline, against the baseline's)
    "k6_wide_m": ({}, [(kernel, 65536, m, m) for m in (17, 20, 24, 28, 32)
                       for kernel in ("K6", "K6d")]),
    # K6 wide's staging at no m and at every m (the choice by m and type,
    # det_staged, against each), and float64's search by a butterfly of
    # shuffles; at every m of one row a lane and at the two-rows-a-lane
    # register widths
    "k6_wide_moves": ({
        "all_direct": [("minor_det_warp.cuh", K6_ALL_DIRECT)],
        "all_staged": [("minor_det_warp.cuh", K6_ALL_STAGED)],
        "search64_shfl": [("warp.cuh", K6_SEARCH_64)],
    }, [*((kernel, 65536, m, m) for m in range(17, 33)
          for kernel in ("K6", "K6d")),
        ("K6", 16384, 33, 33), ("K6d", 16384, 33, 33),
        *(("K6", 4096, m, m) for m in (40, 48, 56, 64)),
        *(("K6d", 4096, m, m) for m in (40, 48))]),
    # the block kernel (m > 64): its panel width by m against 8 and 16 at
    # every m, and three or four blocks an SM forced (registers capped)
    "k6_panel": ({
        "panel8": [("minor_det.cu", K6_PANEL8)],
        "panel16": [("minor_det.cu", K6_PANEL16)],
        "min_blocks_3": [("minor_det.cu", _k6_min_blocks(3))],
        "min_blocks_4": [("minor_det.cu", _k6_min_blocks(4))],
    }, [("K6d", 1024, 80, 80), ("K6d", 1024, 128, 128), ("K6", 1024, 96, 96),
        ("K6d", 256, 250, 250), ("K6", 256, 250, 250)]),
    # K6 above m = 32: (16384, 33, 33) and (4096, 64, 64) in float32,
    # (256, 250, 250) in float64 on the block kernel's global copy, m =
    # 33, 37, 45, 50, 56 and 64 (each register width of
    # minor_det_warp_hi.cu and _top.cu), and the block kernel just past
    # them (m = 80 and 96, in shared memory) and at m = 250 in float32; no
    # variants of their own (with --baseline, against the baseline's)
    "k6_block": ({}, [
        ("K6", 16384, 33, 33), ("K6", 4096, 64, 64), ("K6d", 256, 250, 250),
        ("K6d", 16384, 33, 33), ("K6", 4096, 37, 37), ("K6d", 4096, 45, 45),
        ("K6", 4096, 50, 50), ("K6d", 4096, 56, 56), ("K6d", 4096, 64, 64),
        ("K6d", 1024, 80, 80), ("K6", 1024, 96, 96), ("K6", 256, 250, 250)]),
    # diagnostics of the two warp kernels, each taking one phase out (with
    # --baseline, of the baseline's kernels too): warp_lu's pivot-row
    # broadcast (each lane uses its own row), its pivot search (the pivot
    # at place k), both; K3's X = det(U) U^-1, its Z = X L^-1, its owner
    # scatter, its two barriers per matrix, and its grid cap (four times
    # the partials budget: more blocks)
    "wide_diag": ({
        "diag_no_bcast": [("warp.cuh", WARP_BCAST)],
        "diag_no_search": [("warp.cuh", WARP_SEARCH)],
        "diag_neither": [("warp.cuh", WARP_BCAST), ("warp.cuh", WARP_SEARCH)],
        "diag_no_x": [(WARP_GRAD, K3_X)],
        "diag_no_z": [(WARP_GRAD, K3_Z)],
        "diag_no_scatter": [(WARP_GRAD, K3_SCATTER)],
        "diag_no_bar": [(WARP_GRAD, K3_BAR_NEXT), (WARP_GRAD, K3_BAR_DONE)],
        "diag_grid4x": [(PY, "GRAD_PARTIAL_FLOATS", 1 << 19),
                        (PY, "WARP_GRAD_PARTIAL_FLOATS", 1 << 22)],
    }, [("K1", 3, 20, 30), ("K3", 3, 20, 26)]),
    # the design moves of the warp kernels, each switched back off: K3
    # wide's partials budget at m > 16 (4 MB a matrix) against the 512 KB
    # of the register kernel and 2 MB (another grid: another reduction
    # order)
    "wide_moves": ({
        "k3_grid_1x": [(PY, "WARP_GRAD_PARTIAL_FLOATS", 1 << 17)],
        "k3_grid_4x": [(PY, "WARP_GRAD_PARTIAL_FLOATS", 1 << 19)],
    }, [("K3", 3, 20, 26), ("K3", 16, 28, 33), ("K3", 64, 26, 30),
        ("K3", 64, 30, 33)]),
    # K1 and K3 wide at m = 17..30 (B, m, n: 3e5 to 2e7 (rank, matrix)
    # pairs a call); no variants of their own (with --baseline, against
    # the baseline's)
    "wide_m": ({}, [
        (kernel, B, m, n) for B, m, n in [
            (3, 17, 26), (3, 20, 28), (3, 22, 30), (16, 24, 30), (16, 26, 32),
            (16, 28, 33), (64, 30, 33)] for kernel in ("K1", "K3")]),
    # the prefix walk (K1, K2 and K4 at m >= 17 where n - m >= 6) against
    # the warp kernel in this tree (warp_only), its run length, register
    # cap, snapshotted and registered levels, and diagnostics taking out
    # its pivot search, its multipliers and their broadcast, and its
    # restarts (with --baseline, against the parent's kernels too)
    "prefix": ({
        "warp_only": _WARP_ONLY,
        "run128": _prefix_const(PREFIX_CU, "kPrefixRunMax", "PREFIX_RUN_MAX",
                                512, 128),
        "run2048": _prefix_const(PREFIX_CU, "kPrefixRunMax",
                                 "PREFIX_RUN_MAX", 512, 2048),
        "runs8192": _prefix_const(PREFIX_CU, "kPrefixRunsWanted",
                                  "PREFIX_RUNS_WANTED", 2048, 8192),
        "min_blocks1": [(PREFIX_CUH, _PREFIX_MIN_BLOCKS,
                         "constexpr int kPrefixMinBlocks = 1;")],
        "min_blocks3": [(PREFIX_CUH, _PREFIX_MIN_BLOCKS,
                         "constexpr int kPrefixMinBlocks = 3;")],
        "snap0": _prefix_const(PREFIX_CUH, "kPrefixSnap", "PREFIX_SNAP", 6,
                               0),
        "snap4": _prefix_const(PREFIX_CUH, "kPrefixSnap", "PREFIX_SNAP", 6,
                               4),
        "deep8": _prefix_const(PREFIX_CUH, "kPrefixDeep", "PREFIX_DEEP", 10,
                               8),
        "deep12": _prefix_const(PREFIX_CUH, "kPrefixDeep", "PREFIX_DEEP", 10,
                                12),
        "diag_no_search": [(PREFIX_CUH, PREFIX_STEP_NO_SEARCH)],
        "diag_no_bcast": [(PREFIX_CUH, e) for e in PREFIX_STEP_NO_BCAST],
        "diag_no_restart": [(PREFIX_CUH, PREFIX_NO_RESTART)],
    }, PREFIX_SHAPES),
    # the prefix walk's dispatch: every shape on the warp kernel
    # (warp_only) and on the prefix walk (prefix_all; with runs of 8 ranks
    # at least, in place of 32, prefix_all_run8)
    "prefix_edge": ({"warp_only": _WARP_ONLY, "prefix_all": _PREFIX_ALL,
                     "prefix_all_run8": _PREFIX_ALL + _prefix_const(
                         PREFIX_CU, "kPrefixRunMin", "PREFIX_RUN_MIN", 32,
                         8)},
                    PREFIX_EDGE_SHAPES),
    # the shapes on each side of 2**18 ranks on the warp kernel and on the
    # prefix walk
    "prefix_ranks": ({"warp_only": _WARP_ONLY, "prefix_all": _PREFIX_ALL},
                     PREFIX_RANK_SHAPES),
    # K6's staged tile at m <= 16 (the wrapper's 128 matrices at a stride
    # of m^2 + 1, in up to 227 KB of shared memory) against a 100 KB and a
    # 48 KB budget and against no staging (each thread reading its matrix
    # from global memory with stride m^2, the kernel's design before it
    # staged): a tile over the budget is read unstaged
    "k6_stage": ({
        "stage100k": [("minor_det.cu", K6_BUDGET,
                       "constexpr int kDetStageBytes = 102400;")],
        "stage48k": [("minor_det.cu", K6_BUDGET,
                      "constexpr int kDetStageBytes = 49152;")],
        "unstaged": [("minor_det.cu", K6_BUDGET,
                      "constexpr int kDetStageBytes = 0;")],
    }, K6_SHAPES),
}


def _includes(src: Path) -> set[str]:
    return set(re.findall(r'#include "([^"]+)"', src.read_text()))


def _source_edits(edits: list) -> list[tuple[str, dict]]:
    """A variant's edits of sources as (file, {old: new}): ``(file, old,
    new)`` or ``(file, {old: new, ...})``, alternatives of which exactly
    one must be in the file; edits of launch parameters (``PY``) left
    out."""
    return [(e[0], e[1] if len(e) == 2 else {e[1]: e[2]})
            for e in edits if e[0] != PY]


def _apply(d: Path, name: str, edits: list) -> set[str]:
    """Make a variant's edits of the sources copied to ``d``; returns the
    files touched.  An edit whose alternatives hold the key None may find
    none of them (nor the file), but every variant with edits of sources
    must make at least one."""
    touched = set()
    for fn, alts in _source_edits(edits):
        optional = None in alts
        text = (d / fn).read_text() if (d / fn).exists() else ""
        hits = [old for old in alts
                if old is not None and text.count(old) == 1]
        if len(hits) != 1 and not (optional and not hits):
            raise SystemExit(f"{name}: no single one of {list(alts)!r} "
                             f"is in {fn} once; the experiment no "
                             "longer fits the sources")
        if hits:
            (d / fn).write_text(text.replace(hits[0], alts[hits[0]]))
            touched.add(fn)
    if _source_edits(edits) and not touched:
        raise SystemExit(f"{name}: none of its edits fits the sources")
    return touched


def _build_all(variants: dict[str, list],
               baseline: Path | None = None) -> tuple[dict, dict]:
    """Compile ``cur`` and each variant (only the sources its edits reach;
    the rest reuse ``cur``'s objects), and ``base``, every source of
    ``baseline``, where given, with each ``diag_`` variant of it
    (``base+<variant>``); link and bind each library; returns the
    libraries and ptxas's registers and spills of each, by name."""
    nvcc = _build._nvcc()
    shutil.rmtree(OUT, ignore_errors=True)
    every = {"cur": [], **variants}
    if baseline is not None:
        every["base"] = []
        every.update({f"base+{v}": e for v, e in variants.items()
                      if _is_diag(v) and _fits(baseline, e)})
    jobs = {}
    for name, edits in every.items():
        root = "base" if name.startswith("base") else "cur"
        src_dir = baseline if root == "base" else _build.CSRC
        d = OUT / name
        shutil.copytree(src_dir, d)
        touched = _apply(d, name, edits)
        for s in sorted(src_dir.glob("*.cu")):
            if name == root or s.name in touched or \
                    _includes(s) & touched or \
                    any(_includes(src_dir / h) & touched
                        for h in _includes(s) if (src_dir / h).exists()):
                jobs[(name, s.name)] = [nvcc, *_build.NVCC_FLAGS, "-c", "-o",
                                        str(d / f"{s.name}.o"),
                                        str(d / s.name)]
    logs = {}

    def compile_one(key):
        proc = subprocess.run(jobs[key], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        return key, proc.returncode, proc.stdout

    # at most two compilers a core at once: each takes a GB or more
    with ThreadPoolExecutor(2 * (os.cpu_count() or 4)) as pool:
        for (name, src), rc, text in pool.map(compile_one, list(jobs)):
            if rc:
                raise SystemExit(f"nvcc failed on {name}/{src}:\n"
                                 f"{text[-4000:]}")
            logs[name] = logs.get(name, "") + text
    libs, ptxas = {}, {}
    for name in every:
        root = "base" if name.startswith("base") else "cur"
        d = OUT / name
        objs = [str((d if (d / f"{s.name}.o").exists() else OUT / root)
                    / f"{s.name}.o")
                for s in sorted((OUT / root).glob("*.cu"))]
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-shared", "-o", str(d / "lib.so"), *objs],
                       check=True)
        libs[name] = _build._bind(ctypes.CDLL(str(d / "lib.so")))
        ptxas[name] = {**_ptxas(logs[root]), **_ptxas(logs.get(name, ""))}
    return libs, ptxas


def _fits(src_dir: Path, edits: list) -> bool:
    """Whether some edit of a variant finds its text in ``src_dir`` (a
    diagnostic of a kernel the baseline does not have is not built on
    it)."""
    return any(old is not None and (src_dir / fn).exists()
               and old in (src_dir / fn).read_text()
               for fn, alts in _source_edits(edits) for old in alts)


def _is_diag(variant: str) -> bool:
    return variant.split(".")[-1].startswith("diag_")


# launch parameters that, set with the source constant they mirror,
# change the order of the partials' reduction (a run's length) or the
# kernel (the dispatch threshold); the prefix walk's other constants
# (registered and snapshotted levels) move no arithmetic
_REORDERING = {"PREFIX_RUN_MAX", "PREFIX_RUN_MIN", "PREFIX_RUNS_WANTED",
               "PREFIX_MIN_GAP"}


def _launch_only(edits: list) -> bool:
    """A variant of launch parameters alone, or one that sets a
    parameter of ``_REORDERING`` with its source constant: its bits may
    differ."""
    return bool(edits) and (all(e[0] == PY for e in edits) or any(
        e[0] == PY and e[1] in _REORDERING for e in edits))


@contextlib.contextmanager
def _launch_params(module, edits: list):
    """Set a variant's launch parameters (``(PY, name, value)`` edits of
    the constants of ``module``, a ``radic_fused``; a name the module does
    not have is left out) while its calls are made."""
    saved = {e[1]: getattr(module, e[1]) for e in edits
             if e[0] == PY and hasattr(module, e[1])}
    try:
        for name in saved:
            setattr(module, name, next(e[2] for e in edits
                                       if e[0] == PY and e[1] == name))
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def _launcher(baseline: Path | None):
    """The baseline's ``radic_fused`` (beside its ``csrc``), which sets
    the grids its kernels are launched with, else this checkout's."""
    src = baseline.parent / "radic_fused.py" if baseline else None
    if src is None or not src.exists():
        return rf
    spec = importlib.util.spec_from_file_location(
        "repro_torch.kernels._baseline_radic_fused", src)
    module = importlib.util.module_from_spec(spec)
    module.__package__ = "repro_torch.kernels"
    spec.loader.exec_module(module)
    return module


def _k6_key(m: int, double: bool) -> str:
    """The ptxas key of K6's kernel at m > 16: the warp kernel's instance
    (its register width past m = 33, csrc/minor_det_warp_hi.cu and
    _top.cu) or the block kernel."""
    t = "d" if double else "f"
    if m <= 33:
        return f"K6<{m},warp,{t}"
    widths = [w for w in (40, 48, 56, 64) if m <= w]
    return f"K6<{widths[0]},warp,{t}" if widths else "K6<block"


def _ptxas(log: str) -> dict[str, str]:
    """K1<m> / K3<m> / K6<m> -> 'registers r, spill s B' from ptxas -v
    output."""
    out, cur = {}, None
    for line in log.splitlines():
        e = re.search(r"entry function '(\w+)'", line)
        if e:
            k1 = re.search(r"radic_partial_kernelILi(\d+)ELb(\d)", e.group(1))
            k3 = re.search(r"radic_grad_partial_kernelILi(\d+)E", e.group(1))
            w1 = re.search(r"radic_warp_partial_kernelILi(\d+)E", e.group(1))
            p1 = re.search(r"radic_prefix_kernelILi(\d+)E", e.group(1))
            w3 = re.search(r"radic_grad_warp_kernelILi(\d+)E", e.group(1))
            w6 = re.search(r"minor_det_warp_kernelILi(\d+)E(?:Lb[01]E)?"
                           r"([fd])", e.group(1))
            b6 = re.search(r"minor_det_block\w*kernelI([fd])E", e.group(1))
            cur = (f"K1<{k1.group(1)},{'staged' if k1.group(2) == '1' else 'global'}>"
                   if k1 else f"K3<{k3.group(1)}>" if k3 else
                   f"K1<{w1.group(1)},warp>" if w1 else
                   f"K1<{p1.group(1)},prefix>" if p1 else
                   f"K3<{w3.group(1)},warp>" if w3 else
                   f"K6<{w6.group(1)},warp,{w6.group(2)}>" if w6 else
                   f"K6<block,{b6.group(1)}>" if b6 else None)
        sp = re.search(r"(\d+) bytes spill stores", line)
        if cur and sp:
            out[cur] = f"spill {sp.group(1)} B"
        r = re.search(r"Used (\d+) registers", line)
        if cur and r:
            out[cur] = f"{r.group(1)} regs, {out.get(cur, 'spill 0 B')}"
            cur = None
    return out


def _call(lib, kernel: str, As, cts, table, count: int, grids=rf):
    """A closure launching one call of `kernel` with the grids of
    ``grids`` (a ``radic_fused``), and its output."""
    B, m, n = As.shape
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if kernel in ("K1", "K4"):
        G = grids.partial_grid_blocks(m, n, count)
        part = torch.empty((G, B), device="cuda")
        out = torch.empty((B,), device="cuda")
        args = (As.data_ptr(), B, m, n, table.data_ptr(), 0, count,
                part.data_ptr(), G, out.data_ptr(), stream)
        fn = (lib.radic_batched_partial if kernel == "K1"
              else lib.radic_bygrid_partial)
    else:
        G = grids.grad_grid_blocks(count, m, n, lib.radic_grad_tile(m))
        part = torch.empty((G, B, m, n), device="cuda")
        out = torch.empty((B, m, n), device="cuda")
        args = (As.data_ptr(), cts.data_ptr(), B, m, n, table.data_ptr(), 0,
                count, part.data_ptr(), G, out.data_ptr(), stream)
        fn = lib.radic_batched_grad_partial

    def run():
        rc = fn(*args)
        if rc:
            raise RuntimeError(lib.radic_error_string(rc).decode())
    run.buffers = (part, out)   # alive while the launch may write them
    return run, out


def _inputs(kernel: str, B: int, m: int, n: int, gen: torch.Generator):
    """K5: ranks (all of C(n, m) where B is that, else B random ones) and
    the table; K6 and K6d: B random m x m matrices."""
    if kernel == "K5":
        total = comb(n, m)
        qs = (torch.arange(total, dtype=torch.int32, device="cuda")
              if B == total else
              torch.randint(0, total, (B,), dtype=torch.int32,
                            device="cuda", generator=gen))
        table = torch.as_tensor(binom_table(n, m, dtype=np.int32)).cuda()
        return qs, table
    dt = torch.float64 if kernel == "K6d" else torch.float32
    # entries of variance 1/m at m > 16, so that |det| stays in range
    scale = 1.0 if m <= rf.CUDA_MAX_M else m ** -0.5
    return torch.randn(B, m, m, device="cuda", generator=gen,
                       dtype=dt) * scale


def _call_small(lib, kernel: str, x, m: int, n: int):
    """A closure launching one call of K5 or K6 on ``x``, and its output;
    ``block`` is the wrappers' default."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if kernel == "K5":
        qs, table = x
        out = torch.empty((qs.numel(), m), dtype=torch.int32, device="cuda")
        args = (qs.data_ptr(), qs.numel(), n, m, table.data_ptr(),
                out.data_ptr(), 256, stream)
        fn = lib.radic_unrank
    else:
        B = x.shape[0]
        is_double = int(x.dtype == torch.float64)
        out = torch.empty((B,), dtype=x.dtype, device="cuda")
        # the block kernel's global copy, where a matrix passes shared
        # memory
        work = torch.empty((lib.radic_minor_det_work_elems(B, m, is_double),),
                           dtype=x.dtype, device="cuda")
        args = (x.data_ptr(), B, m, is_double, out.data_ptr(), 128,
                work.data_ptr() if work.numel() else None, stream)
        fn = lib.radic_minor_det

    def run():
        rc = fn(*args)
        if rc:
            raise RuntimeError(lib.radic_error_string(rc).decode())
    run.buffers = (work, out)   # alive while the launch may write them
    return run, out


def _profiled_ms(run, reps: int = 50) -> float | None:
    """Device time per call from ``torch.profiler``: the kernel intervals
    of ``reps`` calls over ``reps`` (the launch-bound event window says
    little of a kernel of a few microseconds).  None where the profiler
    lost a record (an event name seen other than ``reps`` times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = {e.name for e in dev}
    if not dev or any(sum(e.name == k for e in dev) != reps for k in names):
        return None
    return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3


def _window_ms(run, reps: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    baseline = None
    if argv[:1] == ["--baseline"]:
        baseline, argv = Path(argv[1]).resolve(), argv[2:]
    names = argv or list(EXPERIMENTS)
    unknown = set(names) - set(EXPERIMENTS)
    if unknown:
        print(f"unknown experiments {sorted(unknown)}; "
              f"known: {list(EXPERIMENTS)}", file=sys.stderr)
        return 2
    variants = {}
    for e in names:
        for v, edits in EXPERIMENTS[e][0].items():
            variants[f"{e}.{v}"] = edits
    libs, ptxas = _build_all(variants, baseline)
    base_grids = _launcher(baseline)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result, ok = {"card": card.strip(), "rounds": 4, "times": []}, True
    for e in names:
        for kernel, B, m, n in EXPERIMENTS[e][1]:
            order = ["cur", *(f"{e}.{v}" for v in EXPERIMENTS[e][0]),
                     *(["base"] if baseline is not None else []),
                     *(f"base+{e}.{v}" for v in EXPERIMENTS[e][0]
                       if f"base+{e}.{v}" in libs)]
            if kernel in ("K1", "K3", "K4"):
                As = torch.randn(B, m, n, device="cuda", generator=gen)
                cts = torch.randn(B, device="cuda", generator=gen)
                table = torch.as_tensor(
                    binom_table(n, m, dtype=np.int32)).cuda()
                calls = {}
                for v in order:
                    grids = base_grids if v.startswith("base") else rf
                    with _launch_params(grids,
                                        variants.get(v.split("+")[-1], [])):
                        calls[v] = _call(libs[v], kernel, As, cts, table,
                                         comb(n, m), grids)
            else:
                x = _inputs(kernel, B, m, n, gen)
                calls = {v: _call_small(libs[v], kernel, x, m, n)
                         for v in order}
            for v in list(order):
                try:
                    calls[v][0]()
                    torch.cuda.synchronize()
                except RuntimeError as err:
                    print(f"{e} {kernel} ({B}, {m}, {n}) {v}: FAILED {err}",
                          flush=True)
                    order.remove(v)
                    ok = False
            reps = max(3, math.ceil(150.0 / _window_ms(calls["cur"][0], 1)))
            ms = {v: [] for v in order}
            prof = {v: [] for v in order}
            for rnd in range(result["rounds"]):
                for v in (order if rnd % 2 == 0 else order[::-1]):
                    ms[v].append(_window_ms(calls[v][0], reps))
                    if kernel in ("K5", "K6", "K6d"):
                        prof[v].append(_profiled_ms(calls[v][0]))
            want = calls["cur"][1]
            bound = ""
            if kernel in ("K6", "K6d"):
                # each matrix read once, each determinant written once
                nbytes = B * (m * m + 1) * (8 if kernel == "K6d" else 4)
                bound = (f"; bytes bound "
                         f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
            for v in order:
                got = calls[v][1]
                same = bool(torch.equal(got, want))
                ok &= same or _is_diag(v) or _launch_only(
                    variants.get(v.split("+")[-1], []))
                gap = ((got.double() - want.double()).abs().max()
                       / want.double().abs().max())
                diff = "" if same else (
                    f" (max |diff| / max |cur| {float(gap):.3e})")
                key = (f"K{'1' if kernel == 'K4' else kernel[1]}<{m}"
                       if kernel[:2] != "K6" or m <= rf.CUDA_MAX_M else
                       _k6_key(m, kernel == "K6d"))
                regs = "; ".join(f"{k} {s}" for k, s in
                                 ptxas[v].items() if k.startswith(key))
                profiled = "".join(
                    " lost" if t is None else f" {t:.5f}" for t in prof[v])
                print(f"{e} {kernel} ({B}, {m}, {n}) {v}: mean "
                      f"{sum(ms[v]) / len(ms[v]):.4f} ms, rounds "
                      f"{' '.join(f'{t:.4f}' for t in ms[v])}, "
                      + (f"profiled device ms{profiled}, " if prof[v]
                         else "")
                      + f"{'same bits' if same else 'BITS DIFFER'}{diff}; "
                      f"{regs}"
                      + bound,
                      flush=True)
                result["times"].append(dict(
                    experiment=e, kernel=kernel, shape=[B, m, n], variant=v,
                    ms=ms[v], profiled_ms=prof[v], reps=reps,
                    same_bits=same, ptxas=regs))
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
