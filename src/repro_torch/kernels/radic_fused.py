"""Host wrappers of the fused Radic CUDA kernels, each beside its plain
torch version.

Port of ``repro/kernels/radic_fused.py``, all four of its Pallas kernels:

* :func:`radic_batched_partial_cuda` replaces the Pallas kernel
  ``radic_batched_combo_kernel`` (radic_fused.py:156, wrapper
  ``radic_batched_partial_pallas``): per matrix of a stack
  ``As (B, m, n)``, ``Σ sign(B_q)·det(A_b[:, B_q])`` over the ranks
  ``[q_start, q_start + count)`` → ``(B,)``.
* :func:`radic_partial_cuda` replaces ``radic_fused_kernel``
  (radic_fused.py:39, wrapper ``radic_partial_pallas``): the same sum for
  one matrix ``A (m, n)`` → a scalar.  It launches the same CUDA kernel at
  B = 1 and keeps its own launch count.

The kernels compute in float32 whatever the input dtype and the wrapper
casts the result back.  Each entry takes m ≤ 16 to the register kernels
(``csrc/radic_fused.cu``, ``csrc/radic_grad.cu``: one thread owns a
minor) and 17 ≤ m ≤ 33 to the wide kernels: the forward to the prefix
walk (``csrc/radic_prefix.cuh``: a warp's lanes hold the candidate
columns and each elimination prefix is shared by every minor that
starts with it, so the walk is bound by its chain of short steps) where
:func:`prefix_walk` says so, else to the warp kernel
(``csrc/radic_warp.cu``: one warp owns a minor, bound by its warp
collectives); the backward to ``csrc/radic_warp_grad.cuh``.  The int32
Pascal table bounds every shape the reference's Pallas path answers to
those.
Each wrapper first checks what the kernels take (m, the table's shape,
the int32 rank range, the batch), on either device; then, given a tensor
on the CPU, it runs its plain version (``*_plain``); given a CUDA tensor
it launches the kernel or raises — it never falls back.  Every launch
adds one to the wrapper's ``launches`` attribute, a launch of a wide
kernel to its ``wide_launches`` too, and one of the prefix walk to its
``prefix_launches``.  :func:`prefix_walk_model` is a plain torch model of
the prefix walk itself (its runs, its shared prefixes and its pivots),
for the tests; nothing on the main path calls it.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import CUDA_MAX_M, WARP_MAX_M
from repro_torch.core.pascal import INT32_MAX
from repro_torch.core.radic import (signed_minor_pullback_batched,
                                    signed_minor_sum_batched)
from repro_torch.core.unrank import unrank_py, unrank_torch

from ._launch import check_rc, counted, require_cuda, reset_launch_counts
from ._launch import count as count_launch

__all__ = ["radic_batched_partial_cuda", "radic_batched_partial_plain",
           "radic_partial_cuda", "radic_partial_plain",
           "radic_batched_grad_partial_cuda",
           "radic_batched_grad_partial_plain", "radic_grad_partial_cuda",
           "radic_grad_partial_plain", "radic_batched_partial_bygrid_cuda",
           "grid_blocks", "warp_grid_blocks", "grad_grid_blocks",
           "prefix_walk", "prefix_run", "prefix_grid_blocks",
           "partial_grid_blocks", "prefix_smem_bytes",
           "wide_partial_smem_bytes", "prefix_walk_model",
           "reset_launch_counts", "TILE", "RUN", "WARP_TILE", "MAX_BLOCKS"]

TILE = 256            # threads per block (common.cuh kTile)
RUN = 8               # consecutive ranks per thread (common.cuh kRun)
BATCH_CHUNK = 16      # matrices per block (common.cuh kBatchChunk)
WARPS = 8             # warps per block of the warp walk (radic_warp.cu)
WARP_RUN = 8          # consecutive ranks per warp (radic_warp.cu kWarpRun)
WARP_TILE = WARPS * WARP_RUN   # ranks per tile of the warp walk
MAX_BLOCKS = 1024     # fixed rank-walk width: bounds the partials buffer
GRAD_MAX_BLOCKS = 1024      # the same for the gradient kernel (K3) ...
GRAD_PARTIAL_FLOATS = 1 << 17  # ... whose partials hold G·m·n <= this
# ... and at m >= 17, where fewer blocks than the card holds leave the
# warp kernel's latency exposed (4 MB a matrix: G = min(tiles, 1024) for
# every m·n <= 1024)
WARP_GRAD_PARTIAL_FLOATS = 1 << 20
GRAD_WARPS = 8        # warps per block of the warp gradient kernel
PLAIN_CHUNK = 2048    # ranks per step of the plain versions
# The prefix walk (csrc/radic_prefix.cuh, radic_prefix.cu): warps per
# block, the levels a walk keeps in registers and above them in shared
# memory (a restart resumes at the deepest of the latter its change leaves
# intact), the smallest n - m it takes (below it the warp kernel, which
# measured faster there at a small batch), the widest m it has an
# instance for, a run's length (at most RUN_MAX ranks, halved down to RUN_MIN
# while a matrix has fewer than RUNS_WANTED runs), and the ints of a
# warp's combination
PREFIX_WARPS = 8
PREFIX_DEEP = 10
PREFIX_SNAP = 6
PREFIX_MIN_GAP = 6
PREFIX_MAX_M = 27
PREFIX_RUN_MAX = 512
PREFIX_RUN_MIN = 32
PREFIX_RUNS_WANTED = 2048
PREFIX_COMBO_INTS = 36


def grid_blocks(count: int) -> int:
    """Blocks of the rank walk: one per tile of ``TILE`` threads ×
    ``RUN`` ranks, at most ``MAX_BLOCKS``.  A function of ``count`` only,
    so the reduction order (and with it every bit of a result) never
    depends on the batch."""
    return max(1, min(-(-count // (TILE * RUN)), MAX_BLOCKS))


def warp_grid_blocks(count: int) -> int:
    """Blocks of the warp walk (m ≥ 17): one per tile of ``WARPS`` warps
    × ``WARP_RUN`` ranks, at most ``MAX_BLOCKS``; a function of ``count``
    only, as :func:`grid_blocks` is."""
    return max(1, min(-(-count // WARP_TILE), MAX_BLOCKS))


def prefix_walk(m: int, n: int) -> bool:
    """Whether K1, K2 and K4 take the prefix walk at (m, n)
    (radic_prefix.cu ``prefix_walk``, which ``chip_smoke.py`` phase 1
    holds this to through the library's ``radic_partial_route``)."""
    return (CUDA_MAX_M < m <= PREFIX_MAX_M and n <= WARP_MAX_M
            and n - m >= PREFIX_MIN_GAP)


def prefix_run(count: int) -> int:
    """Ranks of a warp's run in the prefix walk (radic_prefix.cu
    ``prefix_run``): a function of ``count`` only."""
    r = PREFIX_RUN_MAX
    while r > PREFIX_RUN_MIN and count < r * PREFIX_RUNS_WANTED:
        r //= 2
    return r


def prefix_grid_blocks(count: int) -> int:
    """Blocks of the prefix walk: one per tile of ``PREFIX_WARPS`` warps
    × :func:`prefix_run` ranks, at most ``MAX_BLOCKS``; a function of
    ``count`` only."""
    return max(1, min(-(-count // (PREFIX_WARPS * prefix_run(count))),
                      MAX_BLOCKS))


def partial_grid_blocks(m: int, n: int, count: int) -> int:
    """Blocks of the kernel K1, K2 and K4 launch at (m, n)."""
    if m <= CUDA_MAX_M:
        return grid_blocks(count)
    return (prefix_grid_blocks(count) if prefix_walk(m, n)
            else warp_grid_blocks(count))


def prefix_snap_levels(m: int) -> range:
    """The levels the prefix walk keeps a snapshot of in shared memory
    (radic_prefix.cuh ``prefix_snap_lo``): max(1, K0 - PREFIX_SNAP) ..
    K0 - 1, K0 = m - min(PREFIX_DEEP, m - 1); level k holds its m - k
    live entries and the signed product, a lane each."""
    K0 = m - min(PREFIX_DEEP, m - 1)
    return range(max(1, K0 - PREFIX_SNAP), K0)


def prefix_smem_bytes(m: int, n: int) -> int:
    """Shared memory per block of the prefix walk (radic_prefix.cuh
    ``prefix_stage_bytes``): the warps' sums, combinations and
    snapshots (each level's m - k live entries and the signed product, a
    lane each), the Pascal table and the matrix."""
    snap = 32 * sum(m - k + 1 for k in prefix_snap_levels(m))
    return 4 * (PREFIX_WARPS * (1 + PREFIX_COMBO_INTS + snap)
                + (n + 1) * (m + 1) + m * n)


def wide_partial_smem_bytes(B: int, m: int, n: int) -> int:
    """Shared memory per block of the kernel K1 launches at m ≥ 17 (the
    library's ``radic_partial_smem_bytes``)."""
    return (prefix_smem_bytes(m, n) if prefix_walk(m, n)
            else warp_partial_smem_bytes(B, m, n))


def vec_row(m: int) -> int:
    """Floats of one row of U or of L by columns in a warp's scratch of
    the warp gradient kernel (radic_warp_grad.cuh ``vec_row``): the
    16-byte groups that cover m columns."""
    return -(-m // 4) * 4


def warp_partial_smem_bytes(B: int, m: int, n: int) -> int:
    """Shared memory per block of the warp walk (radic_warp.cu
    ``warp_partial_smem_bytes``): the block's sums per (matrix, warp), the
    Pascal table and the block's batch slice of A."""
    nb = min(BATCH_CHUNK, B)
    return 4 * (BATCH_CHUNK * WARPS + (n + 1) * (m + 1) + nb * m * n)


def warp_grad_tile(m: int) -> int:
    """Ranks per tile of the warp gradient kernel (radic_warp_grad.cuh
    ``warp_grad_tile``): 32, halved (to 8 at least) while the tile's
    cofactors exceed 48 KB."""
    t = 32
    while t > 8 and t * m * m * 4 > 48 * 1024:
        t //= 2
    return t


def warp_grad_smem_bytes(m: int) -> int:
    """Shared memory per block of the warp gradient kernel
    (radic_warp_grad.cuh ``warp_grad_bytes``): W rank masks, the tile's
    cofactors, each warp's U (later X, rows of ``m | 1``), L by columns
    and permutation, W signs and the tile's combos."""
    W, br = warp_grad_tile(m), vec_row(m)
    u = -(-m * max(br, m | 1) // 4) * 4
    return 8 * W + 4 * (W * m * m + GRAD_WARPS * (u + (m + 1) * br) + W
                        + W * m)


def grad_grid_blocks(count: int, m: int, n: int, tile: int) -> int:
    """Blocks of the gradient kernel's rank walk: one per tile of
    ``tile`` ranks (the kernel's own, ``radic_grad_tile(m)``), at most
    ``GRAD_MAX_BLOCKS``, and few enough that each matrix's partials
    ``(G, m, n)`` hold at most ``GRAD_PARTIAL_FLOATS`` floats (512 KB;
    ``WARP_GRAD_PARTIAL_FLOATS``, 4 MB, for the warp kernel at m > 16).
    A function of the rank range and the shape only, never of B."""
    budget = (GRAD_PARTIAL_FLOATS if m <= CUDA_MAX_M
              else WARP_GRAD_PARTIAL_FLOATS)
    return max(1, min(-(-count // tile), GRAD_MAX_BLOCKS, budget // (m * n)))


# ------------------------------------------------------------ plain versions
def radic_batched_partial_plain(As: torch.Tensor, table: torch.Tensor,
                                q_start: int, count: int, *,
                                dtype: torch.dtype = torch.float32,
                                chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain torch version of the K1 kernel: the same rank range, walked
    in chunks of ``chunk`` ranks (unrank → gather → ``torch.linalg.det``
    → signed masked sum), accumulated in ``dtype`` (float32 by default;
    float64 for a ground truth) → ``(B,)`` in ``dtype``."""
    B, m, n = As.shape
    X = As.to(dtype)
    acc = torch.zeros((B,), dtype=dtype, device=As.device)
    chunk = max(1, min(chunk, count))
    idx = torch.arange(chunk, dtype=torch.int64, device=As.device)
    for base in range(0, count, chunk):
        offs = base + idx
        valid = offs < count
        combos = unrank_torch(q_start + torch.where(valid, offs, 0), n, m,
                              table)
        acc = acc + signed_minor_sum_batched(X, combos, valid)
    return acc


def radic_partial_plain(A: torch.Tensor, table: torch.Tensor, q_start: int,
                        count: int, *, dtype: torch.dtype = torch.float32,
                        chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain torch version of the K2 kernel: one matrix → a scalar."""
    return radic_batched_partial_plain(A[None], table, q_start, count,
                                       dtype=dtype, chunk=chunk)[0]


def radic_batched_grad_partial_plain(As: torch.Tensor, cts: torch.Tensor,
                                     table: torch.Tensor, q_start: int,
                                     count: int, *,
                                     dtype: torch.dtype = torch.float32,
                                     chunk: int = PLAIN_CHUNK
                                     ) -> torch.Tensor:
    """Plain torch version of the K3 kernel: the forward's rank range
    replayed in chunks of ``chunk`` ranks, each pulling the cotangents
    ``cts (B,)`` back through its signed minor sum in closed form
    (cofactors, :func:`~repro_torch.core.radic.cofactors`) and adding
    the result to the running gradient, in ``dtype`` (float32 by default;
    float64 for a ground truth) → ``(B, m, n)`` in ``dtype``."""
    B, m, n = As.shape
    X = As.to(dtype)
    c = torch.as_tensor(cts, device=As.device).to(dtype).reshape(B)
    g = torch.zeros((B, m, n), dtype=dtype, device=As.device)
    chunk = max(1, min(chunk, count))
    idx = torch.arange(chunk, dtype=torch.int64, device=As.device)
    for base in range(0, count, chunk):
        offs = base + idx
        valid = offs < count
        combos = unrank_torch(q_start + torch.where(valid, offs, 0), n, m,
                              table)
        g = g + signed_minor_pullback_batched(X, c, combos, valid)
    return g


def radic_grad_partial_plain(A: torch.Tensor, ct, table: torch.Tensor,
                             q_start: int, count: int, *,
                             dtype: torch.dtype = torch.float32,
                             chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain torch version of the K3 kernel at B = 1: ``A (m, n)``, a
    scalar cotangent → ``(m, n)``."""
    cts = torch.as_tensor(ct, device=A.device).reshape(1)
    return radic_batched_grad_partial_plain(A[None], cts, table, q_start,
                                            count, dtype=dtype,
                                            chunk=chunk)[0]


def prefix_walk_model(A: torch.Tensor, table: torch.Tensor, q_start: int,
                      count: int, *, dtype: torch.dtype = torch.float64,
                      run: int | None = None, deep: int = PREFIX_DEEP,
                      snap: int = PREFIX_SNAP) -> dict:
    """A plain torch model of the prefix walk (``csrc/radic_prefix.cuh``)
    on one matrix ``A (m, n)`` over the ranks [q_start, q_start + count):
    the kernel's tiles and runs (``run`` ranks a warp, :func:`prefix_run`
    by default), its restarts (levels 1..K0, K0 = m - min(deep, m - 1),
    eliminated again at a run's start and where a prefix of length K0 is
    used up: from A, or from the snapshot of level k in ``snap`` levels
    above K0 where the change leaves positions 0..k-1 alone), each deeper
    prefix eliminated once for every leaf below it, det_ge's pivot rule
    on the live rows of ``A[:, B]`` (the
    largest magnitude, a NaN as +inf, a tie to the lower row, a zero pivot
    dividing by 1), and its sums (each lane's leaves in rank order, a
    butterfly over the lanes, the runs in the order of a block's warps,
    the blocks' partials in order), in ``dtype``.  Returns ``total`` (a
    0-d tensor), ``runs`` (each run's first rank and its leaves in visit
    order, each a (0-indexed combination, det(A[:, B])) pair),
    ``steps`` (elimination steps, one a column eliminated) and
    ``restarts``."""
    m, n = A.shape
    X = A.to(dtype)
    K0 = m - min(deep, m - 1)
    lo = max(1, K0 - snap)   # levels lo..K0-1 are snapshotted
    run = prefix_run(count) if run is None else run
    tiles = -(-count // (PREFIX_WARPS * run))
    grid = max(1, min(tiles, MAX_BLOCKS))
    off = max(0, n - 32)   # lane j holds column j + off
    base = -1.0 if (m * (m + 1) // 2) % 2 else 1.0
    stats = {"steps": 0, "restarts": 0}
    inf = torch.tensor(float("inf"), dtype=dtype)

    def step(V, c, prod, sgn):
        """Eliminate column c from the live rows V (L, n): the pivot, the
        other rows less their multiples of its row, the product and the
        sign (the pivot's index among the live rows flips it if odd, the
        column's Radic share (-1)^(c + 1) too)."""
        col = V[:, c]
        key = torch.where(torch.isnan(col), inf, col.abs())
        p = int(torch.nonzero(key == key.max())[0])
        piv = col[p]
        safe = torch.where(piv == 0, torch.ones_like(piv), piv)
        rest = torch.cat([V[:p], V[p + 1:]])
        f = torch.cat([col[:p], col[p + 1:]]) / safe
        stats["steps"] += 1
        flip = -1.0 if p % 2 else 1.0
        return (rest - f[:, None] * V[p][None, :], prod * piv,
                sgn * flip * (1.0 if c % 2 else -1.0), flip)

    def walk(q, length):
        combo = [c - 1 for c in unrank_py(q, n, m)]
        lanes = torch.zeros(32, dtype=dtype)
        leaves = []
        w = {"left": length, "first": True}

        def level(K, V, prod, sgn, perm, c, prefix):
            while c <= n - m + K and w["left"] > 0:
                V2, p2, s2, flip = step(V, c, prod, sgn)
                if K == m - 2:
                    js = combo[m - 1] if w["first"] else c + 1
                    je = min(n - 1, js + w["left"] - 1)
                    for j in range(js, je + 1):
                        leaves.append((tuple(prefix + [c, j]),
                                       perm * flip * (p2 * V2[0, j])))
                        lanes[j - off] += ((s2 * (1.0 if j % 2 else -1.0))
                                           * (p2 * V2[0, j]))
                    w["left"] -= je - js + 1
                    w["first"] = False
                else:
                    level(K + 1, V2, p2, s2, perm * flip,
                          combo[K + 1] if w["first"] else c + 1,
                          prefix + [c])
                c += 1

        snaps, start = {}, 0   # level -> (V, prod, sgn, perm)
        while w["left"] > 0:
            if start:
                V, prod, sgn, perm = snaps[start]
            else:
                V, prod, sgn, perm = X, torch.ones((), dtype=dtype), base, 1.0
            for k in range(start, K0):
                if k >= lo:
                    snaps[k] = (V, prod, sgn, perm)
                V, prod, sgn, flip = step(V, combo[k], prod, sgn)
                perm *= flip
            stats["restarts"] += 1
            level(K0, V, prod, sgn, perm,
                  combo[K0] if w["first"] else combo[K0 - 1] + 1,
                  combo[:K0])
            if w["left"] > 0:   # the prefix of length K0 is used up
                at = max(i for i in range(K0) if combo[i] < n - m + i)
                combo[at:K0] = range(combo[at] + 1, combo[at] + 1 + K0 - at)
                start = at if at >= lo else 0
        for d in (16, 8, 4, 2, 1):   # the lanes' butterfly
            lanes = lanes + lanes[torch.arange(32) ^ d]
        return lanes[0], leaves

    runs, total = [], torch.zeros((), dtype=dtype)
    for g in range(grid):
        warps = [torch.zeros((), dtype=dtype) for _ in range(PREFIX_WARPS)]
        for t in range(g, tiles, grid):
            for wp in range(PREFIX_WARPS):
                o = (t * PREFIX_WARPS + wp) * run
                if o < count:
                    s, leaves = walk(q_start + o, min(run, count - o))
                    warps[wp] = warps[wp] + s
                    runs.append((q_start + o, leaves))
        part = torch.zeros((), dtype=dtype)
        for s in warps:
            part = part + s
        total = total + part
    return {"total": total, "runs": runs, **stats}


# ------------------------------------------------------------------ launches
def _check(As: torch.Tensor, table: torch.Tensor, q_start: int,
           count: int, max_batch: int = BATCH_CHUNK * 65535) -> None:
    """What the kernels take, checked on both branches of a wrapper, so
    that a CPU tensor is refused what a CUDA tensor would be."""
    B, m, n = As.shape
    if not 1 <= m <= WARP_MAX_M:
        raise ValueError(f"the CUDA kernels are built for 1 <= m <= "
                         f"{WARP_MAX_M}, got m = {m}")
    if n < m:
        raise ValueError(f"expected m <= n, got ({m}, {n})")
    if tuple(table.shape) != (n + 1, m + 1):
        raise ValueError(f"table shape {tuple(table.shape)} != "
                         f"({n + 1}, {m + 1})")
    if q_start < 0 or count < 0 or q_start + count > INT32_MAX + 1:
        raise ValueError(f"rank range [{q_start}, {q_start + count}) is "
                         "outside the kernel's int32 ranks")
    if B > max_batch:
        raise ValueError(f"batch {B} exceeds {max_batch}")


def _launch(As: torch.Tensor, table: torch.Tensor, q_start: int,
            count: int, *, bygrid: bool = False) -> torch.Tensor:
    """Launch K1's kernel pair (K4's with ``bygrid``) on the current
    stream → ``(B,)`` float32: the register walk at m ≤ 16, the prefix
    walk or the warp walk above (:func:`prefix_walk`)."""
    from . import _build  # lazy: builds the library at first launch
    B = As.shape[0]
    X = As.to(torch.float32).contiguous()
    T = table.to(device=As.device, dtype=torch.int32).contiguous()
    m, n = As.shape[1:]
    grid = partial_grid_blocks(m, n, count)
    partials = torch.empty((grid, B), dtype=torch.float32, device=As.device)
    out = torch.empty((B,), dtype=torch.float32, device=As.device)
    lib = _build.load()
    entry = lib.radic_bygrid_partial if bygrid else lib.radic_batched_partial
    with torch.cuda.device(As.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(X.data_ptr(), B, m, As.shape[2], T.data_ptr(),
                   int(q_start), int(count), partials.data_ptr(), grid,
                   out.data_ptr(), stream)
    check_rc(lib, rc, "radic")
    return out


def _launch_grad(As: torch.Tensor, cts: torch.Tensor, table: torch.Tensor,
                 q_start: int, count: int) -> torch.Tensor:
    """Launch K3's kernel pair on the current stream → ``(B, m, n)``
    float32."""
    from . import _build  # lazy: builds the library at first launch
    B, m, n = As.shape
    X = As.to(torch.float32).contiguous()
    C = torch.as_tensor(cts, device=As.device).to(torch.float32) \
        .reshape(B).contiguous()
    T = table.to(device=As.device, dtype=torch.int32).contiguous()
    lib = _build.load()
    grid = grad_grid_blocks(count, m, n, lib.radic_grad_tile(m))
    partials = torch.empty((grid, B, m, n), dtype=torch.float32,
                           device=As.device)
    out = torch.empty((B, m, n), dtype=torch.float32, device=As.device)
    with torch.cuda.device(As.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.radic_batched_grad_partial(
            X.data_ptr(), C.data_ptr(), B, m, n, T.data_ptr(), int(q_start),
            int(count), partials.data_ptr(), grid, out.data_ptr(), stream)
    check_rc(lib, rc, "radic gradient")
    return out


@counted
def radic_batched_partial_cuda(As: torch.Tensor, table: torch.Tensor,
                               q_start: int, count: int) -> torch.Tensor:
    """Per-matrix Σ sign·det over ranks [q_start, q_start+count) of a
    stack ``As (B, m, n)`` → ``(B,)`` in ``As.dtype`` (K1)."""
    _check(As, table, q_start, count)
    if As.device.type == "cpu":
        return radic_batched_partial_plain(As, table, q_start,
                                           count).to(As.dtype)
    require_cuda(As)
    if As.shape[0] == 0:
        return torch.zeros((0,), dtype=As.dtype, device=As.device)
    out = _launch(As, table, q_start, count)
    count_launch(radic_batched_partial_cuda, wide=As.shape[1] > CUDA_MAX_M,
                 prefix=prefix_walk(*As.shape[1:]))
    return out.to(As.dtype)


@counted
def radic_partial_cuda(A: torch.Tensor, table: torch.Tensor, q_start: int,
                       count: int) -> torch.Tensor:
    """Σ sign·det over ranks [q_start, q_start+count) of one matrix
    ``A (m, n)`` → a 0-d tensor in ``A.dtype`` (K2: the K1 kernel at
    B = 1)."""
    _check(A[None], table, q_start, count)
    if A.device.type == "cpu":
        return radic_partial_plain(A, table, q_start, count).to(A.dtype)
    require_cuda(A)
    out = _launch(A[None], table, q_start, count)
    count_launch(radic_partial_cuda, wide=A.shape[0] > CUDA_MAX_M,
                 prefix=prefix_walk(*A.shape))
    return out[0].to(A.dtype)


@counted
def radic_batched_partial_bygrid_cuda(As: torch.Tensor, table: torch.Tensor,
                                      q_start: int, count: int
                                      ) -> torch.Tensor:
    """K1's function on the by-grid kernel (K4): ``(B,)`` in
    ``As.dtype``, equal to :func:`radic_batched_partial_cuda` bit for
    bit.  The function is K1's, so its plain version is K1's too."""
    _check(As, table, q_start, count, max_batch=65535)
    if As.device.type == "cpu":
        return radic_batched_partial_plain(As, table, q_start,
                                           count).to(As.dtype)
    require_cuda(As)
    if As.shape[0] == 0:
        return torch.zeros((0,), dtype=As.dtype, device=As.device)
    out = _launch(As, table, q_start, count, bygrid=True)
    count_launch(radic_batched_partial_bygrid_cuda,
                 wide=As.shape[1] > CUDA_MAX_M,
                 prefix=prefix_walk(*As.shape[1:]))
    return out.to(As.dtype)


@counted
def radic_batched_grad_partial_cuda(As: torch.Tensor, cts: torch.Tensor,
                                    table: torch.Tensor, q_start: int,
                                    count: int) -> torch.Tensor:
    """Cotangents ``cts (B,)`` pulled back through the signed minor sum
    over ranks [q_start, q_start+count) of ``As (B, m, n)`` →
    ``(B, m, n)`` in ``As.dtype`` (K3)."""
    _check(As, table, q_start, count)
    if As.device.type == "cpu":
        return radic_batched_grad_partial_plain(As, cts, table, q_start,
                                                count).to(As.dtype)
    require_cuda(As)
    if As.shape[0] == 0:
        return torch.zeros_like(As)
    out = _launch_grad(As, cts, table, q_start, count)
    count_launch(radic_batched_grad_partial_cuda,
                 wide=As.shape[1] > CUDA_MAX_M)
    return out.to(As.dtype)


@counted
def radic_grad_partial_cuda(A: torch.Tensor, ct, table: torch.Tensor,
                            q_start: int, count: int) -> torch.Tensor:
    """A scalar cotangent pulled back through the signed minor sum of one
    matrix ``A (m, n)`` → ``(m, n)`` in ``A.dtype`` (K3's kernel at
    B = 1, counted on its own)."""
    _check(A[None], table, q_start, count)
    if A.device.type == "cpu":
        return radic_grad_partial_plain(A, ct, table, q_start,
                                        count).to(A.dtype)
    require_cuda(A)
    cts = torch.as_tensor(ct, device=A.device).reshape(1)
    out = _launch_grad(A[None], cts, table, q_start, count)
    count_launch(radic_grad_partial_cuda, wide=A.shape[0] > CUDA_MAX_M)
    return out[0].to(A.dtype)
