"""The wide path (m >= 17) of the port's ``cuda`` entries against the
reference's Pallas entries in interpret mode, on the CPU, where the
wrappers run their plain versions: values, gradients, the by-grid and
B = 1 entries, the table's overflow at (33, 34), ``minor_det`` for large
m, a queue serving m >= 17, a torch model of the warp kernel's rank
tiling, and the plain torch model of the prefix walk (its visit order,
its leaves, its partial sums and its step count).  On the card
``chip_smoke.py`` holds the warp kernels and the prefix walk against
these same plain versions, and the prefix walk's bits to those its
kernels gave before its deep step went to shuffles."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.launch import det_queue as ref_q  # noqa: E402
from repro_torch.core.pascal import binom_table, comb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import radic_fused as rf  # noqa: E402
from repro_torch.launch.det_queue import DetQueue  # noqa: E402

WIDE = [(17, 20), (20, 22), (24, 26), (33, 33)]
SMEM_PER_BLOCK = 232448  # the most shared memory a block may use (227 KB)
# (q_start, count) as fractions of C(n, m): the full range and two parts
RANGES = [None, (0.0, 0.5), (0.3, 0.4)]


def _stack(seed, B, m, n):
    """Entries of scale 1/sqrt(m): minors of order 1."""
    return (np.random.default_rng(seed).normal(size=(B, m, n))
            / np.sqrt(m)).astype(np.float32)


def _range(m, n, part):
    total = comb(n, m)
    if part is None:
        return 0, total
    q0 = int(part[0] * total)
    return q0, max(1, min(int(part[1] * total), total - q0))


@pytest.mark.parametrize("part", RANGES)
@pytest.mark.parametrize("m,n", WIDE)
def test_wide_values_match_reference_pallas(m, n, part):
    As = _stack(m * 41 + n, 2, m, n)
    q0, cnt = _range(m, n, part)
    got = ops.radic_det_batched_cuda(torch.from_numpy(As), q0, cnt)
    want = np.asarray(ref_ops.radic_det_batched_pallas(jnp.asarray(As), q0,
                                                       cnt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    four = ops.radic_det_batched_cuda_bygrid(torch.from_numpy(As), q0, cnt)
    assert torch.equal(four, got)
    one = ops.radic_det_cuda(torch.from_numpy(As[1]), q_start=q0, count=cnt)
    np.testing.assert_allclose(float(one), want[1], rtol=1e-3, atol=1e-4)
    for b in range(2):
        exact = ref.radic_partial_ref(As[b], q0, cnt)
        assert abs(float(got[b]) - exact) <= 2e-3 * max(1.0, abs(exact))


@pytest.mark.parametrize("part", RANGES)
@pytest.mark.parametrize("m,n", WIDE)
def test_wide_gradients_match_reference_pallas(m, n, part):
    As = _stack(m * 43 + n, 2, m, n)
    cts = np.array([1.5, -0.75], np.float32)
    q0, cnt = _range(m, n, part)
    got = ops.radic_det_batched_grad_cuda(torch.from_numpy(As), cts, q0, cnt)
    want = np.asarray(ref_ops.radic_det_batched_grad_pallas(
        jnp.asarray(As), jnp.asarray(cts), q0, cnt))
    assert got.shape == (2, m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    one = ops.radic_det_grad_cuda(torch.from_numpy(As[0]), 1.5, q0, cnt)
    np.testing.assert_allclose(one.numpy(), want[0], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("entry", ["values", "bygrid", "grad", "scalar",
                                   "scalar_grad"])
def test_table_overflow_at_33_34_in_both_packages(entry):
    """C(34, 33) fits int32, but the table's peak C(34, 17) does not: both
    packages raise OverflowError on every entry."""
    A = np.ones((1, 33, 34), np.float32)
    port, want = {
        "values": (lambda: ops.radic_det_batched_cuda(torch.from_numpy(A)),
                   lambda: ref_ops.radic_det_batched_pallas(jnp.asarray(A))),
        "bygrid": (lambda: ops.radic_det_batched_cuda_bygrid(
            torch.from_numpy(A)),
            lambda: ref_ops.radic_det_batched_pallas_bygrid(jnp.asarray(A))),
        "grad": (lambda: ops.radic_det_batched_grad_cuda(
            torch.from_numpy(A), [1.0]),
            lambda: ref_ops.radic_det_batched_grad_pallas(
                jnp.asarray(A), jnp.ones(1))),
        "scalar": (lambda: ops.radic_det_cuda(torch.from_numpy(A[0])),
                   lambda: ref_ops.radic_det_pallas(jnp.asarray(A[0]))),
        "scalar_grad": (lambda: ops.radic_det_grad_cuda(
            torch.from_numpy(A[0]), 1.0),
            lambda: ref_ops.radic_det_grad_pallas(jnp.asarray(A[0]), 1.0)),
    }[entry]
    with pytest.raises(OverflowError):
        port()
    with pytest.raises(OverflowError):
        want()


@pytest.mark.parametrize("m", [17, 33, 64])
def test_minor_det_large_m_matches_reference(m):
    mats = (np.random.default_rng(m).normal(size=(6, m, m))
            / np.sqrt(m)).astype(np.float32)
    mats[1, 3] = mats[1, 0]            # singular
    mats[2] = mats[0][[1, 0, *range(2, m)]]   # one row swap
    got = ops.minor_det(torch.from_numpy(mats))
    want = np.asarray(ref_ops.minor_det(jnp.asarray(mats)))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), ref.minor_det_ref(mats),
                               rtol=5e-4, atol=1e-6)
    assert float(got[1]) == 0.0 and float(got[2]) == -float(got[0])
    f64 = ops.minor_det(torch.from_numpy(mats.astype(np.float64)))
    want64 = np.linalg.det(mats.astype(np.float64))
    np.testing.assert_allclose(f64.numpy(), want64, rtol=1e-9,
                               atol=1e-9 * np.abs(want64).max())


def _nan_stack(seed, m, n):
    """Three matrices: a NaN column, a NaN row (every minor holds it),
    and a clean one."""
    As = _stack(seed, 3, m, n)
    As[0, :, 3] = np.nan
    As[1, 7, :] = np.nan
    return As


@pytest.mark.parametrize("entry", ["values", "grad"])
def test_wide_nan_input_matches_reference_pallas(entry):
    """NaN input at m = 20: the matrices that hold a NaN answer NaN where
    the reference does (det_ge's pivot rule: a NaN row never wins, the
    row at the step's place keeps it when its own entry is NaN), and
    their batch neighbour answers as alone."""
    As = _nan_stack(5, 20, 22)
    A = torch.from_numpy(As)
    if entry == "values":
        got = ops.radic_det_batched_cuda(A).numpy()
        want = np.asarray(ref_ops.radic_det_batched_pallas(jnp.asarray(As)))
        alone = ops.radic_det_batched_cuda(A[2:].clone()).numpy()
    else:
        cts = np.array([1.5, -0.75, 2.0], np.float32)
        got = ops.radic_det_batched_grad_cuda(A, cts).numpy()
        want = np.asarray(ref_ops.radic_det_batched_grad_pallas(
            jnp.asarray(As), jnp.asarray(cts)))
        alone = ops.radic_det_batched_grad_cuda(A[2:].clone(),
                                                cts[2:]).numpy()
    assert np.isnan(got[:2]).any(axis=tuple(range(1, got.ndim))).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(got[2:], alone)


@pytest.mark.parametrize("m", [20, 40])
def test_minor_det_nan_matches_reference(m):
    """A NaN column, a NaN on the first pivot's place, and a NaN below it
    (which det_ge never picks): NaN determinants, as the reference
    gives; the clean matrix beside them as alone."""
    mats = (np.random.default_rng(m + 1).normal(size=(4, m, m))
            / np.sqrt(m)).astype(np.float32)
    mats[0, :, 3] = np.nan
    mats[1, 0, 0] = np.nan
    mats[2, 5, 0] = np.nan
    got = ops.minor_det(torch.from_numpy(mats)).numpy()
    want = np.asarray(ref_ops.minor_det(jnp.asarray(mats)))
    assert np.isnan(got[:3]).all()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-6)
    assert got[3] == ops.minor_det(torch.from_numpy(mats[3:])).numpy()[0]


@pytest.mark.parametrize("name", ["duplicate column", "zero column"])
def test_wide_singular_gradient_matches_differences(name):
    """Exactly zero pivots at m = 17: the closed-form pullback equals
    central differences of the float64 oracle."""
    rng = np.random.default_rng(7)
    A = rng.normal(size=(17, 19)) / np.sqrt(17)
    if name == "duplicate column":
        A[:, 4] = A[:, 1]
    else:
        A[:, 6] = 0.0
    got = ops.radic_det_grad_cuda(torch.from_numpy(A), 1.0).numpy()
    h = 1e-6
    want = np.zeros_like(A)
    for r in range(17):
        for c in range(19):
            E = np.zeros_like(A)
            E[r, c] = h
            want[r, c] = (ref.radic_det_oracle(A + E)
                          - ref.radic_det_oracle(A - E)) / (2 * h)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_queue_serves_wide_requests_as_the_reference():
    """A mix of m >= 17 and small shapes through the port's default
    (cuda) queue and the reference's pallas queue: the same answers."""
    rng = np.random.default_rng(11)
    shapes = [(17, 19), (2, 5), (18, 20), (17, 19), (20, 21), (3, 7),
              (33, 33)]
    mats = [(rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
            for s in shapes]
    with DetQueue(device="cpu") as q:
        got = [f.result(timeout=300) for f in q.submit_many(mats)]
    with ref_q.DetQueue(backend="pallas") as q:
        want = [float(f.result(timeout=300)) for f in q.submit_many(mats)]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


# ----------------------------------------------- the warp walk's tiling
def _warp_runs(q_start: int, count: int):
    """A torch model of the warp walk (radic_warp.cu): tile ``t`` of
    ``WARPS`` warps × ``WARP_RUN`` ranks goes to block ``t mod G``, and
    warp ``w`` of the tile owns the run ``[(t·WARPS + w)·WARP_RUN,
    +WARP_RUN)`` of offsets, cut at ``count``.  Returns (block, warp,
    first rank, length) of every run that holds a rank."""
    G = rf.warp_grid_blocks(count)
    tiles = -(-count // rf.WARP_TILE)
    t = torch.arange(tiles)
    w = torch.arange(rf.WARPS)
    first = ((t[:, None] * rf.WARPS + w[None, :]) * rf.WARP_RUN).reshape(-1)
    block = (t % G).repeat_interleave(rf.WARPS)
    warp = w.repeat(tiles)
    keep = first < count
    first, block, warp = first[keep], block[keep], warp[keep]
    return block, warp, q_start + first, (count - first).clamp(
        max=rf.WARP_RUN)


@pytest.mark.parametrize("count", [1, 7, 8, 9, 63, 64, 65, 1140, 10 ** 6,
                                   64 * 1024 + 5, 30_045_015])
def test_warp_grid_blocks_is_a_function_of_count(count):
    """The warp walk's block count depends on the rank count alone (never
    on B); every block walks at least one tile.  So do the prefix walk's
    run length and block count: a run of 512 ranks halved (to 32 at
    least) while a matrix has fewer than 2,048 runs, a tile of 8 runs."""
    G = rf.warp_grid_blocks(count)
    assert G == max(1, min(-(-count // rf.WARP_TILE), rf.MAX_BLOCKS))
    if count <= 10 ** 6:
        block, _, _, _ = _warp_runs(0, count)
        assert set(block.tolist()) == set(range(G))
    run = rf.prefix_run(count)
    assert run in (32, 64, 128, 256, 512)
    assert run == 32 or count >= run * rf.PREFIX_RUNS_WANTED
    assert run == 512 or count < 2 * run * rf.PREFIX_RUNS_WANTED
    tiles = -(-count // (rf.PREFIX_WARPS * run))
    Gp = rf.prefix_grid_blocks(count)
    assert Gp == max(1, min(tiles, rf.MAX_BLOCKS))
    # each block walks tiles g, g + G, ...: every block holds a tile
    assert {t % Gp for t in range(min(tiles, 2 * Gp))} == set(range(Gp))


@pytest.mark.parametrize("q_start,count", [(0, 1), (3, 6), (60, 9),
                                           (1000, 5000), (0, 1140),
                                           (123_456, 64 * 1024 + 77)])
def test_warp_runs_cover_the_range_once(q_start, count):
    _, warp, first, length = _warp_runs(q_start, count)
    assert bool((length >= 1).all()) and bool((length <= rf.WARP_RUN).all())
    assert bool((warp < rf.WARPS).all())
    offs = torch.arange(rf.WARP_RUN)
    ranks = (first[:, None] + offs)[offs[None, :] < length[:, None]]
    assert ranks.numel() == count
    assert torch.equal(ranks.sort().values,
                       torch.arange(q_start, q_start + count))


@pytest.mark.parametrize("n,m,q_start,count", [
    (20, 17, 0, 1140), (26, 24, 0, 325), (30, 20, 30_045_015 - 200, 200),
    (33, 33, 0, 1), (33, 32, 0, 33)])
def test_warp_successor_walk_reproduces_unranking(n, m, q_start, count):
    """Each warp unranks its run's first rank and steps with the
    dictionary-order successor: that gives unrank_torch's combos."""
    from repro_torch.core.unrank import successor_torch, unrank_torch
    table = torch.as_tensor(binom_table(n, m, dtype=np.int64))
    _, _, first, length = _warp_runs(q_start, count)
    combo = unrank_torch(first, n, m, table)
    steps = [combo]
    for _ in range(rf.WARP_RUN - 1):
        combo = successor_torch(combo, n)
        steps.append(combo)
    walk = torch.stack(steps, 1)
    offs = torch.arange(rf.WARP_RUN)
    valid = offs[None, :] < length[:, None]
    want = unrank_torch((first[:, None] + offs)[valid], n, m, table)
    assert torch.equal(walk[valid], want)


@pytest.mark.parametrize("m", range(17, 34))
def test_warp_kernels_shared_memory_fits_a_block(m):
    """The twins of the warp kernels' shared memory per block (held to the
    built library's own counts by chip_smoke.py phase 1) stay within the
    227 KB a block may use at every n the int32 table allows and the
    widest batch slice."""
    for n in range(m, 34):
        assert rf.warp_partial_smem_bytes(16, m, n) <= SMEM_PER_BLOCK
        # two blocks of the prefix walk (its register cap) fit an SM
        assert 2 * rf.prefix_smem_bytes(m, n) <= SMEM_PER_BLOCK
        assert rf.wide_partial_smem_bytes(16, m, n) == (
            rf.prefix_smem_bytes(m, n) if rf.prefix_walk(m, n)
            else rf.warp_partial_smem_bytes(16, m, n))
    assert rf.warp_grad_tile(m) in (8, 16, 32)
    assert rf.warp_grad_tile(m) * m * m * 4 <= 48 * 1024 \
        or rf.warp_grad_tile(m) == 8
    assert rf.warp_grad_smem_bytes(m) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("count,m,n", [(1, 17, 17), (18, 17, 18),
                                       (230_230, 20, 26), (593_775, 24, 30),
                                       (237_336, 28, 33), (1, 33, 33),
                                       (10 ** 7, 17, 33)])
def test_warp_grad_grid_is_a_function_of_the_shape(count, m, n):
    """K3's warp kernel (m > 16) has its own partials budget: its block
    count depends on (count, m, n) and its tile only, never on B, is never
    below the register kernel's budget, and each matrix's partials stay
    within 4 MB."""
    tile = rf.warp_grad_tile(m)
    g = rf.grad_grid_blocks(count, m, n, tile)
    assert 1 <= g <= min(-(-count // tile), rf.GRAD_MAX_BLOCKS)
    assert g * m * n <= rf.WARP_GRAD_PARTIAL_FLOATS <= (4 << 20) // 4
    assert g >= min(-(-count // tile), rf.GRAD_PARTIAL_FLOATS // (m * n))



# ------------------------------------------------- the prefix walk's model
# (m, n, q_start, count, run): a whole range in runs of 32 (tiles, runs
# and restarts straddled, ending at the last rank), a range inside one
# run, one that starts mid-subtree in runs of 32, the last 300 ranks in
# runs of 128 (restarts inside a run), and a whole range in one run
WALKS = {"whole": (17, 20, 0, 1140, None), "one_run": (18, 21, 100, 20, None),
         "mid": (19, 22, 1000, 500, None), "last": (20, 23, 1771 - 300, 300, 128),
         "single": (17, 19, 0, 171, 1 << 20)}


def _walk_matrix(m, n, seed):
    return np.random.default_rng(seed).normal(size=(m, n)) / np.sqrt(m)


@pytest.fixture(scope="module")
def walks():
    out = {}
    for name, (m, n, q0, cnt, run) in WALKS.items():
        A = _walk_matrix(m, n, m * 7 + n)
        table = torch.as_tensor(binom_table(n, m, dtype=np.int64))
        out[name] = (A, rf.prefix_walk_model(torch.from_numpy(A), table, q0,
                                             cnt, run=run))
    return out


def _prefix_counts(combos, m):
    """Distinct prefixes of each length among a run's combinations."""
    return [len({c[:k] for c in combos}) for k in range(m + 1)]


@pytest.mark.parametrize("name", list(WALKS))
def test_prefix_walk_visits_each_rank_once_in_order(walks, name):
    """Each run visits its ranks in rank order, from its first, and the
    runs cover the range once."""
    from repro_torch.core.unrank import unrank_py
    m, n, q0, cnt, run = WALKS[name]
    _, res = walks[name]
    seen = []
    for first, leaves in res["runs"]:
        assert len(leaves) == min(run or rf.prefix_run(cnt), q0 + cnt - first)
        for i, (combo, _) in enumerate(leaves):
            assert combo == tuple(c - 1 for c in unrank_py(first + i, n, m))
        seen += range(first, first + len(leaves))
    assert sorted(seen) == list(range(q0, q0 + cnt))


@pytest.mark.parametrize("name", list(WALKS))
def test_prefix_walk_leaves_are_the_minors(walks, name):
    """Each leaf's determinant (its shared prefix's pivots times its own
    last pivot, with the permutation's sign) is float64 det(A[:, B])."""
    A, res = walks[name]
    combos = [c for _, leaves in res["runs"] for c, _ in leaves]
    dets = torch.stack([d for _, leaves in res["runs"] for _, d in leaves])
    X = torch.from_numpy(A)
    want = torch.linalg.det(X[:, torch.tensor(combos)].permute(1, 0, 2))
    assert (dets - want).abs().max() <= 1e-12 * max(1.0, want.abs().max())


@pytest.mark.parametrize("name", list(WALKS))
def test_prefix_walk_steps_follow_the_prefix_counts(walks, name):
    """One step a prefix of length lo + 1 .. m - 1 met in a run (levels
    lo..K0-1 are snapshotted, so a restart resumes below the deepest
    level its change leaves intact), and lo steps a restart that the
    change takes above level lo (one a prefix of length lo met in a run);
    a restart a prefix of length K0 met in a run.  Over a whole range in
    one run that is C(n, m - 1) - 1 plus the extra steps, sum over k <= lo
    of (R - C(n - m + k, k)), R = C(n - m + lo, lo)."""
    m, n, q0, cnt, run = WALKS[name]
    _, res = walks[name]
    K0 = m - min(rf.PREFIX_DEEP, m - 1)
    lo = max(1, K0 - rf.PREFIX_SNAP)
    steps = restarts = 0
    for _, leaves in res["runs"]:
        d = _prefix_counts([c for c, _ in leaves], m)
        steps += sum(d[lo + 1:m]) + lo * d[lo]
        restarts += d[K0]
    assert (res["steps"], res["restarts"]) == (steps, restarts)
    if name == "single":
        R = comb(n - m + lo, lo)
        assert restarts == comb(n - m + K0, K0)
        assert steps == comb(n, m - 1) - 1 + sum(
            R - comb(n - m + k, k) for k in range(1, lo + 1))


@pytest.mark.parametrize("name", ["whole", "mid", "last"])
def test_prefix_walk_partial_matches_reference_pallas(walks, name):
    """The model in float32 sums the range as the reference's Pallas
    entry does, at its tolerances."""
    m, n, q0, cnt, run = WALKS[name]
    A, _ = walks[name]
    A32 = A.astype(np.float32)
    got = rf.prefix_walk_model(torch.from_numpy(A32),
                               torch.as_tensor(binom_table(n, m, dtype=np.int64)),
                               q0, cnt, dtype=torch.float32, run=run)["total"]
    want = np.asarray(ref_ops.radic_det_batched_pallas(jnp.asarray(A32[None]),
                                                       q0, cnt))[0]
    np.testing.assert_allclose(float(got), want, rtol=1e-3, atol=1e-4)
    assert abs(float(got) - ref.radic_partial_ref(A32, q0, cnt)) <= 2e-3 * max(
        1.0, abs(ref.radic_partial_ref(A32, q0, cnt)))


@pytest.mark.parametrize("kind", ["zero", "nan"])
def test_prefix_walk_bad_column_reaches_only_its_minors(kind):
    """A zero column gives exactly 0 and a NaN column gives NaN exactly in
    the leaves that take it, the column being a pivot of the prefix or a
    leaf's last; every other leaf stays finite and nonzero."""
    m, n = 17, 20
    A = _walk_matrix(m, n, 5)
    bad = (2, n - 1)
    A[:, list(bad)] = 0.0 if kind == "zero" else np.nan
    res = rf.prefix_walk_model(torch.from_numpy(A),
                               torch.as_tensor(binom_table(n, m, dtype=np.int64)),
                               0, comb(n, m))
    for _, leaves in res["runs"]:
        for combo, det in leaves:
            if set(bad) & set(combo):
                assert (float(det) == 0.0) if kind == "zero" \
                    else bool(torch.isnan(det))
            else:
                assert bool(torch.isfinite(det)) and float(det) != 0.0


# ------------------------------------------ the prefix walk's bits on the card
def _chip_smoke():
    """chip_smoke.py, the on-card check, loaded by path from the repo root."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prefix_walk_bits_fixture_holds_every_case():
    """The fixture lists the cases chip_smoke.py's bit check makes, in
    order, and its K1, K2 and K4 answers agree bit for bit, as the walk's
    design has them in every entry and batch slot."""
    cs = _chip_smoke()
    want = json.loads(cs.PREFIX_BITS.read_text())
    assert [(c["m"], c["n"], c["kind"], c["q_start"], c["count"])
            for c in want] == cs.prefix_bits_cases()
    assert all(c["K1"] == c["K2"] == c["K4"] and len(c["K1"]) == 2
               for c in want)


@pytest.mark.card
def test_prefix_walk_bits_match_the_recorded_parent():
    """K1, K2 and K4 on the prefix walk answer, bit for bit, as the walk
    did before its deep step went to shuffles: the fixture holds that
    commit's answers on an H100 to the same cases (every m of the walk,
    ties, a zero, a NaN and a repeated column).  chip_smoke.py makes the
    same check on the card, where jax is not installed."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the fixture holds the card's bits")
    _chip_smoke().phase_prefix_bits()
