"""The port's host combinatorics against the reference, exactly: Pascal
tables, ``comb``, unranking/ranking/successor (host Python and the
vectorized torch walk vs the reference's ``*_jnp``), and the paper's own
artifacts (Example 1, Table 1, Table 2)."""

import itertools

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core import oracle as ref_oracle  # noqa: E402
from repro.core import paper_reference as ref_paper  # noqa: E402
from repro.core import pascal as ref_pascal  # noqa: E402
from repro.core import unrank as ref_unrank  # noqa: E402
from repro_torch.core import (combinations_lex, combinatorial_addition,  # noqa: E402
                              first_member, grain_sequence, last_member)
from repro_torch.core import pascal, unrank  # noqa: E402

NM_SMALL = [(n, m) for n in range(1, 10) for m in range(1, n + 1)]
NM_WALK = [(8, 5), (6, 3), (10, 2), (12, 6), (5, 5), (9, 1), (16, 3),
           (14, 7), (20, 4), (30, 10)]


@pytest.mark.parametrize("n,m", [(8, 5), (12, 6), (33, 4), (40, 10),
                                 (40, 30), (60, 20), (1, 1), (5, 0)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_binom_table_equals_reference(n, m, dtype):
    def build(mod):
        try:
            return mod.binom_table(n, m, dtype=dtype)
        except OverflowError as e:
            return type(e)
    want, got = build(ref_pascal), build(pascal)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got is want


def test_true_peak_table_guard():
    """C(40,30) fits int32 but the table's mid column C(40,20) does not:
    both packages raise rather than wrap."""
    assert pascal.comb(40, 30) < pascal.INT32_MAX < pascal.comb(40, 20)
    for mod in (ref_pascal, pascal):
        with pytest.raises(OverflowError):
            mod.binom_table(40, 30, dtype=np.int32)
    np.testing.assert_array_equal(
        pascal.binom_table(40, 30, dtype=np.int64),
        ref_pascal.binom_table(40, 30, dtype=np.int64))


def test_comb_and_paper_table_equal_reference():
    for n in range(-1, 25):
        for k in range(-1, 26):
            assert pascal.comb(n, k) == ref_pascal.comb(n, k)
    for n, m in [(8, 5), (10, 3), (4, 4), (3, 5)]:
        np.testing.assert_array_equal(pascal.paper_table(n, m),
                                      ref_pascal.paper_table(n, m))
    assert pascal.INT32_MAX == ref_pascal.INT32_MAX


@pytest.mark.parametrize("n,m", NM_SMALL)
def test_host_walks_equal_reference_exhaustively(n, m):
    for q in range(pascal.comb(n, m)):
        combo = unrank.unrank_py(q, n, m)
        assert combo == ref_unrank.unrank_py(q, n, m)
        assert unrank.rank_py(combo, n, m) == q
        assert unrank.successor_py(combo, n) == \
            ref_unrank.successor_py(combo, n)
        assert combinatorial_addition(q, n, m) == combo
    assert first_member(m) == ref_unrank.first_member(m)
    assert last_member(n, m) == ref_unrank.last_member(n, m)


@pytest.mark.parametrize("n,m", NM_WALK)
def test_torch_walks_equal_reference_jnp(n, m):
    total = pascal.comb(n, m)
    rng = np.random.default_rng(n * 100 + m)
    qs = np.unique(np.concatenate([
        [0, total - 1], rng.integers(0, total, size=64)])).astype(np.int32)
    want = np.asarray(ref_unrank.unrank_jnp(jnp.asarray(qs), n, m))
    got = unrank.unrank_torch(torch.from_numpy(qs), n, m)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    back_want = np.asarray(ref_unrank.rank_jnp(jnp.asarray(want), n, m))
    back = unrank.rank_torch(got, n, m)
    np.testing.assert_array_equal(back.numpy(), back_want)
    np.testing.assert_array_equal(back.numpy(), qs)
    succ_want = np.asarray(ref_unrank.successor_jnp(jnp.asarray(want), n))
    succ = unrank.successor_torch(got, n)
    np.testing.assert_array_equal(succ.numpy(), succ_want)


@pytest.mark.parametrize("n,m", [(40, 16), (44, 10), (60, 30)])
def test_torch_walk_int64_ranks_past_int32(n, m):
    """The torch walk runs on int64 ranks, like the reference under x64:
    ranks past 2**31 unrank exactly (checked against the bigint path)."""
    total = pascal.comb(n, m)
    assert total > pascal.INT32_MAX
    qs = [0, 2**31 - 1, 2**31, 2**31 + 12345, total // 2, total - 1]
    got = unrank.unrank_torch(torch.tensor(qs, dtype=torch.int64), n, m)
    want = [ref_unrank.unrank_py(q, n, m) for q in qs]
    assert [tuple(r) for r in got.tolist()] == want
    assert unrank.rank_torch(got, n, m).tolist() == qs


def test_unrank_torch_accepts_int32_table():
    """An int32 table (the kernel's) gives the same walk as int64."""
    n, m = 12, 5
    qs = torch.arange(pascal.comb(n, m))
    t32 = torch.as_tensor(pascal.binom_table(n, m, dtype=np.int32))
    assert torch.equal(unrank.unrank_torch(qs, n, m, t32),
                       unrank.unrank_torch(qs, n, m))


def test_example_1_and_table_2():
    """Paper Example 1 (q=49, n=8, m=5 -> [2,5,6,7,8]) and Table 2."""
    assert combinatorial_addition(49, 8, 5) == (2, 5, 6, 7, 8)
    assert unrank.unrank_py(49, 8, 5) == (2, 5, 6, 7, 8)
    combos = combinations_lex(8, 5)
    assert combos == ref_oracle.combinations_lex(8, 5)
    assert len(combos) == 56
    for q, c in enumerate(combos):
        assert combinatorial_addition(q, 8, 5) == c
        assert ref_paper.combinatorial_addition(q, 8, 5) == c
    got = unrank.unrank_torch(torch.arange(56), 8, 5)
    assert [tuple(r) for r in got.tolist()] == combos
    T = pascal.paper_table(8, 5)
    assert T[4, 2] == pascal.comb(7, 4) == 35
    assert T[3, 1] == pascal.comb(5, 3) == 10


@pytest.mark.parametrize("start,count", [(37, 10), (0, 126), (120, 10)])
def test_grain_sequence_equals_reference(start, count):
    s = unrank.unrank_py(start, 9, 4)
    assert grain_sequence(s, count, 9) == \
        ref_paper.grain_sequence(s, count, 9)
    want = list(itertools.combinations(range(1, 10), 4))[start:start + count]
    assert grain_sequence(s, count, 9) == want
