"""The yardstick's operation counts."""

import itertools
from math import comb

import pytest

from conftest import radic_mixes
from detbench import work
from detbench.traffic import load_workload

# every Radic traffic mix kept, a cell's or one kept for a later cell
CELLS = radic_mixes()


def prefix_tree_flops(m: int, n: int) -> int:
    """The prefix walk's count by brute force: every elimination prefix
    (a sorted column tuple of length 1..m-1 that some m-combination
    starts with) once, and every leaf."""
    total = 4 * comb(n, m)
    for k in range(1, m):
        rows = m - k
        for pre in itertools.combinations(range(n), k):
            if pre[-1] <= n - m + k - 1:    # m - k columns still fit after
                c = pre[-1]
                total += 2 * rows * (n - 1 - c) + 5 * rows + 2
    return total


@pytest.mark.parametrize("m,n", [(1, 1), (1, 5), (2, 4), (3, 7), (4, 9),
                                 (5, 10), (6, 6), (5, 12)])
def test_prefix_walk_flops_is_the_prefix_tree(m, n):
    assert work.prefix_walk_flops(m, n) == prefix_tree_flops(m, n)


@pytest.mark.parametrize("cell", CELLS)
def test_least_work_at_most_the_per_minor_count(cell):
    for m, n in load_workload(cell).shapes:
        per_minor = comb(n, m) * work.ge_flops(m)
        assert 0 < work.value_flops(m, n) <= per_minor
        assert work.gradient_flops(m, n) == comb(n, m) * work.grad_flops(m)


def test_least_seconds_takes_the_larger_bound():
    t, which = work.least_seconds(67e12, 1.0)
    assert t == pytest.approx(1.0) and which == "operations"
    t, which = work.least_seconds(1.0, 3.35e12)
    assert t == pytest.approx(1.0) and which == "bytes"


def test_answer_work_counts_each_byte_once():
    ops, nbytes = work.answer_work(3, 5, grad=False)
    assert nbytes == 4 * (3 * 5 + 1) and ops == work.value_flops(3, 5)
    ops, nbytes = work.answer_work(3, 5, grad=True)
    assert nbytes == 4 * (2 * 3 * 5 + 1)
    assert work.answer_work(4, 3, grad=False)[0] == 0
