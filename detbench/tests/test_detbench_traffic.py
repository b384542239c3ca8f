"""The generator: seed-independent work, seed-determined matrices."""

import hashlib

import numpy as np
import pytest

from conftest import radic_mixes
from detbench.traffic import (BLOCK_ROUNDS, Sampler, Traffic,
                              load_workload, workload_from_dict)

# every Radic traffic mix kept, a cell's or one kept for a later cell
CELLS = radic_mixes()
SEEDS = (0, 7, 2**31 + 11, 2**33 + 5, -3)


@pytest.mark.parametrize("cell", CELLS)
def test_shape_sequence_and_kinds_do_not_depend_on_the_seed(cell):
    w = load_workload(cell)
    ks = range(0, 3 * BLOCK_ROUNDS * len(w.shapes), 97)
    want = [(Traffic(w, 1).shape(k), Traffic(w, 1).is_grad(k)) for k in ks]
    for seed in SEEDS:
        t = Traffic(w, seed)
        assert [(t.shape(k), t.is_grad(k)) for k in ks] == want
        assert all(t.matrix(k).shape == t.shape(k) for k in ks)


def test_matrices_are_made_by_the_seed():
    w = load_workload("narrow.values")
    ks = [0, 5, 36 * BLOCK_ROUNDS + 3, 5 * 36 * BLOCK_ROUNDS + 40]
    for seed in SEEDS:
        a, b = Traffic(w, seed), Traffic(w, seed)
        for k in reversed(ks):
            b.matrix(k)     # another order of blocks gives the same
        assert all(np.array_equal(a.matrix(k), b.matrix(k)) for k in ks)
        assert a.matrix(0).dtype == np.float32
    assert not np.array_equal(Traffic(w, 1).matrix(0),
                              Traffic(w, 2).matrix(0))
    assert not np.array_equal(Traffic(w, 3).matrix(0),
                              Traffic(w, -3).matrix(0))


@pytest.mark.parametrize("cell", ["narrow.values", "wide.near"])
def test_no_request_repeats_a_matrix(cell):
    w = load_workload(cell)
    t = Traffic(w, 2**33 + 1)
    n = 3 * BLOCK_ROUNDS * len(w.shapes)
    mats, _ = t.requests(0, n)
    digests = {hashlib.sha1(a.tobytes()).digest() for a in mats}
    assert len(digests) == n
    warm, _ = t.warm_requests(4)
    assert not {hashlib.sha1(a.tobytes()).digest() for a in warm} & digests


def test_every_fourth_request_of_every_shape_is_a_gradient():
    w = load_workload("narrow.mixed")
    t = Traffic(w, 0)
    S = len(w.shapes)
    grads = np.array([t.is_grad(k) for k in range(8 * S)]).reshape(8, S)
    assert (grads.sum(0) == 2).all()           # each shape: 1 in 4 rounds
    assert (grads.sum(1) == S // 4).all()      # each round: 1 in 4 shapes
    mats, kinds = t.requests(0, 8)
    assert [g for g, _ in kinds] == [t.is_grad(k) for k in range(8)]
    assert all(ct == 1.0 for g, ct in kinds if g)


def test_the_sample_is_drawn_by_the_seed_not_by_the_answer_order():
    w = load_workload("narrow.mixed")
    t = Traffic(w, 5)
    ks = list(range(3 * BLOCK_ROUNDS * len(w.shapes)))
    a, b = Sampler(t), Sampler(t)
    for k in ks:
        a.offer(k, k)
    for k in reversed(ks):
        b.offer(k, k)
    chosen = a.chosen()
    assert chosen == b.chosen()
    kinds = {(k % t.S, t.is_grad(k)) for k in chosen}
    assert len(kinds) == 2 * len(w.shapes)
    assert len(chosen) == 2 * len(w.shapes) * w.check_per_shape
    other = Sampler(Traffic(w, 6))
    for k in ks:
        other.offer(k)
    assert set(other.chosen()) != set(chosen)


@pytest.mark.parametrize("bad", [
    {"config": "c", "loop": "burst", "shapes": [[2, 3]], "outstanding": 1},
    {"config": "c", "shapes": [[3, 2]], "outstanding": 1},
    {"config": "c", "shapes": [[2, 3], [2, 3]], "outstanding": 1},
    {"config": "c", "shapes": [[2, 3]]},
    {"config": "c", "loop": "open", "shapes": [[2, 3]]},
    {"config": "c", "shapes": [[2, 3]], "outstanding": 1,
     "check_per_shape": 0},
])
def test_a_malformed_workload_is_refused(bad):
    with pytest.raises(ValueError):
        workload_from_dict("bad", bad)
