"""The port's DetQueue against the reference queue: identical bucketing
decisions and wire policy, the same results on the same requests, and the
concurrency contracts of ``tests/test_det_queue.py`` on the port (on the
CPU, where the kernel backend runs its plain version)."""

import threading

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.launch import det_queue as ref_q  # noqa: E402
from repro_torch.core import (DetEngine, radic_det_batched,  # noqa: E402
                              radic_det_oracle)
from repro_torch.launch.det_queue import (BucketPolicy, DetQueue,  # noqa: E402
                                          LoadShedError, QueueClosedError,
                                          Request, bucket_by_shape,
                                          pad_capacity, plan_buckets)

CPU = "cpu"
CAP = 8
SHAPES = [(1, 4), (2, 5), (2, 6), (3, 7), (3, 9), (4, 10), (4, 2)]
POLICIES = [
    dict(max_batch=4, mode="never"),
    dict(max_batch=4, mode="never", exact_capacity=False),
    dict(max_batch=8, mode="merge", col_class=4, col_max=16),
    dict(max_batch=8, mode="auto", merge_below=4, merge_depth=8),
    dict(max_batch=3, mode="auto", merge_depth=2, pin_capacity=True),
    dict(max_batch=64, mode="merge", col_class=3, col_max=9),
]


def _mats(rng, num, shapes=SHAPES):
    return [rng.normal(size=shapes[int(rng.integers(0, len(shapes)))]
                       ).astype(np.float32) for _ in range(num)]


def _decisions(plans):
    return [(p.shape, [r.seq for r in p.requests], p.capacity,
             p.merged_count, p.grad) for p in plans]


# ------------------------------------------------------------- pure planning
@pytest.mark.parametrize("pol", POLICIES)
def test_policy_wire_round_trip_from_reference(pol):
    ref_pol = ref_q.BucketPolicy(**pol)
    port = BucketPolicy.from_wire(ref_pol.to_wire())
    assert port.to_wire() == ref_pol.to_wire()
    assert ref_q.BucketPolicy.from_wire(port.to_wire()) == ref_pol
    extra = dict(ref_pol.to_wire(), unknown_field=1)
    assert BucketPolicy.from_wire(extra) == port


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pol", POLICIES)
def test_plan_buckets_decisions_equal_reference(pol, seed):
    rng = np.random.default_rng(seed)
    shapes = SHAPES + [(2, 7), (3, 16), (2, 17), (5, 5)]
    mats = _mats(rng, int(rng.integers(1, 40)), shapes)
    grads = [bool(g) for g in rng.random(len(mats)) < 0.2]
    order = rng.permutation(len(mats))  # arrival order differs from seq
    reqs = [Request(seq=int(i), array=mats[i], shape=mats[i].shape,
                    grad=grads[i]) for i in order]
    ref_reqs = [ref_q.Request(seq=int(i), array=mats[i],
                              shape=mats[i].shape, grad=grads[i])
                for i in order]
    for depth in (None, 1, 100):
        got = plan_buckets(reqs, BucketPolicy(**pol), depth)
        want = ref_q.plan_buckets(ref_reqs, ref_q.BucketPolicy(**pol), depth)
        assert _decisions(got) == _decisions(want)


def test_pure_helpers_equal_reference():
    for k in range(0, 70):
        for mb in (1, 4, 64):
            assert pad_capacity(k, mb) == ref_q.pad_capacity(k, mb)
    pol, ref_pol = BucketPolicy(col_class=4, col_max=16), \
        ref_q.BucketPolicy(col_class=4, col_max=16)
    for m in range(1, 8):
        for n in range(1, 20):
            assert pol.canonical_shape(m, n) == ref_pol.canonical_shape(m, n)
    mats = _mats(np.random.default_rng(3), 20)
    assert bucket_by_shape(mats) == ref_q.bucket_by_shape(mats)
    assert plan_buckets([], pol) == []
    with pytest.raises(ValueError):
        BucketPolicy(mode="sometimes")
    with pytest.raises(ValueError):
        BucketPolicy(max_batch=0)


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_queue_matches_reference_queue_and_oracle(backend):
    mats = _mats(np.random.default_rng(7), 40)
    pol = dict(max_batch=CAP, mode="auto", merge_depth=8)
    with DetQueue(chunk=128, policy=BucketPolicy(**pol), device=CPU,
                  backend=backend) as q:
        dets, stats = q.serve(mats, timeout=120)
    with ref_q.DetQueue(chunk=128, policy=ref_q.BucketPolicy(**pol)) as rq:
        ref_dets, ref_stats = rq.serve(mats, timeout=120)
    assert stats["completed"] == len(mats)
    assert stats["dispatches"] == ref_stats["dispatches"]
    assert stats["merged_requests"] == ref_stats["merged_requests"]
    np.testing.assert_allclose(dets, ref_dets, rtol=1e-3, atol=1e-4)
    for A, got in zip(mats, dets):
        m, n = A.shape
        want = radic_det_oracle(A) if m <= n else 0.0
        assert abs(got - want) <= 2e-3 * max(1.0, abs(want))


def _ref(A, shape, cap):
    """Single-threaded batched reference at a canonical shape + pinned
    capacity: row 0 of a zero-padded stack."""
    m, n = A.shape
    if m > n:
        return 0.0
    stack = np.zeros((cap, *shape), np.float32)
    stack[0, :m, :n] = A
    return float(radic_det_batched(torch.from_numpy(stack))[0])


@pytest.mark.parametrize("mode", ["never", "merge"])
def test_producer_threads_bit_identical(mode):
    """Racing producers, merges and splits never move a bit of a result."""
    pol = BucketPolicy(max_batch=CAP, mode=mode, pin_capacity=True)
    collected: dict[int, list] = {}
    with DetQueue(chunk=128, policy=pol, device=CPU) as q:
        def producer(pid):
            mats = _mats(np.random.default_rng(1000 + pid), 10)
            collected[pid] = [(A, q.submit(A)) for A in mats]

        threads = [threading.Thread(target=producer, args=(p,))
                   for p in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        results = [(A, f.result(timeout=120))
                   for pairs in collected.values() for A, f in pairs]
        stats = q.snapshot()
    assert stats["completed"] == stats["submitted"] == 30
    for A, val in results:
        shape = pol.canonical_shape(*A.shape) if mode == "merge" \
            else tuple(A.shape)
        assert val == _ref(A, shape, CAP), (A.shape, mode)


def test_batch_composition_invariance():
    """Unpinned capacities: a request's determinant does not depend on
    the batch it landed in (exact, as the kernel promises)."""
    rng = np.random.default_rng(11)
    mats = [rng.normal(size=(3, 8)).astype(np.float32) for _ in range(13)]
    with DetQueue(policy=BucketPolicy(max_batch=5, mode="never"),
                  device=CPU) as q:
        batched, _ = q.serve(mats, timeout=120)
        alone = [q.submit(A).result(timeout=60) for A in mats[:4]]
    assert alone == batched[:4]


def test_poll_and_close_drain_race():
    mats = [np.random.default_rng(i).normal(size=(3, 8)).astype(np.float32)
            for i in range(12)]
    q = DetQueue(device=CPU)
    got: dict[int, float] = {}

    def poller():
        while True:
            batch = q.poll(timeout=None)
            if not batch:
                return
            got.update(batch)

    t = threading.Thread(target=poller)
    t.start()
    futs = q.submit_many(mats)
    q.close()
    t.join(timeout=120)
    assert not t.is_alive(), "poller hung after close"
    assert got == {f.seq: f.result() for f in futs}


# ------------------------------------------------------------------- edges
def test_m_greater_than_n_is_zero_without_dispatch():
    with DetQueue(device=CPU) as q:
        assert q.submit(np.ones((4, 2), np.float32)).result(60) == 0.0
        stats = q.snapshot()
    assert stats["dispatches"] == 0 and stats["batches"] == 1


def test_empty_and_invalid_requests():
    with DetQueue(device=CPU) as q:
        dets, stats = q.serve([])
        assert dets == [] and stats["dispatches"] == 0
        with pytest.raises(ValueError):
            q.submit(np.zeros((2, 2, 2), np.float32))


@pytest.mark.parametrize("shape,exc", [((16, 40), OverflowError),
                                       ((17, 20), ValueError)])
def test_batch_error_fails_its_futures_and_reaches_poll(shape, exc):
    """A batch the plan rejects fails its own futures (and poll stream);
    the queue keeps serving other requests."""
    with DetQueue(device=CPU) as q:
        bad = q.submit(np.ones(shape, np.float32))
        with pytest.raises(exc):
            bad.result(timeout=120)
        responses = []
        while not responses:
            responses = q.poll(timeout=30.0)
        (seq, err), = responses
        assert seq == bad.seq and isinstance(err, exc)
        assert q.submit(np.ones((2, 4), np.float32)).result(120) == 0.0


def test_gradient_requests_are_the_next_slice():
    """Gradient requests, the slice after the value path, are served: each
    resolves to its (m, n) array, equal to the plan's own backward."""
    A = np.random.default_rng(4).normal(size=(2, 4)).astype(np.float32)
    with DetQueue(device=CPU) as q:
        one = q.submit(A, grad=True, cotangent=2.0).result(120)
        many = q.submit_many([A], [(True, 1.0)])[0].result(120)
        stats = q.snapshot()
    assert stats["submitted"] == 2 and stats["grad_dispatches"] == 2
    plan = DetEngine().plan(2, 4, capacity=1, device=CPU)
    want = plan.grad(torch.from_numpy(A[None]), torch.ones(1))[0].numpy()
    assert isinstance(many, np.ndarray) and many.shape == (2, 4)
    np.testing.assert_array_equal(many, want)
    np.testing.assert_allclose(one, 2.0 * want, rtol=1e-6, atol=1e-7)


def test_admission_control_sheds_deterministically():
    mats = [np.random.default_rng(i).normal(size=(2, 5)).astype(np.float32)
            for i in range(10)]
    with DetQueue(max_pending=4, device=CPU) as q:
        futs = q.submit_many(mats)
        shed = [f for f in futs
                if isinstance(f.exception(timeout=60), LoadShedError)]
        assert len(shed) == 6
        assert [f.seq for f in futs if f not in shed] == [0, 1, 2, 3]
        stats = q.snapshot()
    assert stats["shed"] == 6 and stats["completed"] == 4


def test_close_without_drain_and_submit_after_close():
    q = DetQueue(linger_s=30.0, device=CPU)
    futs = q.submit_many([np.ones((3, 8), np.float32)] * 3)
    q.close(drain=False)
    for f in futs:
        assert isinstance(f.exception(timeout=60), QueueClosedError)
    assert set(dict(q.poll(timeout=0))) == {f.seq for f in futs}
    with pytest.raises(QueueClosedError):
        q.submit(np.ones((1, 3), np.float32))
    q.close()
    assert not any(t.is_alive() for t in q._threads)


def test_plan_cache_bounded_under_long_tail_shapes():
    shapes = [(1, 4), (1, 5), (2, 5), (2, 6), (3, 7), (3, 8)]
    rng = np.random.default_rng(2)
    mats = [rng.normal(size=s).astype(np.float32) for s in shapes] * 2
    with DetQueue(engine=DetEngine(max_plans=2), device=CPU,
                  policy=BucketPolicy(max_batch=CAP, mode="never")) as q:
        dets, stats = q.serve(mats, timeout=120)
    info = stats["plan_cache"]
    assert info["size"] <= 2 and info["evictions"] > 0
    for A, got in zip(mats, dets):
        want = radic_det_oracle(A)
        assert abs(got - want) <= 2e-3 * max(1.0, abs(want))


def test_queue_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        DetQueue()
    with pytest.raises(ValueError):
        DetQueue(max_batch=8, policy=BucketPolicy(max_batch=64), device=CPU)
