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


def _reference_outcome(A: np.ndarray):
    """What the reference's kernel-backend queue makes of one request: its
    value, or the type of the error that fails it."""
    with ref_q.DetQueue(backend="pallas") as q:
        try:
            return float(q.submit(A).result(timeout=300))
        except (OverflowError, ValueError) as e:
            return type(e)


# The ids name the error each shape met in the port's cuda backend when it
# had kernels for m <= 16 only; (17, 20) is now served, as the reference
# serves it.
@pytest.mark.parametrize("shape", [(16, 40), (17, 20)],
                         ids=["shape0-OverflowError", "shape1-ValueError"])
def test_batch_error_fails_its_futures_and_reaches_poll(shape):
    """A batch the plan rejects fails its own futures (and poll stream)
    where the reference's queue fails them, with the same error type; a
    shape the reference serves resolves to its value.  Either way the
    queue keeps serving other requests."""
    A = np.ones(shape, np.float32)
    want = _reference_outcome(A)
    with DetQueue(device=CPU) as q:
        fut = q.submit(A)
        if isinstance(want, type):
            with pytest.raises(want):
                fut.result(timeout=120)
        else:
            assert fut.result(timeout=120) == pytest.approx(want, abs=1e-4)
        responses = []
        while not responses:
            responses = q.poll(timeout=30.0)
        (seq, got), = responses
        assert seq == fut.seq
        if isinstance(want, type):
            assert isinstance(got, want)
        else:
            assert got == fut.result()
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


# ------------------------------------------------- plan keys and prefill
@pytest.mark.parametrize("backend,ref_backend", [("cuda", "pallas"),
                                                 ("torch", "jnp")])
def test_plan_cache_counts_equal_reference(backend, ref_backend):
    """The queue keys its plans as the reference's does: the ``cuda``
    backend (the pallas counterpart) by shape alone, the ``torch``
    backend (the jnp counterpart) by shape and the batch's exact
    capacity.  So the same traffic gives the same plan-cache size, hits,
    misses and evictions."""
    mats = _mats(np.random.default_rng(11), 30, SHAPES[:4])
    pol = dict(max_batch=4, mode="never")
    with DetQueue(chunk=64, policy=BucketPolicy(**pol), device=CPU,
                  backend=backend, plan_cache=3) as q:
        for _ in range(2):
            q.serve(mats, timeout=120)
        got = q.snapshot()["plan_cache"]
    with ref_q.DetQueue(chunk=64, policy=ref_q.BucketPolicy(**pol),
                        backend=ref_backend, plan_cache=3) as rq:
        for _ in range(2):
            rq.serve(mats, timeout=300)
        want = rq.snapshot()["plan_cache"]
    keys = ("size", "hits", "misses", "evictions")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["evictions"] > 0 and got["hits"] > 0


@pytest.mark.parametrize("backend,pin", [("cuda", False), ("cuda", True),
                                         ("torch", True)])
def test_prefilled_family_is_hit_by_the_first_batch(backend, pin):
    """A family prefilled as the front ships it — ``(m, n, capacity)``
    with the policy's bound — is a plain cache hit for the first real
    batch, under the exact-capacity policy (where the ``cuda`` backend
    keys no capacity) and the pinned one."""
    from repro_torch.launch.det_front import route_key
    policy = BucketPolicy(max_batch=CAP, mode="merge", pin_capacity=pin)
    mats = _mats(np.random.default_rng(12), 3, [(2, 5)])
    with DetQueue(chunk=64, policy=policy, device=CPU,
                  backend=backend) as q:
        entry = route_key((2, 5), policy, np.float32)[:3]
        assert q.prefill([entry, ("bad",), None]) == 1
        before = q.engine.cache_info()
        dets, _ = q.serve(mats, timeout=120)
        after = q.engine.cache_info()
    assert after["misses"] == before["misses"] == 1
    assert after["hits"] == before["hits"] + 1
    for A, got in zip(mats, dets):
        want = radic_det_oracle(A)
        assert abs(got - want) <= 2e-3 * max(1.0, abs(want))


# ------------------------------------------------------------- on a mesh
def _grid(*shape, names=("data", "model")):
    from repro_torch.core import Mesh
    return Mesh(np.full(shape, CPU, dtype=object), names[:len(shape)])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_mesh_queue_and_drain_match_single_device(backend):
    """``DetQueue(mesh=...)`` and ``drain_queue(mesh=...)`` on a (2, 4)
    CPU grid answer as one device does, within the reference's
    between-backend tolerance; m > n still answers 0."""
    from repro_torch.launch.det_serve import drain_queue
    mats = _mats(np.random.default_rng(9), 24)
    pol = BucketPolicy(max_batch=CAP, mode="never")
    with DetQueue(chunk=128, policy=pol, device=CPU, backend=backend) as q:
        want, _ = q.serve(mats, timeout=120)
    with DetQueue(chunk=128, policy=pol, backend=backend,
                  mesh=_grid(2, 4)) as q:
        got, stats = q.serve(mats, timeout=120)
    assert stats["completed"] == len(mats)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    drained, _ = drain_queue(mats, chunk=128, backend=backend,
                             max_batch=CAP, mesh=_grid(2, 4))
    np.testing.assert_allclose(drained, want, rtol=1e-3, atol=1e-4)


REF_ODD_GROUP = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, numpy as np
from jax.sharding import Mesh
from repro.launch.det_queue import BucketPolicy, DetQueue
mesh = Mesh(np.array(jax.devices()), ("data",))
mats = [np.random.default_rng(i).normal(size=(2, 5)).astype(np.float32)
        for i in range(3)]
for pol in (BucketPolicy(), BucketPolicy(pin_capacity=True)):
    with DetQueue(mesh=mesh, batch_axis="data", policy=pol) as q:
        for f in q.submit_many(mats):
            try:
                print("VALUE", f.result(timeout=120))
            except ValueError as e:
                print("RAISED", "not divisible" in str(e))
"""


def test_batch_axis_with_exact_capacities_refuses_an_odd_group():
    """With ``batch_axis`` and exact capacities (the default policy) a
    group of three fails the divisibility check, in the reference's queue
    too; a pinned capacity serves it."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, "-c", REF_ODD_GROUP],
                         capture_output=True, text=True, env=env, cwd=repo,
                         timeout=300)
    lines = ref.stdout.split()
    assert lines[:6] == ["RAISED", "True"] * 3, ref.stderr[-2000:]
    assert lines[6::2] == ["VALUE"] * 3
    mats = [np.random.default_rng(i).normal(size=(2, 5)).astype(np.float32)
            for i in range(3)]
    mesh = _grid(2, names=("data",))
    with DetQueue(mesh=mesh, batch_axis="data") as q:
        for f in q.submit_many(mats):
            with pytest.raises(ValueError, match="not divisible"):
                f.result(timeout=120)
    with DetQueue(mesh=mesh, batch_axis="data",
                  policy=BucketPolicy(pin_capacity=True)) as q:
        got = [f.result(timeout=120) for f in q.submit_many(mats)]
    np.testing.assert_allclose(got, [radic_det_oracle(A) for A in mats],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, [float(v) for v in lines[7::2]],
                               rtol=1e-3, atol=1e-4)
