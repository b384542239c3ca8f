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


# -------------------------------------------------- the pipeline's timings
TIMERS = ("stage_wait_s", "stage_cpu_s", "complete_host_s", "backlog_s")
STAGER_RANGES = ("queue.plan", "queue.pack", "queue.upload", "queue.launch",
                 "queue.handoff")
COMPLETER_RANGES = ("queue.unpack", "queue.deliver")
# a card's only: the stager's copy back behind the kernel and the
# completer's wait on the batch's event; none on the CPU
CARD_RANGES = ("queue.copy_back", "queue.device_wait")


def _timed_queue():
    """A torch-backend queue whose stager blocks on a one-deep pipeline."""
    return DetQueue(device=CPU, backend="torch", pipeline_depth=1,
                    policy=BucketPolicy(max_batch=4, mode="never"))


def _burst(q, num=48):
    """Values and every 4th a gradient, all of m <= n, so that every
    batch goes through the stager and the completer."""
    mats = _mats(np.random.default_rng(21), num, SHAPES[:-1])
    grads = [(k % 4 == 0, 1.0) for k in range(num)]
    for f in q.submit_many(mats, grads):
        f.result(timeout=120)


def test_pipeline_timers_bound_each_other():
    with _timed_queue() as q:
        _burst(q)
        st = q.snapshot()
        q.reset_stats()
        zero = q.snapshot()
    assert "complete_s" not in st
    assert 0 < st["stage_wait_s"] <= st["stage_s"]
    # two clocks over one interval: a CPU cannot run past the wall
    assert 0 < st["stage_cpu_s"] <= st["stage_s"] + 5e-3
    assert st["complete_host_s"] > 0
    waits = sum(b["wait_s"] for b in st["buckets"].values())
    assert 0 <= st["backlog_s"] <= waits
    assert all(zero[k] == 0.0 for k in TIMERS + ("stage_s",))


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    with _timed_queue() as q:
        _burst(q)
        assert entered == []
        # a profiler of the calling thread alone: entered, not recorded
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            _burst(q)
    assert set(STAGER_RANGES + COMPLETER_RANGES) <= set(entered)


def test_ranges_lie_on_the_pipeline_threads_and_never_overlap():
    from torch._C._profiler import _ExperimentalConfig
    all_threads = _ExperimentalConfig(profile_all_threads=True)
    with _timed_queue() as q:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                experimental_config=all_threads) as prof:
            with torch.profiler.record_function("test.caller"):
                _burst(q)
    spans: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("queue.", "test.caller")):
            spans.setdefault(e.name(), []).append(
                (e.start_thread_id(), e.start_ns(), e.end_ns()))
    (caller, _, _), = spans.pop("test.caller")
    assert set(spans) == set(STAGER_RANGES + COMPLETER_RANGES)
    assert not set(spans) & set(CARD_RANGES)
    threads = {name: {t for t, _, _ in s} for name, s in spans.items()}
    stager = set.union(*(threads[n] for n in STAGER_RANGES))
    completer = set.union(*(threads[n] for n in COMPLETER_RANGES))
    assert len(stager) == len(completer) == 1 and stager != completer
    assert caller not in stager | completer
    by_thread: dict[int, list] = {}
    for s in spans.values():
        for t, a, b in s:
            by_thread.setdefault(t, []).append((a, b))
    for ivs in by_thread.values():
        ivs.sort()
        assert all(b0 <= a1 for (_, b0), (a1, _) in zip(ivs, ivs[1:]))


# ------------------------------------------------------ the copy back
def test_no_copy_back_is_enqueued_on_the_cpu():
    """The CPU backends keep the answers on the host: no batch comes back
    through an enqueued copy, and ``reset_stats`` zeroes the count."""
    with _timed_queue() as q:
        _burst(q)
        st = q.snapshot()
        q.reset_stats()
        zero = q.snapshot()
    assert st["dispatches"] > 0 and st["grad_dispatches"] > 0
    assert st["async_copies"] == 0
    assert zero["async_copies"] == 0 and zero["dispatches"] == 0


def test_delivered_gradients_outlive_a_reused_output_buffer(monkeypatch):
    """Gradient arrays are delivered as host copies: they keep their
    values after 20 later batches of the same shape went through, even
    where every batch's answers land in one reused buffer (as a pinned
    buffer from the caching host allocator is reused), and no two of
    them share memory."""
    reused: dict[tuple, torch.Tensor] = {}
    plan_of = DetQueue._plan

    class OneBuffer:
        def __init__(self, exe):
            self.exe = exe

        def __call__(self, A):
            return self.exe(A)

        def grad(self, A, ct):
            out = self.exe.grad(A, ct)
            buf = reused.setdefault(tuple(out.shape), torch.empty_like(out))
            return buf.copy_(out)

    monkeypatch.setattr(DetQueue, "_plan",
                        lambda self, *a: OneBuffer(plan_of(self, *a)))
    rng = np.random.default_rng(5)
    pol = BucketPolicy(max_batch=4, mode="never", pin_capacity=True)

    def batch():
        return [rng.normal(size=(3, 7)).astype(np.float32) for _ in range(4)]

    with DetQueue(device=CPU, policy=pol) as q:
        mats = batch()
        first = [f.result(timeout=120)
                 for f in q.submit_many(mats, [(True, 1.0)] * 4)]
        kept = [g.copy() for g in first]
        for _ in range(20):
            for f in q.submit_many(batch(), [(True, 1.0)] * 4):
                f.result(timeout=120)
        st = q.snapshot()
    assert st["grad_dispatches"] == 21 and len(reused) == 1
    plan = DetEngine().plan(3, 7, capacity=4, device=CPU)
    want = plan.grad(torch.from_numpy(np.stack(mats)), torch.ones(4))
    for g, k, w in zip(first, kept, want.numpy()):
        assert g.shape == (3, 7)
        np.testing.assert_array_equal(g, k)
        np.testing.assert_array_equal(g, w)
    assert not any(np.shares_memory(a, b)
                   for i, a in enumerate(first) for b in first[i + 1:])
    assert not any(np.shares_memory(g, buf.numpy())
                   for g in first for buf in reused.values())


@pytest.mark.card
def test_on_the_card_answers_come_back_through_the_stager_s_copy():
    """On a card every batch's answers come back through the copy the
    stager enqueued behind its kernel, and equal the batched evaluator's
    on the same padded stack bit for bit, values and gradients."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the copy back into pinned memory is a "
                    "card's only")
    rng = np.random.default_rng(9)
    shapes, cap, num = [(3, 8), (5, 24), (8, 32)], 16, 30
    mats = [rng.normal(size=shapes[k % 3]).astype(np.float32)
            for k in range(num)]
    grads = [(k % 4 == 1, 1.0) for k in range(num)]
    pol = BucketPolicy(max_batch=cap, mode="never", pin_capacity=True)
    with DetQueue(policy=pol, device="cuda") as q:
        got = [f.result(timeout=600) for f in q.submit_many(mats, grads)]
        st = q.snapshot()
    assert st["dispatches"] == 6 and st["async_copies"] == st["dispatches"]
    for shape in shapes:
        for grad in (False, True):
            idx = [k for k in range(num)
                   if mats[k].shape == shape and grads[k][0] == grad]
            stack = torch.zeros((cap, *shape))
            stack[:len(idx)] = torch.from_numpy(np.stack([mats[k]
                                                          for k in idx]))
            stack = stack.cuda().requires_grad_(grad)
            dets = radic_det_batched(stack, device="cuda")
            if grad:
                ct = torch.zeros(cap, device="cuda")
                ct[:len(idx)] = 1.0
                want = torch.autograd.grad(dets, stack, ct)[0].cpu().numpy()
                for j, k in enumerate(idx):
                    np.testing.assert_array_equal(got[k], want[j])
            else:
                want = dets.cpu().tolist()
                assert [got[k] for k in idx] == want[:len(idx)]
    arrays = [g for g in got if isinstance(g, np.ndarray)]
    assert not any(np.shares_memory(a, b)
                   for i, a in enumerate(arrays) for b in arrays[i + 1:])
