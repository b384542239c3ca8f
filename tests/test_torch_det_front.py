"""Twin of ``tests/test_det_front.py`` for the port's serving front
(``repro_torch.launch.det_front``), on the CPU (``device="cpu"``: the
workers run the kernels' plain versions), the two warm-start tests over
the plan store included (the module's shared front has a store, so its
snapshot counts store hits and misses).  Added here: the front held to
the reference's in-process ``DetQueue`` on the same seeded inputs, the
card check made before any process starts, and a worker whose queue
cannot be built answering with ``WorkerError``.

The reference's battery:

The load-bearing invariant mirrors the DetQueue battery one level up:
per-request results are independent of *which worker* served them and
of any re-routing that happened along the way.  With capacity pinned
and the merge policy fixed, a request's determinant through a 2-worker
``DetFront`` is bit-identical to the single-process ``DetQueue`` — and
stays bit-identical when the owning worker is SIGKILLed mid-flight and
its pending requests re-plan on the survivor (plans are pure functions
of their key).

Worker processes spawn real torch-importing children; the module keeps
the request counts small, shares policies and reuses one 2-worker front
(``shared_front``) where a test leaves its workers alive, so the battery
stays CI-sized.
"""

import numpy as np
import pytest

from repro_torch.core import comb
from repro_torch.core.engine import stable_key_hash
from repro_torch.launch import transport as T
from repro_torch.launch.det_front import (DetFront, HashRing, WorkerError,
                                          route_key)
from repro_torch.launch.det_queue import (BucketPolicy, DetQueue,
                                          LoadShedError, QueueClosedError)

CHUNK = 128
DEV = "cpu"
CAP = 8
# the DetQueue battery's heterogeneous pool, incl. one m > n degenerate
SHAPES = [(1, 4), (2, 5), (2, 6), (3, 7), (3, 9), (4, 10), (4, 2)]

PINNED = BucketPolicy(max_batch=CAP, mode="merge", pin_capacity=True)


def _mats(rng, num):
    out = []
    for _ in range(num):
        m, n = SHAPES[int(rng.integers(0, len(SHAPES)))]
        out.append(rng.normal(size=(m, n)).astype(np.float32))
    return out


def _queue_reference(mats, policy=PINNED):
    """The single-process ground truth for a request set."""
    with DetQueue(chunk=CHUNK, policy=policy, device=DEV) as q:
        dets, _ = q.serve(mats, timeout=300)
    return dets


@pytest.fixture(autouse=True)
def _restore_kernel_store_dir(monkeypatch):
    """A queue opened over a plan store points the kernel build at it,
    process-wide: put the setting back after every test."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "_store_dir", _build._store_dir)


@pytest.fixture(scope="module")
def _front2(tmp_path_factory):
    with DetFront(workers=2, chunk=CHUNK, policy=PINNED, device=DEV,
                  persist_dir=str(tmp_path_factory.mktemp("plans"))) \
            as front:
        yield front


@pytest.fixture
def shared_front(_front2):
    """The module's 2-worker front, with its response stream drained and
    its counters zeroed (the workers order the reset before any later
    batch)."""
    assert _front2.alive_workers == [0, 1]
    _front2.poll(timeout=0)
    _front2.reset_stats()
    return _front2


# --------------------------------------------------------------- pure pieces
def test_stable_key_hash_is_process_stable():
    """The ring hash must not depend on PYTHONHASHSEED — pin a value so
    any accidental fallback to builtin hash() fails loudly."""
    key = (3, 9, 8, "float32", False)
    assert stable_key_hash(key) == stable_key_hash(tuple(key))
    assert stable_key_hash(key) != stable_key_hash((3, 9, 8, "float64",
                                                    False))
    import pathlib
    import subprocess
    import sys
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run(
        [sys.executable, "-c",
         "from repro_torch.core.engine import stable_key_hash;"
         "print(stable_key_hash((3, 9, 8, 'float32', False)))"],
        capture_output=True, text=True,
        env={"PYTHONPATH": src, "PYTHONHASHSEED": "12345"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == stable_key_hash(key)


def test_route_key_projects_policy_canonical_shape():
    merge = BucketPolicy(max_batch=8, mode="merge", col_class=4, col_max=16)
    never = BucketPolicy(max_batch=8, mode="never")
    # merging policies route by canonical shape: everything that could
    # coalesce must share one owner
    assert route_key((2, 5), merge, np.float32) \
        == route_key((2, 6), merge, np.float32) \
        == (2, 8, 8, "float32", False)
    # exact-shape policies route exact
    assert route_key((2, 5), never, np.float32) \
        != route_key((2, 6), never, np.float32)
    # the dtype selects the program family; float64 is the x64 family
    assert route_key((2, 5), never, np.float32) \
        != route_key((2, 5), never, np.float64)
    assert route_key((2, 5), never, np.float64) == \
        (2, 5, 8, "float64", True)


def test_hash_ring_consistency_on_removal():
    """Removing one worker moves only the keys it owned; every other
    key keeps its owner — the consistent-hashing property that makes
    re-routing deterministic and minimal."""
    ring = HashRing([0, 1, 2], vnodes=64)
    keys = [(m, n, 8, "float32", False) for m in range(1, 6)
            for n in range(m, 12)]
    before = {k: ring.owner(k) for k in keys}
    ring.remove(1)
    after = {k: ring.owner(k) for k in keys}
    for k in keys:
        if before[k] != 1:
            assert after[k] == before[k]
        else:
            assert after[k] != 1
    # walk order: first element is the owner, all workers appear once
    ring2 = HashRing([0, 1, 2], vnodes=64)
    for k in keys:
        w = ring2.walk(k)
        assert w[0] == ring2.owner(k) and sorted(w) == [0, 1, 2]


def test_hash_ring_empty_and_validation():
    with pytest.raises(RuntimeError):
        HashRing([]).owner((1, 2, 3))
    with pytest.raises(ValueError):
        HashRing([0], vnodes=0)
    assert HashRing([]).walk((1, 2, 3)) == []


# ------------------------------------------------------------- bit identity
@pytest.mark.parametrize("workers", [1, 2])
def test_front_bit_identical_to_single_queue(workers, rng, request):
    """The tentpole invariant: the same request set produces identical
    bits through DetQueue (1 process) and DetFront (1 and 2 workers)."""
    mats = _mats(rng, 30)
    want = _queue_reference(mats)
    if workers == 2:
        front = request.getfixturevalue("shared_front")
        got, stats = front.serve(mats, timeout=300)
    else:
        with DetFront(workers=workers, chunk=CHUNK, policy=PINNED,
                      device=DEV) as front:
            got, stats = front.serve(mats, timeout=300)
            assert front.alive_workers == list(range(workers))
    assert got == want
    assert stats["front"]["submitted"] == 30
    assert stats["total"]["completed"] == 30
    assert stats["front"]["worker_deaths"] == 0


@pytest.mark.parametrize("workers,shm", [(1, False), (2, False), (2, True)])
def test_front_grad_bit_identical_to_single_queue(workers, shm, rng,
                                                  request):
    """Gradient traffic extends the tentpole invariant (DESIGN_GRAD.md):
    a mixed value/grad burst with nonuniform cotangents produces
    bit-identical results through DetFront — local and zero-copy shm
    transports — as through the 1-process DetQueue.  Grad results are
    (m, n) arrays; every bit must survive the wire."""
    mats = _mats(rng, 20)
    grads = [(i % 3 == 0, [1.0, -2.0, 0.5, 1.5][i % 4])
             for i in range(len(mats))]
    with DetQueue(chunk=CHUNK, policy=PINNED, device=DEV) as q:
        want = [f.result(timeout=300)
                for f in q.submit_many(mats, grads)]
    if (workers, shm) == (2, False):
        front = request.getfixturevalue("shared_front")
        got = [f.result(timeout=300)
               for f in front.submit_many(mats, grads)]
    else:
        with DetFront(workers=workers, chunk=CHUNK, policy=PINNED,
                      shm=shm, device=DEV) as front:
            got = [f.result(timeout=300)
                   for f in front.submit_many(mats, grads)]
    for i, (g, w) in enumerate(zip(got, want)):
        if grads[i][0]:
            assert isinstance(g, np.ndarray)
            assert g.shape == mats[i].shape
            np.testing.assert_array_equal(g, w)  # bit identity, no tol
        else:
            assert g == w


def test_front_worker_kill_reroutes_bit_identical(rng):
    """SIGKILL the worker that owns a hot shape while its requests are
    pending: the front must detect the death, re-route the orphans to
    the survivor, and still deliver bit-identical results for every
    request (plans are pure functions of the key)."""
    mats = _mats(rng, 40)
    want = _queue_reference(mats)
    with DetFront(workers=2, chunk=CHUNK, policy=PINNED,
                  device=DEV) as front:
        victim = front.owner_of((3, 9))
        futs = front.submit_many(mats)
        front.kill_worker(victim)
        got = [f.result(timeout=300) for f in futs]
        stats = front.snapshot()
        assert front.alive_workers == [1 - victim]
    assert got == want
    assert stats["front"]["worker_deaths"] == 1
    # the kill landed before the first result could possibly complete
    # (cold compile takes far longer than the submit->kill window), so
    # the victim's routed share was actually re-routed
    assert stats["front"]["rerouted"] > 0
    # the front delivered every request exactly once (the dead worker's
    # own counters died with it; the front's view is authoritative)
    assert stats["front"]["completed"] == 40


def test_front_retire_worker_drains_and_requeues(rng):
    """The graceful-downscale path: retire_worker hands the un-staged
    backlog back via DetQueue.drain_pending, the ring drops the worker,
    and everything still resolves bit-identically on the survivor."""
    mats = [rng.normal(size=(3, 7)).astype(np.float32) for _ in range(16)]
    want = _queue_reference(mats)
    # linger keeps the worker's backlog un-staged long enough for the
    # retire to deterministically catch requests in drain_pending
    with DetFront(workers=2, chunk=CHUNK, policy=PINNED,
                  linger_s=3.0, device=DEV) as front:
        victim = front.owner_of((3, 7))
        futs = front.submit_many(mats)
        front.retire_worker(victim)
        got = [f.result(timeout=300) for f in futs]
        stats = front.snapshot()
        assert front.alive_workers == [1 - victim]
    assert got == want
    assert stats["front"]["worker_deaths"] == 0  # clean exit, not a death
    assert stats["front"]["rerouted"] > 0


def test_front_all_workers_dead_fails_pending(rng):
    mats = [rng.normal(size=(3, 9)).astype(np.float32) for _ in range(8)]
    front = DetFront(workers=1, chunk=CHUNK, policy=PINNED, device=DEV)
    try:
        futs = front.submit_many(mats)
        front.kill_worker(0)
        for f in futs:
            with pytest.raises(RuntimeError):
                f.result(timeout=120)
        with pytest.raises(RuntimeError):
            front.submit(mats[0])
    finally:
        front.close()


# ------------------------------------------------ ownership and balance
def test_plan_ownership_is_exclusive_and_sticky(rng):
    """Every shape's plan family lives on exactly one worker: the
    aggregated pool plan-cache misses equal the number of distinct
    program families — no duplicated XLA compiles across the pool."""
    shapes = [(2, 5), (3, 7), (3, 9), (4, 10)]
    mats = [rng.normal(size=shapes[i % 4]).astype(np.float32)
            for i in range(32)]
    with DetFront(workers=2, chunk=CHUNK, policy=PINNED,
                  device=DEV) as front:
        owners = {s: front.owner_of(s) for s in shapes}
        front.serve(mats, timeout=300)
        stats = front.snapshot()
        assert {s: front.owner_of(s) for s in shapes} == owners  # sticky
    # merge policy canonicalizes (2,5)->(2,8), (3,7)/(3,9)->(3,12)...
    families = {route_key(s, PINNED, np.float32) for s in shapes}
    assert stats["total"]["plan_cache"]["misses"] == len(families)
    per_worker_sizes = [snap["plan_cache"]["size"]
                        for snap in stats["workers"].values()]
    assert sum(per_worker_sizes) == len(families)


def test_bounded_load_placement_splits_equal_families():
    """With K equal-weight plan families and N workers, bounded-load
    placement may not park more than (1 + eps) * K/N weight on any one
    worker — the raw-arc split that motivated it routinely does."""
    with DetFront(workers=2, chunk=CHUNK, device=DEV,
                  policy=BucketPolicy(max_batch=CAP, mode="never")) as front:
        shapes = [(3, n) for n in range(8, 24)]  # 16 families
        for s in shapes:
            front.owner_of(s)
        loads = front.snapshot(timeout=60)["front"]["plan_load"]
    total = sum(loads.values())
    assert len(loads) == 2 and total > 0
    assert max(loads.values()) <= total * (1 + front._balance_eps) / 2 \
        + max(comb(n, 3) for _, n in shapes)


# ------------------------------------------------------ queue-surface parity
def test_front_loadshed_propagates_end_to_end(rng):
    """Per-worker admission control must surface as LoadShedError on the
    front's futures AND its poll stream, exactly once per request."""
    A = rng.normal(size=(2, 5)).astype(np.float32)
    with DetFront(workers=2, chunk=CHUNK, max_pending=2, device=DEV,
                  policy=BucketPolicy(max_batch=CAP,
                                      pin_capacity=True)) as front:
        futs = front.submit_many([A] * 10)  # one shape -> one worker
        excs = [f.exception(timeout=120) for f in futs]
        served = [f for f, e in zip(futs, excs) if e is None]
        shed = [f for f, e in zip(futs, excs)
                if isinstance(e, LoadShedError)]
        assert len(served) == 2 and len(shed) == 8
        by_seq = {}
        while len(by_seq) < 10:
            got = front.poll(timeout=60.0)
            assert got, "poll timed out with responses outstanding"
            by_seq.update(got)
        stats = front.snapshot()
    assert set(by_seq) == {f.seq for f in futs}
    assert sum(isinstance(v, LoadShedError) for v in by_seq.values()) == 8
    assert stats["front"]["shed"] == 8 and stats["total"]["shed"] == 8


def test_front_error_propagates_with_type(rng):
    """A worker-side plan-time failure (C(40,16) overflowing int32)
    surfaces as the same exception type on the front future; the pool
    keeps serving other requests."""
    with DetFront(workers=2, chunk=CHUNK, policy=PINNED,
                  device=DEV) as front:
        bad = front.submit(np.ones((16, 40), np.float32))
        with pytest.raises(OverflowError):
            bad.result(timeout=300)
        ok = front.submit(np.ones((4, 2), np.float32))  # m > n => 0
        assert ok.result(timeout=300) == 0.0
        stats = front.snapshot()
    assert stats["front"]["errors"] == 1


def test_worker_error_rebuild_fallback():
    from repro_torch.launch.det_front import _rebuild_exc
    assert isinstance(_rebuild_exc("OverflowError", "x"), OverflowError)
    assert isinstance(_rebuild_exc("LoadShedError", "x"), LoadShedError)
    exc = _rebuild_exc("SomeExoticError", "boom")
    assert isinstance(exc, WorkerError) and "SomeExoticError" in str(exc)


def test_front_poll_stream_exactly_once(rng, shared_front):
    mats = _mats(rng, 20)
    front = shared_front
    futs = front.submit_many(mats)
    by_seq = {}
    while len(by_seq) < len(mats):
        got = front.poll(timeout=60.0)
        assert got, "poll timed out with responses outstanding"
        by_seq.update(got)
    assert by_seq == {f.seq: f.result() for f in futs}


def test_front_close_idempotent_and_rejects_submits(rng):
    front = DetFront(workers=1, chunk=CHUNK, policy=PINNED, device=DEV)
    fut = front.submit(rng.normal(size=(2, 5)).astype(np.float32))
    front.close()
    assert fut.done()  # close drains accepted work before stopping
    with pytest.raises(QueueClosedError):
        front.submit(np.ones((2, 5), np.float32))
    front.close()  # idempotent
    # the request's response is still pollable after close, then the
    # stream ends cleanly (no hang) even with timeout=None semantics
    assert front.poll(timeout=0.0) == [(fut.seq, fut.result())]
    assert front.poll(timeout=0.0) == []


def test_front_validation():
    with pytest.raises(ValueError):
        DetFront(workers=0, device=DEV)
    with pytest.raises(ValueError):
        DetFront(workers=1, max_batch=8, device=DEV,
                 policy=BucketPolicy(max_batch=64))


def test_front_stats_aggregation_shape(rng, shared_front):
    mats = _mats(rng, 12)
    shared_front.serve(mats, timeout=300)
    stats = shared_front.snapshot()
    f, tot, per = stats["front"], stats["total"], stats["workers"]
    assert f["submitted"] == 12 and sum(f["routed"].values()) == 12
    assert tot["submitted"] == tot["completed"] == 12
    assert set(per) <= {0, 1} and len(per) == f["workers_alive"] == 2
    assert tot["backlog_peak"] == max(s["backlog_peak"]
                                      for s in per.values())
    for key in ("hits", "misses", "evictions", "size",
                "store_hits", "store_misses"):
        assert tot["plan_cache"][key] == sum(s["plan_cache"][key]
                                             for s in per.values())
    # the front has a store: every plan-cache miss consulted it
    pc = tot["plan_cache"]
    assert pc["misses"] >= 1
    assert pc["store_hits"] + pc["store_misses"] == pc["misses"]
    assert tot["grad_dispatches"] == sum(s["grad_dispatches"]
                                         for s in per.values())
    assert f["prefill"] is True and f["cold_workers"] == []
    # bucket merge across workers preserves counts
    assert sum(b["count"] for b in tot["buckets"].values()) == 12




# ------------------------------------------------------------ warm start
def test_front_warm_start_from_plan_store_bit_identical(rng, tmp_path):
    """A front over a populated plan store restores plans instead of
    planning afresh (store hits in the aggregated snapshot) and every
    result stays bit-identical to the cold 1-process DetQueue."""
    mats = _mats(rng, 20)
    want = _queue_reference(mats)  # cold reference, no store anywhere
    store = str(tmp_path / "plans")
    with DetQueue(chunk=CHUNK, policy=PINNED, device=DEV,
                  persist_dir=store) as q:
        q.serve(mats, timeout=300)
    with DetFront(workers=1, chunk=CHUNK, policy=PINNED, device=DEV,
                  persist_dir=store) as front:
        got, stats = front.serve(mats, timeout=300)
    assert got == want
    pc = stats["total"]["plan_cache"]
    assert pc["store_hits"] >= 1 and pc["store_misses"] == 0
    assert stats["front"]["prefill"] is True  # auto-on with a store


def test_front_join_with_prefill_warms_before_admission(rng, tmp_path):
    """A worker joining via the accept listener with a populated plan
    store is shipped the front's live plan families in the handshake and
    warms them (store first) before it is admitted: its very first
    snapshot shows store hits, and results match the cold join exactly."""
    import threading
    import time
    mats = _mats(rng, 24)
    want = _queue_reference(mats)
    store = str(tmp_path / "plans")
    with DetQueue(chunk=CHUNK, policy=PINNED, device=DEV,
                  persist_dir=store) as q:
        q.serve(mats, timeout=300)
    with DetFront(workers=1, chunk=CHUNK, policy=PINNED, device=DEV,
                  persist_dir=store, accept="127.0.0.1:0") as front:
        first = [f.result(timeout=300)
                 for f in front.submit_many(mats[:12])]
        assert front._prefill_entries()  # live families to ship
        joiner = threading.Thread(
            target=T.run_worker_client, args=(front.accept_address,),
            kwargs={"log": lambda *a, **k: None}, daemon=True)
        joiner.start()
        t0 = time.monotonic()
        while len(front.alive_workers) != 2:
            assert time.monotonic() - t0 < 60.0
            time.sleep(0.05)
        snap = front.snapshot()
        joiner_wid = [w for w in front.alive_workers if w != 0][0]
        jpc = snap["workers"][joiner_wid]["plan_cache"]
        # admitted already warm: the prefill consulted the store before
        # the worker answered ready
        assert jpc["store_hits"] >= 1
        assert jpc["size"] == len(front._prefill_entries())
        rest = [f.result(timeout=300)
                for f in front.submit_many(mats[12:])]
    joiner.join(timeout=30)
    assert not joiner.is_alive()
    assert first + rest == want


# ------------------------------------------------ the port against jax
def test_front_matches_reference_queue(rng, shared_front):
    """Values and gradients through the port's front equal the
    reference's in-process ``DetQueue`` (jnp backend) on the same seeded
    requests, at the reference's tolerance between backends."""
    ref_queue = pytest.importorskip("repro.launch.det_queue")
    mats = _mats(rng, 24)
    grads = [(i % 3 == 0, [1.0, -2.0, 0.5, 1.5][i % 4])
             for i in range(len(mats))]
    ref_policy = ref_queue.BucketPolicy(max_batch=CAP, mode="merge",
                                        pin_capacity=True)
    with ref_queue.DetQueue(chunk=CHUNK, policy=ref_policy) as q:
        want = [f.result(timeout=300) for f in q.submit_many(mats, grads)]
    got = [f.result(timeout=300)
           for f in shared_front.submit_many(mats, grads)]
    for (g, _), a, b in zip(grads, got, want):
        if g:
            assert isinstance(a, np.ndarray) and a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-4)


# ------------------------------------------------------ no fallback
def test_front_on_cuda_without_a_card_raises_before_spawning(monkeypatch):
    """``DetFront(device="cuda")`` on a host without a card raises as
    ``resolve_device`` does, and no worker process is started."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the front would serve on it")
    spawned = []
    monkeypatch.setattr(T.LocalTransport, "_spawn",
                        lambda self, *a, **k: spawned.append(a))
    for shm in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DetFront(workers=2, chunk=CHUNK, policy=PINNED, shm=shm)
    assert spawned == []


def test_worker_that_cannot_build_its_queue_answers_worker_error():
    """A worker whose queue cannot be built (here: the card it was told
    to serve on is missing) stays on the wire and answers every request
    with the cause, which the front rebuilds as ``WorkerError``; it
    serves nothing on the CPU in its place."""
    import queue
    import torch

    from repro_torch.launch.det_front import _rebuild_exc
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the worker's queue would build")

    class Conn:
        def __init__(self):
            self.sent = []

        def send(self, msg):
            self.sent.append(msg)

        def close(self):
            pass

    cfg = T.WorkerConfig(chunk=CHUNK, backend="cuda", dtype="float32",
                         policy=PINNED, max_pending=None, plan_cache=8,
                         linger_s=0.0, stage_depth=None, pipeline_depth=2,
                         pin_workers=False, device="cuda")
    req_q, conn = queue.Queue(), Conn()
    A = np.ones((2, 5), np.float32)
    for msg in [("batch", 0, [(0, A), (1, A, 1.0)]), ("stats", 7),
                ("stop",)]:
        req_q.put(msg)
    T._local_worker_main(3, cfg, req_q, conn)
    kinds = [m[0] for m in conn.sent]
    assert kinds == ["ack", "error", "error", "stats", "bye"]
    for _, seq, name, text in conn.sent[1:3]:
        exc = _rebuild_exc(name, text)
        assert isinstance(exc, WorkerError)
        assert "worker 3 could not start" in str(exc)
        assert "no CUDA device" in str(exc)
    assert conn.sent[3][2]["completed"] == 0
    assert "no CUDA device" in conn.sent[3][2]["startup_error"]
