"""Twin of ``tests/test_autoscale.py`` for the port
(``repro_torch.launch.autoscale`` over the port's front), on the CPU
(``device="cpu"``).  Added here: the port's ``Autoscaler`` takes the
reference's decisions on the same snapshot sequence, and the worker
ceiling is the reference's.

The reference's battery covers the elastic serving pool: live worker
join, the SLO autoscaler, and straggler-aware health.

The load-bearing invariant is the same one every serving tier above the
DetQueue carries: membership changes must be invisible in the results.
A worker that joins mid-workload (via ``DetFront.grow`` or by dialing
the front's ``--accept`` listener) and a worker retired by the
autoscaler or the straggler sweep may only change *where* plans run —
per-request determinants stay bit-identical to the 1-process
``DetQueue`` because the sticky placer never moves an already-assigned
plan family and retirement is the graceful drain.

The controller itself is tested synchronously: ``Autoscaler.tick``
takes an injected snapshot + clock, so hysteresis (consecutive-tick
thresholds, cooldown windows) is pinned deterministically against a
stub front, while the scale-up/scale-down legs drive a real local
pool.
"""

import threading
import time

import numpy as np
import pytest

from repro.launch import autoscale as ref_autoscale
from repro_torch.launch.autoscale import (Autoscaler, AutoscalePolicy,
                                          default_max_workers)
from repro_torch.launch.det_front import DetFront
from repro_torch.launch.det_queue import BucketPolicy, DetQueue
from repro_torch.launch.transport import run_worker_client

CHUNK = 128
DEV = "cpu"
CAP = 8
SHAPES = [(1, 4), (2, 5), (2, 6), (3, 7), (3, 9), (4, 10), (4, 2)]
PINNED = BucketPolicy(max_batch=CAP, mode="merge", pin_capacity=True)


def _mats(rng, num):
    out = []
    for _ in range(num):
        m, n = SHAPES[int(rng.integers(0, len(SHAPES)))]
        out.append(rng.normal(size=(m, n)).astype(np.float32))
    return out


def _queue_reference(mats, policy=PINNED):
    with DetQueue(chunk=CHUNK, policy=policy, device=DEV) as q:
        dets, _ = q.serve(mats, timeout=300)
    return dets


def _wait_alive_count(front, want, timeout=60.0):
    deadline = time.monotonic() + timeout
    while len(front.alive_workers) != want:
        assert time.monotonic() < deadline, \
            f"alive={front.alive_workers}, want {want} workers"
        time.sleep(0.05)


def _snap(alive, *, pending=0, shed=0, submitted=0, lat=None, load=None):
    """Synthetic ``snapshot()['front']`` for deterministic tick tests."""
    per = pending // max(1, alive)
    return {"front": {
        "workers_alive": alive,
        "pending": {i: per for i in range(alive)},
        "shed": shed,
        "submitted": submitted,
        "latency_ema_s": dict(lat or {}),
        "plan_load": dict(load) if load is not None
        else {i: 0.0 for i in range(alive)},
    }}


class _StubFront:
    """Records actuator calls; never spawns anything."""

    def __init__(self):
        self.grown = 0
        self.retired = []

    def grow(self, count=1):
        self.grown += count
        return list(range(100, 100 + count))

    def retire_worker(self, wid):
        self.retired.append(wid)


# ----------------------------------------------------------- live join
def test_join_mid_workload_bit_identical(rng):
    """A worker that dials the ``accept`` listener mid-workload (the
    ``det_serve --join`` path, run in-thread here) plus a ``grow()``
    worker must leave every result bit-identical to the 1-process
    queue: admission is atomic and the sticky placer keeps assigned
    families put."""
    mats = _mats(rng, 24)
    want = _queue_reference(mats)
    with DetFront(workers=1, chunk=CHUNK, policy=PINNED, device=DEV,
                  accept="127.0.0.1:0") as front:
        first = front.submit_many(mats[:12])
        assert front.grow(1) == [1]
        joiner = threading.Thread(
            target=run_worker_client, args=(front.accept_address,),
            kwargs={"log": lambda *a, **k: None}, daemon=True)
        joiner.start()
        _wait_alive_count(front, 3)
        rest = front.submit_many(mats[12:])
        got = [f.result(timeout=300) for f in first + rest]
        snap = front.snapshot()
        assert snap["front"]["joined"] == 2
        assert snap["front"]["workers_alive"] == 3
    joiner.join(timeout=30)
    assert got == want


def test_placer_sticky_across_grow(rng):
    """Families assigned before a grow stay on their owner afterwards
    (the ring-level monotone property, observed end-to-end)."""
    mats = _mats(rng, 16)
    with DetFront(workers=2, chunk=CHUNK, policy=PINNED,
                  device=DEV) as front:
        front.serve(mats, timeout=300)
        owners = {s: front.owner_of(s) for s in SHAPES}
        front.grow(1)
        _wait_alive_count(front, 3)
        assert {s: front.owner_of(s) for s in SHAPES} == owners


# ----------------------------------------------------------- autoscaler legs
def test_autoscaler_scales_up_under_backlog_and_down_on_idle(rng):
    """Injected breach snapshots make the controller grow a real local
    pool 1→2; injected idle snapshots drain it back to 1; results stay
    bit-identical throughout."""
    mats = _mats(rng, 16)
    want = _queue_reference(mats)
    with DetFront(workers=1, chunk=CHUNK, policy=PINNED,
                  device=DEV) as front:
        scaler = Autoscaler(front, min_workers=1, max_workers=2,
                            up_ticks=2, idle_ticks=2, cooldown_s=5.0)
        busy = dict(pending=64, submitted=64)
        assert scaler.tick(_snap(1, **busy), now=0.0) == "hold"
        assert scaler.tick(_snap(1, **busy), now=1.0) == "up"
        _wait_alive_count(front, 2)
        assert front.serve(mats, timeout=300)[0] == want

        assert scaler.tick(_snap(2, submitted=64), now=2.0) == "hold"
        # within cooldown: idle ticks accumulate but no action fires
        assert scaler.tick(_snap(2, submitted=64), now=3.0) == "hold"
        assert scaler.tick(_snap(2, submitted=64), now=20.0) == "down"
        _wait_alive_count(front, 1)
        assert scaler.scaled_up == 1 and scaler.scaled_down == 1
        # the survivor still serves the full pool bit-identically
        assert front.serve(mats, timeout=300)[0] == want


def test_autoscaler_loop_thread_runs_and_stops(rng):
    """The background loop drives real snapshots without flapping an
    idle pool below min_workers, and stop() joins cleanly."""
    with DetFront(workers=1, chunk=CHUNK, policy=PINNED,
                  device=DEV) as front:
        with Autoscaler(front, min_workers=1, max_workers=2,
                        interval_s=0.05, idle_ticks=2,
                        cooldown_s=0.0) as scaler:
            front.serve(_mats(rng, 8), timeout=300)
            time.sleep(0.5)
        assert len(front.alive_workers) == 1  # never below the floor
        assert scaler.scaled_down == 0


# -------------------------------------------------------------- hysteresis
def test_autoscaler_no_flap_on_alternating_load():
    """Alternating breach/idle observations never act: both hysteresis
    counters reset on every sign change."""
    stub = _StubFront()
    a = Autoscaler(stub, min_workers=1, max_workers=4,
                   up_ticks=2, idle_ticks=2, cooldown_s=0.0)
    for i in range(10):
        snap = (_snap(2, pending=64, submitted=64 + i) if i % 2 == 0
                else _snap(2, submitted=64 + i))
        assert a.tick(snap, now=float(i)) == "hold"
    assert stub.grown == 0 and stub.retired == []


def test_autoscaler_cooldown_bounds_action_rate():
    """Persistent breach: exactly one scale-up per cooldown window, no
    matter how many ticks observe the breach."""
    stub = _StubFront()
    a = Autoscaler(stub, min_workers=1, max_workers=8,
                   up_ticks=2, cooldown_s=10.0)
    actions = [a.tick(_snap(2, pending=640, submitted=n), now=float(n))
               for n in range(12)]
    assert actions.count("up") == 2  # t=1 and t=11, not one per tick
    assert stub.grown == 2


def test_autoscaler_respects_bounds():
    stub = _StubFront()
    a = Autoscaler(stub, min_workers=1, max_workers=2,
                   up_ticks=1, idle_ticks=1, cooldown_s=0.0)
    # at max: breach holds
    assert a.tick(_snap(2, pending=640, submitted=1), now=0.0) == "hold"
    # at min: idle holds
    assert a.tick(_snap(1), now=1.0) == "hold"
    assert stub.grown == 0 and stub.retired == []
    # scale-down picks the least plan-loaded worker deterministically
    a2 = Autoscaler(stub, min_workers=1, max_workers=4,
                    up_ticks=1, idle_ticks=1, cooldown_s=0.0)
    assert a2.tick(_snap(3, load={0: 5.0, 1: 1.0, 2: 3.0}),
                   now=0.0) == "down"
    assert stub.retired == [1]


def test_autoscaler_latency_slo_trigger():
    stub = _StubFront()
    a = Autoscaler(stub, min_workers=1, max_workers=4, slo_latency_s=0.5,
                   up_ticks=1, cooldown_s=0.0)
    snap = _snap(2, submitted=1, lat={0: 0.1, 1: 0.9})
    assert a.tick(snap, now=0.0) == "up"
    assert stub.grown == 1


def test_autoscale_policy_validation():
    with pytest.raises(ValueError):
        AutoscalePolicy(min_workers=0)
    with pytest.raises(ValueError):
        AutoscalePolicy(min_workers=3, max_workers=2)
    with pytest.raises(ValueError):
        AutoscalePolicy(cold_hit_rate=1.5)
    with pytest.raises(ValueError):
        AutoscalePolicy(cold_grace_requests=-1)
    assert default_max_workers() >= 1


# ------------------------------------------------- plan-cache temperature
def test_autoscaler_cold_set_from_hit_rates():
    """The warm-start signal (DESIGN_PERSIST.md): a worker still paying
    compiles (low engine+store hit rate) is cold; a store-prefilled
    joiner (store_hits ≈ misses) and a long-warmed worker (past the
    grace window) are not."""
    a = Autoscaler(_StubFront(), cold_hit_rate=0.5, cold_grace_requests=64)

    def pc(hits, misses, store_hits=0):
        return {"plan_cache": {"hits": hits, "misses": misses,
                               "store_hits": store_hits}}
    workers = {
        0: pc(0, 4),            # cold joiner compiling from scratch
        1: pc(0, 4, 4),         # store-prefilled: every miss was a hit
        2: pc(100, 10),         # mature worker, past the grace window
        3: pc(1, 3, 1),         # rate 0.5: at the threshold, not below
        4: {},                  # no plan_cache section: not judged
    }
    assert a._cold_set(workers) == {0}


def test_autoscaler_tick_marks_cold_workers_on_front():
    """Every tick pushes the cold set to the front (which shields those
    workers from the straggler sweep); fronts without the hook and
    snapshots without a workers section both degrade gracefully."""
    class _ColdStub(_StubFront):
        def __init__(self):
            super().__init__()
            self.cold_calls = []

        def mark_cold_workers(self, wids):
            self.cold_calls.append(set(wids))

    stub = _ColdStub()
    a = Autoscaler(stub, up_ticks=1, cooldown_s=0.0)
    snap = _snap(2, submitted=4)
    snap["workers"] = {
        0: {"plan_cache": {"hits": 0, "misses": 3, "store_hits": 0}},
        1: {"plan_cache": {"hits": 9, "misses": 1, "store_hits": 0}},
    }
    a.tick(snap, now=0.0)
    assert stub.cold_calls == [{0}]
    # worker 0 warms up: the next tick clears it
    snap["workers"][0]["plan_cache"] = {"hits": 9, "misses": 3,
                                        "store_hits": 0}
    a.tick(snap, now=1.0)
    assert stub.cold_calls == [{0}, set()]
    # plain stub (no hook) + snapshot without workers: still no crash
    assert Autoscaler(_StubFront()).tick(_snap(1), now=0.0) == "hold"


def test_cold_worker_shielded_from_straggler_sweep(rng):
    """A cold-marked worker's high latency EMA (it is compiling, not
    slow) must not get it drained; once the mark clears, the sweep
    treats it like any other peer."""
    mats = _mats(rng, 16)
    with DetFront(workers=3, chunk=CHUNK, policy=PINNED, device=DEV,
                  straggler_factor=2.0, straggler_warmup=4,
                  straggler_cooldown_s=0.0) as front:
        front.serve(mats, timeout=300)
        # the serve's own sweeps may drain a worker slowed by a loaded
        # host; only the seeded sweep below is under test
        drained = front.snapshot()["front"]["stragglers_drained"]
        victim = front.alive_workers[0]
        with front._lock:  # seed measured EMAs deterministically
            for w in front._workers:
                w.timer.ema = 10.0 if w.id == victim else 0.1
                w.timer.n = 10
        front.mark_cold_workers([victim])
        front._sweep_stragglers(time.monotonic())
        snap = front.snapshot()
        assert snap["front"]["stragglers_drained"] == drained
        assert snap["front"]["cold_workers"] == [victim]
        assert victim in front.alive_workers
        front.mark_cold_workers([])  # warm now: ordinary health rules
        front._sweep_stragglers(time.monotonic())
        _wait_alive_count(front, 2)
        assert front.snapshot()["front"]["stragglers_drained"] == 1


# ------------------------------------------------------- straggler health
def test_straggler_sweep_drains_slow_worker(rng):
    """A worker whose completion-latency EMA sits far above the median
    of its warmed peers is retired by the sweep — gracefully, so the
    pool keeps serving bit-identically on the survivors."""
    mats = _mats(rng, 16)
    want = _queue_reference(mats)
    with DetFront(workers=3, chunk=CHUNK, policy=PINNED, device=DEV,
                  straggler_factor=2.0, straggler_warmup=4,
                  straggler_cooldown_s=0.0) as front:
        assert front.serve(mats, timeout=300)[0] == want
        victim = front.alive_workers[0]
        with front._lock:  # seed measured EMAs deterministically
            for w in front._workers:
                w.timer.ema = 10.0 if w.id == victim else 0.1
                w.timer.n = 10
        front._sweep_stragglers(time.monotonic())
        _wait_alive_count(front, 2)
        snap = front.snapshot()
        assert snap["front"]["stragglers_drained"] == 1
        assert victim not in front.alive_workers
        assert front.serve(mats, timeout=300)[0] == want


def test_straggler_sweep_needs_quorum_and_cooldown(rng):
    """With a single warmed worker there is no peer median — the sweep
    must hold; and back-to-back sweeps inside the cooldown window drain
    at most one worker."""
    with DetFront(workers=2, chunk=CHUNK, policy=PINNED, device=DEV,
                  straggler_factor=2.0, straggler_warmup=4,
                  straggler_cooldown_s=3600.0) as front:
        with front._lock:
            w0, w1 = front._workers
            w0.timer.ema, w0.timer.n = 10.0, 10
            w1.timer.ema, w1.timer.n = 0.1, 0  # not warmed: no quorum
        front._sweep_stragglers(time.monotonic())
        assert front.snapshot()["front"]["stragglers_drained"] == 0
        with front._lock:
            w1.timer.n = 10  # warmed now: quorum of 2
        now = time.monotonic()
        front._sweep_stragglers(now)
        front._sweep_stragglers(now + 1.0)  # inside cooldown: no-op
        assert front.snapshot()["front"]["stragglers_drained"] == 1
        assert len(front.alive_workers) == 1


# ------------------------------------------------ held to the reference
def test_default_max_workers_equals_reference():
    assert default_max_workers() == ref_autoscale.default_max_workers()


class _RecordingFront:
    """A stub front that records every actuator and cold-set call, and
    whose grow is capped (so the capacity-exhausted branch runs too)."""

    def __init__(self, capacity):
        self.calls = []
        self.capacity = capacity

    def grow(self, count=1):
        n = min(count, self.capacity)
        self.capacity -= n
        self.calls.append(("grow", count, n))
        return list(range(100, 100 + n))

    def retire_worker(self, wid):
        self.calls.append(("retire", wid))

    def mark_cold_workers(self, wids):
        self.calls.append(("cold", sorted(wids)))


@pytest.mark.parametrize("seed", range(4))
def test_autoscaler_decisions_equal_reference(seed):
    """On the same seeded sequence of synthetic snapshots and clock
    readings, the port's controller and the reference's take the same
    action at every tick, drive the same actuator calls (grow, retire
    victim, cold set) and end with the same counters."""
    rng = np.random.default_rng(seed)
    kw = dict(min_workers=1, max_workers=4, up_ticks=2, idle_ticks=2,
              cooldown_s=3.0, slo_latency_s=0.5, cold_hit_rate=0.5,
              cold_grace_requests=16)
    port_front, ref_front = _RecordingFront(2), _RecordingFront(2)
    port = Autoscaler(port_front, **kw)
    ref = ref_autoscale.Autoscaler(ref_front, **kw)
    submitted = shed = 0
    for t in range(60):
        alive = int(rng.integers(1, 5))
        submitted += int(rng.integers(0, 3)) * int(rng.integers(0, 40))
        shed += int(rng.random() < 0.1)
        if rng.random() < 0.05:
            submitted = shed = 0  # a reset_stats window
        snap = _snap(alive, pending=int(rng.choice([0, 0, 4, 64])),
                     shed=shed, submitted=submitted,
                     lat={i: float(rng.random()) for i in range(alive)},
                     load={i: float(rng.integers(0, 9))
                           for i in range(alive)})
        snap["workers"] = {
            i: {"plan_cache": {"hits": int(rng.integers(0, 20)),
                               "misses": int(rng.integers(0, 8)),
                               "store_hits": 0}}
            for i in range(alive)}
        now = t * 0.75
        assert port.tick(snap, now=now) == ref.tick(snap, now=now), t
    assert port_front.calls == ref_front.calls
    assert (port.scaled_up, port.scaled_down) == \
        (ref.scaled_up, ref.scaled_down)
    assert any(c[0] != "cold" for c in port_front.calls)
