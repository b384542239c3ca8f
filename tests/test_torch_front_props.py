"""Twin of ``tests/test_front_props.py`` for the port
(``repro_torch.launch.det_front`` and ``.transport``): the same
properties of the routing layer — HashRing, PlanPlacer (bounded-load
placement) and the wire-stability of routing keys — plus the port's
routing held to the reference's: the same owner for every key, exactly.

These are the pure pieces the fault battery leans on — if placement
were not a pure function of (key, membership), "deterministic
re-route" would be vacuous.  Also covers the shm ring's pure protocol
(descriptor round-trips, FIFO allocation invariants) that ShmTransport
builds on.  Runs under hypothesis when installed, otherwise under the
seeded fallback sampler (tests/_hyp_fallback.py), so tier-1 exercises
the same properties on bare boxes.
"""

import math
import pickle

import numpy as np

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from _hyp_fallback import given, settings, st

from repro.launch import det_front as ref_front
from repro_torch.core.engine import stable_key_hash
from repro_torch.launch.det_front import HashRing, PlanPlacer, route_key
from repro_torch.launch.det_queue import BucketPolicy
from repro_torch.launch.transport import (FrameDecoder, ShmRing,
                                          ShmRingReader, encode_frame,
                                          is_shm_descriptor)

# modest shapes keep C(n, m) well away from float trouble while still
# spanning ~6 orders of magnitude of plan weight
_shapes = st.tuples(st.integers(1, 8), st.integers(1, 24))
_shape_lists = st.lists(_shapes, min_size=1, max_size=24)
_worker_counts = st.integers(1, 6)


def _key(shape, max_batch=8):
    m, n = shape
    return (m, n, max_batch, "float32", False)


# ------------------------------------------------------------ bounded load
@settings(max_examples=50)
@given(_shape_lists, _worker_counts)
def test_bounded_load_invariant_arbitrary_weight_mixes(shapes, workers):
    """For ANY mix of C(n, m) plan weights, no worker's accumulated
    load may exceed the bounded-load bound: (1 + eps) x fair share of
    the total, plus one key's weight (the key that tipped it — placement
    is online, a key is never split)."""
    placer = PlanPlacer(list(range(workers)))
    keys = [_key(s) for s in shapes]
    for k in keys:
        placer.assign(k)
    total = sum(placer.key_weight(k) for k in set(keys))
    assert sum(placer.load.values()) == total
    if total == 0:
        return
    bound = total * (1.0 + placer.eps) / workers \
        + max(placer.key_weight(k) for k in set(keys))
    assert max(placer.load.values()) <= bound + 1e-9


@settings(max_examples=50)
@given(_shape_lists, _worker_counts)
def test_placement_is_sticky_and_deterministic(shapes, workers):
    """Re-assigning the same keys changes nothing (sticky), and an
    independent placer over the same worker ids reproduces the same
    ownership map exactly (pure function of key + membership) — the
    property that lets the fault battery predict a victim before the
    front exists."""
    a = PlanPlacer(list(range(workers)))
    b = PlanPlacer(list(range(workers)))
    keys = [_key(s) for s in shapes]
    first = {k: a.assign(k) for k in keys}
    again = {k: a.assign(k) for k in keys}
    other = {k: b.assign(k) for k in keys}
    assert first == again == other


# ------------------------------------------------- monotone consistency
@settings(max_examples=50)
@given(_shape_lists, st.integers(2, 6))
def test_ring_removal_moves_only_the_victims_keys(shapes, workers):
    ring = HashRing(list(range(workers)), vnodes=32)
    keys = {_key(s) for s in shapes}
    before = {k: ring.owner(k) for k in keys}
    victim = ring.owner(_key(sorted(shapes)[0]))
    ring.remove(victim)
    for k in keys:
        if before[k] != victim:
            assert ring.owner(k) == before[k]
        else:
            assert ring.owner(k) != victim


@settings(max_examples=50)
@given(_shape_lists, st.integers(1, 5))
def test_ring_addition_steals_keys_only_for_the_new_node(shapes, workers):
    """Monotone consistency under scale-up: adding a worker may claim
    keys for itself, but must never shuffle a key between two old
    workers."""
    ring = HashRing(list(range(workers)), vnodes=32)
    keys = {_key(s) for s in shapes}
    before = {k: ring.owner(k) for k in keys}
    new = workers  # fresh id
    ring.add(new)
    for k in keys:
        after = ring.owner(k)
        assert after == before[k] or after == new


@settings(max_examples=25)
@given(_shape_lists, st.integers(1, 5))
def test_placer_addition_never_moves_assigned_families(shapes, workers):
    """The property the live-join path leans on (DESIGN_FRONT.md,
    "Dynamic membership"): ``PlanPlacer.add`` extends the ring's
    monotone consistency through the sticky owner map — every family
    assigned before the join keeps its owner afterwards, bit-for-bit,
    and the joiner can only win families it is later *offered*.  Also
    pins idempotence: re-adding a live worker must not zero its load."""
    placer = PlanPlacer(list(range(workers)))
    keys = [_key(s) for s in shapes]
    before = {k: placer.assign(k) for k in keys}
    load_before = dict(placer.load)
    new = workers  # fresh id
    placer.add(new)
    assert {k: placer.assign(k) for k in keys} == before
    assert placer.load[new] == 0.0  # nothing moved to the joiner
    placer.add(0)  # idempotent: live worker keeps its accumulated load
    assert placer.load[0] == load_before[0]


@settings(max_examples=25)
@given(_shape_lists, st.integers(2, 5))
def test_ring_walk_is_a_permutation_starting_at_owner(shapes, workers):
    ring = HashRing(list(range(workers)), vnodes=32)
    for s in shapes:
        w = ring.walk(_key(s))
        assert w[0] == ring.owner(_key(s))
        assert sorted(w) == list(range(workers))


# ----------------------------------------------------- wire round-trips
@settings(max_examples=50)
@given(_shapes, st.integers(1, 64))
def test_stable_key_hash_round_trips_through_wire_encoding(shape, cap):
    """A routing key must hash identically before and after a frame
    encode/decode — including when its components arrive as numpy
    scalars (an array's ``.shape`` member, a decoded payload)."""
    key = (shape[0], shape[1], cap, "float32", False)
    decoded = FrameDecoder().feed(encode_frame(("route", key)))[0][1]
    assert tuple(decoded) == key
    assert stable_key_hash(decoded) == stable_key_hash(key)
    npkey = (np.int64(shape[0]), np.int64(shape[1]), np.int32(cap),
             np.str_("float32"), np.bool_(False))
    assert stable_key_hash(npkey) == stable_key_hash(key)


@settings(max_examples=50)
@given(_shapes)
def test_route_key_canonicalization_shares_owner_for_mergeable_shapes(shape):
    """Under a merging policy, every exact shape that can coalesce into
    a canonical bucket must produce the *same* routing key as the
    canonical shape itself — otherwise one merged program would compile
    on two workers."""
    policy = BucketPolicy(max_batch=8, mode="merge", col_class=4,
                          col_max=16)
    m, n = shape
    canon = policy.canonical_shape(m, n)
    assert route_key(shape, policy, np.float32) \
        == route_key(canon, policy, np.float32)
    # exact policies route exact
    never = BucketPolicy(max_batch=8, mode="never")
    assert route_key(shape, never, np.float32)[:2] == (m, n)


@settings(max_examples=25)
@given(st.lists(st.integers(0, 255), min_size=1, max_size=64))
def test_frame_decoder_survives_arbitrary_chunking(cuts):
    """TCP may deliver any byte split: feeding a frame stream one
    arbitrarily-sized chunk at a time must reproduce the messages
    exactly and in order."""
    msgs = [("result", 7, 3.25), ("hb", 0),
            ("batch", 3, [(1, np.arange(6, dtype=np.float32))]),
            ("stats", 1, {"completed": 2, "buckets": {(2, 5): {"n": 1}}},
             4)]
    blob = b"".join(encode_frame(m) for m in msgs)
    dec = FrameDecoder()
    out = []
    i = 0
    for c in cuts:
        if i >= len(blob):
            break
        step = 1 + (c % 97)
        out.extend(dec.feed(blob[i:i + step]))
        i += step
    out.extend(dec.feed(blob[i:]))
    assert len(out) == len(msgs)
    for got, want in zip(out, msgs):
        if got[0] == "batch":
            assert got[1] == want[1]
            assert np.array_equal(got[2][0][1], want[2][0][1])
        else:
            assert got == want


# -------------------------------------------------- shm ring protocol
_RING_DTYPES = ("float32", "float64", "int32", "int64")


@settings(max_examples=50)
@given(st.tuples(st.integers(0, 6), st.integers(0, 6)), st.integers(0, 3))
def test_shm_descriptor_round_trip_and_pickle_stability(shape, dti):
    """For ANY shape (empty included) and serving dtype: write -> read
    through the ring is bit-identical, and the descriptor survives the
    mp.Queue pickle hop as a *tuple* (is_shm_descriptor keys on tuple
    type — a pickle that thawed it as a list would silently ship the
    descriptor to the kernel as data)."""
    dtype = _RING_DTYPES[dti]
    ring = ShmRing(capacity=4096)
    reader = ShmRingReader(ring.name)
    try:
        rng = np.random.default_rng(shape[0] * 29 + shape[1] * 7 + dti)
        arr = (rng.normal(size=shape) * 100).astype(dtype)
        desc = ring.write(arr)
        assert desc is not None and is_shm_descriptor(desc)
        thawed = pickle.loads(pickle.dumps(desc))
        assert is_shm_descriptor(thawed)
        got = reader.read(thawed)
        assert got.dtype == arr.dtype and got.shape == arr.shape
        np.testing.assert_array_equal(got, arr)
        # control tuples of the same arity must never be mistaken for one
        assert not is_shm_descriptor(("batch", 1, [], (), ""))
    finally:
        reader.close()
        ring.dispose()


@settings(max_examples=25)
@given(st.lists(st.integers(0, 300), min_size=1, max_size=32),
       st.integers(1, 6))
def test_shm_ring_fifo_allocation_invariants(sizes, window):
    """For ANY payload-size sequence under a FIFO release cadence:
    every granted slot is 64-aligned, in-bounds, never wraps
    mid-payload, and never overlaps a live (unreleased) allocation; a
    write either fits entirely or returns None (the inline-fallback
    signal) — and after releases it must succeed again, so capacity
    pressure can only slow the ring down, never wedge or corrupt it."""
    align, cap = 64, 1024
    ring = ShmRing(capacity=cap)
    reader = ShmRingReader(ring.name)
    try:
        live = []  # (desc, alloc, expected payload), oldest first

        def drain_one():
            desc, _, want = live.pop(0)
            np.testing.assert_array_equal(reader.read(desc), want)

        for i, sz in enumerate(sizes):
            arr = np.full(sz, (i * 37 + sz) % 251, np.uint8)
            desc = ring.write(arr)
            while desc is None and live:
                drain_one()
                desc = ring.write(arr)
            assert desc is not None, "empty ring refused a fitting payload"
            off = desc[1]
            alloc = max(-(-sz // align) * align, align)
            assert off % align == 0
            assert off + sz <= cap  # never wraps mid-payload
            for other, oalloc, _ in live:
                o = other[1]
                assert off + alloc <= o or o + oalloc <= off, (
                    "granted slot overlaps a live allocation")
            live.append((desc, alloc, arr))
            if len(live) > window:
                drain_one()
        while live:
            drain_one()
    finally:
        reader.close()
        ring.dispose()


def test_worker_config_wire_round_trip():
    """The handshake payload: WorkerConfig (policy included) must
    survive to_wire -> frame -> from_wire exactly."""
    from repro_torch.launch.transport import WorkerConfig
    policy = BucketPolicy(max_batch=16, mode="merge", merge_below=3,
                          col_class=2, col_max=8, pin_capacity=True)
    cfg = WorkerConfig(chunk=512, backend="cuda", dtype="float32",
                       policy=policy, max_pending=64, plan_cache=32,
                       linger_s=0.25, stage_depth=48, pipeline_depth=4,
                       pin_workers=True, device="cuda:1")
    wire = FrameDecoder().feed(
        encode_frame(("hello", 0, cfg.to_wire())))[0][2]
    back = WorkerConfig.from_wire(wire)
    assert back == cfg
    assert back.policy == policy


# ------------------------------------------------- held to the reference
@settings(max_examples=50)
@given(_shape_lists, _worker_counts, st.sampled_from([1, 8, 32, 64]))
def test_routing_equals_reference(shapes, workers, vnodes):
    """The port's ring and placer place every key as the reference's do
    on the same workers and vnodes: owners, ring walks, the placer's
    assignments in order, its load vector, and the same owners after a
    worker leaves and another joins."""
    ids = list(range(workers))
    keys = [_key(s) for s in shapes]
    ring, ref_ring = HashRing(ids, vnodes), ref_front.HashRing(ids, vnodes)
    for k in keys:
        assert ring.owner(k) == ref_ring.owner(k)
        assert ring.walk(k) == ref_ring.walk(k)
    placer = PlanPlacer(ids, vnodes=vnodes)
    ref_placer = ref_front.PlanPlacer(ids, vnodes=vnodes)
    assert [placer.assign(k) for k in keys] == \
        [ref_placer.assign(k) for k in keys]
    assert placer.load == ref_placer.load
    victim = placer.assign(keys[0])
    for p in (placer, ref_placer):
        p.remove(victim)
        p.add(workers)
    assert [placer.assign(k) for k in keys] == \
        [ref_placer.assign(k) for k in keys]
    assert placer.owner_map == ref_placer.owner_map


@settings(max_examples=50)
@given(_shapes, st.sampled_from(["auto", "merge", "never"]),
       st.integers(1, 64))
def test_route_key_equals_reference(shape, mode, cap):
    """The routing key is the reference's tuple: float32 families route
    as the reference's without x64, float64 families as the
    reference's with x64 (the only setting where it computes them in
    float64)."""
    from repro.launch.det_queue import BucketPolicy as RefPolicy
    policy = BucketPolicy(max_batch=cap, mode=mode)
    ref_policy = RefPolicy(max_batch=cap, mode=mode)
    assert route_key(shape, policy, np.float32) == \
        ref_front.route_key(shape, ref_policy, np.float32, False)
    assert route_key(shape, policy, np.float64) == \
        ref_front.route_key(shape, ref_policy, np.float64, True)
