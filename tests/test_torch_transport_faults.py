"""Twin of ``tests/test_transport_faults.py`` for the port's transports
(``repro_torch.launch.transport``), on the CPU (``device="cpu"``).
Added here: frames are byte-identical between the reference and the
port and decode across the two, and a spawn or hello that carries a
warm-start ``prefill`` warms the worker's queue from the plan store
before the worker answers anything.

The reference's battery:

Going over sockets is where serving correctness gets hard: partial
writes, dead peers, duplicated and delayed frames.  The battery injects
each failure class at the *frame* level (a :class:`FlakyTransport`
wrapping the real ``SocketTransport``) and asserts the three invariants
the transport seam promises:

* the front re-routes **deterministically** (stable hashing: the same
  victim's keys always land on the same survivor);
* futures **never hang** (every ``result(timeout=...)`` below is a
  liveness assertion — a stuck future fails the test, it doesn't wedge
  it);
* results stay **bit-identical** to a 1-process ``DetQueue`` under the
  pinned-capacity policy, faults and all.

Workers are real socket daemons: in-thread (`ThreadedWorkerServer`) for
the frame-mangling tests (full visibility, no spawn cost) and real
subprocess daemons for the SIGKILL-mid-flight proof — the socket
extension of the process-sentinel kill test.
"""

import pickle
import signal
import time

import numpy as np
import pytest

from repro.launch import transport as RT
from repro_torch.launch import transport as T
from repro_torch.launch.det_front import DetFront, PlanPlacer, route_key
from repro_torch.launch.det_queue import BucketPolicy, DetQueue

CHUNK = 128
DEV = "cpu"
CAP = 8
PINNED = BucketPolicy(max_batch=CAP, mode="merge", pin_capacity=True)
# the front-battery heterogeneous pool, incl. one m > n degenerate
SHAPES = [(1, 4), (2, 5), (2, 6), (3, 7), (3, 9), (4, 10), (4, 2)]


def _mats(rng, num, shapes=SHAPES):
    out = []
    for _ in range(num):
        m, n = shapes[int(rng.integers(0, len(shapes)))]
        out.append(rng.normal(size=(m, n)).astype(np.float32))
    return out


def _queue_reference(mats, policy=PINNED):
    """The single-process ground truth for a request set."""
    with DetQueue(chunk=CHUNK, policy=policy, device=DEV) as q:
        dets, _ = q.serve(mats, timeout=300)
    return dets


def _static_owner(shape, workers=(0, 1), policy=PINNED):
    """Predict which worker id owns a shape *before* any front exists:
    placement is a pure function of (key, worker ids), which is exactly
    what lets a fault rule target the right victim at transport-build
    time — and is itself a determinism assertion."""
    placer = PlanPlacer(list(workers))
    return placer.assign(route_key(shape, policy, np.float32))


# ------------------------------------------------------------ flaky plumbing
class _FlakySocket:
    """A sendall-mangling shim over a real socket.  The link writes
    exactly one frame per ``sendall``, so ``rule(frame_index, data)``
    sees whole frames and returns the byte chunks actually sent —
    ``[]`` drops, ``[d, d]`` duplicates, ``[d[:k]]`` truncates."""

    def __init__(self, sock, rule):
        self._sock = sock
        self._rule = rule
        self._n = 0

    def sendall(self, data):
        self._n += 1
        for chunk in self._rule(self._n, data):
            self._sock.sendall(chunk)

    def recv(self, *args):
        return self._sock.recv(*args)

    def fileno(self):
        return self._sock.fileno()

    def shutdown(self, *args):
        return self._sock.shutdown(*args)

    def close(self):
        return self._sock.close()


class FlakyTransport(T.SocketTransport):
    """SocketTransport whose post-handshake streams are mangled by
    per-worker rules (handshakes stay clean by construction: the shim
    is installed by ``_finish``, after ready)."""

    def __init__(self, addresses, rules, **kwargs):
        super().__init__(addresses, **kwargs)
        self._rules = rules

    def _finish(self, sock, wid, addr):
        rule = self._rules.get(wid)
        return _FlakySocket(sock, rule) if rule is not None else sock


def _frame_msg(data):
    """Decode one whole frame's message (test-side peek for
    content-aware fault rules)."""
    return pickle.loads(data[10:])  # header: magic 2B + len 4B + crc 4B


def _servers(k):
    return [T.ThreadedWorkerServer() for _ in range(k)]


def _close_all(servers):
    for s in servers:
        s.close(timeout=10)


# ------------------------------------------------------------- clean loopback
def test_socket_front_bit_identical_to_queue(rng):
    """No faults: a front over two socket daemons is bit-identical to
    the 1-process DetQueue on the mixed-shape pool."""
    mats = _mats(rng, 30)
    want = _queue_reference(mats)
    servers = _servers(2)
    try:
        tr = T.SocketTransport([s.address for s in servers],
                               heartbeat_s=0.25)
        with DetFront(transport=tr, chunk=CHUNK, policy=PINNED,
                      device=DEV) as front:
            got, stats = front.serve(mats, timeout=300)
    finally:
        _close_all(servers)
    assert got == want
    assert stats["front"]["worker_deaths"] == 0
    assert stats["total"]["completed"] == 30
    assert stats["front"]["degraded"] is False


def test_socket_front_head_shapes_bit_identical(rng):
    """The acceptance workload: head_shapes() (equal-work hot shapes)
    through a socket-loopback front matches the 1-process queue bit for
    bit."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from benchmarks.perf_serve import head_shapes
    shapes = head_shapes(max_m=4, target_ranks=120, per_m=2)
    assert shapes, "head_shapes returned no shapes at test scale"
    mats = _mats(rng, 24, shapes=shapes)
    want = _queue_reference(mats)
    servers = _servers(2)
    try:
        tr = T.SocketTransport([s.address for s in servers])
        with DetFront(transport=tr, chunk=CHUNK, policy=PINNED,
                      device=DEV) as front:
            got, _ = front.serve(mats, timeout=300)
    finally:
        _close_all(servers)
    assert got == want


# ------------------------------------------------------------------ drops
def test_dropped_request_frames_reroute_without_hanging(rng):
    """Every request frame to the victim vanishes while its heartbeats
    keep flowing — the failure a pure heartbeat detector cannot see.
    The unacked-batch deadline must declare the victim dead and re-route
    to the survivor, bit-identically, with no future left hanging."""
    mats = [rng.normal(size=(3, 7)).astype(np.float32) for _ in range(12)]
    want = _queue_reference(mats)
    victim = _static_owner((3, 7))
    servers = _servers(2)
    try:
        tr = FlakyTransport([s.address for s in servers],
                            rules={victim: lambda i, d: []},
                            heartbeat_s=0.25)
        with DetFront(transport=tr, chunk=CHUNK, policy=PINNED,
                      ack_timeout_s=1.0, device=DEV) as front:
            assert front.owner_of((3, 7)) == victim
            futs = front.submit_many(mats)
            got = [f.result(timeout=300) for f in futs]
            stats = front.snapshot()
            assert front.alive_workers == [1 - victim]
    finally:
        _close_all(servers)
    assert got == want
    assert stats["front"]["worker_deaths"] == 1
    assert stats["front"]["rerouted"] == 12


# ------------------------------------------------------------- truncation
def test_truncated_frame_desyncs_peer_and_reroutes(rng):
    """The victim's first batch frame is cut in half; the next frame
    lands misaligned in its decoder (CRC mismatch -> FrameError), the
    daemon drops the session, the front sees EOF and re-routes — with
    the unacked deadline as the backstop for the half-frame that never
    errors (nothing further arrives to expose it)."""
    mats = [rng.normal(size=(3, 7)).astype(np.float32) for _ in range(10)]
    want = _queue_reference(mats)
    victim = _static_owner((3, 7))

    def truncate_first(i, d):
        return [d[: len(d) // 2]] if i == 1 else [d]

    servers = _servers(2)
    try:
        tr = FlakyTransport([s.address for s in servers],
                            rules={victim: truncate_first},
                            heartbeat_s=0.25)
        with DetFront(transport=tr, chunk=CHUNK, policy=PINNED,
                      ack_timeout_s=2.0, device=DEV) as front:
            futs = front.submit_many(mats[:5])
            time.sleep(0.2)
            futs += front.submit_many(mats[5:])  # exposes the desync
            got = [f.result(timeout=300) for f in futs]
            stats = front.snapshot()
    finally:
        _close_all(servers)
    assert got == want
    assert stats["front"]["worker_deaths"] == 1
    assert stats["front"]["rerouted"] > 0


# ------------------------------------------------------------ duplication
def test_duplicated_frames_are_idempotent(rng):
    """Every frame to both workers is sent twice.  Batch acks and
    responses are keyed (batch id / seq), so duplicates are absorbed:
    every seq appears on the poll stream exactly once, counters don't
    double, results stay bit-identical."""
    mats = _mats(rng, 20)
    want = _queue_reference(mats)
    dup = {0: lambda i, d: [d, d], 1: lambda i, d: [d, d]}
    servers = _servers(2)
    try:
        tr = FlakyTransport([s.address for s in servers], rules=dup,
                            heartbeat_s=0.25)
        with DetFront(transport=tr, chunk=CHUNK, policy=PINNED,
                      ack_timeout_s=5.0, device=DEV) as front:
            futs = front.submit_many(mats)
            by_seq = {}
            while len(by_seq) < len(mats):
                got = front.poll(timeout=60.0)
                assert got, "poll timed out with responses outstanding"
                for seq, val in got:
                    assert seq not in by_seq, "duplicate poll delivery"
                    by_seq[seq] = val
            stats = front.snapshot()
    finally:
        _close_all(servers)
    assert [by_seq[f.seq] for f in futs] == want
    assert stats["front"]["worker_deaths"] == 0
    assert stats["front"]["completed"] == 20


# ----------------------------------------------------------------- delay
def test_delayed_frames_all_resolve(rng):
    """Frames are delayed below the heartbeat deadline: nothing may be
    declared dead, nothing may hang, results stay bit-identical."""
    mats = _mats(rng, 16)
    want = _queue_reference(mats)

    def slow(i, d):
        time.sleep(0.03)
        return [d]

    servers = _servers(2)
    try:
        tr = FlakyTransport([s.address for s in servers],
                            rules={0: slow, 1: slow}, heartbeat_s=0.5)
        with DetFront(transport=tr, chunk=CHUNK, policy=PINNED,
                      ack_timeout_s=10.0, device=DEV) as front:
            got, stats = front.serve(mats, timeout=300)
    finally:
        _close_all(servers)
    assert got == want
    assert stats["front"]["worker_deaths"] == 0


# ---------------------------------------------------------- peer death
def test_socket_worker_sigkill_mid_flight_bit_identical(rng):
    """The PR 4 SIGKILL proof, extended over the wire: a real daemon
    subprocess is SIGKILLed with requests in flight; the front detects
    the torn connection, re-routes the orphans to the survivor daemon,
    and every request still matches the 1-process queue bit for bit."""
    mats = _mats(rng, 24)
    want = _queue_reference(mats)
    procs, addrs = [], []
    try:
        for _ in range(2):
            proc, addr = T.spawn_worker_daemon(device=DEV)
            procs.append(proc)
            addrs.append(addr)
        tr = T.SocketTransport(addrs, heartbeat_s=0.25)
        with DetFront(transport=tr, chunk=CHUNK, policy=PINNED,
                      device=DEV) as front:
            victim = front.owner_of((3, 9))
            futs = front.submit_many(mats)
            procs[victim].send_signal(signal.SIGKILL)
            got = [f.result(timeout=300) for f in futs]
            stats = front.snapshot()
            assert front.alive_workers == [1 - victim]
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(timeout=30)
    assert got == want
    assert stats["front"]["worker_deaths"] == 1
    assert stats["front"]["rerouted"] > 0
    assert stats["front"]["completed"] == 24


def test_total_socket_loss_fails_pending_without_hanging(rng):
    mats = [rng.normal(size=(3, 9)).astype(np.float32) for _ in range(6)]
    servers = _servers(1)
    try:
        tr = T.SocketTransport([servers[0].address], heartbeat_s=0.25)
        front = DetFront(transport=tr, chunk=CHUNK, policy=PINNED,
                         device=DEV)
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
    finally:
        _close_all(servers)


# ----------------------------------------------------------- reconnect
def _wait_alive(front, want, timeout=60.0):
    deadline = time.monotonic() + timeout
    while sorted(front.alive_workers) != sorted(want):
        assert time.monotonic() < deadline, \
            f"alive={front.alive_workers}, want {want}"
        time.sleep(0.05)


def test_reconnect_worker_rejoins_socket_pool(rng):
    """Graceful reconnect-and-reroute: after a socket peer death the
    front re-dials the same address (a fresh daemon session), the
    stable ring re-inserts the old arc, and the rejoined pool serves
    the same requests bit-identically."""
    mats = _mats(rng, 16)
    want = _queue_reference(mats)
    servers = [T.ThreadedWorkerServer(max_sessions=2) for _ in range(2)]
    try:
        tr = T.SocketTransport([s.address for s in servers],
                               heartbeat_s=0.25)
        with DetFront(transport=tr, chunk=CHUNK, policy=PINNED,
                      device=DEV) as front:
            assert front.serve(mats, timeout=300)[0] == want
            victim = front.owner_of((3, 7))
            front.kill_worker(victim)
            _wait_alive(front, [1 - victim])
            assert front.reconnect_worker(victim) is True
            assert front.reconnect_worker(victim) is True  # idempotent
            assert sorted(front.alive_workers) == [0, 1]
            futs = front.submit_many(mats)
            got = [f.result(timeout=300) for f in futs]
            stats = front.snapshot()
    finally:
        _close_all(servers)
    assert got == want
    assert stats["front"]["worker_deaths"] == 1
    assert stats["front"]["workers_alive"] == 2


def test_reconnect_worker_respawns_local_process(rng):
    """The same rejoin over LocalTransport: the dead worker's process
    is respawned under its old id."""
    mats = _mats(rng, 12)
    want = _queue_reference(mats)
    with DetFront(workers=2, chunk=CHUNK, policy=PINNED,
                      device=DEV) as front:
        victim = front.owner_of((3, 9))
        front.kill_worker(victim)
        _wait_alive(front, [1 - victim])
        assert front.reconnect_worker(victim) is True
        assert sorted(front.alive_workers) == [0, 1]
        got, stats = front.serve(mats, timeout=300)
    assert got == want
    assert stats["front"]["worker_deaths"] == 1


def test_reconnect_after_total_loss_restarts_the_stream(rng):
    """Total worker loss ends the response stream; a successful
    reconnect must restart it — submits work again and poll() delivers
    rather than reporting a dead end."""
    mats = [rng.normal(size=(2, 5)).astype(np.float32) for _ in range(6)]
    want = _queue_reference(mats)
    with DetFront(workers=1, chunk=CHUNK, policy=PINNED,
                      device=DEV) as front:
        futs = front.submit_many(mats)
        front.kill_worker(0)
        for f in futs:
            with pytest.raises(RuntimeError):
                f.result(timeout=120)
        _wait_alive(front, [])
        assert front.reconnect_worker(0) is True
        futs = front.submit_many(mats)
        got = [f.result(timeout=300) for f in futs]
        by_seq = {}
        while not all(f.seq in by_seq for f in futs):
            polled = front.poll(timeout=60.0)
            assert polled or all(f.seq in by_seq for f in futs)
            by_seq.update(polled)
    assert got == want
    assert [by_seq[f.seq] for f in futs] == want


# ------------------------------------------------- degraded stats snapshot
def test_snapshot_degraded_when_worker_stops_answering(rng):
    """The satellite regression: a worker that dies (or goes deaf)
    between the liveness check and the stats reply must not make
    ``snapshot()`` raise or hang — it returns partial stats flagged
    ``degraded`` (here: the victim's stats request frames are dropped
    while everything else flows)."""
    mats = [rng.normal(size=(2, 5)).astype(np.float32) for _ in range(8)]
    victim = _static_owner((2, 5))

    def drop_stats(i, d):
        return [] if _frame_msg(d)[0] == "stats" else [d]

    servers = _servers(2)
    try:
        tr = FlakyTransport([s.address for s in servers],
                            rules={victim: drop_stats}, heartbeat_s=0.25)
        with DetFront(transport=tr, chunk=CHUNK, policy=PINNED,
                      device=DEV) as front:
            futs = front.submit_many(mats)
            assert all(isinstance(f.result(timeout=300), float)
                       for f in futs)
            stats = front.snapshot(timeout=1.5)
            # serving still works after a degraded snapshot
            assert isinstance(
                front.submit(mats[0]).result(timeout=300), float)
    finally:
        _close_all(servers)
    assert stats["front"]["degraded"] is True
    assert victim not in stats["workers"]
    assert (1 - victim) in stats["workers"]


def test_snapshot_after_local_kill_never_raises(rng):
    """Local-transport leg of the same regression: SIGKILL a worker and
    immediately snapshot, racing the death detection — every outcome
    (report, missing report + degraded flag) must return, not raise."""
    with DetFront(workers=2, chunk=CHUNK, policy=PINNED,
                      device=DEV) as front:
        fut = front.submit(rng.normal(size=(3, 7)).astype(np.float32))
        assert isinstance(fut.result(timeout=300), float)
        front.kill_worker(front.owner_of((3, 7)))
        stats = front.snapshot(timeout=10.0)
        assert set(stats) == {"front", "workers", "total"}
        deadline = time.monotonic() + 60
        while len(front.alive_workers) > 1:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        stats = front.snapshot(timeout=30.0)
        assert stats["front"]["degraded"] is False
        assert len(stats["workers"]) == 1


# -------------------------------------------------------- shared-memory ring
def test_shm_ring_descriptor_round_trip():
    """In-process producer/consumer pair: every dtype/shape/layout round
    trips byte-exactly through the ring, and the consumer's release
    watermarks are the monotonic FIFO reclaim protocol promises."""
    rng = np.random.default_rng(3)
    ring = T.ShmRing(1 << 16)
    reader = T.ShmRingReader(ring.name)
    try:
        payloads = [
            rng.normal(size=(3, 9)).astype(np.float32),
            rng.normal(size=(4, 2)),                        # float64
            rng.integers(0, 100, size=(7,), dtype=np.int64),
            np.asfortranarray(rng.normal(size=(5, 6)).astype(np.float32)),
            rng.normal(size=(2, 3, 4)).astype(np.float32),
        ]
        descs = [ring.write(p) for p in payloads]
        assert all(T.is_shm_descriptor(d) for d in descs)
        releases = [d[2] for d in descs]
        assert releases == sorted(releases)                 # FIFO, monotonic
        for p, d in zip(payloads, descs):
            got = reader.read(d)
            np.testing.assert_array_equal(got, np.ascontiguousarray(p))
            assert got.dtype == p.dtype
    finally:
        reader.close()
        ring.dispose()


def test_shm_ring_full_then_reclaim():
    """A full ring returns None (the inline-fallback signal), and space
    comes back exactly when the consumer publishes its watermark —
    including an allocation that skips the wrap fragment."""
    ring = T.ShmRing(256)
    reader = T.ShmRingReader(ring.name)
    try:
        a = np.arange(24, dtype=np.float32)   # 96 B -> 128 B slot
        b = np.arange(6, dtype=np.float32)    # 24 B -> 64 B slot
        d1 = ring.write(a)
        d2 = ring.write(b)
        assert d1 is not None and d2 is not None
        # 192/256 B used; a third 128 B slot would straddle the end and
        # the post-skip position exceeds the unreleased window -> None
        assert ring.write(a) is None
        # oversized payloads never fit, full or empty
        assert ring.write(np.zeros(512, np.float32)) is None
        np.testing.assert_array_equal(reader.read(d1), a)
        np.testing.assert_array_equal(reader.read(d2), b)
        # head published -> the wrap-skipping retry lands at offset 0
        d3 = ring.write(a)
        assert d3 is not None and d3[1] == 0
        np.testing.assert_array_equal(reader.read(d3), a)
    finally:
        reader.close()
        ring.dispose()


def test_shm_ring_disposed_write_returns_none():
    """dispose() is idempotent and flips write() to the inline fallback
    instead of touching a dead mapping."""
    ring = T.ShmRing(256)
    assert ring.write(np.zeros(4, np.float32)) is not None
    ring.dispose()
    ring.dispose()
    assert ring.write(np.zeros(4, np.float32)) is None


def test_shm_front_bit_identical_to_queue(rng):
    """The shm fast path is still the same determinant service: a mixed
    shape stream (degenerate m > n included) through ``DetFront(shm=True)``
    matches the 1-process queue bit for bit."""
    mats = _mats(rng, 24)
    want = _queue_reference(mats)
    with DetFront(workers=2, chunk=CHUNK, policy=PINNED, shm=True,
                  device=DEV) as front:
        assert all(l.startswith("shm(") for l in front.describe_links())
        got, stats = front.serve(mats, timeout=300)
    assert got == want
    assert stats["front"]["completed"] == 24
    assert stats["front"]["worker_deaths"] == 0


def test_shm_tiny_ring_inline_fallback_bit_identical(rng):
    """A ring too small for most payloads degrades per payload to the
    inline pickle path — a mixed descriptor/inline stream must stay
    bit-identical (correctness never depends on ring capacity)."""
    mats = _mats(rng, 20)
    want = _queue_reference(mats)
    tr = T.ShmTransport(2, ring_bytes=64)  # one 64 B slot: most fall back
    with DetFront(transport=tr, chunk=CHUNK, policy=PINNED,
                      device=DEV) as front:
        got, _ = front.serve(mats, timeout=300)
    assert got == want


def test_shm_worker_sigkill_mid_flight_bit_identical(rng):
    """The PR 4 SIGKILL proof on the shm path: a worker dies with
    descriptors in flight (its ring slots are never released), the
    orphans re-route to the survivor, results stay bit-identical."""
    mats = _mats(rng, 24)
    want = _queue_reference(mats)
    with DetFront(workers=2, chunk=CHUNK, policy=PINNED, shm=True,
                  device=DEV) as front:
        victim = front.owner_of((3, 9))
        futs = front.submit_many(mats)
        front.kill_worker(victim)
        got = [f.result(timeout=300) for f in futs]
        stats = front.snapshot()
        assert front.alive_workers == [1 - victim]
    assert got == want
    assert stats["front"]["worker_deaths"] == 1
    assert stats["front"]["completed"] == 24


def test_shm_reconnect_respawns_with_fresh_ring(rng):
    """Rejoin over ShmTransport: the respawned worker gets a brand-new
    ring (a dead worker's unreleased slots die with its link), and the
    rejoined pool serves bit-identically."""
    mats = _mats(rng, 12)
    want = _queue_reference(mats)
    with DetFront(workers=2, chunk=CHUNK, policy=PINNED, shm=True,
                  device=DEV) as front:
        victim = front.owner_of((3, 9))
        front.kill_worker(victim)
        _wait_alive(front, [1 - victim])
        assert front.reconnect_worker(victim) is True
        assert sorted(front.alive_workers) == [0, 1]
        got, stats = front.serve(mats, timeout=300)
    assert got == want
    assert stats["front"]["worker_deaths"] == 1


# ------------------------------------------------ the reference's wire
_WIRE_MSGS = [
    ("batch", 3, [(0, np.arange(6, dtype=np.float32).reshape(2, 3)),
                  (1, np.ones((3, 5)), -2.0)]),
    ("ack", 3), ("result", 0, 1.25),
    ("result", 1, np.arange(15, dtype=np.float64).reshape(3, 5)),
    ("shed", 4, "backlog full"), ("error", 5, "OverflowError", "C(40,16)"),
    ("stats", 1, {"completed": 2, "buckets": {(2, 5): {"count": 1}}}, 9),
    ("requeue", 6), ("hb", 0), ("bye", 1), ("ready", 2), ("reset",),
    ("retire",), ("stop",),
    ("batch", 4, [(7, T.shm_descriptor(64, 128, (2, 3), "float32"))]),
]


@pytest.mark.parametrize("msg", _WIRE_MSGS, ids=[m[0] for m in _WIRE_MSGS])
def test_frames_byte_identical_to_reference(msg):
    """Every message kind encodes to the same bytes in the port and the
    reference, and a frame from either decodes in the other."""
    def same(a, b):
        if isinstance(a, np.ndarray):
            return isinstance(b, np.ndarray) and a.dtype == b.dtype \
                and np.array_equal(a, b)
        if isinstance(a, (tuple, list)):
            return type(a) is type(b) and len(a) == len(b) \
                and all(same(x, y) for x, y in zip(a, b))
        return a == b

    port, ref = T.encode_frame(msg), RT.encode_frame(msg)
    assert port == ref
    assert same(RT.FrameDecoder().feed(port)[0], msg)
    assert same(T.FrameDecoder().feed(ref)[0], msg)


def test_hello_config_crosses_to_the_reference():
    """The port's handshake config is the reference's minus ``x64`` and
    ``persist_dir``, plus ``device``: its policy dict decodes into the
    reference's policy, and a reference hello decodes into the port's
    config with the fields both share."""
    from repro.launch.det_queue import BucketPolicy as RefPolicy
    policy = BucketPolicy(max_batch=16, mode="merge", pin_capacity=True)
    cfg = T.WorkerConfig(chunk=512, backend="cuda", dtype="float32",
                         policy=policy, max_pending=64, plan_cache=32,
                         linger_s=0.0, stage_depth=None, pipeline_depth=4,
                         pin_workers=False, device="cpu")
    wire = RT.FrameDecoder().feed(
        T.encode_frame(("hello", 0, cfg.to_wire())))[0][2]
    assert RefPolicy.from_wire(wire["policy"]) == RefPolicy(
        max_batch=16, mode="merge", pin_capacity=True)
    ref_cfg = RT.WorkerConfig(chunk=512, backend="jnp", dtype="float32",
                              policy=RefPolicy(max_batch=16, mode="merge",
                                               pin_capacity=True),
                              max_pending=64, plan_cache=32, linger_s=0.0,
                              stage_depth=None, pipeline_depth=4, x64=False,
                              pin_workers=False)
    back = T.WorkerConfig.from_wire(T.FrameDecoder().feed(
        RT.encode_frame(("hello", 0, ref_cfg.to_wire())))[0][2])
    assert back.policy == policy and back.chunk == 512
    assert back.device == "cuda"  # the port's default: the card


# ----------------------------------------- prefill warms before ready
def _cfg(persist_dir=None):
    return T.WorkerConfig(chunk=CHUNK, backend="cuda", dtype="float32",
                          policy=PINNED, max_pending=None, plan_cache=8,
                          linger_s=0.0, stage_depth=None, pipeline_depth=2,
                          pin_workers=False, device=DEV,
                          persist_dir=persist_dir)


def _populated_store(tmp_path) -> tuple[str, tuple]:
    """A plan store holding the (2, 5) family, and that family's prefill
    entry as the front ships it."""
    store = str(tmp_path / "plans")
    with DetQueue(chunk=CHUNK, policy=PINNED, device=DEV,
                  persist_dir=store) as q:
        q.serve([np.ones((2, 5), np.float32)], timeout=120)
    return store, route_key((2, 5), PINNED, np.float32)[:3]


def _warm(pc: dict) -> bool:
    """One family planned, and from the store."""
    return pc["size"] == 1 and pc["misses"] == 1 and pc["store_hits"] == 1


def test_spawned_worker_prefills_before_ready(tmp_path, monkeypatch):
    """A worker spawned with a warm-start prefill plans those families,
    store first, before it reads its first request: its first stats
    reply already holds the plan as a store hit.  In process, then as a
    spawned process."""
    import queue
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "_store_dir", _build._store_dir)
    store, entry = _populated_store(tmp_path)

    class Conn:
        def __init__(self):
            self.sent = []

        def send(self, msg):
            self.sent.append(msg)

        def close(self):
            pass

    req_q, conn = queue.Queue(), Conn()
    for msg in [("stats", 1), ("stop",)]:
        req_q.put(msg)
    T._local_worker_main(0, _cfg(store), req_q, conn, prefill=[entry])
    assert [m[0] for m in conn.sent] == ["stats", "bye"]
    assert _warm(conn.sent[0][2]["plan_cache"])

    link = T.LocalTransport(1)._spawn(0, _cfg(store), prefill=[entry])
    try:
        link.send(("stats", 2))
        deadline = time.monotonic() + 120
        got = []
        while not any(m[0] == "stats" for m in got):
            assert time.monotonic() < deadline, got
            msgs, dead = link.pump()
            got += msgs
            assert not dead or msgs, "the spawned worker died"
            time.sleep(0.05)
        stats = [m for m in got if m[0] == "stats"][0]
        assert stats[3] == 2 and _warm(stats[2]["plan_cache"])
        link.send(("stop",))
        link.join(timeout=60)
        assert link.process.exitcode == 0
    finally:
        link.kill()
        link.join(timeout=10)
        link.close()


def test_hello_with_prefill_warms_the_daemons_queue(tmp_path, monkeypatch):
    """A hello that ships a prefill list makes the daemon plan those
    families (store first) before it answers ready: the first stats
    reply after the ready holds them as store hits."""
    import socket
    import threading
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "_store_dir", _build._store_dir)
    store, entry = _populated_store(tmp_path)
    with socket.create_server(("127.0.0.1", 0)) as srv:
        front = socket.create_connection(srv.getsockname(), timeout=10)
        worker, _ = srv.accept()
    session = threading.Thread(
        target=T._serve_front_session,
        args=(worker, ("loopback", 0), lambda *a, **k: None), daemon=True)
    try:
        wire = _cfg(store).to_wire()
        wire["prefill"] = [entry]
        front.sendall(T.encode_frame(("hello", 0, wire)))
        session.start()
        decoder = T.FrameDecoder()

        def frame(kind):
            while True:
                msg = T._read_frame(front, decoder, timeout=60,
                                    skip_hb=True)
                assert msg is not None, f"no {kind} frame"
                if msg[0] == kind:
                    return msg

        assert frame("ready") == ("ready", 0)
        front.sendall(T.encode_frame(("stats", 5)))
        stats = frame("stats")
        assert stats[3] == 5 and _warm(stats[2]["plan_cache"])
        front.sendall(T.encode_frame(("stop",)))
        frame("bye")
        session.join(timeout=60)
        assert not session.is_alive()
    finally:
        front.close()
        worker.close()


def test_dead_worker_with_unread_batch_does_not_block_exit():
    """A local worker that dies before reading a batch larger than the
    pipe's buffer leaves its queue's feeder thread blocked on the write;
    the front's process must still exit (the reference's joins that
    thread at exit and never ends)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = (
        "import numpy as np\n"
        "from repro_torch.launch import transport as T\n"
        "from repro_torch.launch.det_queue import BucketPolicy\n"
        "cfg = T.WorkerConfig(chunk=128, backend='cuda', dtype='float32',\n"
        "    policy=BucketPolicy(), max_pending=None, plan_cache=8,\n"
        "    linger_s=0.0, stage_depth=None, pipeline_depth=2,\n"
        "    pin_workers=False, device='cpu')\n"
        "(link,) = T.LocalTransport(1).start(cfg)\n"
        "link.kill()\n"
        "link.process.join(timeout=60)\n"
        "link.send(('batch', 0, [(0, np.ones((1, 1 << 18), np.float32))]))\n"
        "link.close()\n"
        "print('closed', flush=True)\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "closed"
