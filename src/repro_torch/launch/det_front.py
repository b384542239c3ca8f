"""Multi-worker bucket-routing determinant serving front.

Port of ``repro/launch/det_front.py``.  Routing, placement, re-routing,
the straggler sweep and stats aggregation are the reference's; what
changes: the front takes ``device`` and hands it to every worker (a
spawned pool on ``"cuda"`` checks for a card and builds the kernel
library once, before any worker starts: into the plan store when there
is one), and the routing key's last field says whether the family
computes in float64 (the dtype carries the precision; the reference
reads jax's x64 flag there).  ``persist_dir``/``prefill`` are the
reference's warm start (DESIGN_PERSIST.md): workers plan from the store,
and joiners are shipped the live plan families before admission.

The paper's rank space C(n, m) is a property of the request's *shape*:
one (m, n) class is one plan, one Pascal table, one entry in the
engine's cache.  The scaling unit of the serving tier is therefore
the **plan**, not the request — so the front routes every submitted
matrix by its canonical plan-family key (:func:`route_key`, the
``(m, n, capacity, dtype, x64)`` projection of the engine's
:class:`~repro_torch.core.engine.PlanKey` space) over a consistent-hash
ring of workers, with *bounded-load* placement:
plan keys are few, so raw arc ownership splits load as a handful of
coin flips — instead the front walks the key's clockwise ring order and
takes the first worker whose accumulated plan weight stays within
``1 + eps`` of the fair share, weighting each plan family by its exact
per-request device work ``C(n, m)`` (:class:`PlanPlacer`).  Each worker
owns a disjoint set of plan families and runs its own
:class:`~repro_torch.launch.det_queue.DetQueue` +
:class:`~repro_torch.core.engine.DetEngine`, so:

* no plan is built twice across the pool (ownership is exclusive
  while the membership is stable);
* each worker's executable cache stays LRU-bounded exactly as in the
  single-process queue — the pool bound is the sum of the per-worker
  bounds;
* membership changes move only the keys owned by the changed worker
  (the consistent-hashing property), and because plans are pure
  functions of their key, a re-routed request re-plans on its new owner
  and reproduces **bit-identical** results: the kernels and the torch
  backend compute each matrix of a batch alone (no reduction crosses
  batch slots), so batch re-grouping on the new owner cannot change a
  bit, and each request is answered whole by one worker.

The wire is a pluggable :class:`~repro_torch.launch.transport.Transport`
(DESIGN_FRONT.md has the protocol spec):

    submit()/submit_many() ──route──► per-worker WorkerLink.send
        ──[worker: DetQueue + DetEngine]──► response frames
        ──[one front drainer thread: wait over link waitables]──►
        futures + poll()

:class:`~repro_torch.launch.transport.LocalTransport` (default) is the
spawn + Queue/Pipe single-host pool; :class:`~repro_torch.launch.transport
.SocketTransport` (``det_serve --connect``) is the multi-host pool over
TCP worker daemons.  Routing, placement, re-route semantics and stats
aggregation are transport-blind: peer death — a process sentinel, a
socket EOF, a torn frame, a heartbeat deadline, or an unacknowledged
batch past ``ack_timeout_s`` — always funnels into the same
deterministic re-route of the dead worker's pending requests.

The front exposes the same surface as ``DetQueue`` — ``submit`` /
``submit_many`` / ``poll`` / ``serve`` / ``snapshot`` / ``close`` —
with futures resolved across the transport by the drainer thread.
:class:`~repro_torch.launch.det_queue.LoadShedError` propagates end-to-end
(per-worker ``max_pending`` admission control) and ``snapshot()``
aggregates every worker's stats into one report (with a ``degraded``
flag instead of an exception when a worker dies mid-snapshot).

See DESIGN_FRONT.md for the routing/failure semantics,
``tests/test_torch_det_front.py`` for the bit-identity battery and
``tests/test_torch_transport_faults.py`` for the fault-injection battery.
"""

from __future__ import annotations

import bisect
import math
import socket
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from multiprocessing import connection as mp_connection

import numpy as np
import torch

from repro_torch.core.engine import stable_key_hash
from repro_torch.core.radic import resolve_device
from repro_torch.launch.det_queue import (BucketPolicy, LoadShedError,
                                          QueueClosedError, drain_responses,
                                          prepare_matrix, resolve_future)
from repro_torch.launch.transport import (FrameDecoder, LocalTransport,
                                          ShmTransport, SocketLink,
                                          Transport, TransportError,
                                          WorkerConfig, _read_frame,
                                          encode_frame, parse_hostport)
from repro_torch.runtime.watchdog import StepTimer, Watchdog

__all__ = ["DetFront", "HashRing", "PlanPlacer", "WorkerError", "route_key"]


class WorkerError(RuntimeError):
    """A worker-side evaluation error whose concrete type could not be
    reconstructed across the process boundary; carries
    ``type name: message``."""


def route_key(shape: tuple[int, int], policy: BucketPolicy,
              dtype) -> tuple[int, int, int, str, bool]:
    """Canonical plan routing key ``(m, n, capacity, dtype, x64)`` for a
    request shape under a bucket policy.

    The tuple is the reference's, so both fronts place a family on the
    same worker: ``x64`` is true exactly when the family computes in
    float64, which in the port is the dtype itself (the reference reads
    jax's x64 flag, and computes float64 requests in float64 only with
    it set).

    ``(m, n)`` is the policy's *canonical* shape whenever merging is
    possible (``auto``/``merge``): every exact shape that could ever be
    column-padded into the same canonical bucket must land on the same
    worker, or a merge would plan its family on two hosts.  The
    capacity component is the policy's batch bound — the plan family's
    capacity class; the per-batch exact capacities a worker plans all
    belong to the family it owns.
    """
    m, n = int(shape[0]), int(shape[1])
    if policy.mode in ("auto", "merge"):
        m, n = policy.canonical_shape(m, n)
    name = np.dtype(dtype).name
    return (m, n, policy.max_batch, name, name == "float64")


class HashRing:
    """Consistent-hash ring: stable key → worker id, with virtual nodes.

    Placement uses :func:`repro_torch.core.engine.stable_key_hash`, so it is
    identical across processes and restarts (no ``PYTHONHASHSEED``
    dependence).  Removing a worker moves only the keys it owned to
    their next clockwise owner — the deterministic re-route target after
    a worker death.
    """

    def __init__(self, workers, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._points: list[tuple[int, int]] = []  # sorted (point, worker)
        for w in workers:
            self.add(int(w))

    def add(self, worker: int) -> None:
        for v in range(self.vnodes):
            pt = stable_key_hash(("det-front-vnode", worker, v))
            bisect.insort(self._points, (pt, worker))

    def remove(self, worker: int) -> None:
        self._points = [(p, w) for p, w in self._points if w != worker]

    def __len__(self) -> int:
        return len({w for _, w in self._points})

    def owner(self, key) -> int:
        """The worker owning ``key``: first ring point clockwise of the
        key's stable hash (wrapping)."""
        if not self._points:
            raise RuntimeError("hash ring is empty (no live workers)")
        pt = stable_key_hash(key)
        i = bisect.bisect_right(self._points, (pt, -1))
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def walk(self, key) -> list[int]:
        """Every distinct worker in clockwise ring order from the key's
        point — the deterministic candidate sequence for bounded-load
        placement (the plain ``owner`` is ``walk(key)[0]``)."""
        if not self._points:
            return []
        pt = stable_key_hash(key)
        i = bisect.bisect_right(self._points, (pt, -1))
        n = len(self._points)
        seen: set[int] = set()
        order: list[int] = []
        for j in range(n):
            w = self._points[(i + j) % n][1]
            if w not in seen:
                seen.add(w)
                order.append(w)
        return order


class PlanPlacer:
    """Bounded-load, sticky plan-family placement over a
    :class:`HashRing` — pure state, no transport, no processes (the
    property tests drive it directly).

    Placement: take the first worker on the key's clockwise ring walk
    whose load (summed weights of owned plan families) stays within
    ``1 + eps`` of the fair share, falling back to the least-loaded
    worker.  The weight of a plan family is its exact per-request
    device work ``C(n, m)``.  Ownership is sticky (memoized) until the
    owner leaves, so every request of a family keeps hitting the one
    worker that planned it.  The owner map is LRU-bounded
    (``max_families``): a long-tail shape stream must not grow the
    router's memory or permanently skew the load vector with weights of
    families that never recur — an evicted family simply re-assigns on
    next sight, the router analogue of an evicted plan re-planning.

    Not thread-safe on its own; the front serializes calls under its
    lock.
    """

    def __init__(self, worker_ids, *, vnodes: int = 64, eps: float = 0.25,
                 max_families: int = 128):
        self.ring = HashRing(worker_ids, vnodes=vnodes)
        self.eps = float(eps)
        self.max_families = int(max_families)
        self.owner_map: OrderedDict[tuple, int] = OrderedDict()
        self.load: dict[int, float] = {int(w): 0.0 for w in worker_ids}

    @staticmethod
    def key_weight(key: tuple) -> float:
        """A plan family's per-request device work: its rank-space size
        C(n, m) (1 for the degenerate m > n families).  Capped before
        the float conversion — an astronomically wide shape must not
        raise OverflowError mid-submit (the request itself still fails
        properly at plan time on its own future)."""
        m, n = int(key[0]), int(key[1])
        if m > n:
            return 1.0
        return float(min(math.comb(n, m), 10 ** 18))

    def assign(self, key: tuple, usable=None) -> int:
        """The key's current owner, assigning one on first sight.

        ``usable(wid)`` filters the routable workers (the front passes
        its liveness predicate); a worker must also still hold a load
        entry — a retiring worker stays alive to finish in-flight work
        but left the load map (and the ring) at retire time, so it
        never receives new or re-routed families.
        """
        wid = self.owner_map.get(key)
        if wid is not None and wid in self.load \
                and (usable is None or usable(wid)):
            self.owner_map.move_to_end(key)
            return wid
        routable = [a for a in self.load
                    if usable is None or usable(a)]
        if not routable:
            raise RuntimeError("no routable workers")
        wt = self.key_weight(key)
        total = sum(self.load[a] for a in routable) + wt
        bound = total * (1.0 + self.eps) / len(routable)
        pick = None
        for cand in self.ring.walk(key):
            if cand in routable and self.load[cand] + wt <= bound:
                pick = cand
                break
        if pick is None:
            pick = min(routable, key=lambda a: self.load[a])
        self.owner_map[key] = pick
        self.load[pick] += wt
        while len(self.owner_map) > self.max_families:
            old_key, old_wid = self.owner_map.popitem(last=False)
            if old_wid in self.load:
                self.load[old_wid] = max(
                    0.0, self.load[old_wid] - self.key_weight(old_key))
        return pick

    def release(self, wid: int) -> None:
        """Forget a departing worker's plan ownership so its families
        re-assign to the survivors on next sight."""
        for key in [k for k, o in self.owner_map.items() if o == wid]:
            del self.owner_map[key]
        self.load.pop(wid, None)

    def remove(self, wid: int) -> None:
        """Take a worker out of both the ring and the load map."""
        self.ring.remove(wid)
        self.release(wid)

    def add(self, wid: int) -> None:
        """Admit a worker into the ring and the load map (live join /
        rejoin).  Monotone by construction: the new node steals only the
        ring arcs its vnodes land on, and the sticky ``owner_map`` keeps
        every *already-assigned* family on the worker that planned it —
        the joiner picks up only families first seen (or re-assigned
        after an eviction/death) from now on.  Idempotent per id."""
        wid = int(wid)
        if wid not in self.load:
            self.ring.add(wid)
            self.load[wid] = 0.0


# -------------------------------------------------------------- front side
@dataclass
class _FrontRequest:
    """Front-side record of one routed request: enough to re-route it
    bit-identically if its worker dies before responding.  ``grad``
    requests carry their scalar cotangent ``ct`` (the determinant is
    scalar-valued, so one float is the whole cotangent payload)."""
    seq: int
    array: np.ndarray
    shape: tuple[int, int]
    future: Future
    grad: bool = False
    ct: float = 1.0
    t_submit: float = field(default_factory=time.perf_counter)

    def wire_pair(self) -> tuple:
        """The request's slot in a ``("batch", bid, pairs)`` message:
        ``(seq, arr)`` for a value request, ``(seq, arr, ct)`` for a
        gradient request — same triple on first routing and on every
        re-route, so a death cannot change what a request computes."""
        if self.grad:
            return (self.seq, self.array, self.ct)
        return (self.seq, self.array)


class _WorkerHandle:
    __slots__ = ("id", "link", "pending", "unacked", "alive", "clean",
                 "joined", "timer")

    def __init__(self, link, *, joined: bool = False,
                 timer: StepTimer | None = None):
        self.id = link.id
        self.link = link
        self.pending: dict[int, _FrontRequest] = {}
        self.unacked: dict[int, float] = {}  # batch id -> monotonic send t
        self.alive = True
        self.clean = False  # saw the worker's "bye"
        self.joined = joined  # admitted via live join (no transport entry)
        # per-worker completion-latency EMA (straggler health signal);
        # mutated only under the front's lock
        self.timer = timer if timer is not None else StepTimer()


_EXC_TYPES: dict[str, type[BaseException]] = {
    "LoadShedError": LoadShedError,
    "QueueClosedError": QueueClosedError,
    "OverflowError": OverflowError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
}


def _rebuild_exc(name: str, text: str) -> BaseException:
    cls = _EXC_TYPES.get(name)
    if cls is not None:
        return cls(text)
    return WorkerError(f"{name}: {text}")


class DetFront:
    """Horizontally scaled determinant serving: N workers behind a
    pluggable transport, one ``DetQueue`` + ``DetEngine`` each, requests
    routed by canonical plan key over a consistent-hash ring.

    >>> with DetFront(workers=2, max_batch=32) as front:
    ...     fut = front.submit(np.ones((2, 5), np.float32))
    ...     det = fut.result(timeout=60)

    ``transport`` selects the wire: the default is
    ``LocalTransport(workers)`` (spawned processes on this host); pass a
    :class:`~repro_torch.launch.transport.SocketTransport` to serve over
    remote ``det_serve --listen`` daemons instead (``workers`` is then
    taken from the transport's address list).  ``shm=True`` upgrades
    the default same-host pool to
    :class:`~repro_torch.launch.transport.ShmTransport` — matrix
    payloads ride a per-link shared-memory ring instead of the pickled
    queue, bit-identical results (``det_serve --shm``).

    ``device`` is where every worker's queue computes (default the
    card).  A pool the front spawns itself checks it first, as
    ``resolve_device`` does (``"cuda"`` without a card raises
    ``RuntimeError`` before any process starts), and on the card builds
    the kernel library once, so that the workers load it instead of
    each building it.  Remote daemons check their own device.

    Same contract as ``DetQueue``: ``submit`` returns a ``Future``
    carrying ``.seq``; every submitted seq appears on the ``poll()``
    stream exactly once (results, sheds and errors alike);
    ``close()`` is idempotent and never strands a future.
    """

    # reprolint lock-discipline registry (see DESIGN_LINT.md).  The
    # router lock is re-entrant (death path nests); the response deque
    # and the drainer's end-of-stream flag live under the response cv;
    # ``_stats_cv`` shares ``_lock``, so either name is the same mutex
    # for the stats-report attributes.
    _GUARDED_BY = {
        "_seq": ("_lock",),
        "_bid": ("_lock",),
        "_closing": ("_lock",),
        "_next_wid": ("_lock",),
        "_last_drain_t": ("_lock",),
        "stats": ("_lock",),
        "_stats_token": ("_lock", "_stats_cv"),
        "_stats_reports": ("_lock", "_stats_cv"),
        "_drained": ("_resp_cv",),
        "_responses": ("_resp_cv",),
        "_cold_wids": ("_lock",),
    }

    def __init__(self, workers: int = 2, *, transport: Transport | None = None,
                 chunk: int = 2048,
                 backend: str = "cuda", dtype=np.float32, device="cuda",
                 max_batch: int | None = None,
                 policy: BucketPolicy | None = None,
                 max_pending: int | None = None, plan_cache: int = 128,
                 linger_s: float = 0.0, stage_depth: int | None = None,
                 pipeline_depth: int = 8, pin_workers: bool = False,
                 vnodes: int = 64, response_buffer: int = 65536,
                 ack_timeout_s: float | None = None,
                 accept: str | None = None,
                 accept_heartbeat_s: float = 1.0,
                 accept_heartbeat_misses: int = 5,
                 straggler_factor: float | None = None,
                 straggler_warmup: int = 8,
                 straggler_cooldown_s: float = 5.0,
                 watchdog_s: float | None = None,
                 shm: bool = False, shm_ring_bytes: int = 8 << 20,
                 persist_dir: str | None = None,
                 prefill: bool | None = None):
        if policy is None:
            policy = BucketPolicy(
                max_batch=64 if max_batch is None else max_batch)
        elif max_batch is not None and max_batch != policy.max_batch:
            raise ValueError(
                f"conflicting max_batch: argument {max_batch} vs "
                f"policy.max_batch {policy.max_batch} — set it on the "
                "policy only")
        self.policy = policy
        self.dtype = np.dtype(dtype)
        self.device = torch.device(device)
        # the wire: sends, receives and peer-death signals all live
        # behind the links; everything below is transport-blind.
        # ``shm=True`` selects the zero-copy same-host ring for the
        # default (spawned, same-host) worker pool — it never applies
        # to an explicit transport, which may be remote.
        if transport is None:
            if shm:
                transport = ShmTransport(workers, ring_bytes=shm_ring_bytes)
            else:
                transport = LocalTransport(workers)
            # no card, no pool: raise before spawning anything
            self.device = resolve_device(self.device)
            if self.device.type == "cuda" and backend == "cuda":
                # one build for the pool: N workers starting at once
                # would each run the full parallel nvcc build (with a
                # store, the library lands there and workers load it)
                from repro_torch.kernels import _build
                if persist_dir is not None:
                    _build.use_store_dir(persist_dir)
                _build.load()
        self._transport = transport
        cfg = WorkerConfig(chunk=int(chunk), backend=backend,
                           dtype=self.dtype.name, policy=policy,
                           max_pending=max_pending,
                           plan_cache=int(plan_cache),
                           linger_s=float(linger_s),
                           stage_depth=stage_depth,
                           pipeline_depth=int(pipeline_depth),
                           pin_workers=bool(pin_workers),
                           device=str(self.device),
                           persist_dir=persist_dir)
        self._cfg = cfg
        # plan-family warm-start (DESIGN_PERSIST.md): joining workers
        # are shipped the live routing working set as a prefill list so
        # they plan (store first, plan second) before admission.
        # Default: on whenever a plan store is configured.
        self._prefill_enabled = (bool(prefill) if prefill is not None
                                 else persist_dir is not None)
        # workers the autoscaler currently judges cold (low plan-cache
        # hit rate, typically still planning after a join): shielded
        # from the straggler sweep so warm-up latency is never read as
        # slowness
        self._cold_wids: set[int] = set()
        # the hello a live-joining worker receives over the accept
        # listener — identical in shape to SocketTransport's handshake,
        # so a dialed-in daemon and a --connect daemon build the same
        # queue from the same config source
        self._accept_hb_s = float(accept_heartbeat_s)
        self._accept_hb_timeout = (self._accept_hb_s
                                   * int(accept_heartbeat_misses)
                                   if self._accept_hb_s > 0 else None)
        wire_cfg = cfg.to_wire()
        wire_cfg["heartbeat_s"] = self._accept_hb_s
        self._wire_cfg = wire_cfg
        self._workers = [_WorkerHandle(link) for link in transport.start(cfg)]
        self._by_id = {w.id: w for w in self._workers}
        self._placer = PlanPlacer(
            [w.id for w in self._workers], vnodes=vnodes,
            max_families=max(64, int(plan_cache) * len(self._workers)))
        self._next_wid = max(w.id for w in self._workers) + 1
        # straggler health: drain a worker whose completion-latency EMA
        # is persistently worse than its peers' (None = disabled)
        self._straggler_factor = straggler_factor
        self._straggler_warmup = int(straggler_warmup)
        self._straggler_cooldown = float(straggler_cooldown_s)
        # the first drain needs no cooldown: 0.0 here (the reference's
        # value) would hold every drain until the monotonic clock, which
        # counts from boot, passes the cooldown
        self._last_drain_t = float("-inf")
        # unacked-batch deadline: a worker acks every batch frame on
        # receipt, so this is an RTT/queueing-scale bound on frame loss
        # — deliberately NOT a compute deadline (a batch may
        # legitimately wait behind a long evaluation)
        self._ack_timeout = ack_timeout_s

        # reentrant: the death path (_on_worker_exit → _reroute) nests
        self._lock = threading.RLock()
        self._seq = 0
        self._bid = 0  # batch ids for the ack protocol
        self._closing = False
        self._drained = False  # drainer exited: the response stream is over
        self._responses: deque = deque(maxlen=response_buffer)
        self._resp_cv = threading.Condition()
        self._stats_cv = threading.Condition(self._lock)
        self._stats_token = 0
        self._stats_reports: dict[int, dict] = {}
        self.stats = self._zero_stats([w.id for w in self._workers])

        # runtime watchdog over the drainer: the drainer beats every
        # loop pass, so a wedged drain (a pump stuck in a pathological
        # link) surfaces as a counted stall instead of a silently
        # frozen response stream.  Built strictly before the drainer
        # thread starts — the loop reads the attribute.
        self._watchdog: Watchdog | None = None
        if watchdog_s is not None:
            self._watchdog = Watchdog(float(watchdog_s),
                                      self._note_drainer_stall).start()

        # live-join listener: a `det_serve --join host:port` daemon dials
        # in, the front assigns it a fresh worker id and admits it
        self._accept_srv: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self.accept_address: str | None = None
        if accept is not None:
            host, port = parse_hostport(accept, default_host="127.0.0.1")
            self._accept_srv = socket.create_server((host, port))
            bound = self._accept_srv.getsockname()
            self.accept_address = f"{bound[0]}:{bound[1]}"
            self._accept_srv.settimeout(0.25)
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name="det-front-accept",
                daemon=True)

        self._drainer = threading.Thread(target=self._drain_loop,
                                         name="det-front-drainer",
                                         daemon=True)
        self._drainer.start()
        if self._accept_thread is not None:
            self._accept_thread.start()

    @staticmethod
    def _zero_stats(worker_ids) -> dict:
        return {"submitted": 0, "completed": 0, "shed": 0, "errors": 0,
                "rerouted": 0, "worker_deaths": 0,
                "routed": {wid: 0 for wid in worker_ids},
                "stragglers_drained": 0, "drainer_stalls": 0,
                "joined": 0, "responses_dropped": 0}

    def _note_drainer_stall(self) -> None:
        with self._lock:
            self.stats["drainer_stalls"] += 1

    # ------------------------------------------------------------- routing
    @property
    def _balance_eps(self) -> float:
        return self._placer.eps

    def route_key(self, shape: tuple[int, int]) -> tuple:
        """The stable routing key for a request shape under this front's
        policy/dtype — ``(m, n, capacity, dtype, x64)``."""
        return route_key(shape, self.policy, self.dtype)

    def _owner(self, key: tuple) -> int:
        """The key's current owner (assigning on first sight).  Callers
        hold ``self._lock``."""
        try:
            return self._placer.assign(
                key, lambda wid: self._by_id[wid].alive)
        except RuntimeError:
            raise RuntimeError("DetFront has no live workers") from None

    def owner_of(self, shape: tuple[int, int]) -> int:
        """Which live worker currently owns a request shape (tests and
        chaos tooling: pick the right victim)."""
        with self._lock:
            return self._owner(self.route_key(shape))

    @property
    def alive_workers(self) -> list[int]:
        with self._lock:
            return [w.id for w in self._workers if w.alive]

    def describe_links(self) -> list[str]:
        """One transport descriptor per live worker link — ``local(…)``,
        ``shm(pid=…, ring=…)``, ``socket(…)`` — for ops/debug output and
        for tests asserting which wire a front actually selected."""
        with self._lock:
            return [w.link.describe() for w in self._workers if w.alive]

    # -------------------------------------------------------------- submit
    def _prepare(self, A) -> np.ndarray:
        return prepare_matrix(A, self.dtype)

    def submit(self, A, *, grad: bool = False,
               cotangent: float = 1.0) -> Future:
        """Route and enqueue one matrix; returns a ``Future`` with
        ``.seq``.  ``grad=True`` requests the VJP instead of the value:
        the future resolves to the (m, n) gradient ndarray
        ``cotangent · ∂det/∂A`` (see DESIGN_GRAD.md)."""
        return self._submit_prepared(
            [self._prepare(A)], [(bool(grad), float(cotangent))])[0]

    def submit_many(self, mats, grads=None) -> list[Future]:
        """Route and enqueue a burst: one message per owning worker, so
        each worker's stager sees a deep snapshot (full batches), not a
        trickle of singletons.  ``grads`` mirrors
        ``DetQueue.submit_many``: one ``(grad, cotangent)`` pair per
        matrix (``None`` = all value requests)."""
        return self._submit_prepared(
            [self._prepare(A) for A in mats],
            None if grads is None
            else [(bool(g), float(ct)) for g, ct in grads])

    def _send_batches(self, batches: dict[int, list]) -> None:
        """One framed ``batch`` message per owning worker, stamped with
        a batch id the worker acks on receipt.  A send failure does not
        raise: the link is broken, the drainer's next sweep declares the
        worker dead and re-routes its pending (including what we just
        routed to it).  Takes the (re-entrant) router lock itself, so it
        is safe from any caller."""
        with self._lock:
            for wid, pairs in batches.items():
                w = self._by_id[wid]
                bid = self._bid
                self._bid += 1
                w.unacked[bid] = time.monotonic()
                try:
                    w.link.send(("batch", bid, pairs))
                except TransportError as e:
                    w.unacked.pop(bid, None)
                    if w.link.broken:
                        continue  # peer gone: the sweep re-routes w.pending
                    # the link is healthy but this frame cannot be sent
                    # (e.g. an over-the-limit payload): re-routing would
                    # hit the same wall on every worker — fail these
                    for pr in pairs:
                        self._complete(w, pr[0], exc=e)

    def _submit_prepared(self, arrs: list[np.ndarray],
                         grads: list[tuple[bool, float]] | None = None
                         ) -> list[Future]:
        if grads is None:
            grads = [(False, 1.0)] * len(arrs)
        if len(grads) != len(arrs):
            raise ValueError("grads must match the matrices one-to-one")
        futs: list[Future] = []
        with self._lock:
            if self._closing:
                raise QueueClosedError("DetFront is closed")
            if not any(w.alive for w in self._workers):
                raise RuntimeError("DetFront has no live workers")
            batches: dict[int, list[tuple]] = {}
            for arr, (grad, ct) in zip(arrs, grads):
                shape = (int(arr.shape[0]), int(arr.shape[1]))
                # grad and value requests of one shape share the plan
                # family (same key → same worker): the backward reuses
                # the forward's plan, so splitting them would plan
                # the family twice across the pool for nothing
                wid = self._owner(self.route_key(shape))
                seq = self._seq
                self._seq += 1
                fut = Future()
                fut.seq = seq
                req = _FrontRequest(seq=seq, array=arr, shape=shape,
                                    future=fut, grad=grad, ct=ct)
                self._by_id[wid].pending[seq] = req
                self.stats["submitted"] += 1
                self.stats["routed"][wid] += 1
                batches.setdefault(wid, []).append(req.wire_pair())
                futs.append(fut)
            self._send_batches(batches)
        return futs

    # ---------------------------------------------------------- responses
    _resolve = staticmethod(resolve_future)

    def _complete(self, w: _WorkerHandle, seq: int, val=None,
                  exc: BaseException | None = None) -> None:
        with self._lock:
            req = w.pending.pop(seq, None)
            if req is None:
                return  # completed right before a kill we already re-routed
            # mirror DetQueue's counter semantics: "completed" is
            # delivered results only; sheds and errors get their own
            # counters (a response of any kind is still exactly one)
            if isinstance(exc, LoadShedError):
                self.stats["shed"] += 1
            elif exc is not None:
                self.stats["errors"] += 1
            else:
                self.stats["completed"] += 1
                # delivered results feed the worker's latency EMA — the
                # straggler-health signal (sheds return on admission
                # scale and would make a drowning worker look fast)
                w.timer.record(seq, time.perf_counter() - req.t_submit)
        # responses (and stats above) strictly before the future resolves,
        # mirroring DetQueue._deliver's ordering contract
        with self._resp_cv:
            dropped = max(0, len(self._responses) + 1
                          - (self._responses.maxlen or 0))
            self._responses.append((seq, val if exc is None else exc))
            self._resp_cv.notify_all()
        if dropped:
            with self._lock:
                self.stats["responses_dropped"] += dropped
        self._resolve(req.future, val=val, exc=exc)

    def _handle_msg(self, w: _WorkerHandle, msg) -> None:
        kind = msg[0]
        if kind == "result":
            self._complete(w, msg[1], val=msg[2])
        elif kind == "ack":
            with self._lock:
                w.unacked.pop(msg[1], None)
        elif kind == "shed":
            self._complete(w, msg[1], exc=LoadShedError(msg[2]))
        elif kind == "error":
            self._complete(w, msg[1], exc=_rebuild_exc(msg[2], msg[3]))
        elif kind == "requeue":
            # a retiring worker handed back an un-staged request: route it
            # to its next owner (the worker left the ring at retire time)
            with self._lock:
                req = w.pending.pop(msg[1], None)
                if req is not None:
                    self._reroute([req])
        elif kind == "stats":
            with self._lock:
                if msg[3] == self._stats_token:
                    self._stats_reports[msg[1]] = msg[2]
                    self._stats_cv.notify_all()
        elif kind == "bye":
            w.clean = True

    # ------------------------------------------------- death and re-routing
    def _reroute(self, orphans: list[_FrontRequest]) -> None:
        """Deterministically re-dispatch requests whose worker went away.

        The dead/retired worker is already off the ring, so ``owner()``
        yields each key's next clockwise owner — the same answer for the
        same key on every front instance (stable hashing).  Plans are
        pure functions of their key, so the new owner reproduces the
        same results — bit-identical when the policy pins capacity (one
        program shape per bucket; otherwise re-grouping may select a
        different batch-size specialization, the capacity effect
        DESIGN_SERVE.md documents).
        """
        with self._lock:
            orphans = sorted(orphans, key=lambda r: r.seq)
            alive = [w for w in self._workers
                     if w.alive and w.id in self._placer.load]
            if not alive:
                exc = RuntimeError("DetFront: all workers are gone")
                with self._resp_cv:
                    self._responses.extend((r.seq, exc) for r in orphans)
                    self._resp_cv.notify_all()
                for r in orphans:
                    self._resolve(r.future, exc=exc)
                return
            batches: dict[int, list[tuple]] = {}
            for req in orphans:
                wid = self._owner(self.route_key(req.shape))
                self._by_id[wid].pending[req.seq] = req
                self.stats["rerouted"] += 1
                batches.setdefault(wid, []).append(req.wire_pair())
            self._send_batches(batches)

    def _on_worker_exit(self, w: _WorkerHandle) -> None:
        with self._lock:
            if not w.alive:
                return
            w.alive = False
            self._placer.remove(w.id)
            orphans = list(w.pending.values())
            w.pending.clear()
            w.unacked.clear()
            if not w.clean:
                self.stats["worker_deaths"] += 1
            self._stats_cv.notify_all()  # a stats() waiter stops expecting it
        w.link.join(timeout=5)
        if orphans:
            self._reroute(orphans)

    def _expire_worker(self, w: _WorkerHandle) -> None:
        """A transport-level death verdict (broken link, heartbeat
        deadline, unacked batch): surface whatever responses are still
        buffered, then kill the link and re-route the rest."""
        msgs, _ = w.link.pump()
        for m in msgs:
            self._handle_msg(w, m)
        try:
            w.link.kill()
        except Exception:  # noqa: BLE001 — already half-dead links differ
            pass
        self._on_worker_exit(w)

    def _drain_loop(self) -> None:
        try:
            self._drain_loop_inner()
        finally:
            # backstop for an exception path: the flag must be set even
            # if the loop died, or every poller would wait forever
            with self._resp_cv:
                self._drained = True
                self._resp_cv.notify_all()

    def _drain_loop_inner(self) -> None:
        while True:
            with self._lock:
                live = [w for w in self._workers if w.alive]
                if not live:
                    # set the end-of-stream flag atomically with the
                    # liveness check (under self._lock): a concurrent
                    # reconnect_worker serializes behind this lock and
                    # therefore either revives a worker before we look
                    # (we keep looping) or observes _drained and
                    # restarts the drainer — never a live worker with
                    # no drainer
                    with self._resp_cv:
                        self._drained = True
                        self._resp_cv.notify_all()
                    return  # clean shutdown or total loss
            waitmap: dict = {}
            for w in live:
                for obj in w.link.waitables():
                    waitmap.setdefault(obj, w)
            try:
                ready = mp_connection.wait(list(waitmap), timeout=0.2) \
                    if waitmap else []
                if not waitmap:
                    time.sleep(0.05)  # all links broken; sweep below acts
            except (OSError, ValueError):
                ready = []  # a handle closed under us mid-wait; sweep below
            woken: list[_WorkerHandle] = []
            seen: set[int] = set()
            for obj in ready:
                w = waitmap[obj]
                if id(w) not in seen:
                    seen.add(id(w))
                    woken.append(w)
            for w in woken:
                msgs, dead = w.link.pump()
                for m in msgs:
                    self._handle_msg(w, m)
                if dead:
                    self._on_worker_exit(w)
            # transport-level death sweep: verdicts no waitable can
            # signal — a broken/killed link, a peer silent past its
            # heartbeat deadline, a batch unacked past the ack bound
            now = time.monotonic()
            for w in live:
                if not w.alive:
                    continue
                with self._lock:  # submit/ack paths mutate unacked
                    stale = self._ack_timeout is not None and any(
                        now - t > self._ack_timeout
                        for t in w.unacked.values())
                if w.link.broken or w.link.expired(now) or stale:
                    self._expire_worker(w)
            # straggler verdicts ride the same sweep: persistently slow
            # workers get a graceful drain, not just dead ones
            if self._straggler_factor is not None:
                self._sweep_stragglers(now)
            if self._watchdog is not None:
                self._watchdog.beat()

    def _sweep_stragglers(self, now: float) -> None:
        """Drain (retire) a worker whose completion-latency EMA is
        persistently worse than its peers' — ``straggler_factor`` × the
        median of the *other* warmed workers.  At most one drain per
        ``straggler_cooldown_s`` (hysteresis: the survivors' EMAs need
        time to absorb the re-routed families before the next verdict),
        and never below two routable workers (a pool of one has no
        baseline and no re-route target).
        """
        victim = None
        with self._lock:
            if now - self._last_drain_t < self._straggler_cooldown:
                return
            # cold workers (per the autoscaler's plan-cache hit-rate
            # signal) are excluded on both sides of the comparison: a
            # joiner still planning its families must neither be
            # drained for warming up nor drag the peer baseline
            warmed = [(w, w.timer.ema) for w in self._workers
                      if w.alive and w.id in self._placer.load
                      and w.id not in self._cold_wids
                      and w.timer.ema is not None
                      and w.timer.n >= self._straggler_warmup]
            if len(warmed) >= 2:
                worst, worst_ema = max(warmed, key=lambda t: t[1])
                others = sorted(e for w, e in warmed if w is not worst)
                baseline = others[len(others) // 2]
                if worst_ema > self._straggler_factor * baseline:
                    victim = worst
                    self._last_drain_t = now
                    self.stats["stragglers_drained"] += 1
        if victim is not None:
            self.retire_worker(victim.id)

    # ------------------------------------------------------ poll and serve
    def poll(self, max_items: int | None = None,
             timeout: float | None = 0.0) -> list[tuple[int, float]]:
        """Drain completed ``(seq, det)`` responses — same contract as
        ``DetQueue.poll``: waits up to ``timeout`` for the first item,
        then drains what's ready; errored/shed requests deliver their
        exception instance; every seq appears exactly once."""
        # the drainer is the only producer of new responses: once it has
        # flagged itself drained (clean close OR total worker loss),
        # every response that will ever exist is already in the deque —
        # a flag, not thread-liveness, because a poller woken by the
        # drainer's final notify could still observe the thread alive
        def eos():
            with self._resp_cv:  # re-entrant under drain_responses' hold
                return self._drained
        # the deque reference is immutable after __init__; drain_responses
        # does every mutation under the cv it is handed here
        return drain_responses(self._responses, self._resp_cv,  # reprolint: disable=lock-discipline
                               eos, max_items, timeout)

    def serve(self, mats, timeout: float | None = None):
        """Submit everything, wait for everything; ``(dets, stats)``.
        Shed/errored requests surface as exceptions from the futures —
        use :meth:`submit_many` directly for shed-tolerant flows."""
        futs = self.submit_many(mats)
        dets = [f.result(timeout=timeout) for f in futs]
        self.poll(timeout=0)
        return dets, self.snapshot()

    # ---------------------------------------------------------------- stats
    def reset_stats(self) -> None:
        """Zero front counters and every worker's queue counters (FIFO
        request streams order the reset before any later batch)."""
        with self._lock:
            routed = {wid: 0 for wid in self.stats["routed"]}
            self.stats = self._zero_stats([])
            self.stats["routed"] = routed
            for w in self._workers:
                if w.alive:
                    try:
                        w.link.send(("reset",))
                    except TransportError:
                        pass  # dying worker: the sweep will collect it

    def snapshot(self, timeout: float = 30.0) -> dict:
        """One aggregated report over the whole pool.

        ``front`` holds the router's own counters, ``workers`` the
        per-worker ``DetQueue.snapshot()`` s (keyed by worker id), and
        ``total`` sums the scalar counters, merges the per-bucket stats
        and aggregates the plan caches (hits/misses/evictions summed,
        ``backlog_peak`` maxed) — the single pane the CLI prints.

        Never raises on a worker that died between the liveness check
        and its stats reply (or whose link refused the send): the
        report is returned with whatever workers answered and
        ``front["degraded"] = True`` — partial observability of a
        degraded pool is still observability.
        """
        with self._lock:
            alive = [w for w in self._workers if w.alive]
            self._stats_token += 1
            token = self._stats_token
            self._stats_reports = {}
            asked: list[_WorkerHandle] = []
            for w in alive:
                try:
                    w.link.send(("stats", token))
                    asked.append(w)
                except TransportError:
                    pass  # dead between liveness check and request
            deadline = time.monotonic() + timeout
            # a worker dying mid-wait notifies the cv and drops out of
            # the expected count (its report will never come)
            while len(self._stats_reports) < sum(
                    1 for w in asked if w.alive):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._stats_cv.wait(remaining)
            reports = dict(self._stats_reports)
            degraded = len(reports) < len(alive)
            front = {k: (dict(v) if isinstance(v, dict) else v)
                     for k, v in self.stats.items()}
            front["workers_alive"] = sum(1 for w in self._workers if w.alive)
            front["workers_total"] = len(self._workers)
            front["plan_load"] = dict(self._placer.load)
            front["plan_families"] = len(self._placer.owner_map)
            front["degraded"] = degraded
            # autoscaler inputs: per-worker front-side backlog and the
            # completion-latency EMA the straggler sweep reads
            front["pending"] = {w.id: len(w.pending)
                                for w in self._workers if w.alive}
            front["latency_ema_s"] = {w.id: w.timer.ema
                                      for w in self._workers
                                      if w.alive and w.timer.ema is not None}
            front["accept_address"] = self.accept_address
            front["cold_workers"] = sorted(self._cold_wids)
            front["prefill"] = self._prefill_enabled
        return {"front": front, "workers": reports,
                "total": self._aggregate(reports)}

    @staticmethod
    def _aggregate(reports: dict[int, dict]) -> dict:
        # the port's queues count gradient dispatches apart
        # (``grad_dispatches``); the reference's do not
        total = {"submitted": 0, "completed": 0, "batches": 0,
                 "dispatches": 0, "grad_dispatches": 0,
                 "merged_requests": 0, "padded_slots": 0,
                 "ranks": 0, "shed": 0, "backlog_peak": 0,
                 "responses_dropped": 0, "buckets": {},
                 "plan_cache": {"size": 0, "max_plans": 0, "hits": 0,
                                "misses": 0, "evictions": 0,
                                "store_hits": 0, "store_misses": 0}}
        for snap in reports.values():
            for k in ("submitted", "completed", "batches", "dispatches",
                      "grad_dispatches", "merged_requests", "padded_slots",
                      "ranks", "shed", "responses_dropped"):
                total[k] += snap.get(k, 0)
            total["backlog_peak"] = max(total["backlog_peak"],
                                        snap.get("backlog_peak", 0))
            for shape, b in snap.get("buckets", {}).items():
                agg = total["buckets"].setdefault(
                    shape, {"count": 0, "batches": 0, "ranks": 0,
                            "wait_s": 0.0})
                for k in agg:
                    agg[k] += b.get(k, 0)
            pc = snap.get("plan_cache", {})
            for k in total["plan_cache"]:
                total["plan_cache"][k] += pc.get(k, 0)
        return total

    # ----------------------------------------------------- dynamic membership
    def _prefill_entries(self) -> list:
        """The live routing working set as a wire-plain prefill list.

        One ``(m, n, capacity)`` tuple per currently-assigned plan
        family, least-recently-used first (the joiner warms hot
        families last, so they are freshest in its LRU).  dtype and
        device ride the worker config, not the list.
        """
        with self._lock:
            return [(int(k[0]), int(k[1]), int(k[2]))
                    for k in self._placer.owner_map]

    def mark_cold_workers(self, wids) -> None:
        """Record which workers the autoscaler currently judges cold
        (plan-cache hit rate below its threshold).  Cold workers are
        exempt from the straggler sweep — a joiner paying its first plans
        must not read as a slow peer and get drained for warming up."""
        cold = {int(w) for w in wids}
        with self._lock:
            self._cold_wids = cold

    def _reserve_wid(self) -> int:
        with self._lock:
            if self._closing:
                raise QueueClosedError("DetFront is closed")
            wid = self._next_wid
            self._next_wid += 1
            return wid

    def _admit(self, link, *, joined: bool = False) -> int:
        """Admit a live link as a brand-new pool member (the join path's
        single synchronization point).

        Everything happens under the router lock, so admission is
        atomic with respect to routing: no batch can route to the
        joiner before its handle, ring arc and load entry all exist.
        The sticky ``owner_map`` (see :meth:`PlanPlacer.add`) keeps
        every in-flight and already-assigned family on its current
        owner — the joiner only picks up families first seen after this
        point, which is what keeps results bit-identical through a join
        (a family never half-moves between planned workers).
        """
        w = _WorkerHandle(link, joined=joined)
        with self._lock:
            if self._closing:
                raise QueueClosedError("DetFront is closed")
            self._workers.append(w)
            self._by_id[w.id] = w
            self._placer.add(w.id)
            self.stats["routed"].setdefault(w.id, 0)
            self.stats["joined"] += 1
            # same revival dance as reconnect_worker: if total loss had
            # ended the response stream, the admitted worker restarts it
            with self._resp_cv:
                restart = self._drained
                if restart:
                    self._drained = False
            if restart:
                self._drainer = threading.Thread(target=self._drain_loop,
                                                 name="det-front-drainer",
                                                 daemon=True)
                self._drainer.start()
        return w.id

    def grow(self, count: int = 1) -> list[int]:
        """Scale the pool up by ``count`` brand-new workers via the
        transport (spawn locally / dial a standby daemon) — the
        autoscaler's scale-up action.  Returns the admitted worker ids;
        stops early when the transport has no more capacity (no spare
        daemon addresses), so the result can be shorter than asked.
        """
        admitted: list[int] = []
        prefill = (self._prefill_entries() or None) \
            if self._prefill_enabled else None
        for _ in range(int(count)):
            wid = self._reserve_wid()
            try:
                link = self._transport.dial_new(wid, prefill)
            except TransportError:
                break
            if link is None:
                break
            admitted.append(self._admit(link))
        return admitted

    def _accept_loop(self) -> None:
        """Admit ``det_serve --join`` daemons dialing into the accept
        listener.  The handshake mirrors ``SocketTransport`` with the
        direction reversed: the front speaks first — ``("hello", wid,
        cfg)`` with a freshly reserved id and the same wire config every
        other worker got — and admits on ``("ready", wid)``, so a
        dialed-in worker and a ``--connect`` worker are
        indistinguishable past the handshake."""
        srv = self._accept_srv
        while True:
            with self._lock:
                if self._closing:
                    return
            try:
                conn, addr = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed under us (close())
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                wid = self._reserve_wid()
                decoder = FrameDecoder()
                wire_cfg = self._wire_cfg
                if self._prefill_enabled:
                    entries = self._prefill_entries()
                    if entries:
                        # ship the live working set: the joiner warms
                        # these families before it answers ready (and
                        # is only admitted on ready)
                        wire_cfg = dict(wire_cfg)
                        wire_cfg["prefill"] = entries
                conn.sendall(encode_frame(("hello", wid, wire_cfg)))
                msg = _read_frame(conn, decoder, timeout=30.0, skip_hb=True)
                if msg is None or msg[0] != "ready" or msg[1] != wid:
                    conn.close()
                    continue
                conn.settimeout(None)
                link = SocketLink(wid, conn, (addr[0], addr[1]),
                                  self._accept_hb_timeout, decoder=decoder)
                self._admit(link, joined=True)
            except (OSError, TransportError, QueueClosedError):
                try:
                    conn.close()
                except OSError:
                    pass
                with self._lock:
                    if self._closing:
                        return

    # ------------------------------------------------------------ lifecycle
    def retire_worker(self, worker_id: int) -> None:
        """Gracefully drain one worker: it leaves the ring *now* (new
        and requeued work routes to the survivors), hands back its
        un-staged backlog for re-routing, finishes in-flight batches,
        and exits.  The planned-downscale path; ``kill_worker`` is the
        chaos path."""
        with self._lock:
            w = self._by_id[worker_id]
            if not w.alive:
                return
            self._placer.remove(worker_id)
            try:
                w.link.send(("retire",))
            except TransportError:
                pass  # already unreachable: the sweep collects it as dead

    def reconnect_worker(self, worker_id: int) -> bool:
        """Graceful rejoin after a death: ask the transport to rebuild
        the worker's link (respawn the local process / re-dial the
        daemon address) and put it back on the ring.

        The stable hash re-inserts the worker's old arc, so ownership
        after the rejoin equals ownership before the death — the same
        determinism the re-route relies on, run in reverse.  The rejoined
        worker starts empty (fresh queue, fresh plan cache) and picks up
        families on next sight exactly like a re-routed family re-plans.
        Returns ``True`` when the worker is live again; ``False`` when
        the peer stayed unreachable.
        """
        with self._lock:
            if self._closing:
                raise QueueClosedError("DetFront is closed")
            w = self._by_id[worker_id]
            if w.alive:
                return True
            if w.joined:
                return False  # live-joined peers re-join by dialing in
        try:
            link = self._transport.redial(worker_id)
        except TransportError:
            return False
        if link is None:
            return False
        with self._lock:
            if w.alive or self._closing:
                link.close()  # raced another reconnect / a close
                return w.alive
            w.link = link
            w.pending.clear()
            w.unacked.clear()
            w.alive = True
            w.clean = False
            w.timer = StepTimer()  # a fresh peer earns a fresh EMA
            self._placer.add(worker_id)
            # _drained belongs to the response cv (pollers read it under
            # _resp_cv); nest it inside _lock in the established
            # lock -> resp_cv order (same as _drain_loop_inner)
            with self._resp_cv:
                restart = self._drained  # total loss had ended the stream
                if restart:
                    self._drained = False
            if restart:
                self._drainer = threading.Thread(target=self._drain_loop,
                                                 name="det-front-drainer",
                                                 daemon=True)
                self._drainer.start()
        return True

    def kill_worker(self, worker_id: int) -> None:
        """Chaos/test hook: make a worker unreachable *now* (SIGKILL for
        a local process, a torn connection for a socket peer).  The
        drainer detects the death, delivers whatever responses survived
        in flight, and re-routes the rest."""
        self._by_id[worker_id].link.kill()

    def close(self, timeout: float | None = None) -> None:
        """Idempotent shutdown: stop every worker (each drains its
        accepted backlog), join the drainer and the links, and fail
        any future that still has no response."""
        with self._lock:
            first = not self._closing
            self._closing = True
            alive = [w for w in self._workers if w.alive]
        if first:
            if self._watchdog is not None:
                self._watchdog.stop()
            if self._accept_srv is not None:
                try:
                    self._accept_srv.close()  # accept() raises, loop exits
                except OSError:
                    pass
            for w in alive:
                try:
                    w.link.send(("stop",))
                except TransportError:
                    pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        self._drainer.join(timeout=timeout)
        for w in self._workers:
            w.link.join(timeout=10)
            w.link.close()
        leftovers: list[_FrontRequest] = []
        with self._lock:
            for w in self._workers:
                leftovers.extend(w.pending.values())
                w.pending.clear()
        if leftovers:
            exc = QueueClosedError(
                f"DetFront closed with {len(leftovers)} unresolved requests")
            with self._resp_cv:
                self._responses.extend((r.seq, exc) for r in leftovers)
            for r in leftovers:
                self._resolve(r.future, exc=exc)
        with self._resp_cv:
            self._resp_cv.notify_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
