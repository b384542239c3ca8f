"""Async pipelined determinant serving: a thread-safe request/response
queue over the shape-bucketed batched Radic evaluator.

Port of ``repro/launch/det_queue.py``.  The phases of a batch — *stage*
(pad + stack + upload), *dispatch* (launch the kernel) and *complete*
(wait + unpack + deliver) — run on a pipeline of two threads connected by
a bounded queue:

    submit() ──► pending ──[stager]──► inflight ──[completer]──► futures

* **stager** snapshots the pending requests, plans buckets (below), pads
  each group into a pinned host stack, starts the upload with
  ``.to(device, non_blocking=True)`` on the current stream, launches the
  plan's kernel, enqueues the copy of its answers back into pinned host
  memory behind it (``.to("cpu", non_blocking=True)``, from torch's
  caching host allocator) and records a ``torch.cuda.Event`` behind the
  copy — without waiting — then stages the next batch.  The pinned stack
  rides with the batch until it completes, so the upload never reads
  freed memory.
* **completer** waits on the oldest in-flight batch's event, which marks
  the end of its kernel and of its copy back, then only reads host
  memory: it unpacks the answers and resolves the per-request futures
  (and the ``poll()`` response queue).  It makes no copy call to the
  driver and no stream synchronisation, so it never stalls the stager's
  driver calls; a pageable copy there would return only once every batch
  launched after its own had run.

Re-bucketing is dynamic (:class:`BucketPolicy`), with the reference's
decisions: under load, under-filled buckets that share a row count ``m``
are **merged** by zero-padding columns up to a canonical width — exact
for the Radic determinant, since every minor that touches a zero column
vanishes; hot buckets are **split** into ``max_batch`` slices.  Batch
composition never changes a result: the kernel's rank walk and reduction
order do not depend on the batch, so a request's determinant is
bit-identical alone or in any batch.

The dispatcher holds :class:`repro_torch.core.engine.DetPlan` s from one
LRU-bounded :class:`repro_torch.core.engine.DetEngine`, and admission
control (``max_pending`` + :class:`LoadShedError`) bounds the backlog
under overload.  Gradient requests (``submit(A, grad=True,
cotangent=ct)``) ride the same pipeline in batches of their own: the
stager dispatches the plan's cofactor-form VJP (``DetPlan.grad``) with the
batch's cotangents, and each request resolves to its ``(m, n)`` array.
``persist_dir`` opens the engine's plan store and ``prefill`` warms plan
families before traffic (DESIGN_PERSIST.md).  With a ``mesh``
(:class:`repro_torch.core.distributed.Mesh`) every batch is staged on the
mesh's first device and sharded rank space × batch over the grid
(``batch_axis``), as ``radic_det_batched(mesh=...)`` does.

The pipeline times itself.  ``stats`` (``snapshot()``) carries the
stager's ``stage_s`` a snapshot, of which ``stage_wait_s`` blocked on the
full in-flight queue and ``stage_cpu_s`` ran on a CPU
(``time.thread_time``); the completer's ``complete_host_s``, from a
batch's event to its futures resolved (the unpack and the delivery, no
copy); ``backlog_s``, each delivered request's wait from submit to the
stager's snapshot; and ``async_copies``, the batches whose answers came
back through a copy the stager enqueued (every dispatch on a card, none
on the CPU).  While a profiler runs, each phase is a ``torch.profiler``
range on the device trace's clock: ``queue.plan``, ``queue.pack``,
``queue.upload``, ``queue.launch``, ``queue.copy_back`` (a card's only)
and ``queue.handoff`` on the stager, ``queue.device_wait`` (a card's
only), ``queue.unpack`` and ``queue.deliver`` on the completer.  No range
encloses another, so a gap of the card is put down to one phase; a
profiler sees them only if it records every thread
(``profile_all_threads``), and without a profiler none is entered.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.autograd.profiler as _profiler

from repro_torch.core import DetEngine, comb
from repro_torch.core.radic import resolve_device

__all__ = ["BucketPolicy", "DetQueue", "LoadShedError", "QueueClosedError",
           "Request", "StagePlan", "plan_buckets", "pad_capacity",
           "bucket_by_shape", "drain_responses", "prepare_matrix",
           "resolve_future"]


def resolve_future(fut: Future, val=None, exc: BaseException | None = None):
    """set_result/set_exception tolerating a racing cancel: a future
    cancelled between the done() check and the set would otherwise raise
    InvalidStateError and take a pipeline thread down.  Shared by the
    queue and the multi-worker front."""
    try:
        if fut.done():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(val)
    except Exception:  # noqa: BLE001 — InvalidStateError from cancel race
        pass


_NO_RANGE = contextlib.nullcontext()


def _range(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler runs;
    else nothing, since a range costs about 10 µs even when no profiler
    records it and the stager sets the pace."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_RANGE


def prepare_matrix(A, dtype) -> np.ndarray:
    """Host-side request validation shared by queue and front: a single
    2-D matrix at the serving dtype."""
    arr = np.asarray(A, dtype=dtype)
    if arr.ndim != 2:
        raise ValueError(f"request is not a matrix: shape {arr.shape}")
    return arr


def drain_responses(responses: deque, cv: threading.Condition,
                    eos, max_items: int | None,
                    timeout: float | None) -> list[tuple]:
    """The shared ``poll()`` drain loop behind DetQueue and DetFront.

    Waits up to ``timeout`` for the first response (``0`` → pure poll,
    ``None`` → wait indefinitely), then drains whatever else is ready,
    up to ``max_items``.  ``eos()`` is the caller's end-of-stream
    predicate, evaluated under ``cv`` — true only once no response can
    ever be produced again (the two callers genuinely differ here:
    the queue's pipeline threads vs the front's drainer flag).
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    out: list[tuple] = []
    while max_items is None or len(out) < max_items:
        try:
            out.append(responses.popleft())
            continue
        except IndexError:
            pass
        if out:
            break
        with cv:
            if responses:
                continue
            if eos():
                break
            if deadline is None:
                cv.wait()
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not cv.wait(remaining):
                    break
    return out


class QueueClosedError(RuntimeError):
    """Raised on a pending request's future when the queue shuts down
    without serving it (``close(drain=False)``, or a teardown path that
    abandons the backlog).

    A serving front tearing a worker down must be able to call
    ``close()`` with a non-empty backlog and have every pending future
    resolve with *this* — never hang, never silently cancel — so the
    caller can distinguish "the queue went away" from a result, a
    :class:`LoadShedError`, or a per-batch evaluation error and re-route
    the request elsewhere.
    """


class LoadShedError(RuntimeError):
    """Raised on a request's future when admission control sheds it.

    A bounded backlog (``DetQueue(max_pending=...)``) protects the
    pipeline from unbounded memory growth and unbounded tail latency
    under overload: once the pending backlog is full, new submissions
    are rejected *immediately* — the future carries this exception and
    the ``poll()`` stream still delivers the request's seq exactly once
    — instead of queueing behind work that can't be served at the
    arrival rate.
    """


def bucket_by_shape(mats) -> dict[tuple[int, int], list[int]]:
    """Queue indices grouped by exact (m, n) shape, shapes sorted."""
    buckets: dict[tuple[int, int], list[int]] = defaultdict(list)
    for i, A in enumerate(mats):
        shp = np.shape(A)
        if len(shp) != 2:
            raise ValueError(f"request {i} is not a matrix: shape {shp}")
        buckets[tuple(shp)].append(i)
    return dict(sorted(buckets.items()))


def pad_capacity(k: int, max_batch: int) -> int:
    """Smallest power of two >= k, capped at ``max_batch``.

    ``k == 0`` (an empty bucket) has capacity 0: empty buckets dispatch
    nothing — a phantom all-zero row is wasted device work and a wasted
    jit cache entry.
    """
    if k <= 0:
        return 0
    cap = 1
    while cap < min(k, max_batch):
        cap *= 2
    return min(cap, max_batch)


@dataclass(frozen=True)
class BucketPolicy:
    """Dynamic re-bucketing knobs (all decisions are pure functions).

    mode:
      * ``"auto"`` — merge under-filled buckets only under load;
      * ``"merge"`` — always merge to the canonical column class
        (deterministic shapes regardless of load — what the bit-identity
        tests force);
      * ``"never"`` — exact-shape buckets only.

    A bucket with fewer than ``merge_below`` pending requests merges
    when the drained queue depth is at least ``merge_depth`` (``auto``).
    Merging rounds ``n`` up to the next multiple of ``col_class`` (never
    past ``col_max``); only buckets sharing ``m`` can land in the same
    canonical bucket.  The extra C(n_canon, m) − C(n, m) ranks all hit a
    zero column, so they contribute exact zeros.

    A bucket deeper than ``max_batch`` is split into ``max_batch``
    slices — under light load a bucket drains as one small padded batch,
    while a hot bucket fans out into several slices that overlap each
    other in the pipeline.  ``pin_capacity`` pads *every* batch to
    ``max_batch`` instead of the per-group power of two: one program
    shape per bucket, and per-request results that are independent of
    how requests happened to be grouped (the reference pins capacity
    because XLA specializes per batch shape; the port's kernel does not
    depend on the batch, and its plain CPU version is held to the same
    rule by the tests).
    """

    max_batch: int = 64
    mode: str = "auto"
    merge_below: int = 4
    merge_depth: int = 32
    col_class: int = 4
    col_max: int = 16
    pin_capacity: bool = False
    exact_capacity: bool = True

    def __post_init__(self):
        if self.mode not in ("auto", "merge", "never"):
            raise ValueError(f"unknown policy mode {self.mode!r}")
        if self.max_batch < 1 or self.col_class < 1:
            raise ValueError("max_batch and col_class must be >= 1")

    def to_wire(self) -> dict:
        """Plain-dict wire form for the socket transport's handshake:
        the daemon rebuilds the policy from the front's dict, so both
        sides bucket identically by construction (pickling the class
        would silently bind the daemon to the front's code version)."""
        from dataclasses import asdict
        return asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "BucketPolicy":
        from dataclasses import fields
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def canonical_shape(self, m: int, n: int) -> tuple[int, int]:
        """Merge target: n rounded up to the next ``col_class`` multiple."""
        if m > n or n >= self.col_max:
            return (m, n)  # zero-by-definition and huge shapes never merge
        n_canon = min(-(-n // self.col_class) * self.col_class, self.col_max)
        return (m, max(n_canon, n))

    def should_merge(self, pending: int, depth: int) -> bool:
        if self.mode == "merge":
            return True
        if self.mode == "never":
            return False
        return pending < self.merge_below and depth >= self.merge_depth

    def capacity(self, group: int) -> int:
        if group <= 0:
            return 0
        if self.pin_capacity:
            return self.max_batch
        if self.exact_capacity:
            # no padded batch rows at all: the AOT executable cache makes
            # one program per (shape, exact size) affordable, unlike the
            # traced path whose jit cache wants the pow2 bound (at most
            # max_batch variants per shape either way)
            return min(group, self.max_batch)
        return pad_capacity(group, self.max_batch)


@dataclass
class Request:
    """One queued matrix plus its delivery endpoints.

    ``grad``/``ct`` mark a gradient request (the cofactor-form VJP with
    scalar cotangent ``ct``): its future resolves to the ``(m, n)``
    ndarray ``ct · d(det)/dA`` instead of a float.
    """
    seq: int
    array: np.ndarray          # host copy, already the serving dtype
    shape: tuple[int, int]
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)
    grad: bool = False
    ct: float = 1.0


@dataclass
class StagePlan:
    """One device batch: requests bound to a canonical shape + capacity."""
    shape: tuple[int, int]     # canonical (m, n) the stack is padded to
    requests: list[Request]
    capacity: int
    merged_count: int          # how many requests were column-padded here
    grad: bool = False         # gradient batch: dispatches plan.grad
    t_taken: float = 0.0       # the stager's snapshot (perf_counter)

    @property
    def merged(self) -> bool:
        return self.merged_count > 0


def plan_buckets(requests: list[Request], policy: BucketPolicy,
                 depth: int | None = None) -> list[StagePlan]:
    """Pure bucket planner: requests → list of device batches.

    Groups by exact (shape, grad), applies the merge policy to pick each
    bucket's canonical shape, coalesces same-target buckets (FIFO by
    submit ``seq``), then splits every target bucket into
    ``<= max_batch`` slices with the policy's capacity.  Empty input
    plans nothing.

    Gradient buckets never column-merge: zero-padded columns are exact
    for the *value* (every minor touching one vanishes) but the result
    of a grad request is the full ``(m, n)`` array, whose shape the
    caller asked for — and ``jnp.linalg.det``'s pullback can be
    non-finite on rank-deficient padding.  Values and gradients of the
    same shape stay in separate device batches (one dispatches the
    forward executable, the other the VJP program).
    """
    if depth is None:
        depth = len(requests)
    by_shape: dict[tuple[tuple[int, int], bool], list[Request]] = \
        defaultdict(list)
    for r in requests:
        by_shape[(r.shape, r.grad)].append(r)
    targets: dict[tuple[tuple[int, int], bool], list[Request]] = \
        defaultdict(list)
    for (shape, grad), reqs in sorted(by_shape.items()):
        if not grad and policy.should_merge(len(reqs), depth):
            target = policy.canonical_shape(*shape)
        else:
            target = shape
        targets[(target, grad)].extend(reqs)
    plans: list[StagePlan] = []
    for (target, grad), reqs in sorted(targets.items()):
        reqs.sort(key=lambda r: r.seq)
        for base in range(0, len(reqs), policy.max_batch):
            grp = reqs[base:base + policy.max_batch]
            plans.append(StagePlan(
                shape=target, requests=grp,
                capacity=policy.capacity(len(grp)),
                merged_count=sum(1 for r in grp if r.shape != target),
                grad=grad))
    return plans


class _Shutdown:
    """Sentinel flowing through the pipeline queues."""


_SHUTDOWN = _Shutdown()


class DetQueue:
    """Thread-safe submit/poll determinant server with a staged pipeline.

    >>> with DetQueue(max_batch=32) as q:
    ...     fut = q.submit(np.ones((2, 5), np.float32))
    ...     det = fut.result(timeout=30)

    ``submit`` never blocks on device work; results arrive through the
    returned future and, tagged with the request sequence number, through
    ``poll()``.  ``serve(mats)`` is the synchronous convenience wrapper
    (submit all, wait all) used by the CLI and benchmarks.
    """

    # lock-discipline registry: these
    # attributes are shared between the caller, the stager and the
    # completer and may only be touched under one of the listed locks.
    # ``_wake`` is a Condition sharing ``_lock``, so holding either names
    # the same mutex; ``_responses`` lives under the response cv.
    _GUARDED_BY = {
        "_pending": ("_lock", "_wake"),
        "_seq": ("_lock", "_wake"),
        "_closing": ("_lock", "_wake"),
        "_fatal": ("_lock", "_wake"),
        "stats": ("_lock", "_wake"),
        "_responses": ("_resp_cv",),
    }

    def __init__(self, *, chunk: int = 2048, backend: str = "cuda",
                 max_batch: int | None = None,
                 policy: BucketPolicy | None = None,
                 dtype=np.float32, device=None, mesh=None,
                 batch_axis: str | None = None,
                 pipeline_depth: int = 8, linger_s: float = 0.0,
                 stage_depth: int | None = None,
                 response_buffer: int = 65536,
                 max_pending: int | None = None,
                 engine: DetEngine | None = None, plan_cache: int = 128,
                 persist_dir: str | None = None):
        if policy is None:
            policy = BucketPolicy(
                max_batch=64 if max_batch is None else max_batch)
        elif max_batch is not None and max_batch != policy.max_batch:
            raise ValueError(
                f"conflicting max_batch: argument {max_batch} vs "
                f"policy.max_batch {policy.max_batch} — set it on the "
                "policy only")
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        self.device = resolve_device(
            device if mesh is None else mesh.first_device)
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.policy = policy
        self.chunk = chunk
        self.backend = backend
        self.dtype = np.dtype(dtype)
        self._torch_dtype = torch.from_numpy(np.empty(0, self.dtype)).dtype
        self.linger_s = linger_s
        # the linger gate: how deep a pending snapshot must be before the
        # stager stops waiting for more arrivals.  The default (one
        # max_batch) is right for single-hot-bucket traffic, but a
        # multi-bucket stream spreads a snapshot over many shapes — with
        # pinned capacities every thin per-bucket group then pays a full
        # batch of padded device work, so serving tiers with B hot
        # buckets want roughly B * max_batch here (see
        # the reference's benchmarks/perf_serve.py --workers).
        self.stage_depth = policy.max_batch if stage_depth is None \
            else int(stage_depth)
        self.max_pending = max_pending
        # the dispatcher holds DetPlans, not raw lambdas: the engine owns
        # every executable behind one LRU-bounded cache (long-tail shape
        # traffic cannot grow the plan map without limit).
        # ``persist_dir`` turns on the durable plan store
        # (DESIGN_PERSIST.md): misses consult it before planning and
        # fresh plans write back in the store's background thread.
        self.engine = engine if engine is not None \
            else DetEngine(max_plans=plan_cache, persist_dir=persist_dir)

        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._pending: list[Request] = []
        self._seq = 0
        self._closing = False
        self._fatal: BaseException | None = None

        self._inflight: queue.Queue = queue.Queue(maxsize=pipeline_depth)
        # bounded: futures-only consumers never poll, so an unbounded
        # response log would leak on a long-lived queue.  Overflow drops
        # the oldest responses and is counted in stats.
        self._responses: deque = deque(maxlen=response_buffer)
        self._resp_cv = threading.Condition()

        self.stats = self._zero_stats()

        self._threads = [
            threading.Thread(target=self._stager, name="det-stager",
                             daemon=True),
            threading.Thread(target=self._completer, name="det-completer",
                             daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- submit
    def _enqueue(self, arrs: list[np.ndarray],
                 grads: list[tuple[bool, float]] | None = None
                 ) -> list[Future]:
        """Append prepared arrays under one lock, with one stager wake.

        ``grads`` pairs each array with its ``(grad, cotangent)``
        request mode (None → all value requests).

        Admission control: with ``max_pending`` set, arrays that would
        grow the un-staged backlog past the bound are *shed* — their
        future resolves immediately with :class:`LoadShedError` and
        their seq flows through ``poll()`` like any other response (so
        poll-driven consumers see every submission exactly once).  The
        check runs under the same lock the stager snapshots under, so a
        single ``submit_many`` burst sheds deterministically.
        """
        if grads is None:
            grads = [(False, 1.0)] * len(arrs)
        elif len(grads) != len(arrs):
            raise ValueError(
                f"grads length {len(grads)} != matrices {len(arrs)}")
        futs: list[Future] = []
        shed: list[Request] = []
        with self._wake:
            if self._closing:
                raise QueueClosedError("DetQueue is closed")
            if self._fatal is not None:
                raise RuntimeError("DetQueue pipeline died") from self._fatal
            for arr, (grad, ct) in zip(arrs, grads):
                req = Request(seq=self._seq, array=arr,
                              shape=(arr.shape[0], arr.shape[1]),
                              grad=bool(grad), ct=float(ct))
                self._seq += 1
                req.future.seq = req.seq
                futs.append(req.future)
                self.stats["submitted"] += 1
                if self.max_pending is not None \
                        and len(self._pending) >= self.max_pending:
                    self.stats["shed"] += 1
                    shed.append(req)
                    continue
                self._pending.append(req)
                self.stats["backlog_peak"] = max(
                    self.stats["backlog_peak"], len(self._pending))
            self._wake.notify_all()
        for req in shed:
            exc = LoadShedError(
                f"backlog full ({self.max_pending} pending): request "
                f"seq={req.seq} shape={req.shape} shed")
            with self._resp_cv:
                # same drop accounting as _deliver: an append into a full
                # response deque evicts the oldest undrained response
                dropped = max(0, len(self._responses) + 1
                              - (self._responses.maxlen or 0))
                self._responses.append((req.seq, exc))
                self._resp_cv.notify_all()
            if dropped:
                with self._lock:
                    self.stats["responses_dropped"] += dropped
            self._resolve(req.future, exc=exc)
        return futs

    def _prepare(self, A) -> np.ndarray:
        return prepare_matrix(A, self.dtype)

    def submit(self, A, *, grad: bool = False,
               cotangent: float = 1.0) -> Future:
        """Enqueue one matrix; returns a ``Future`` carrying ``.seq``.

        ``grad=True`` makes it a gradient request: the future resolves to
        the ``(m, n)`` ndarray ``cotangent · d(det)/dA`` (the cofactor-form
        VJP, DESIGN_GRAD.md) instead of the determinant."""
        return self._enqueue([self._prepare(A)],
                             [(grad, cotangent)])[0]

    def submit_many(self, mats, grads=None) -> list[Future]:
        """Enqueue a burst atomically: the stager sees one deep snapshot
        (full batches, load-aware re-bucketing) instead of a trickle.
        ``grads`` optionally pairs each matrix with ``(grad, cotangent)``
        (see :meth:`submit`)."""
        return self._enqueue([self._prepare(A) for A in mats], grads)

    def poll(self, max_items: int | None = None,
             timeout: float | None = 0.0) -> list[tuple[int, float]]:
        """Drain completed ``(seq, det)`` responses.

        Waits up to ``timeout`` for the first response (``0`` → pure
        poll, ``None`` → wait indefinitely), then drains whatever else is
        ready, up to ``max_items``.  A failed request's response carries
        the exception instance instead of a float — every submitted seq
        eventually appears exactly once.
        """
        # end-of-stream only once the pipeline has actually finished:
        # close(drain=True) keeps delivering responses after _closing is
        # set, and close() re-notifies the cv when the threads have been
        # joined
        def eos():
            with self._lock:
                closing, fatal = self._closing, self._fatal
            return (closing
                    and not any(t.is_alive() for t in self._threads)) \
                or fatal is not None
        # the deque reference is immutable after __init__; drain_responses
        # does every mutation under the cv it is handed here
        return drain_responses(self._responses, self._resp_cv, eos,  # reprolint: disable=lock-discipline
                               max_items, timeout)

    def serve(self, mats, timeout: float | None = None):
        """Submit everything, wait for everything; ``(dets, stats)``.

        Consumes the ``poll()`` responses of its own requests (don't mix
        ``serve`` with a concurrent ``poll`` consumer on one queue).
        """
        futs = self.submit_many(mats)
        dets = [f.result(timeout=timeout) for f in futs]
        self.poll(timeout=0)
        return dets, self.snapshot()

    @staticmethod
    def _zero_stats() -> dict:
        return {
            "submitted": 0, "completed": 0, "batches": 0, "dispatches": 0,
            "grad_dispatches": 0,
            "merged_requests": 0, "padded_slots": 0, "ranks": 0,
            "responses_dropped": 0, "shed": 0, "backlog_peak": 0,
            "stage_s": 0.0, "stage_wait_s": 0.0, "stage_cpu_s": 0.0,
            "complete_host_s": 0.0, "backlog_s": 0.0, "async_copies": 0,
            "buckets": {},
        }

    def snapshot(self) -> dict:
        with self._lock:
            s = dict(self.stats)
            s["buckets"] = {k: dict(v) for k, v in self.stats["buckets"].items()}
        s["plan_cache"] = self.engine.cache_info()
        return s

    def reset_stats(self):
        """Zero the counters (benchmarks: after the warm/compile pass, so
        a snapshot covers only the steady-state serving that followed)."""
        with self._lock:
            self.stats = self._zero_stats()

    # -------------------------------------------------------------- close
    def drain_pending(self) -> list[Request]:
        """Atomically remove and return every not-yet-staged request.

        The re-routing hook for a serving front: the caller takes
        ownership of the returned :class:`Request` s — their futures are
        still unresolved, their seqs have not appeared on the ``poll()``
        stream — and is responsible for either resolving them or
        re-submitting the arrays elsewhere (``launch/det_front.py`` does
        the latter when it retires a worker).  Requests already staged
        into the pipeline are not touched; they complete normally.
        """
        with self._wake:
            pend, self._pending = self._pending, []
        return pend

    def close(self, drain: bool = True, timeout: float | None = None):
        """Shut the pipeline down.  Idempotent and safe with a non-empty
        backlog: ``drain=True`` (default) serves everything already
        submitted; ``drain=False`` abandons the un-staged backlog, but
        every abandoned future resolves with :class:`QueueClosedError`
        (and its seq still flows through ``poll()``) — pending work never
        hangs a caller, whichever teardown path ran first.  Every call
        joins the pipeline threads, so concurrent/repeated ``close()``
        calls all return only once the pipeline has actually stopped.
        """
        with self._wake:
            self._closing = True
            pend: list[Request] = []
            if not drain:
                pend, self._pending = self._pending, []
            self._wake.notify_all()
        if pend:
            exc = QueueClosedError(
                f"DetQueue closed with {len(pend)} un-staged requests")
            with self._resp_cv:
                self._responses.extend((r.seq, exc) for r in pend)
                self._resp_cv.notify_all()
            for r in pend:
                self._resolve(r.future, exc=exc)
        for t in self._threads:
            t.join(timeout=timeout)
        with self._resp_cv:  # wake any poller blocked on a closed queue
            self._resp_cv.notify_all()
        # plan persistence is write-behind (DESIGN_PERSIST.md): drain the
        # store's writer so a short-lived process still lands its plans
        self.engine.flush_store()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ----------------------------------------------------------- pipeline
    def _plan(self, shape: tuple[int, int], capacity: int):
        """The :class:`~repro_torch.core.engine.DetPlan` for one device
        batch.  Keyed as the reference keys it: the ``torch`` backend (the
        jnp counterpart) pins the batch's capacity, the ``cuda`` backend
        (the pallas counterpart) and mesh plans take one shape for every
        batch size, so the plan cache counts what the reference's does on
        the same traffic.  The cache is LRU-bounded, so a long tail of
        request shapes re-plans instead of growing without limit."""
        m, n = shape
        pinned = self.backend == "torch" and self.mesh is None
        return self.engine.plan(
            m, n, batched=True, capacity=capacity if pinned else None,
            dtype=self.dtype, chunk=self.chunk, backend=self.backend,
            device=self.device, mesh=self.mesh, batch_axis=self.batch_axis)

    def prefill(self, entries) -> int:
        """Warm the engine for expected plan families before traffic.

        ``entries``: iterable of ``(m, n, capacity)`` — the wire form of
        a join handshake's prefill list (capacity is the policy bound;
        dtype/backend/chunk/device come from this queue's own config,
        exactly as ``_plan`` would bind them, so a prefetched plan IS the
        plan the first real batch will hit).  With a plan store
        configured the warm path is store-first, plan-second.  Malformed
        or unplannable entries are skipped; returns the number warmed.
        """
        warmed = 0
        for e in entries:
            try:
                m, n, cap = int(e[0]), int(e[1]), e[2]
                cap = None if cap is None else int(cap)
            except (TypeError, ValueError, IndexError):
                continue
            try:
                self._plan((m, n), cap)
                warmed += 1
            except Exception:   # noqa: BLE001 — prefill is best-effort
                continue
        return warmed

    _resolve = staticmethod(resolve_future)

    def _fail_plan(self, plan: StagePlan, exc: BaseException):
        """Fail one batch; the pipeline keeps serving others.

        The error is delivered on both response paths: the futures get
        ``set_exception``, and ``poll()`` consumers get a ``(seq, exc)``
        tuple — otherwise a poll-driven consumer would wait forever for
        an errored request's seq.
        """
        with self._resp_cv:
            self._responses.extend((r.seq, exc) for r in plan.requests)
            self._resp_cv.notify_all()
        for r in plan.requests:
            self._resolve(r.future, exc=exc)

    def _fatal_now(self) -> BaseException | None:
        """The pipeline-death exception, read under the lock (None while
        healthy).  ``_fatal`` is never reset, so a non-None result is
        stable without holding the lock further."""
        with self._lock:
            return self._fatal

    def _put_alive(self, q_: queue.Queue, item) -> bool:
        """Bounded put that aborts if the pipeline died.

        A dead downstream thread stops consuming; blocking forever in
        ``put()`` would then hang ``close()``.  Returns False once
        ``_fatal`` is set — the caller fails its in-hand batch and exits.
        """
        while self._fatal_now() is None:
            try:
                q_.put(item, timeout=0.2)
                if self._fatal_now() is not None:
                    # raced a dying pipeline: nobody may consume this item
                    self._drain_failed()
                return True
            except queue.Full:
                continue
        return False

    def _drain_failed(self):
        """Fail every batch sitting in the pipeline queue (fatal path)."""
        exc = self._fatal_now()
        while True:
            try:
                item = self._inflight.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, tuple):
                for r in item[0].requests:
                    self._resolve(r.future, exc=exc)

    def _fail_all(self, exc: BaseException):
        """A pipeline thread died: fail every future still in the system
        and unstick the sibling threads so ``close()`` can join them."""
        with self._wake:
            self._fatal = exc
            pend, self._pending = self._pending, []
            self._wake.notify_all()  # stager waits on this; it exits on fatal
        for r in pend:
            self._resolve(r.future, exc=exc)
        self._drain_failed()
        try:  # just drained, so there is room; a racing refill is
            self._inflight.put_nowait(_SHUTDOWN)  # handled by _put_alive
        except queue.Full:
            pass
        with self._resp_cv:
            self._resp_cv.notify_all()

    def _deliver(self, plan: StagePlan, outs: list[float], *, ranks: int = 0,
                 t_host: float | None = None,
                 count_batch: bool = False) -> float:
        """Deliver one finished batch — ``poll()`` responses and stats
        strictly before the futures resolve: a caller woken by the
        batch's last future must observe the batch fully counted and its
        responses visible (``serve()`` and the stats assertions in the
        tests rely on this).  ``count_batch`` is for paths that bypass
        the stager's batch accounting (the trivial m > n short-circuit).

        ``t_host`` (the completer's) starts the batch's host time, which
        is counted with the stats; the futures resolve after that, so
        their time is returned for the next batch to count.
        """
        k = len(plan.requests)
        now = time.perf_counter()
        submitted = sum(r.t_submit for r in plan.requests)
        wait = k * now - submitted
        # drop accounting under the response cv so concurrent deliverers
        # (stager's trivial path + completer) don't both read a stale
        # length; an active poller draining in parallel can still make
        # this an upper bound, which is fine for a diagnostic counter
        with self._resp_cv:
            dropped = max(0, len(self._responses) + k
                          - (self._responses.maxlen or 0))
            self._responses.extend(
                (r.seq, val) for r, val in zip(plan.requests, outs))
            self._resp_cv.notify_all()
        with self._lock:
            st = self.stats
            st["batches"] += 1 if count_batch else 0
            st["completed"] += k
            st["ranks"] += ranks
            st["backlog_s"] += k * plan.t_taken - submitted
            st["responses_dropped"] += dropped
            b = st["buckets"].setdefault(
                plan.shape, {"count": 0, "batches": 0, "ranks": 0,
                             "wait_s": 0.0})
            b["count"] += k
            b["batches"] += 1
            b["ranks"] += ranks
            b["wait_s"] += wait
            t_counted = time.perf_counter()
            if t_host is not None:
                st["complete_host_s"] += t_counted - t_host
        for r, val in zip(plan.requests, outs):
            self._resolve(r.future, val)
        return time.perf_counter() - t_counted

    def _complete_trivial(self, plan: StagePlan):
        """Deliver an m > n batch (det = 0 by definition) straight from
        the stager: no device work at all.  A grad request's pullback is
        the all-zero ``(m, n)`` array for the same reason."""
        if plan.grad:
            m, n = plan.shape
            outs = [np.zeros((m, n), dtype=self.dtype)
                    for _ in plan.requests]
        else:
            outs = [0.0] * len(plan.requests)
        self._deliver(plan, outs, count_batch=True)

    def _pack(self, plan: StagePlan) -> tuple[torch.Tensor, ...]:
        """Pad + stack one planned batch into host buffers → ``(stack,)``,
        or ``(stack, cotangents)`` for a grad batch.  On a card they are
        pinned, so that the upload can be asynchronous; the caller keeps
        them alive until the batch completes.

        Grad batches also stage the per-matrix cotangent vector; padded
        slots carry ``ct = 0`` and are sliced off before delivery, so
        whatever the pullback produces for the all-zero padding matrices
        never reaches a caller."""
        m, n = plan.shape
        cuda = self.device.type == "cuda"
        host = torch.zeros((plan.capacity, m, n), dtype=self._torch_dtype,
                           pin_memory=cuda)
        view = host.numpy()
        for j, r in enumerate(plan.requests):
            rm, rn = r.shape
            view[j, :rm, :rn] = r.array   # zero col-pad is det-exact
        if not plan.grad:
            return (host,)
        host_ct = torch.zeros((plan.capacity,), dtype=self._torch_dtype,
                              pin_memory=cuda)
        host_ct.numpy()[:len(plan.requests)] = [r.ct for r in plan.requests]
        return host, host_ct

    def _upload(self, host: tuple[torch.Tensor, ...]
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Begin the copies of ``_pack``'s buffers → ``(device stack,
        device cotangents or None)``; on a card they are asynchronous on
        the current stream."""
        cuda = self.device.type == "cuda"
        dev = [t.to(self.device, non_blocking=cuda) for t in host]
        return dev[0], (dev[1] if len(dev) > 1 else None)

    def _stager(self):
        try:
            while True:
                with self._wake:
                    while not self._pending and not self._closing \
                            and self._fatal is None:
                        self._wake.wait()
                    if self._fatal is not None:
                        return
                    if self.linger_s > 0 and not self._closing and \
                            len(self._pending) < self.stage_depth:
                        # a deadline loop, not a single wait: every submit
                        # notifies _wake, and a trickle of early wakes
                        # must not cut the batching window short
                        deadline = time.monotonic() + self.linger_s
                        while not self._closing and self._fatal is None \
                                and len(self._pending) < self.stage_depth:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                break
                            self._wake.wait(remaining)
                    reqs, self._pending = self._pending, []
                    closing = self._closing
                if reqs:
                    t0, cpu0 = time.perf_counter(), time.thread_time()
                    waited = 0.0   # blocked on the full in-flight queue
                    with _range("queue.plan"):
                        plans = plan_buckets(reqs, self.policy, len(reqs))
                    for plan in plans:
                        plan.t_taken = t0
                        if plan.capacity == 0:
                            continue  # empty buckets dispatch nothing
                        if plan.shape[0] > plan.shape[1]:
                            # paper: det = 0 for m > n — known at plan
                            # time, so no stack, no upload, no pipeline
                            self._complete_trivial(plan)
                            continue
                        try:
                            with _range("queue.pack"):
                                host = self._pack(plan)
                            with _range("queue.upload"):
                                dev, cts = self._upload(host)
                            # async dispatch: the launch only enqueues
                            # device work (grad batches enter the plan's
                            # VJP, value batches its forward)
                            with _range("queue.launch"):
                                exe = self._plan(plan.shape, plan.capacity)
                                dets = exe.grad(dev, cts) if plan.grad \
                                    else exe(dev)
                            done = None
                            if dets.device.type == "cuda":
                                # the copy back rides the kernel's stream
                                # into pinned memory, and the event marks
                                # the end of both
                                with _range("queue.copy_back"):
                                    stream = torch.cuda.current_stream(
                                        dets.device)
                                    dets = dets.to("cpu", non_blocking=True)
                                    done = torch.cuda.Event()
                                    done.record(stream)
                        except Exception as e:  # noqa: BLE001 — batch-local
                            # e.g. C(n, m) overflowing int32 for one weird
                            # shape: fail this batch, keep serving the rest
                            self._fail_plan(plan, e)
                            continue
                        # stats strictly before the hand-off: a caller woken
                        # by the batch's last future must see it counted
                        with self._lock:
                            st = self.stats
                            st["batches"] += 1
                            st["dispatches"] += 1  # m > n handled above
                            st["grad_dispatches"] += int(plan.grad)
                            st["async_copies"] += int(done is not None)
                            st["merged_requests"] += plan.merged_count
                            st["padded_slots"] += (plan.capacity
                                                   - len(plan.requests))
                        t_put = time.perf_counter()
                        with _range("queue.handoff"):
                            alive = self._put_alive(
                                self._inflight, (plan, dets, done, host))
                        waited += time.perf_counter() - t_put
                        if not alive:
                            self._fail_plan(plan, self._fatal_now())
                            return
                    with self._lock:
                        st = self.stats
                        st["stage_s"] += time.perf_counter() - t0
                        st["stage_wait_s"] += waited
                        st["stage_cpu_s"] += time.thread_time() - cpu0
                if closing:
                    self._put_alive(self._inflight, _SHUTDOWN)
                    return
        except BaseException as e:  # noqa: BLE001 — must not hang futures
            self._fail_all(e)  # also plants a shutdown sentinel downstream

    def _completer(self):
        try:
            # the last batch's futures, resolved after its stats were
            # counted: the next batch counts their host time
            carried = 0.0
            while True:
                item = self._inflight.get()
                if isinstance(item, _Shutdown):
                    return
                plan, dets, done, host = item
                del item
                try:
                    # on a card the event marks the end of the kernel and
                    # of the stager's copy back: past it, the answers lie
                    # in host memory and nothing here calls the driver
                    if done is not None:
                        with _range("queue.device_wait"):
                            done.synchronize()
                    t_host = time.perf_counter() - carried
                    with _range("queue.unpack"):
                        vals = dets.numpy()
                        k = len(plan.requests)
                        # grad batches deliver (m, n) arrays in one
                        # ordinary host copy, never views of the pinned
                        # buffer, which goes back to the allocator for a
                        # later batch; value batches unpack the
                        # (capacity,) dets to floats
                        outs = list(vals[:k].copy()) if plan.grad \
                            else vals[:k].tolist()
                except Exception as e:  # noqa: BLE001 — batch-local
                    self._fail_plan(plan, e)
                    continue
                # the upload and the copy back have completed: release
                # the pinned buffers
                del host, dets, vals
                m, n = plan.shape
                with _range("queue.deliver"):
                    carried = self._deliver(plan, outs,
                                            ranks=comb(n, m) * k,
                                            t_host=t_host)
        except BaseException as e:  # noqa: BLE001
            self._fail_all(e)
