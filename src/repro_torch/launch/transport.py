"""Pluggable transport layer under the multi-worker serving front.

Port of ``repro/launch/transport.py``.  The wire is the reference's,
byte for byte: the frame layout, the message tuples and the handshake.
What changes: a worker builds the port's
:class:`~repro_torch.launch.det_queue.DetQueue` on the device its
:class:`WorkerConfig` names (the dtype rides the config, so there is no
x64 flag to align), local workers are always ``spawn``ed (a forked child
would inherit its parent's CUDA state), and a worker that cannot build its
queue answers every request with a :class:`WorkerStartupError` (nothing
falls back to the CPU).  ``WorkerConfig.persist_dir`` names the plan
store, and a spawn or hello that carries a ``prefill`` list warms those
plan families (store first, plan second) before the worker answers.

``DetFront`` (DESIGN_FRONT.md) routes requests by canonical plan key
over a consistent-hash ring of workers, each running one
:class:`~repro_torch.launch.det_queue.DetQueue` + ``DetEngine``.  Routing,
bounded-load placement, re-route semantics and stats aggregation never
touch process-local state — the only part of the front that knows *how*
bytes reach a worker is the transport, and this module is that seam:

* :class:`LocalTransport` — the original single-host path: ``spawn``
  worker processes wired with an ``mp.Queue`` (requests) and a ``Pipe``
  (responses), peer death detected via the process sentinel.  Kept
  message-for-message identical to the pre-seam front, so single-host
  results stay bit-identical.
* :class:`ShmTransport` — the single-host *fast* path: the same spawn
  topology and Queue/Pipe control plane, but matrix payloads travel
  through a per-link ``multiprocessing.shared_memory`` ring buffer as
  plain ``(offset, shape, dtype)`` descriptors — no pickling of the
  matrix bytes.  Payloads that don't fit fall back to the inline
  ndarray per message, so correctness never depends on ring capacity.
  Results are bit-identical to :class:`LocalTransport` (same bytes,
  same worker code past decode); ``det_serve --shm`` selects it.
* :class:`SocketTransport` — the multi-host path: length-prefixed
  pickled frames over TCP to :func:`run_worker_server` daemons
  (``det_serve --listen host:port``), peer death detected by
  heartbeat/deadline instead of a sentinel, torn/corrupt frames
  detected by a CRC and treated as peer death so the front's existing
  deterministic re-route machinery takes over.

Both implement one interface (:class:`WorkerLink` per worker, created
by ``Transport.start``), so a multi-host pool is two shell commands::

    host-a$ python -m repro_torch.launch.det_serve --listen 0.0.0.0:7341
    host-b$ python -m repro_torch.launch.det_serve --num 256 \\
                --connect host-a:7341,host-c:7341

Wire protocol (DESIGN_FRONT.md has the full spec):

* **Frame**: ``magic(2B) | payload_len(4B, big-endian) | crc32(4B) |
  payload`` — payload is a pickled message tuple.  A bad magic, an
  oversized length or a CRC mismatch means the stream desynchronized
  (truncated/corrupt frame): :class:`FrameError`, peer declared dead.
* **Handshake**: the front sends ``("hello", worker_id, cfg_wire)`` and
  waits for ``("ready", worker_id)``; the daemon builds its ``DetQueue``
  from the front's :class:`WorkerConfig` (one config source — the front
  — so routing policy and bucketing policy can never disagree).
* **Requests**: ``("batch", bid, [(seq, ndarray), …])`` — ``bid`` is
  the front's batch id, acknowledged on receipt — plus the control
  messages ``("stats", token)``, ``("reset",)``, ``("retire",)``,
  ``("stop",)``.  A gradient request rides the same message as a
  ``(seq, ndarray, ct)`` triple: the determinant is scalar-valued, so
  the full cotangent payload is one float (DESIGN_GRAD.md).
* **Responses**: ``("ack", bid)`` (batch frame received, sent *before*
  evaluation so lost frames are detected on RTT scale, never compute
  scale), ``("result", seq, det)`` — ``det`` is a float for a value
  request, the (m, n) gradient ndarray for a grad request —
  ``("shed", seq, msg)``,
  ``("error", seq, type_name, msg)``, ``("stats", id, snapshot,
  token)``, ``("requeue", seq)``, ``("hb", id)`` (filtered at the link,
  never surfaced to the front) and a final ``("bye", id)``.

Messages carry only plain picklable data (ints, strings, numpy arrays,
:class:`~repro_torch.launch.det_queue.BucketPolicy` via its ``to_wire``
dict), never a tensor — see ``tests/test_torch_front_props.py`` for the
round-trip properties and ``tests/test_torch_transport_faults.py`` for
the fault battery.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import queue as _queue
import socket
import struct
import threading
import time
import zlib
from concurrent.futures import Future
from dataclasses import asdict, dataclass, fields

import numpy as np
import torch

from repro_torch.core.radic import resolve_device
from repro_torch.launch.det_queue import BucketPolicy, DetQueue, LoadShedError

__all__ = ["FrameDecoder", "FrameError", "LocalTransport", "ShmRing",
           "ShmRingReader", "ShmTransport", "SocketTransport",
           "ThreadedWorkerServer", "Transport", "TransportError",
           "WorkerConfig", "WorkerLink", "WorkerStartupError",
           "encode_frame", "is_shm_descriptor",
           "parse_hostport", "run_worker_client", "run_worker_loop",
           "run_worker_server", "shm_descriptor", "spawn_worker_daemon"]


class TransportError(RuntimeError):
    """A worker link failed (send to a dead peer, handshake timeout,
    torn stream).  The front treats it as peer death and re-routes."""


class WorkerStartupError(RuntimeError):
    """A worker could not build its queue (no card, no kernel library).
    It stays on the wire and answers every request it is sent with this
    error, which the front reports as a ``WorkerError`` naming the cause:
    nothing is served on another device in its place."""


class FrameError(TransportError):
    """The byte stream desynchronized: bad magic, oversized length or
    CRC mismatch — a truncated or corrupted frame.  Unrecoverable for
    the connection (framing has no resync point by design: a desynced
    peer must be declared dead, its requests re-routed)."""


# ------------------------------------------------------------------ framing
_MAGIC = b"\xd7\x4d"            # 0xD74D: "det matrix"
_HEADER = struct.Struct("!2sII")  # magic, payload length, crc32(payload)
MAX_FRAME_BYTES = 1 << 30       # 1 GiB: no sane batch is larger; a bogus
#                                 length from a desynced stream must not
#                                 look like a pending 7-exabyte recv


def encode_frame(msg) -> bytes:
    """One wire frame for one message tuple.  Refuses payloads the
    decoder would reject (> ``MAX_FRAME_BYTES``) — an oversized batch
    must fail loudly at the sender, not desync every receiver it
    touches."""
    payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) > MAX_FRAME_BYTES:
        raise TransportError(
            f"frame payload of {len(payload)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte frame limit (split the batch)")
    return _HEADER.pack(_MAGIC, len(payload), zlib.crc32(payload)) + payload


class FrameDecoder:
    """Incremental frame parser: feed arbitrary byte chunks, get whole
    messages.  Tolerates any split points (TCP is a byte stream);
    raises :class:`FrameError` on desync and stays poisoned after —
    the connection must be torn down, not resumed."""

    def __init__(self):
        self._buf = bytearray()
        self._poisoned = False

    def feed(self, data: bytes) -> list:
        if self._poisoned:
            raise FrameError("decoder already desynchronized")
        self._buf += data
        out = []
        while True:
            if len(self._buf) < _HEADER.size:
                return out
            magic, length, crc = _HEADER.unpack_from(self._buf)
            if magic != _MAGIC or length > MAX_FRAME_BYTES:
                self._poisoned = True
                raise FrameError(
                    f"frame desync: magic={magic!r} length={length}")
            end = _HEADER.size + length
            if len(self._buf) < end:
                return out
            payload = bytes(self._buf[_HEADER.size:end])
            del self._buf[:end]
            if zlib.crc32(payload) != crc:
                self._poisoned = True
                raise FrameError("frame desync: payload CRC mismatch")
            try:
                out.append(pickle.loads(payload))
            except Exception as e:  # noqa: BLE001 — torn pickle = desync
                self._poisoned = True
                raise FrameError(f"frame payload unpickle failed: {e}") \
                    from e


def parse_hostport(addr: str, *, default_host: str = "0.0.0.0") \
        -> tuple[str, int]:
    """``"host:port"`` / ``":port"`` / ``"port"`` → ``(host, port)``."""
    text = addr.strip()
    if ":" in text:
        host, _, port = text.rpartition(":")
        host = host or default_host
    else:
        host, port = default_host, text
    try:
        return host, int(port)
    except ValueError:
        raise ValueError(f"bad address {addr!r}: want host:port") from None


# ------------------------------------------------------------ worker config
@dataclass(frozen=True)
class WorkerConfig:
    """Everything a worker needs to build its DetQueue — plain picklable
    fields only, with an explicit plain-dict wire form for the socket
    handshake (mesh serving stays out of scope for remote workers — a
    mesh wants the whole host).  ``dtype`` carries the precision (the
    reference's ``x64`` flag has no counterpart); ``device`` is where the
    worker's queue computes (``"cuda"``, ``"cuda:N"`` or ``"cpu"``)."""
    chunk: int
    backend: str
    dtype: str
    policy: BucketPolicy
    max_pending: int | None
    plan_cache: int
    linger_s: float
    stage_depth: int | None
    pipeline_depth: int
    pin_workers: bool
    device: str = "cuda"
    # durable plan store root (DESIGN_PERSIST.md); a plain string so it
    # rides the wire dict like every other field.  Workers on other
    # hosts simply see an empty/fresh store at that path.
    persist_dir: str | None = None

    def to_wire(self) -> dict:
        d = asdict(self)
        d["policy"] = self.policy.to_wire()
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "WorkerConfig":
        names = {f.name for f in fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        kw["policy"] = BucketPolicy.from_wire(d["policy"])
        return cls(**kw)

    def make_queue(self):
        """The worker's queue on ``device``.  Raises without a card
        (``resolve_device``).  On the card it creates the worker's CUDA
        context before it serves, and loads the kernel library (built by
        the front or the daemon before any worker started, so this finds
        it by its hash; with a plan store, in the store)."""
        device = resolve_device(self.device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            if self.backend == "cuda":
                from repro_torch.kernels import _build
                if self.persist_dir is not None:
                    _build.use_store_dir(self.persist_dir)
                _build.load()
        return DetQueue(chunk=self.chunk, backend=self.backend,
                        dtype=np.dtype(self.dtype), policy=self.policy,
                        max_pending=self.max_pending,
                        plan_cache=self.plan_cache, linger_s=self.linger_s,
                        stage_depth=self.stage_depth,
                        pipeline_depth=self.pipeline_depth, device=device,
                        persist_dir=self.persist_dir)


class _FailedQueue:
    """The queue surface of a worker whose ``DetQueue`` could not be
    built: every submission raises the startup error, so
    :func:`run_worker_loop` answers each request with it."""

    def __init__(self, worker_id: int, exc: BaseException):
        self.message = (f"worker {worker_id} could not start: "
                        f"{type(exc).__name__}: {exc}")

    def submit_many(self, arrs, grads=None):
        raise WorkerStartupError(self.message)

    def drain_pending(self) -> list:
        return []

    def reset_stats(self) -> None:
        pass

    def snapshot(self) -> dict:
        snap = DetQueue._zero_stats()
        snap["plan_cache"] = {"size": 0, "max_plans": 0, "hits": 0,
                              "misses": 0, "evictions": 0}
        snap["startup_error"] = self.message
        return snap

    def close(self, drain: bool = True) -> None:
        pass


# ----------------------------------------------------------- worker side
def run_worker_loop(worker_id: int, q, recv, recv_nowait, send_raw) -> None:
    """The transport-agnostic worker service loop.

    Owns one ``DetQueue`` ``q``, consumes request messages via ``recv``
    (blocking) / ``recv_nowait`` (raises ``queue.Empty``), and reports
    every outcome through ``send_raw`` — which may raise on a dead
    front; every send is best-effort.  Greedy drain: one
    ``submit_many`` per wake, so the queue's stager sees deep
    snapshots, not a trickle.  On ``stop``/``retire`` the queue is
    closed with ``drain=True`` (every accepted request resolves first)
    and a final ``("bye", id)`` is sent.
    """
    send_lock = threading.Lock()  # completer callbacks race the main loop

    def send(msg) -> None:
        with send_lock:
            try:
                send_raw(msg)
            except (OSError, ValueError, BrokenPipeError, TransportError):
                pass  # front went away; nothing useful to do from here

    def on_done(seq: int):
        def cb(fut: Future) -> None:
            exc = fut.exception()
            if exc is None:
                val = fut.result()
                if isinstance(val, np.ndarray):
                    # a gradient result: the (m, n) cotangent pullback
                    # rides the frame as-is (ndarrays are first-class
                    # wire payloads, same as the request matrices)
                    send(("result", seq, val))
                else:
                    send(("result", seq, float(val)))
            elif isinstance(exc, LoadShedError):
                send(("shed", seq, str(exc)))
            else:
                send(("error", seq, type(exc).__name__, str(exc)))
        return cb

    def submit_pairs(pairs) -> None:
        # a pair is ``(seq, arr)`` for a value request or
        # ``(seq, arr, ct)`` for a gradient request (scalar cotangent)
        seqs: list = []
        arrs: list = []
        grads: list = []
        for pr in pairs:
            if len(pr) == 3:
                seq, arr, ct = pr
                grads.append((True, ct))
            else:
                seq, arr = pr
                grads.append((False, 1.0))
            seqs.append(seq)
            arrs.append(arr)
        try:
            futs = q.submit_many(arrs, grads)
        except Exception as e:  # noqa: BLE001 — report, keep serving
            for seq in seqs:
                send(("error", seq, type(e).__name__, str(e)))
            return
        for seq, fut in zip(seqs, futs):
            fut.add_done_callback(on_done(seq))

    try:
        retired = False
        while not retired:
            msgs = [recv()]
            while True:  # greedy drain (see docstring)
                try:
                    msgs.append(recv_nowait())
                except _queue.Empty:
                    break
            pairs: list = []
            for msg in msgs:
                kind = msg[0]
                if kind == "batch":
                    # ack on *receipt*, before any evaluation: the front
                    # bounds frame loss on ack latency (RTT + queueing),
                    # never on compute — a batch may then legitimately
                    # sit behind a slow plan or a long launch
                    send(("ack", msg[1]))
                    pairs.extend(msg[2])
                    continue
                if pairs:
                    submit_pairs(pairs)
                    pairs = []
                if kind == "stop":
                    retired = True
                    break
                if kind == "retire":
                    # hand the un-staged backlog back for re-routing;
                    # in-flight work still completes before the bye
                    for r in q.drain_pending():
                        send(("requeue", r.seq))
                    retired = True
                    break
                if kind == "reset":
                    q.reset_stats()
                elif kind == "stats":
                    send(("stats", worker_id, q.snapshot(), msg[1]))
            if pairs:
                submit_pairs(pairs)
    finally:
        q.close(drain=True)   # resolves every accepted request first
        send(("bye", worker_id))


def _local_worker_main(worker_id: int, cfg: WorkerConfig, req_q, resp_conn,
                       shm_name: str | None = None, prefill=None):
    """Local worker process entry point (module-level: spawn-safe).

    A non-empty ``prefill`` warms those plan families (store first, plan
    second) before the worker consumes any request.  A queue that cannot
    be built (no card, no kernel library) leaves the worker serving
    :class:`_FailedQueue`: every request it is sent fails with the cause.

    With ``shm_name`` (the :class:`ShmTransport` path) the Queue/Pipe
    control plane is unchanged, but batch payloads may arrive as shm
    ring descriptors: they are resolved — copied out of the ring and
    the ring slot released — *at decode time*, before
    :func:`run_worker_loop` sees the message, so ack-on-receipt and the
    greedy drain behave identically to the inline-ndarray path.
    """
    import os

    if cfg.pin_workers and hasattr(os, "sched_setaffinity"):
        # one dedicated core per worker (round-robin): N compute-heavy
        # workers on an N-core host otherwise migrate across cores and
        # steal cycles from each other's host threads
        try:
            os.sched_setaffinity(0, {worker_id % (os.cpu_count() or 1)})
        except OSError:
            pass
    reader = None
    recv, recv_nowait = req_q.get, req_q.get_nowait
    if shm_name is not None:
        reader = ShmRingReader(shm_name)

        def _resolve(msg):
            if isinstance(msg, tuple) and msg and msg[0] == "batch":
                # a pair's matrix slot (index 1) may be a ring
                # descriptor; any trailing fields (a grad request's
                # scalar cotangent) pass through untouched
                pairs = [(pr[0], reader.read(pr[1])
                          if is_shm_descriptor(pr[1]) else pr[1])
                         + tuple(pr[2:]) for pr in msg[2]]
                return ("batch", msg[1], pairs)
            return msg

        def recv():
            return _resolve(req_q.get())

        def recv_nowait():
            return _resolve(req_q.get_nowait())

    try:
        q = cfg.make_queue()
    except Exception as e:  # noqa: BLE001 — reported on every request
        q = _FailedQueue(worker_id, e)
    else:
        if prefill:
            # warm expected plan families (store first, plan second)
            # before consuming any request — a grown worker joins hot
            q.prefill(prefill)
    try:
        run_worker_loop(worker_id, q, recv, recv_nowait, resp_conn.send)
    finally:
        try:
            resp_conn.close()
        except OSError:
            pass
        if reader is not None:
            reader.close()


# ----------------------------------------------------------- link interface
class WorkerLink:
    """One worker as the front's drainer sees it, any transport.

    * ``send(msg)`` — deliver a request message; raises
      :class:`TransportError` if the peer is unreachable.
    * ``waitables()`` — objects for ``multiprocessing.connection.wait``
      (pipes, sockets, process sentinels: anything with a fileno).
    * ``pump()`` — drain every response message available *right now*
      without blocking; returns ``(messages, dead)`` where ``dead``
      means no further message can ever arrive (buffered messages are
      always surfaced before death is reported, so results that beat a
      crash are still delivered).
    * ``expired(now)`` — transport-level death verdicts that no
      waitable can signal (a silent peer past its heartbeat deadline).
    * ``broken`` — the link itself failed (send error, torn frame,
      ``kill()``); the front's sweep turns it into a worker death.
    * ``kill()`` — chaos hook: make the peer unreachable now.
    * ``close()`` / ``join(timeout)`` — teardown.
    """

    id: int
    broken: bool = False

    def send(self, msg) -> None:
        raise NotImplementedError

    def waitables(self) -> list:
        raise NotImplementedError

    def pump(self) -> tuple[list, bool]:
        raise NotImplementedError

    def expired(self, now: float) -> bool:
        return False

    def kill(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def join(self, timeout: float | None = None) -> None:
        pass

    def describe(self) -> str:
        return f"{type(self).__name__}(id={self.id})"


class Transport:
    """Factory for the front's worker links.  ``start(cfg)`` builds and
    returns one :class:`WorkerLink` per worker; the front owns the
    links from then on.  ``redial(wid)`` optionally rebuilds a dead
    worker's link (``DetFront.reconnect_worker``): a fresh peer with an
    empty queue — the stable ring re-inserts its old arc, so placement
    after a rejoin equals placement before the death.  ``dial_new(wid)``
    optionally brings up a worker that never existed (``DetFront.grow``,
    the autoscaler's scale-up path): a brand-new peer under a brand-new
    id, admitted to the ring as a live join.

    ``dial_new``'s ``prefill`` is the front's plan-family warm-start
    list: the new worker plans those families (store first, plan
    second) *before* reporting for traffic, so a scaled-out worker
    joins warm (DESIGN_PERSIST.md)."""

    def start(self, cfg: WorkerConfig) -> list[WorkerLink]:
        raise NotImplementedError

    def redial(self, wid: int) -> WorkerLink | None:
        return None  # transports without a rejoin story

    def dial_new(self, wid: int, prefill=None) -> WorkerLink | None:
        return None  # transports without a scale-out story


# ------------------------------------------------------------ local (spawn)
class LocalLink(WorkerLink):
    """Today's spawn + Queue/Pipe path, unchanged on the wire: requests
    via ``mp.Queue.put``, responses via a ``Pipe``, death via the
    process sentinel."""

    def __init__(self, wid: int, process, req_q, resp_conn):
        self.id = wid
        self.process = process
        self._req_q = req_q
        self._conn = resp_conn

    def send(self, msg) -> None:
        try:
            self._req_q.put(msg)
        except (OSError, ValueError) as e:
            raise TransportError(f"worker {self.id} request queue closed") \
                from e

    def waitables(self) -> list:
        return [self._conn, self.process.sentinel]

    def pump(self) -> tuple[list, bool]:
        msgs: list = []
        while True:
            try:
                if not self._conn.poll(0):
                    break
                msgs.append(self._conn.recv())
            except (EOFError, OSError, ValueError):
                return msgs, True
            except Exception:  # noqa: BLE001 — partial pickle from a kill
                return msgs, True
        # sentinel fired with the pipe already drained → truly gone; a
        # dead writer's buffered data stays pollable, so the loop above
        # always surfaces results that beat the crash
        return msgs, not self.process.is_alive()

    def kill(self) -> None:
        self.process.kill()

    def close(self) -> None:
        if not self.process.is_alive():
            # a dead worker never reads what its queue's feeder thread is
            # still writing (a batch past the pipe's buffer blocks it for
            # good), and multiprocessing joins that thread at exit: the
            # process would never end
            self._req_q.cancel_join_thread()
        self._req_q.close()
        try:
            self._conn.close()
        except OSError:
            pass

    def join(self, timeout: float | None = None) -> None:
        self.process.join(timeout=timeout)
        if self.process.is_alive():
            self.process.terminate()
            self.process.join(timeout=5)

    def describe(self) -> str:
        return f"local(pid={self.process.pid})"


class LocalTransport(Transport):
    """Spawned worker processes on this host — the default transport.
    Always ``spawn``: each worker starts from a fresh interpreter and
    creates its own CUDA context."""

    def __init__(self, workers: int = 2):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.workers = int(workers)
        self._cfg: WorkerConfig | None = None

    def _spawn(self, wid: int, cfg: WorkerConfig,
               prefill=None) -> WorkerLink:
        ctx = mp.get_context("spawn")
        req_q = ctx.Queue()
        recv_conn, send_conn = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_local_worker_main,
                           args=(wid, cfg, req_q, send_conn, None, prefill),
                           name=f"det-front-w{wid}", daemon=True)
        proc.start()
        send_conn.close()  # child owns the send end now
        return LocalLink(wid, proc, req_q, recv_conn)

    def start(self, cfg: WorkerConfig) -> list[WorkerLink]:
        self._cfg = cfg
        return [self._spawn(wid, cfg) for wid in range(self.workers)]

    def redial(self, wid: int) -> WorkerLink | None:
        """Respawn a dead worker's process under the same id."""
        if self._cfg is None:
            return None
        return self._spawn(wid, self._cfg)

    def dial_new(self, wid: int, prefill=None) -> WorkerLink | None:
        """Spawn one more worker process (scale-up is unbounded locally;
        the autoscaler's ``max_workers`` is the policy bound)."""
        if self._cfg is None:
            return None
        return self._spawn(wid, self._cfg, prefill)


# ------------------------------------------------------- shared-memory ring
_SHM_MAGIC = "__shm__"
_SHM_CTRL_BYTES = 16   # two 8-byte-aligned uint64 counters: [head, tail]
_SHM_ALIGN = 64        # payload slots cache-line aligned (and dtype-aligned)


def shm_descriptor(offset, release, shape, dtype) -> tuple:
    """Plain-type wire descriptor for one shm ring payload.

    ``("__shm__", offset, release, shape, dtype_str)`` — ``offset`` is
    the payload's byte position in the ring's data region, ``release``
    the virtual stream position the consumer publishes as the new head
    once the payload is copied out, ``shape``/``dtype`` enough to
    rebuild the ndarray.  Everything is coerced to builtins here so the
    wire never carries numpy scalar types (the reprolint wire-safety
    grammar vets call sites of this builder).
    """
    return (_SHM_MAGIC, int(offset), int(release),
            tuple(int(d) for d in shape), str(dtype))


def is_shm_descriptor(obj) -> bool:
    """True for tuples produced by :func:`shm_descriptor` (the worker's
    decode-time test; inline ndarrays fall through untouched)."""
    return (isinstance(obj, tuple) and len(obj) == 5
            and obj[0] == _SHM_MAGIC)


class ShmRing:
    """Producer side of a per-link single-producer/single-consumer
    shared-memory payload ring (DESIGN_FRONT.md §shm ring protocol).

    Layout: ``head(u64) | tail(u64) | data[capacity]``.  Positions are
    *virtual* (monotonic byte offsets); ``pos % capacity`` locates the
    slot.  Allocations are rounded up to :data:`_SHM_ALIGN` and never
    wrap mid-payload — an allocation that would straddle the end skips
    to the next capacity multiple, so every payload is contiguous and
    dtype-aligned.  The consumer owns ``head`` (its release watermark,
    published after each copy-out in FIFO order — ``mp.Queue`` delivery
    order *is* allocation order, so releases are monotonic); the
    producer owns ``tail``.  A stale ``head`` read under-reports free
    space, which at worst forces the inline-pickle fallback — never
    corruption.

    ``write`` returns ``None`` when the payload doesn't fit (too big
    for the ring, ring full because the worker is behind or dead, ring
    disposed): the caller falls back to sending the ndarray inline, so
    the ring is an overlay fast path, never a liveness dependency.
    """

    # reprolint lock-discipline registry: producer state is touched by
    # the front's drainer thread and close(); the ctrl word stores are
    # single-writer-per-index by protocol.
    _GUARDED_BY = {"_tail": ("_lock",), "_closed": ("_lock",)}

    def __init__(self, capacity: int = 8 << 20):
        from multiprocessing import shared_memory
        if capacity < _SHM_ALIGN:
            raise ValueError(f"ring capacity must be >= {_SHM_ALIGN}")
        self._lock = threading.Lock()
        self.capacity = int(capacity)
        self._shm = shared_memory.SharedMemory(
            create=True, size=_SHM_CTRL_BYTES + self.capacity)
        self._ctrl = np.ndarray((2,), dtype=np.uint64, buffer=self._shm.buf)
        self._ctrl[:] = 0
        self._data = np.ndarray((self.capacity,), dtype=np.uint8,
                                buffer=self._shm.buf, offset=_SHM_CTRL_BYTES)
        self._tail = 0      # virtual write position (mirrors ctrl[1])
        self._closed = False

    @property
    def name(self) -> str:
        return self._shm.name

    def write(self, arr: np.ndarray):
        """Copy ``arr`` into the ring; returns its wire descriptor, or
        ``None`` if it doesn't fit right now (caller sends inline)."""
        arr = np.ascontiguousarray(arr)
        nbytes = int(arr.nbytes)
        alloc = -(-max(nbytes, 1) // _SHM_ALIGN) * _SHM_ALIGN
        if alloc > self.capacity:
            return None
        with self._lock:
            if self._closed:
                return None
            pos = self._tail
            off = pos % self.capacity
            if off + alloc > self.capacity:
                pos += self.capacity - off  # skip the wrap fragment
                off = 0
            # aligned u64 load: the consumer's head only grows, so a
            # torn/stale read can only under-report free space
            head = int(self._ctrl[0])
            if pos + alloc - head > self.capacity:
                return None
            if nbytes:
                self._data[off:off + nbytes] = arr.reshape(-1).view(np.uint8)
            self._tail = pos + alloc
            self._ctrl[1] = np.uint64(self._tail)
            return shm_descriptor(off, self._tail, arr.shape, arr.dtype)

    def dispose(self) -> None:
        """Release the mapping and unlink the segment.  Unlink-early is
        safe on POSIX: the worker's live mapping persists until it
        closes; what's gone is only the name."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            # drop the exporting views before close() (BufferError else)
            self._ctrl = None
            self._data = None
        try:
            self._shm.close()
        except (BufferError, OSError):
            pass
        try:
            self._shm.unlink()
        except (FileNotFoundError, OSError):
            pass


class ShmRingReader:
    """Consumer side: attach by name, resolve descriptors in arrival
    order.  Each :meth:`read` copies the payload out and publishes the
    descriptor's ``release`` watermark as the new head — FIFO decode
    order is the entire reclaim discipline (no per-slot refcounts)."""

    _GUARDED_BY = {"_head": ("_lock",)}

    def __init__(self, name: str):
        from multiprocessing import shared_memory
        self._lock = threading.Lock()
        # attach-side resource_tracker registration is a set-add into
        # the tracker shared with the spawning front (dup of the
        # create-side entry), so the front's dispose() is the one
        # unregister — no bookkeeping needed here
        self._shm = shared_memory.SharedMemory(name=name)
        self._ctrl = np.ndarray((2,), dtype=np.uint64, buffer=self._shm.buf)
        cap = self._shm.size - _SHM_CTRL_BYTES  # size may be page-rounded
        self._data = np.ndarray((cap,), dtype=np.uint8,
                                buffer=self._shm.buf, offset=_SHM_CTRL_BYTES)
        self._head = 0

    def read(self, desc: tuple) -> np.ndarray:
        """Copy the described payload out of the ring and release its
        slot (head := max(head, release))."""
        _, off, release, shape, dtype = desc
        dt = np.dtype(dtype)
        nbytes = dt.itemsize
        for d in shape:
            nbytes *= d
        flat = self._data[off:off + nbytes]
        arr = flat.view(dt).reshape(shape).copy()
        with self._lock:
            if release > self._head:
                self._head = int(release)
                self._ctrl[0] = np.uint64(self._head)
        return arr

    def close(self) -> None:
        self._ctrl = None
        self._data = None
        try:
            self._shm.close()
        except (BufferError, OSError):
            pass


class ShmLink(LocalLink):
    """A :class:`LocalLink` whose batch matrices ride the per-link shm
    ring: control tuples keep their Queue/Pipe framing, each ndarray in
    a ``("batch", …)`` message is replaced by its ring descriptor when
    the ring has room (inline fallback otherwise, per payload).
    Results — scalar dets, or an (m, n) gradient for a grad request —
    ride the response Pipe; only request matrices use the ring."""

    def __init__(self, wid: int, process, req_q, resp_conn, ring: ShmRing):
        super().__init__(wid, process, req_q, resp_conn)
        self.ring = ring

    def send(self, msg) -> None:
        if isinstance(msg, tuple) and msg and msg[0] == "batch":
            pairs = []
            for pr in msg[2]:
                seq, arr = pr[0], pr[1]
                desc = self.ring.write(np.asarray(arr))
                payload = arr if desc is None else desc
                # trailing fields (a grad request's scalar cotangent)
                # stay inline next to the descriptor
                pairs.append((seq, payload) + tuple(pr[2:]))
            msg = ("batch", msg[1], pairs)
        super().send(msg)

    def close(self) -> None:
        super().close()
        self.ring.dispose()

    def describe(self) -> str:
        return f"shm(pid={self.process.pid}, ring={self.ring.name})"


class ShmTransport(LocalTransport):
    """Zero-copy same-host transport: :class:`LocalTransport`'s spawn
    topology and control plane, with a per-link shared-memory ring for
    matrix payloads — no pickle of the matrix bytes, one copy in
    (front) and one copy out (worker) instead of pickle + queue-feeder
    pickle + unpickle.  Bit-identical results by construction: the ring
    carries the exact payload bytes and the worker code path past
    decode is unchanged.  Each redial/dial_new gets a fresh ring, so a
    dead worker's unreleased slots die with its link."""

    def __init__(self, workers: int = 2, *, ring_bytes: int = 8 << 20):
        super().__init__(workers)
        self.ring_bytes = int(ring_bytes)

    def _spawn(self, wid: int, cfg: WorkerConfig,
               prefill=None) -> WorkerLink:
        ctx = mp.get_context("spawn")
        ring = ShmRing(self.ring_bytes)
        req_q = ctx.Queue()
        recv_conn, send_conn = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_local_worker_main,
                           args=(wid, cfg, req_q, send_conn, ring.name,
                                 prefill),
                           name=f"det-front-shm-w{wid}", daemon=True)
        proc.start()
        send_conn.close()  # child owns the send end now
        return ShmLink(wid, proc, req_q, recv_conn, ring)


# ------------------------------------------------------------------ sockets
class SocketLink(WorkerLink):
    """One TCP connection to a worker daemon: framed sends under a lock,
    non-blocking framed receives, heartbeat-deadline death detection."""

    # reprolint lock-discipline registry (see DESIGN_LINT.md): the death
    # flag is read by the drainer and written by send failures, pump EOF
    # and kill — all funneled through the send lock.
    _GUARDED_BY = {"_broken": ("_send_lock",)}

    def __init__(self, wid: int, sock, addr: tuple[str, int],
                 hb_timeout: float | None, decoder: FrameDecoder | None = None):
        self.id = wid
        self.addr = addr
        self._sock = sock
        self._send_lock = threading.Lock()
        self._decoder = decoder if decoder is not None else FrameDecoder()
        self._hb_timeout = hb_timeout
        self._last_rx = time.monotonic()
        self._broken = False

    @property
    def broken(self) -> bool:
        with self._send_lock:
            return self._broken

    def _mark_broken(self) -> None:
        with self._send_lock:
            self._broken = True

    def send(self, msg) -> None:
        data = encode_frame(msg)
        try:
            with self._send_lock:
                if self._broken:
                    raise TransportError(f"worker {self.id} link is down")
                self._sock.sendall(data)
        except OSError as e:
            self._mark_broken()
            raise TransportError(
                f"send to worker {self.id} at {self.addr} failed: {e}") \
                from e

    def waitables(self) -> list:
        return [] if self.broken else [self._sock]

    def pump(self) -> tuple[list, bool]:
        if self.broken:
            return [], True
        msgs: list = []
        dead = False
        while True:
            try:
                data = self._sock.recv(1 << 16, socket.MSG_DONTWAIT)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                dead = True
                break
            if not data:
                dead = True  # orderly EOF: peer closed
                break
            self._last_rx = time.monotonic()
            try:
                msgs.extend(self._decoder.feed(data))
            except FrameError:
                dead = True  # desync: declare the peer dead, re-route
                break
        out = [m for m in msgs if m[0] != "hb"]  # heartbeats stop here
        if dead:
            self._mark_broken()
        return out, dead

    def expired(self, now: float) -> bool:
        if self.broken:
            return True
        return self._hb_timeout is not None \
            and now - self._last_rx > self._hb_timeout

    def kill(self) -> None:
        # shutdown *before* taking the send lock: a sender stuck in
        # sendall() holds the lock until the shutdown unblocks it, so
        # flag-first (lock, then shutdown) would deadlock the killer
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._mark_broken()

    def close(self) -> None:
        self.kill()

    def describe(self) -> str:
        return f"socket({self.addr[0]}:{self.addr[1]})"


class SocketTransport(Transport):
    """Front over remote worker daemons, one TCP address per worker
    (``det_serve --listen`` on each host).  Worker ids are the address
    indices, so the ring layout — and therefore the re-route order — is
    a pure function of the ``--connect`` list."""

    def __init__(self, addresses, *, spares=(), connect_timeout: float = 30.0,
                 heartbeat_s: float = 1.0, heartbeat_misses: int = 5):
        def norm(a):
            return parse_hostport(a, default_host="127.0.0.1") \
                if isinstance(a, str) else (a[0], int(a[1]))

        addrs = [norm(a) for a in addresses]
        if not addrs:
            raise ValueError("SocketTransport needs at least one address")
        self.addresses = addrs
        # standby daemons the autoscaler may dial on scale-up (FIFO);
        # grown workers get fresh ids past the initial address indices
        self.spare_addresses = [norm(a) for a in spares]
        self._grown_addrs: dict[int, tuple[str, int]] = {}
        self.connect_timeout = float(connect_timeout)
        # a peer silent for this long is declared dead: daemons beat
        # every heartbeat_s, so `misses` whole beats lost in a row means
        # the peer (or the path to it) is gone, not merely busy — the
        # daemon's heartbeat thread is independent of its compute
        self.heartbeat_s = float(heartbeat_s)
        self.hb_timeout = (float(heartbeat_s) * int(heartbeat_misses)
                           if heartbeat_s > 0 else None)

    def _dial(self, addr: tuple[str, int]) -> socket.socket:
        sock = socket.create_connection(addr, timeout=self.connect_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _finish(self, sock: socket.socket, wid: int,
                addr: tuple[str, int]):
        """Post-handshake hook: what the link will talk to.  The fault
        battery overrides this to wrap the socket in a frame-mangling
        shim (handshakes stay clean; faults hit only the serving
        stream)."""
        return sock

    def _connect_one(self, wid: int, addr: tuple[str, int],
                     wire_cfg: dict) -> WorkerLink:
        decoder = FrameDecoder()
        try:
            sock = self._dial(addr)
            sock.sendall(encode_frame(("hello", wid, wire_cfg)))
            msg = _read_frame(sock, decoder, timeout=self.connect_timeout,
                              skip_hb=True)
        except (OSError, FrameError) as e:
            raise TransportError(
                f"handshake with worker {wid} at "
                f"{addr[0]}:{addr[1]} failed: {e}") from e
        if msg is None or msg[0] != "ready" or msg[1] != wid:
            raise TransportError(
                f"worker {wid} at {addr[0]}:{addr[1]} answered "
                f"{msg!r}, want ('ready', {wid})")
        sock.settimeout(None)
        # the handshake decoder carries over: bytes that arrived right
        # behind the ready frame must not be lost
        return SocketLink(wid, self._finish(sock, wid, addr), addr,
                          self.hb_timeout, decoder=decoder)

    def start(self, cfg: WorkerConfig) -> list[WorkerLink]:
        wire_cfg = cfg.to_wire()
        wire_cfg["heartbeat_s"] = self.heartbeat_s
        self._wire_cfg = wire_cfg
        links: list[WorkerLink] = []
        try:
            for wid, addr in enumerate(self.addresses):
                links.append(self._connect_one(wid, addr, wire_cfg))
        except TransportError:
            for link in links:
                link.close()
            raise
        return links

    def redial(self, wid: int) -> WorkerLink | None:
        """Re-dial a dead worker's address: a fresh daemon session with
        an empty queue (the daemon re-plans — the same bit-identical
        re-plan a death already forces)."""
        if not hasattr(self, "_wire_cfg"):
            return None
        addr = self._grown_addrs.get(wid)
        if addr is None:
            if wid >= len(self.addresses):
                return None
            addr = self.addresses[wid]
        return self._connect_one(wid, addr, self._wire_cfg)

    def add_spare(self, addr) -> None:
        """Register a standby daemon address for a later ``dial_new``."""
        self.spare_addresses.append(
            parse_hostport(addr, default_host="127.0.0.1")
            if isinstance(addr, str) else (addr[0], int(addr[1])))

    def dial_new(self, wid: int, prefill=None) -> WorkerLink | None:
        """Dial the next standby daemon as a brand-new worker; ``None``
        when no spares remain (the pool is at its physical ceiling).
        ``prefill`` rides the hello's wire dict: the daemon warms those
        plan families before it answers ready."""
        if not hasattr(self, "_wire_cfg") or not self.spare_addresses:
            return None
        addr = self.spare_addresses.pop(0)
        wire_cfg = self._wire_cfg
        if prefill:
            wire_cfg = dict(wire_cfg)
            wire_cfg["prefill"] = list(prefill)
        link = self._connect_one(wid, addr, wire_cfg)
        self._grown_addrs[wid] = addr
        return link


def _read_frame(sock: socket.socket, decoder: FrameDecoder,
                timeout: float | None = None, skip_hb: bool = False):
    """Blocking read of one whole frame (handshake path); ``None`` on
    EOF.  Raises ``socket.timeout``/:class:`FrameError` on trouble."""
    sock.settimeout(timeout)
    while True:
        data = sock.recv(1 << 16)
        if not data:
            return None
        msgs = decoder.feed(data)
        if skip_hb:
            msgs = [m for m in msgs if m[0] != "hb"]
        if msgs:
            return msgs[0]


# ----------------------------------------------------------- worker daemon
def run_worker_server(host: str, port: int, *, serve_once: bool = False,
                      max_sessions: int | None = None,
                      log=print, on_listen=None) -> None:
    """A socket worker daemon: one ``DetQueue`` + ``DetEngine`` behind a
    TCP listener (the ``det_serve --listen`` entry point, which builds
    the kernel library before it listens when it serves on the card).

    Serves one front connection at a time: the front's ``hello``
    carries the full :class:`WorkerConfig`, so the daemon itself is
    configuration-free — start it, point any number of sequential
    fronts at it.  Each session builds a fresh queue (plan caches are
    per-session; a reconnecting front re-plans, which is the same
    bit-identical re-plan a worker death already forces).  The daemon
    heartbeats every ``heartbeat_s`` (from the hello) on an independent
    thread so a long evaluation cannot look like a death.
    """
    srv = socket.create_server((host, port))
    bound = srv.getsockname()
    log(f"det-worker listening on {bound[0]}:{bound[1]}", flush=True)
    if on_listen is not None:
        on_listen(bound[0], bound[1])
    limit = 1 if serve_once else max_sessions
    served = 0
    try:
        while True:
            conn, addr = srv.accept()
            try:
                _serve_front_session(conn, addr, log)
            except (OSError, FrameError) as e:
                log(f"det-worker: session from {addr} dropped: {e}",
                    flush=True)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
            served += 1
            if limit is not None and served >= limit:
                break
    finally:
        srv.close()


def _serve_front_session(conn: socket.socket, addr, log) -> None:
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    decoder = FrameDecoder()
    hello = _read_frame(conn, decoder, timeout=60.0)
    if hello is None or hello[0] != "hello":
        raise FrameError(f"expected hello, got {hello!r}")
    _, wid, wire_cfg = hello
    cfg = WorkerConfig.from_wire(wire_cfg)
    heartbeat_s = float(wire_cfg.get("heartbeat_s", 1.0))
    conn.settimeout(None)
    # a queue that cannot be built fails the handshake: the front sees
    # no ready and raises, so the daemon is never admitted
    q = cfg.make_queue()
    prefill = wire_cfg.get("prefill")
    if prefill:
        # The front shipped its live plan-family working set: warm the
        # engine now (store first, plan second) — strictly before the
        # ready below, which is what admits this worker to the ring.  A
        # warm-started joiner therefore never serves a request it hasn't
        # planned for (DESIGN_PERSIST.md).
        warmed = q.prefill(prefill)
        log(f"det-worker: prefilled {warmed}/{len(prefill)} plan "
            f"families for front {addr}", flush=True)
    log(f"det-worker: serving front {addr} as worker {wid}", flush=True)

    wlock = threading.Lock()

    def send_raw(msg) -> None:
        data = encode_frame(msg)
        with wlock:
            conn.sendall(data)

    requests: _queue.Queue = _queue.Queue()
    hb_stop = threading.Event()

    def reader() -> None:
        # framed reads → the loop's request queue; EOF/desync from the
        # front is a stop: the queue drains what it accepted (sends to
        # a gone front fail silently) and the daemon goes back to accept
        try:
            while True:
                data = conn.recv(1 << 16)
                if not data:
                    break
                for m in decoder.feed(data):
                    requests.put(m)
        except FrameError:
            # stream desynchronized: nothing further from this front can
            # be trusted — tear the connection down abruptly so the front
            # sees a *death* (and re-routes), not a clean bye
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        except OSError:
            pass
        requests.put(("stop",))

    def heartbeat() -> None:
        while not hb_stop.wait(heartbeat_s):
            try:
                send_raw(("hb", wid))
            except OSError:
                return

    send_raw(("ready", wid))  # strictly before the first heartbeat
    threading.Thread(target=reader, name="det-worker-reader",
                     daemon=True).start()
    if heartbeat_s > 0:
        threading.Thread(target=heartbeat, name="det-worker-hb",
                         daemon=True).start()
    try:
        run_worker_loop(wid, q, requests.get, requests.get_nowait, send_raw)
    finally:
        hb_stop.set()
    log(f"det-worker: front {addr} session ended", flush=True)


def run_worker_client(front_addr: str, *, connect_timeout: float = 30.0,
                      log=print) -> None:
    """Dial into a *running* front's ``--accept`` listener and serve one
    session — live join, direction reversed from ``run_worker_server``
    (the ``det_serve --join host:port`` entry point).

    The wire is identical to the accept path: the front speaks first
    (``("hello", wid, cfg)`` with a freshly assigned worker id and the
    full :class:`WorkerConfig`), the worker answers ``("ready", wid)``
    and runs the same :func:`_serve_front_session` loop — one handshake
    shape regardless of who dialed, so routing and bucketing can never
    disagree with the rest of the pool.  Returns when the front retires
    or stops the worker (or the connection dies).
    """
    host, port = parse_hostport(front_addr, default_host="127.0.0.1")
    conn = socket.create_connection((host, port), timeout=connect_timeout)
    log(f"det-worker joining front at {host}:{port}", flush=True)
    try:
        _serve_front_session(conn, (host, port), log)
    finally:
        try:
            conn.close()
        except OSError:
            pass


class ThreadedWorkerServer:
    """An in-process worker daemon on ``127.0.0.1:<ephemeral>`` — the
    loopback building block for the fault battery: real sockets, real
    frames, real heartbeats, but no subprocess spawn cost and full
    visibility from the test.  Serves ``max_sessions`` front sessions
    (default one; reconnect tests want two)."""

    def __init__(self, start_timeout: float = 30.0, max_sessions: int = 1):
        self._ready = threading.Event()
        self._max_sessions = max_sessions
        self.address: str | None = None
        self._thread = threading.Thread(
            target=self._run, name="det-worker-thread", daemon=True)
        self._thread.start()
        if not self._ready.wait(start_timeout):
            raise TransportError("in-thread worker daemon never listened")

    def _run(self) -> None:
        def on_listen(host: str, port: int) -> None:
            self.address = f"{host}:{port}"
            self._ready.set()

        def quiet(*args, **kwargs) -> None:
            pass

        try:
            run_worker_server("127.0.0.1", 0,
                              max_sessions=self._max_sessions, log=quiet,
                              on_listen=on_listen)
        except Exception:  # noqa: BLE001 — a test teardown race, not news
            pass

    def close(self, timeout: float = 30.0) -> None:
        """Unblock a never-connected accept() so the thread can exit."""
        if self._thread.is_alive() and self.address:
            host, port = parse_hostport(self.address)
            try:
                socket.create_connection((host, port), timeout=2).close()
            except OSError:
                pass
        self._thread.join(timeout=timeout)


def spawn_worker_daemon(host: str = "127.0.0.1", port: int = 0, *,
                        serve_once: bool = True, timeout: float = 60.0,
                        device: str = "cuda"):
    """Start ``det_serve --listen`` as a subprocess and wait for its
    "listening" line; returns ``(Popen, "host:port")``.  The loopback
    building block for tests and the chip check's socket leg.  On
    ``device="cuda"`` the daemon loads (or builds) the kernel library
    before it listens, so ``timeout`` covers that too."""
    import os
    import pathlib
    import re
    import subprocess
    import sys

    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    args = [sys.executable, "-m", "repro_torch.launch.det_serve",
            "--listen", f"{host}:{port}", "--device", device]
    if serve_once:
        args.append("--serve-once")
    proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    deadline = time.monotonic() + timeout
    line = ""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        m = re.search(r"det-worker listening on ([\d.]+):(\d+)", line)
        if m:
            return proc, f"{m.group(1)}:{m.group(2)}"
    proc.kill()
    raise TransportError(
        f"worker daemon did not report a listening address: {line!r}")
