"""Determinant serving CLI: drive the async pipelined
:class:`repro_torch.launch.det_queue.DetQueue` (default), the multi-worker
:class:`repro_torch.launch.det_front.DetFront` (``--workers N``) or the
synchronous :func:`drain_queue` reference over a queue of heterogeneous
matrices, on the card.

Port of ``repro/launch/det_serve.py``.  Requests are arbitrary
(m_i, n_i) matrices, grouped by shape (one bucket = one C(n, m) rank
space = one Pascal table), padded along the batch dimension (bounded by
``--max-batch``) and evaluated in one dispatch per group.

  PYTHONPATH=src python -m repro_torch.launch.det_serve --num 64 --verify
  PYTHONPATH=src python -m repro_torch.launch.det_serve --num 64 \\
      --device cpu --backend torch --sync
  PYTHONPATH=src python -m repro_torch.launch.det_serve --num 256 \\
      --workers 2 [--shm] --verify

The front's flags are the reference's: ``--workers N [--shm]`` spawns N
worker processes on this host (``--shm`` carries the matrices over a
shared-memory ring), ``--listen HOST:PORT [--serve-once]`` runs a worker
daemon that a front reaches with ``--connect host:port,...`` (the
front's handshake ships the serving config, device included),
``--accept HOST:PORT`` lets daemons started with ``--join HOST:PORT``
dial in later, ``--autoscale MAX`` grows and retires workers between 1
and MAX, and ``--heartbeat``/``--ack-timeout`` bound how long a silent
peer or an unacknowledged batch may last before it counts as dead.  On
the card every worker holds its own CUDA context on the one device, so
give ``--autoscale`` an explicit maximum there.  A front that spawns its
workers, and a daemon, builds the kernel library before any worker
starts; the workers load it.

``--grad-frac f`` submits a seed-derived fraction of the requests as
gradient requests (cotangent 1.0, the reference's mix for the same seed);
their results are the ``(m, n)`` arrays d(det)/dA, served through the
plan's backward (the CUDA backward kernel on the ``cuda`` backend).

There is no warm pass: nothing is compiled per shape, and the kernel
library is built before the timed pass (a front's timed pass starts once
every worker has answered a stats request, that is, has built its
queue).

``--plan-store DIR`` is the reference's durable plan store
(DESIGN_PERSIST.md) on the one-queue path and the front's: plan records
persist under DIR, the next run's plan-cache misses consult them, and
the kernel library is kept in ``DIR/kernels/``, so a run from a
checkout that never built loads it instead of running ``nvcc``.
``--prefill`` (on by default with a store) ships joining workers the
front's live plan families, which they warm before admission.

``--trace-out FILE`` (the one-queue async path) runs the timed pass under
``torch.profiler`` with every thread recorded and writes its Chrome
trace to FILE: the queue's stager and completer ranges (``queue.pack``,
``queue.launch``, ``queue.device_wait``, ...; see
:mod:`repro_torch.launch.det_queue`) beside the card's kernels and
copies, on one clock, so that each idle gap of the card can be put down
to the phase of the host that held it.  The async stats line ends with
the pipeline's readings: the stager's busy ms a batch (its time less the
wait on the full in-flight queue) and the share of it on a CPU, the
completer's host ms a batch, and the mean wait from submit to the
stager's snapshot.

``--verify`` checks every result on a different code path: a value
against the exact enumeration oracle (``radic_det_oracle``) when its rank
space holds at most ``ORACLE_MAX_RANKS`` minors, else against the torch
backend in float64 on the serving device, one matrix at a time and
unpadded (the oracle's Python loop would take hours at (8, 32)); a
gradient against ``torch.autograd.grad`` of the torch backend's
``radic_det`` in float64, one matrix at a time and unpadded.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.core import (comb, radic_det, radic_det_batched,
                              radic_det_oracle)
from repro_torch.core.radic import resolve_device
from repro_torch.launch.det_queue import (BucketPolicy, DetQueue,
                                          LoadShedError, bucket_by_shape,
                                          pad_capacity)

__all__ = ["bucket_by_shape", "pad_capacity", "drain_queue", "main"]

ORACLE_MAX_RANKS = 1 << 10   # --verify: values past this use float64 torch
VERIFY_CHUNK = 1 << 18       # --verify: ranks per step of the torch backend


def drain_queue(mats, *, chunk: int = 2048, backend: str = "cuda",
                max_batch: int = 64, dtype=np.float32, device=None,
                mesh=None, batch_axis=None):
    """Synchronous reference: evaluate every queued matrix in the calling
    thread; returns ``(dets, stats)``.

    Stage → dispatch → wait, one group at a time.  ``dets`` is a list of
    floats in arrival order.  ``stats`` maps each (m, n) bucket to a dict
    with ``count``, ``dispatches``, ``ranks`` (minors evaluated, excluding
    padding), ``wall_s``, ``mats_per_s`` and ``ranks_per_s``.  With a
    ``mesh`` each group is staged on its first device and sharded over it
    (``batch_axis`` as in ``radic_det_batched``).
    """
    dev = resolve_device(device if mesh is None else mesh.first_device)
    out: list[float | None] = [None] * len(mats)
    stats: dict[tuple[int, int], dict] = {}
    for (m, n), idxs in bucket_by_shape(mats).items():
        t0 = time.perf_counter()
        dispatches = 0
        for base in range(0, len(idxs), max_batch):
            grp = idxs[base:base + max_batch]
            cap = pad_capacity(len(grp), max_batch)
            stack = np.zeros((cap, m, n), dtype=dtype)
            for j, i in enumerate(grp):
                stack[j] = np.asarray(mats[i], dtype=dtype)
            dets = radic_det_batched(torch.from_numpy(stack).to(dev),
                                     chunk=chunk, backend=backend,
                                     mesh=mesh, batch_axis=batch_axis)
            dets = dets.cpu().numpy()
            dispatches += 1
            for j, i in enumerate(grp):
                out[i] = float(dets[j])
        wall = time.perf_counter() - t0
        ranks = comb(n, m) * len(idxs) if m <= n else 0
        stats[(m, n)] = {
            "count": len(idxs),
            "dispatches": dispatches,
            "ranks": ranks,
            "wall_s": wall,
            "mats_per_s": len(idxs) / wall if wall > 0 else float("inf"),
            "ranks_per_s": ranks / wall if wall > 0 else float("inf"),
        }
    return out, stats


def _serve_tolerating_sheds(q, mats, grads=None):
    """Submit-all + wait-all like ``DetQueue.serve``, but a shed request
    yields ``None`` instead of raising (``--max-pending`` sheds a burst
    larger than its bound by design).  ``grads`` is the per-request
    ``(grad, cotangent)`` list; grad requests resolve to ``(m, n)``
    ndarrays instead of floats."""
    futs = q.submit_many(mats, grads)
    dets = []
    for f in futs:
        try:
            dets.append(f.result())
        except LoadShedError:
            dets.append(None)
    q.poll(timeout=0)
    return dets


def _random_queue(num: int, max_m: int, max_n: int, seed: int):
    """The reference's synthetic queue: the same seed gives the same
    matrices."""
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(num):
        m = int(rng.integers(1, max_m + 1))
        n = int(rng.integers(m, max_n + 1))
        mats.append(rng.normal(size=(m, n)).astype(np.float32))
    return mats


def _grad_mix(num: int, grad_frac: float, seed: int):
    """The reference's value/grad mix: seed-derived, so the same command
    line always submits the same mix (None without gradients)."""
    if grad_frac <= 0:
        return None
    grng = np.random.default_rng(seed + 1)
    return [(bool(grng.random() < grad_frac), 1.0) for _ in range(num)]


def _verify(mats, dets, grads, device: torch.device) -> tuple[float, float]:
    """Worst relative error of the served values and gradients against
    the checks of the module docstring."""
    worst = worst_g = 0.0
    for i, (A, got) in enumerate(zip(mats, dets)):
        if got is None:  # shed under --max-pending: nothing to check
            continue
        m, n = A.shape
        T = torch.from_numpy(np.asarray(A, dtype=np.float64)).to(device)
        if grads is not None and grads[i][0]:
            T.requires_grad_(True)
            (want_g,) = torch.autograd.grad(
                radic_det(T, backend="torch", chunk=VERIFY_CHUNK), T)
            want_g = want_g.cpu().numpy()
            err = np.max(np.abs(np.asarray(got, dtype=np.float64) - want_g))
            worst_g = max(worst_g,
                          err / max(1.0, float(np.max(np.abs(want_g)))))
            continue
        if comb(n, m) <= ORACLE_MAX_RANKS:
            want = radic_det_oracle(np.asarray(A))
        else:
            want = float(radic_det(T, backend="torch", chunk=VERIFY_CHUNK))
        worst = max(worst, abs(got - want) / max(1.0, abs(want)))
    return worst, worst_g


def _serve_front(front, mats, label: str, num: int, backend: str,
                 grads=None):
    """A timed pass through any DetFront once every worker is up, then
    the front report (shared by ``--workers`` and ``--connect``); returns
    ``(dets, stats, wall)``."""
    front.snapshot(timeout=300.0)  # every worker has built its queue
    t0 = time.perf_counter()
    dets = _serve_tolerating_sheds(front, mats, grads)
    wall = time.perf_counter() - t0
    stats = front.snapshot()
    stats["front"]["wall_s"] = wall
    f, tot = stats["front"], stats["total"]
    print(f"# det_serve[{label}]: {num} requests, backend={backend}, "
          f"device={front.device}")
    print(f"front: workers={f['workers_alive']}/{f['workers_total']} "
          f"rerouted={f['rerouted']} worker_deaths={f['worker_deaths']} "
          f"shed={f['shed']} errors={f['errors']} "
          f"degraded={f['degraded']} joined={f['joined']} "
          f"stragglers_drained={f['stragglers_drained']}")
    print(f"total: batches={tot['batches']} "
          f"dispatches={tot['dispatches']} "
          f"grad_dispatches={tot['grad_dispatches']} "
          f"merged_requests={tot['merged_requests']} "
          f"padded_slots={tot['padded_slots']} "
          f"backlog_peak={tot['backlog_peak']} "
          f"plan_cache={tot['plan_cache']['size']} "
          f"(hits={tot['plan_cache']['hits']} "
          f"misses={tot['plan_cache']['misses']} "
          f"store_hits={tot['plan_cache']['store_hits']} "
          f"store_misses={tot['plan_cache']['store_misses']})")
    print("worker,routed,completed,batches,dispatches,grad_dispatches,shed,"
          "backlog_peak,plans")
    for wid, snap in sorted(stats["workers"].items()):
        print(f"{wid},{f['routed'].get(wid, 0)},{snap['completed']},"
              f"{snap['batches']},{snap['dispatches']},"
              f"{snap['grad_dispatches']},{snap['shed']},"
              f"{snap['backlog_peak']},{snap['plan_cache']['size']}")
    print("bucket_m,bucket_n,count,batches,ranks,mean_wait_s")
    for (m, n), b in sorted(tot["buckets"].items()):
        print(f"{m},{n},{b['count']},{b['batches']},{b['ranks']},"
              f"{b['wait_s'] / max(1, b['count']):.4f}")
    return dets, stats, wall


def _serve_scaled(front, mats, label: str, num: int, backend: str,
                  autoscale_max: int, grads=None):
    """``_serve_front``, optionally under the SLO autoscaler.

    CLI runs are seconds long, so the controller gets a fast cadence and
    short cooldown here; long-lived deployments should keep the
    :class:`~repro_torch.launch.autoscale.AutoscalePolicy` defaults."""
    if not autoscale_max:
        return _serve_front(front, mats, label, num, backend, grads)
    from repro_torch.launch.autoscale import Autoscaler
    with Autoscaler(front, min_workers=1, max_workers=autoscale_max,
                    interval_s=0.25, cooldown_s=2.0) as scaler:
        out = _serve_front(front, mats, f"{label}+autoscale{autoscale_max}",
                           num, backend, grads)
    print(f"autoscale: up={scaler.scaled_up} down={scaler.scaled_down} "
          f"stalls={scaler.stalls}")
    return out


def _pipeline_readings(stats: dict) -> str:
    """The queue's timings of its own pipeline (a zero denominator
    reads 0)."""
    def per(num: float, den: float) -> float:
        return num / den if den > 0 else 0.0
    busy = stats["stage_s"] - stats["stage_wait_s"]
    host = per(stats["complete_host_s"], stats["dispatches"])
    backlog = per(stats["backlog_s"], stats["completed"])
    return (f"stage_busy_ms={1e3 * per(busy, stats['batches']):.3f} "
            f"stage_cpu_share={100 * per(stats['stage_cpu_s'], busy):.1f}% "
            f"complete_host_ms={1e3 * host:.3f} "
            f"backlog_ms={1e3 * backlog:.3f}")


@contextlib.contextmanager
def _profiled(device: torch.device, path: str):
    """A profiler over every thread, host and card, that writes its
    Chrome trace to ``path`` when it stops (nothing without a path)."""
    if not path:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        yield
    prof.export_chrome_trace(path)


def _warm_device(device: torch.device, backend: str) -> None:
    """Bring up the card and build the kernel library before the clock
    starts (the reference's warm pass compiles; the port builds once)."""
    if device.type != "cuda":
        return
    torch.cuda.init()
    if backend == "cuda":
        from repro_torch.kernels import _build
        _build.load()


def main(argv=None):
    ap = argparse.ArgumentParser(
        epilog="multi-host recipe: start `--listen 0.0.0.0:7341` on every "
               "worker host, then run the front with "
               "`--connect hostA:7341,hostB:7341` — the front's handshake "
               "ships the serving config (device included), so daemons "
               "take no tuning flags; see DESIGN_FRONT.md for the wire "
               "protocol and failure semantics.  Single-host fast path: "
               "`--workers N --shm` moves matrix payloads into a "
               "per-worker shared-memory ring (bit-identical results).")
    ap.add_argument("--num", type=int, default=64,
                    help="queued requests to synthesize")
    ap.add_argument("--max-m", type=int, default=4)
    ap.add_argument("--max-n", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=2048,
                    help="ranks per step of the torch backend")
    ap.add_argument("--backend", choices=("torch", "cuda"), default="cuda")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (cuda, cuda:N or cpu)")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync", action="store_true",
                    help="use the synchronous drain_queue reference")
    ap.add_argument("--workers", type=int, default=0,
                    help="serve through the multi-worker DetFront with N "
                         "worker processes (0 = in-process DetQueue)")
    ap.add_argument("--shm", action="store_true",
                    help="--workers: carry matrix payloads over a per-"
                         "worker shared-memory ring instead of the pickled "
                         "queue (same-host only, bit-identical results)")
    ap.add_argument("--listen", type=str, default="",
                    help="run as a worker daemon on HOST:PORT instead of "
                         "serving a synthetic queue (the front's --connect "
                         "handshake ships the config; combine with "
                         "--serve-once for tests)")
    ap.add_argument("--serve-once", action="store_true",
                    help="with --listen: exit after the first front "
                         "session ends")
    ap.add_argument("--join", type=str, default="",
                    help="run as a worker daemon that dials INTO a running "
                         "front's --accept listener at HOST:PORT (live "
                         "join: same handshake as --listen, direction "
                         "reversed; exits when the front session ends)")
    ap.add_argument("--accept", type=str, default="",
                    help="--connect/--workers: also listen on HOST:PORT "
                         "for workers that dial in later with --join "
                         "(port 0 = ephemeral; the bound address is in "
                         "snapshot()['front']['accept_address'])")
    ap.add_argument("--autoscale", type=int, default=0,
                    help="--connect/--workers: run the SLO autoscaler, "
                         "growing/retiring workers between 1 and N "
                         "(0 = static pool; see launch/autoscale.py)")
    ap.add_argument("--connect", type=str, default="",
                    help="serve through a DetFront over remote worker "
                         "daemons: comma-separated host:port list, one "
                         "address per worker (see --listen)")
    ap.add_argument("--heartbeat", type=float, default=1.0,
                    help="--connect: worker heartbeat cadence in seconds "
                         "(a peer silent for 5 beats is declared dead)")
    ap.add_argument("--ack-timeout", type=float, default=0.0,
                    help="--connect/--workers: declare a worker dead when "
                         "a batch stays unacknowledged this long "
                         "(0 = disabled; bounds frame loss, not compute)")
    ap.add_argument("--policy", choices=("auto", "merge", "never"),
                    default="auto", help="re-bucketing mode (async path)")
    ap.add_argument("--max-pending", type=int, default=0,
                    help="admission-control backlog bound for the async "
                         "path (0 = unbounded; shed requests raise "
                         "LoadShedError on their futures)")
    ap.add_argument("--grad-frac", type=float, default=0.0,
                    help="fraction of requests submitted as gradient "
                         "requests (cotangent 1.0): their futures resolve "
                         "to the (m, n) ndarray d(det)/dA instead of a "
                         "float — async and front paths only "
                         "(DESIGN_GRAD.md)")
    ap.add_argument("--plan-store", type=str, default="", metavar="DIR",
                    help="persist plan records under DIR and restore "
                         "them on the next run (plan-cache misses consult "
                         "the store before planning; writes are "
                         "asynchronous); DIR/kernels/ keeps the kernel "
                         "library")
    ap.add_argument("--prefill", action="store_true",
                    help="--workers/--connect: ship joining workers the "
                         "front's live plan families so they warm up "
                         "(store first, plan second) before admission "
                         "(on by default when --plan-store is given)")
    ap.add_argument("--trace-out", type=str, default="", metavar="FILE",
                    help="async path: profile the timed pass on every "
                         "thread, host and card, and write its Chrome "
                         "trace to FILE")
    ap.add_argument("--verify", action="store_true",
                    help="cross-check every result: values against the "
                         "exact oracle (float64 torch past "
                         f"{ORACLE_MAX_RANKS} minors), gradients against "
                         "float64 autograd of the torch backend")
    args = ap.parse_args(argv)
    if not 0.0 <= args.grad_frac <= 1.0:
        ap.error("--grad-frac must be in [0, 1]")
    if args.grad_frac > 0 and args.sync:
        ap.error("--grad-frac needs the async or front path (drop --sync)")
    if args.trace_out and (args.sync or args.workers or args.connect
                           or args.listen or args.join):
        ap.error("--trace-out needs the one-queue async path")
    device = resolve_device(args.device)

    if args.listen or args.join:
        # worker daemon mode: no synthetic queue, no report — just a
        # DetQueue+DetEngine behind a socket, config shipped by the front;
        # on the card the kernel library is built before any session
        from repro_torch.launch.transport import (parse_hostport,
                                                  run_worker_client,
                                                  run_worker_server)
        if device.type == "cuda":
            from repro_torch.kernels import _build
            _build.load()
        if args.listen:
            host, port = parse_hostport(args.listen)
            run_worker_server(host, port, serve_once=args.serve_once)
        else:
            run_worker_client(args.join)
        return None, None

    mats = _random_queue(args.num, args.max_m, args.max_n, args.seed)
    grads = _grad_mix(args.num, args.grad_frac, args.seed)

    policy = BucketPolicy(max_batch=args.max_batch, mode=args.policy)
    front_kw = dict(chunk=args.chunk, backend=args.backend, policy=policy,
                    device=device, max_pending=args.max_pending or None,
                    ack_timeout_s=args.ack_timeout or None,
                    accept=args.accept or None,
                    persist_dir=args.plan_store or None,
                    prefill=args.prefill or None)
    if args.connect:
        from repro_torch.launch.det_front import DetFront
        from repro_torch.launch.transport import SocketTransport
        addrs = [a.strip() for a in args.connect.split(",") if a.strip()]
        transport = SocketTransport(addrs, heartbeat_s=args.heartbeat)
        with DetFront(transport=transport, **front_kw) as front:
            dets, stats, wall = _serve_scaled(
                front, mats, f"front x{len(addrs)}@socket/{args.policy}",
                args.num, args.backend, args.autoscale, grads)
    elif args.workers > 0:
        from repro_torch.launch.det_front import DetFront
        wire = "shm" if args.shm else "local"
        with DetFront(workers=args.workers, shm=args.shm,
                      **front_kw) as front:
            dets, stats, wall = _serve_scaled(
                front, mats, f"front x{args.workers}@{wire}/{args.policy}",
                args.num, args.backend, args.autoscale, grads)
    elif args.sync:
        _warm_device(device, args.backend)
        t0 = time.perf_counter()
        dets, stats = drain_queue(mats, chunk=args.chunk,
                                  backend=args.backend,
                                  max_batch=args.max_batch, device=device)
        wall = time.perf_counter() - t0
        print(f"# det_serve[sync]: {args.num} requests, {len(stats)} shape "
              f"buckets, backend={args.backend}, device={device}")
        print("bucket_m,bucket_n,count,dispatches,ranks,wall_s,"
              "mats_per_s,ranks_per_s")
        for (m, n), s in stats.items():
            print(f"{m},{n},{s['count']},{s['dispatches']},{s['ranks']},"
                  f"{s['wall_s']:.4f},{s['mats_per_s']:.1f},"
                  f"{s['ranks_per_s']:.3e}")
    else:
        with DetQueue(chunk=args.chunk, backend=args.backend, policy=policy,
                      max_pending=args.max_pending or None, device=device,
                      persist_dir=args.plan_store or None) as q:
            # after the queue: its engine points the build at the store
            _warm_device(device, args.backend)
            with _profiled(device, args.trace_out):
                t0 = time.perf_counter()
                dets = _serve_tolerating_sheds(q, mats, grads)
                wall = time.perf_counter() - t0
            stats = q.snapshot()
        print(f"# det_serve[async/{args.policy}]: {args.num} requests, "
              f"backend={args.backend}, device={device}")
        print(f"batches={stats['batches']} dispatches={stats['dispatches']} "
              f"grad_dispatches={stats['grad_dispatches']} "
              f"merged_requests={stats['merged_requests']} "
              f"padded_slots={stats['padded_slots']} "
              f"shed={stats['shed']} backlog_peak={stats['backlog_peak']} "
              f"plan_cache={stats['plan_cache']['size']}/"
              f"{stats['plan_cache']['max_plans']} "
              f"store_hits={stats['plan_cache']['store_hits']} "
              f"store_misses={stats['plan_cache']['store_misses']} "
              f"{_pipeline_readings(stats)}")
        print("bucket_m,bucket_n,count,batches,ranks,mean_wait_s")
        for (m, n), b in sorted(stats["buckets"].items()):
            print(f"{m},{n},{b['count']},{b['batches']},{b['ranks']},"
                  f"{b['wait_s'] / max(1, b['count']):.4f}")
    print(f"total,{args.num} mats,{wall:.4f}s,{args.num / wall:.1f} mats/s")

    if args.verify:
        worst, worst_g = _verify(mats, dets, grads, device)
        print(f"verify: worst rel err {worst:.2e}"
              + (f", worst grad rel err {worst_g:.2e}"
                 if grads is not None else ""))
        if worst > 2e-3:
            raise AssertionError(f"verify: worst rel err {worst:.2e} > 2e-3")
        if worst_g > 2e-3:
            raise AssertionError(
                f"verify: worst grad rel err {worst_g:.2e} > 2e-3")
    return dets, stats


if __name__ == "__main__":
    main()
