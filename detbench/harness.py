"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

The window drives ``DetQueue.submit_many`` and reads the answers from
the queue's ``poll``.  A closed loop keeps the workload's ``outstanding``
requests in flight and tops them up as answers arrive.  At ``seconds``
the client stops submitting, and the window closes when the last answer
arrives (or a minute after the last answer that did, when some never
come: those count as failed).  The schema accepts an open loop (``loop:
open`` with a ``rate``); its client is not built yet, and such a cell
stops before its window.

After the window the program's state is freed and a sample of the
answers, drawn from the seed, is compared with the plain reference in
float64 (``reference.py``), on the matrices the generator makes again.

That is the Radic service's path, taken where a cell's configuration
names no ``driver``.  A configuration that names one is run by
``drivers/<driver>.py``, whose ``run_cell`` returns the same result line
(``result_line``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from detbench import reference, tracer
from detbench.traffic import Sampler, Traffic, load_config, load_workload

HERE = Path(__file__).resolve().parent
DRIVER_NAME = re.compile(r"[A-Za-z0-9_]{1,64}")

POLL_S = 0.05          # longest wait for an answer in one poll
SLICE_S = 10.0         # the window's rate is logged by slices this long
NEVER_S = 60.0         # an answer this long overdue never comes


@dataclass
class Run:
    """What a run knows once its window has closed: the readers'
    context (``metrics/<name>.py`` take it)."""
    workload: object
    config: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    drain_s: float = 0.0
    attempted: int = 0
    answered: int = 0
    failed: int = 0
    shapes: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), int))
    grads: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    latency_s: np.ndarray = field(default_factory=lambda: np.zeros(0))
    collections: dict = field(default_factory=dict)
    queue: tuple[dict, dict] = ({}, {})
    launches: tuple[dict, dict] = ({}, {})
    traced: dict | None = None
    memory_peak_bytes: int | None = None
    # a language model's run: tokens the window prefilled and decoded,
    # the ``ModelConfig`` it served and the device it ran on
    tokens_prefill: int = 0
    tokens_decode: int = 0
    model: object = None
    device: str | None = None

    def delta(self, key: str) -> float:
        """A queue counter's change over the window."""
        return self.queue[1].get(key, 0) - self.queue[0].get(key, 0)

    def plan_delta(self, key: str) -> int:
        return (self.queue[1].get("plan_cache", {}).get(key, 0)
                - self.queue[0].get("plan_cache", {}).get(key, 0))

    def launch_delta(self) -> dict[str, int]:
        a, b = self.launches
        return {k: b[k] - a.get(k, 0) for k in b}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit (``nvidia-smi``): the roofline's
    peaks are the H100's at its full 700 W."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "name and power limit not read"


def _drain(q) -> None:
    while q.poll(timeout=0):
        pass


class _Collections:
    """Python's collections in a span of time, by generation, and the
    time the full (gen2) ones took: every thread stops while one runs."""

    def __init__(self):
        self.counts = {"count": [0, 0, 0], "gen2_s": 0.0, "gen2_max_s": 0.0}
        self._t = 0.0

    def _cb(self, phase: str, info: dict) -> None:
        g = info["generation"]
        if phase == "start":
            self._t = time.perf_counter()
            return
        self.counts["count"][g] += 1
        if g == 2:
            d = time.perf_counter() - self._t
            self.counts["gen2_s"] += d
            self.counts["gen2_max_s"] = max(self.counts["gen2_max_s"], d)

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
        return False


class _Client:
    """The window's client: submits in k order, records each request's
    submit time and the time its answer was seen, and keeps the answers
    of the sample only."""

    def __init__(self, q, traffic: Traffic, trace: tracer.Trace):
        self.q, self.traffic, self.trace = q, traffic, trace
        self.sampler = Sampler(traffic)
        self.t_sub: list[float] = []
        self.t_ans: list[float] = []
        self.base: int | None = None
        self.submitted = 0
        self.answered = 0
        self.failed = 0

    def submit(self, count: int) -> None:
        k0 = self.submitted
        mats, kinds = self.traffic.requests(k0, count)
        with self.trace.span("client.submit_many"):
            t = time.perf_counter()
            fs = self.q.submit_many(mats, kinds)
        if self.base is None:
            self.base = fs[0].seq
        if fs[-1].seq - self.base != k0 + count - 1:
            raise RuntimeError("the queue's seqs do not follow submission")
        self.submitted += count
        self.t_sub.extend([t] * count)
        self.t_ans.extend([np.nan] * count)

    def poll(self, timeout: float) -> int:
        with self.trace.span("client.poll"):
            resp = self.q.poll(timeout=timeout)
        now = time.perf_counter()
        for seq, val in resp:
            k = seq - self.base
            self.t_ans[k] = now
            self.answered += 1
            if isinstance(val, BaseException):
                self.failed += 1
            else:
                self.sampler.offer(k, val)
        return len(resp)

    @property
    def pending(self) -> int:
        return self.submitted - self.answered


def _closed_loop(c: _Client, outstanding: int, seconds: float):
    t_open = time.perf_counter()
    t_end = t_open + seconds
    c.submit(outstanding)
    t_stop = last = None
    while True:
        got = c.poll(POLL_S)
        now = time.perf_counter()
        if got:
            last = now
        if now < t_end:
            if got:
                c.submit(got)
            continue
        t_stop = t_stop or now
        if not c.pending or now - (last or t_stop) > NEVER_S:
            break
    return t_open, t_stop, max(last or t_stop, t_stop)


def _make_queue(cfg: dict, device: str, backend: str | None):
    from repro_torch.launch.det_queue import BucketPolicy, DetQueue
    policy = BucketPolicy(max_batch=int(cfg["max_batch"]),
                          mode=cfg.get("policy", "auto"))
    return DetQueue(backend=backend or cfg["backend"], policy=policy,
                    dtype=np.dtype(cfg["dtype"]), device=device,
                    chunk=int(cfg.get("chunk", 2048)),
                    plan_cache=int(cfg.get("plan_cache", 128)),
                    pipeline_depth=int(cfg.get("pipeline_depth", 8)),
                    linger_s=float(cfg.get("linger_s", 0.0)))


def serve_window(workload, cfg: dict, seed: int, seconds: float, trace: bool,
                 *, device: str = "cuda", backend: str | None = None,
                 t_start: float | None = None) -> tuple[Run, dict]:
    """Set-up and the measured window → (the run's context, the sample:
    k → answer of each request drawn for the comparison)."""
    import torch
    if t_start is None:
        t_start = time.perf_counter()
    if workload.loop != "closed":
        raise ValueError(f"{workload.name}: only the closed loop is built; "
                         f"a {workload.loop!r} loop needs its client")
    run = Run(workload=workload, config=cfg)
    traffic = Traffic(workload, seed)
    from repro_torch.kernels._launch import launch_counts
    if device == "cuda":
        from repro_torch.kernels import _build
        torch.cuda.init()
        _build.load()
        info = _build.build_info()
        log(f"library {info.get('origin')} in {info.get('seconds', 0):.3f} s:"
            f" {info.get('path')}")
    q = _make_queue(cfg, device, backend)
    try:
        mats, kinds = traffic.warm_requests(int(cfg["max_batch"]))
        for f in q.submit_many(mats, kinds):
            f.result(timeout=600)
        _drain(q)
        q0, l0 = q.snapshot(), launch_counts()
        run.setup_s = time.perf_counter() - t_start
        log(f"set-up {run.setup_s:.3f} s ({len(mats)} warm-up requests)")
        with _Collections() as coll, tracer.Trace(trace, device) as tr:
            client = _Client(q, traffic, tr)
            t_open, t_stop, t_close = _closed_loop(
                client, workload.outstanding, seconds)
        run.collections = coll.counts
        run.queue = (q0, q.snapshot())
        run.launches = (l0, launch_counts())
        if device == "cuda":
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    finally:
        q.close(drain=False)
    run.window_s = t_close - t_open
    run.drain_s = t_close - t_stop
    run.attempted = client.submitted
    run.answered = client.answered
    run.failed = client.failed + client.pending
    ks = np.arange(client.submitted)
    run.shapes = np.asarray(traffic.w.shapes, dtype=np.int64)[ks % traffic.S]
    run.grads = np.array([traffic.is_grad(k) for k in ks], dtype=bool)
    t_ans = np.asarray(client.t_ans)
    ok = ~np.isnan(t_ans)
    run.latency_s = t_ans[ok] - np.asarray(client.t_sub)[ok]
    edges = np.append(np.arange(0.0, run.window_s, SLICE_S), run.window_s)
    per = np.histogram(t_ans[ok] - t_open, edges)[0] / np.diff(edges)
    log(f"answers a second by {SLICE_S:.0f} s slice of the window: "
        + ", ".join(f"{r:.1f}" for r in per))
    log(f"window {run.window_s:.3f} s: {run.answered} of {run.attempted} "
        f"answered, {run.failed} failed; drain {run.drain_s:.3f} s")
    c = run.collections
    log("python collections in the window: "
        + ", ".join(f"gen{g} {c['count'][g]}" for g in range(3))
        + f"; gen2 {c['gen2_s']:.3f} s in all, longest {c['gen2_max_s']:.3f}"
        " s (every thread stops)")
    if trace and tr.events is not None:
        d = run.launch_delta()
        fams = {"value": sum(v for k, v in d.items()
                             if "partial" in k and "grad" not in k),
                "grad": sum(v for k, v in d.items()
                            if "partial" in k and "grad" in k)}
        copies = {"HtoD": run.delta("dispatches")
                  + run.delta("grad_dispatches"),
                  "DtoH": run.delta("dispatches")}
        run.traced = tracer.reduce(tr.events, fams, copies)
        t = run.traced
        if device == "cuda":
            log(f"card: {card_line()} (rooflines against the H100's peaks "
                "at 700 W)")
        log(f"trace: {t['device_events']} device and {t['host_events']} host"
            f" events; recorded against counted launches "
            + ", ".join(f"{k} {t['recorded'][k]}/{t['counted'][k]}"
                        for k in t["recorded"])
            + f"; busy {t['busy_s']:.6f} s of which lost records "
            f"{t['lost_s']:.6f} s")
    return run, client.sampler.chosen()


def compare(workload, traffic: Traffic, sample: dict, device: str,
            dtype=None) -> dict[str, float]:
    """The worst errors of the sampled answers (``sample``: k → answer)
    against the reference in float64.  A value's error is taken against
    the root-sum-square of its signed minors, |got - want| /
    sqrt(Σ det(A[:, J])²), the scale of the rounding of a sum of them (a
    sum can cancel far below that scale, so the error against |want|
    alone swings with the seed); a gradient's per matrix by max |got -
    want| / max(1, max |want|).  With ``dtype`` the answers compared are
    instead the reference's own in that precision (the control)."""
    import torch
    groups: dict[tuple[int, bool], list[int]] = {}
    for k in sample:
        groups.setdefault((k % traffic.S, traffic.is_grad(k)), []).append(k)
    worst = {"value_err_rss": 0.0}
    if workload.has_grads:
        worst["grad_rel_err"] = 0.0
    for (_, grad), ks in sorted(groups.items()):
        As = torch.from_numpy(np.stack([traffic.matrix(k) for k in ks])
                              ).to(device)
        if grad:
            cts = torch.full((len(ks),), workload.cotangent,
                             dtype=torch.float64, device=device)
            want = reference.radic_grads(As, cts)
            got = (reference.radic_grads(As, cts, dtype) if dtype is not None
                   else torch.from_numpy(np.stack(
                       [np.asarray(sample[k]) for k in ks])).to(device))
            m, n = want.shape[1:]
            g, w = got.double().reshape(-1, m * n), want.reshape(-1, m * n)
            err = ((g - w).abs().amax(1) / w.abs().amax(1).clamp(min=1.0)
                   ).max().item()
            key = "grad_rel_err"
        else:
            want, rss = reference.radic_values(As)
            got = (reference.radic_values(As, dtype)[0] if dtype is not None
                   else torch.tensor([float(sample[k]) for k in ks],
                                     dtype=torch.float64, device=device))
            err = ((got.double() - want).abs() / rss).max().item()
            key = "value_err_rss"
        # NaN (an answer that is no number) is worse than any number
        worst[key] = max(worst[key], err if err == err else math.inf)
    worst["compared"] = len(sample)
    return worst


def metric_reader(name: str, root: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"detbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_driver(cell: str, root: Path = HERE):
    """The module ``drivers/<driver>.py`` that the cell's configuration
    names under ``driver``, loaded by path; None where it names none."""
    w = json.loads((root / "workloads" / f"{cell}.json").read_text())
    cfg_path = root / "configs" / f"{w['config']}.json"
    name = json.loads(cfg_path.read_text()).get("driver")
    if name is None:
        return None
    path = root / "drivers" / f"{name}.py"
    if not (isinstance(name, str) and DRIVER_NAME.fullmatch(name)
            and path.is_file()):
        raise ValueError(f"{cfg_path}: driver {name!r} has no file "
                         f"drivers/<driver>.py under {root}")
    spec = importlib.util.spec_from_file_location(f"detbench_driver_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    # registered: dataclasses look a class's module up in sys.modules
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, run: Run, root: Path = HERE):
    """The metric's reader, ``metrics/<name>.py``, over the run."""
    return metric_reader(name, root)(run)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    a trace, the per-layer ones with it, each where its ``workloads``
    names the cell or it has none."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             bench: dict, device: str = "cuda", backend: str | None = None,
             t_start: float | None = None, root: Path = HERE) -> dict:
    """One run → the result line's object (``checks`` last), by the
    driver the cell's configuration names, else by the Radic queue's
    path below."""
    driver = cell_driver(cell, root)
    if driver is not None:
        return driver.run_cell(cell, seed, seconds, trace, bench=bench,
                               device=device, t_start=t_start, root=root)
    import torch
    workload = load_workload(cell, root)
    cfg = load_config(workload.config, root)
    run, sample = serve_window(workload, cfg, seed, seconds, trace,
                             device=device, backend=backend, t_start=t_start)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    worst = compare(workload, Traffic(workload, seed), sample, device)
    log(f"reference: {worst.pop('compared')} answers compared in "
        f"{time.perf_counter() - t0:.3f} s")
    return result_line(run, worst, cfg["guarantees"], cell=cell, trace=trace,
                       bench=bench, device=device, root=root)


def result_line(run: Run, worst: dict[str, float], limits: dict, *,
                cell: str, trace: bool, bench: dict, device: str,
                root: Path = HERE) -> dict:
    """The result line's object (``checks`` last) of a run whose window
    has closed and whose compared numbers are ``worst``."""
    import torch
    # an error that is no finite number reads as the largest float, so
    # that the line stays strict JSON
    checks = {k: {"value": v if math.isfinite(v) else sys.float_info.max,
                  "limit": float(limits[k])} for k, v in worst.items()}
    correct = run.failed == 0 and all(c["value"] <= c["limit"]
                                      for c in checks.values())
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        v = read_metric(m["name"], run, root)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name() if device == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.traced is not None:
        dev["busy_s"] = run.traced["busy_s"]
        dev["window_s"] = run.window_s
        out["breakdown"] = {"device_ops": run.traced["device_ops"],
                            "idle_gaps": run.traced["idle_gaps"]}
    out["checks"] = checks
    return out


def print_result(out: dict) -> None:
    """Stderr's last lines: each compared number beside its limit; then
    the result as stdout's last line."""
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
