"""The traced run's profiler window and its reduction to device time.

``Trace`` runs ``torch.profiler`` over the whole measured window (host
and device activity) and keeps, once it stops, the device events
(kernels, copies, fills) and the host events as arrays.  ``reduce``
turns them into what the per-layer readers take:

* device time per kernel family, corrected for lost records: the
  profiler on this card drops some of the library's kernel records, so a
  family's recorded time is scaled by the launches the program counted
  over the recorded ones (each lost launch costs the family's mean
  recorded launch), and a copy's by the copies the queue's counters say it
  made;
* busy time, the union of the recorded intervals plus the time of the
  lost records, so that lost records do not read as idle time (the
  device's copies of host ranges are no device work: they are left
  out);
* the breakdown: the device operations that took most time, and the
  longest idle gaps, each named by the host operations that overlap it
  most.
"""

from __future__ import annotations

import contextlib
import gc
import re
from dataclasses import dataclass, field

import numpy as np

# Kernel families: the kernels one counted launch runs.  A launch of a
# value wrapper runs one walk (register, prefix or warp) and its
# reduction, a launch of a gradient wrapper one gradient walk and its
# reduction.
FAMILIES = {
    "value": ("radic_partial_kernel", "radic_prefix_kernel",
              "radic_warp_partial_kernel", "reduce_partials_kernel"),
    "grad": ("radic_grad_partial_kernel", "radic_grad_warp_kernel",
             "reduce_grad_partials_kernel"),
}
# the walk of each family, whose records are counted against launches
WALKS = {
    "value": FAMILIES["value"][:3],
    "grad": FAMILIES["grad"][:2],
}
COPY_KINDS = {"HtoD": "Memcpy HtoD", "DtoH": "Memcpy DtoH"}
TOP = 10


def short_name(name: str) -> str:
    """A device op's name without its template and argument lists."""
    name = re.sub(r"^void\s+", "", name)
    name = re.sub(r"^radic::", "", name)
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)] if cut else name


@dataclass
class Events:
    """Device and host events of one window, times in ns."""
    dev_name: list[str] = field(default_factory=list)
    dev_start: np.ndarray = field(default_factory=lambda: np.zeros(0))
    dev_end: np.ndarray = field(default_factory=lambda: np.zeros(0))
    host_name: list[str] = field(default_factory=list)
    host_start: np.ndarray = field(default_factory=lambda: np.zeros(0))
    host_end: np.ndarray = field(default_factory=lambda: np.zeros(0))


def _collect(prof) -> Events:
    """The profiler's events, read from its Kineto results (fast) or,
    where those are not there, from ``prof.events()``."""
    from torch.autograd import DeviceType
    dn, ds, de, hn, hs, he = [], [], [], [], [], []
    kr = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kr is not None:
        for e in kr.events():
            s = e.start_ns()
            end = s + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                dn.append(e.name()); ds.append(s); de.append(end)
            else:
                hn.append(e.name()); hs.append(s); he.append(end)
    else:
        for e in prof.events():
            s = e.time_range.start * 1e3
            end = e.time_range.end * 1e3
            if e.device_type == DeviceType.CUDA:
                dn.append(e.name); ds.append(s); de.append(end)
            else:
                hn.append(e.name); hs.append(s); he.append(end)
    f = np.float64
    return without_annotations(Events(dn, np.asarray(ds, f),
                                      np.asarray(de, f), hn,
                                      np.asarray(hs, f), np.asarray(he, f)))


def without_annotations(ev: Events) -> Events:
    """The events without the device timeline's copies of host ranges: a
    ``record_function`` range that encloses launches is mirrored on the
    device under its own name (a user annotation), and would read as
    device work over the whole range.  A kernel or copy never bears the
    name of a host event."""
    host = set(ev.host_name)
    keep = [i for i, n in enumerate(ev.dev_name) if n not in host]
    if len(keep) == len(ev.dev_name):
        return ev
    return Events([ev.dev_name[i] for i in keep], ev.dev_start[keep],
                  ev.dev_end[keep], ev.host_name, ev.host_start, ev.host_end)


class Trace:
    """A profiler window; ``span(name)`` marks a host span of the
    harness inside it.  With ``on=False`` it does nothing."""

    def __init__(self, on: bool, device: str):
        self.on = on
        self.device = device
        self.events: Events | None = None
        self._prof = None
        self._gc_span = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            gc.callbacks.append(self._gc)
        return self

    def _gc(self, phase: str, info: dict) -> None:
        """Python's collections as host spans ``python.gc``: every
        thread stops while one runs."""
        from torch.profiler import record_function
        if phase == "start":
            self._gc_span = record_function("python.gc")
            self._gc_span.__enter__()
        elif self._gc_span is not None:
            self._gc_span.__exit__(None, None, None)
            self._gc_span = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def __exit__(self, *exc):
        if self._prof is not None:
            gc.callbacks.remove(self._gc)
            if self.device == "cuda":
                import torch
                torch.cuda.synchronize()
            self._prof.__exit__(*exc)
            self.events = _collect(self._prof)
            self._prof = None
        return False


def _union(start: np.ndarray, end: np.ndarray) -> tuple[float, np.ndarray]:
    """Total length of the union of intervals, and its gaps (a, b) in
    time order."""
    if len(start) == 0:
        return 0.0, np.zeros((0, 2))
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    reach = np.maximum.accumulate(e)
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    seg_s = s[idx]
    seg_e = np.maximum.reduceat(e, idx)
    gaps = np.stack([seg_e[:-1], seg_s[1:]], 1)
    return float((seg_e - seg_s).sum()), gaps


# the client's wait for answers: it names no work of the host
WAITING = ("client.poll",)


def _label(ev: Events, a: float, b: float) -> str:
    """The host operations that overlap (a, b) most, by name (the
    client's wait where nothing else does)."""
    if not len(ev.host_start):
        return "no host event"
    ov = np.minimum(ev.host_end, b) - np.maximum(ev.host_start, a)
    hit = np.flatnonzero(ov > 0)
    if not len(hit):
        return "no host event"
    by: dict[str, float] = {}
    for i in hit:
        by[ev.host_name[i]] = by.get(ev.host_name[i], 0.0) + float(ov[i])
    if len(by) > 1:
        for name in WAITING:
            by.pop(name, None)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:2]
    return " + ".join(name for name, _ in top)


def reduce(ev: Events, launches: dict[str, int],
           copies: dict[str, int]) -> dict:
    """Device time, busy time and breakdown of one window.

    ``launches``: counted launches per family (``value``, ``grad``);
    ``copies``: copies the queue made per kind (``HtoD``, ``DtoH``)."""
    dur = ev.dev_end - ev.dev_start
    names = [short_name(n) for n in ev.dev_name]
    by_op: dict[str, float] = {}
    for n, d in zip(names, dur):
        by_op[n] = by_op.get(n, 0.0) + float(d)
    recorded, counted, kernel_ns, lost_ns = {}, {}, {}, 0.0
    for fam, members in FAMILIES.items():
        walks = sum(1 for n in names if n in WALKS[fam])
        t = float(sum(d for n, d in zip(names, dur) if n in members))
        want = int(launches.get(fam, 0))
        recorded[fam], counted[fam] = walks, want
        if want == 0 and walks == 0:
            continue
        if walks == 0:
            kernel_ns[fam] = None   # every record lost: no time to scale
            continue
        scale = max(1.0, want / walks)
        kernel_ns[fam] = t * scale
        lost_ns += t * (scale - 1.0)
    for kind, prefix in COPY_KINDS.items():
        sel = [d for n, d in zip(ev.dev_name, dur) if n.startswith(prefix)]
        want = int(copies.get(kind, 0))
        recorded[kind], counted[kind] = len(sel), want
        if sel:
            lost_ns += float(sum(sel)) * (max(1.0, want / len(sel)) - 1.0)
    busy_ns, gaps = _union(ev.dev_start, ev.dev_end)
    gap_len = gaps[:, 1] - gaps[:, 0] if len(gaps) else np.zeros(0)
    longest = np.argsort(-gap_len, kind="stable")[:TOP]
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "device_events": len(ev.dev_name),
        "host_events": len(ev.host_name),
        "recorded": recorded,
        "counted": counted,
        "kernel_s": {f: (None if v is None else v * 1e-9)
                     for f, v in kernel_ns.items()},
        "busy_s": (busy_ns + lost_ns) * 1e-9,
        "lost_s": lost_ns * 1e-9,
        "device_ops": [[n, d * 1e-9] for n, d in top_ops],
        "idle_gaps": [[_label(ev, *gaps[i]), float(gap_len[i]) * 1e-9]
                      for i in longest],
    }
