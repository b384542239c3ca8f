"""Heartbeat watchdog + step-time straggler detector.

Port of ``repro/runtime/watchdog.py`` (stdlib only, copied unchanged).

The watchdog thread fires ``on_stall`` if no heartbeat arrives within
``timeout_s`` (hung collective / dead host → the launcher checkpoints
what it can and triggers an elastic restart).  The detector keeps an EMA
of step times and flags outliers (persistent stragglers at scale get
their hosts drained; the serving front's drainer sweep and the
autoscaler in ``repro_torch.launch.autoscale`` consume both signals)."""

from __future__ import annotations

import threading
import time
from typing import Callable

__all__ = ["Watchdog", "StepTimer"]


class Watchdog:
    """Fire ``on_stall`` when ``beat()`` goes quiet for ``timeout_s``.

    ``beat()`` is called from whatever thread does the guarded work, the
    deadline check runs on the watchdog's own thread, and ``fired`` is
    read by health probes — so the deadline state is shared three ways
    and lives under ``_lock``.  ``fired`` latches across stalls (a probe
    polling slower than the re-arm period must still see the verdict)
    until ``reset()`` clears it.  ``on_stall`` runs *outside* the lock:
    a handler may ``beat()`` or ``reset()`` without deadlocking.
    """

    # reprolint lock-discipline registry (see DESIGN_LINT.md): the
    # deadline and the latch are written by beat()/reset() callers and
    # the watchdog thread, read by the ``fired`` probe.
    _GUARDED_BY = {"_last": ("_lock",), "_fired": ("_lock",)}

    def __init__(self, timeout_s: float, on_stall: Callable[[], None]):
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._t = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._t.start()
        return self

    def beat(self):
        with self._lock:
            self._last = time.monotonic()

    def reset(self):
        """Clear the ``fired`` latch and re-arm the deadline: one stall
        must not poison every later health check."""
        with self._lock:
            self._fired = False
            self._last = time.monotonic()

    def _run(self):
        while not self._stop.is_set():
            stalled = False
            with self._lock:
                if time.monotonic() - self._last > self.timeout_s:
                    self._fired = True
                    self._last = time.monotonic()  # re-arm
                    stalled = True
            if stalled:
                self.on_stall()  # outside the lock: may beat()/reset()
            time.sleep(self.timeout_s / 10.0)

    @property
    def fired(self) -> bool:
        with self._lock:
            return self._fired

    def stop(self):
        self._stop.set()


class StepTimer:
    """EMA step-time tracker; ``record`` returns True for straggler steps
    (> ``factor`` × EMA after warmup).

    The first sample only *seeds* the EMA — it is calibration, not a
    measurement, so it does not count toward ``n`` or the warmup.
    ``warmup`` is therefore the number of *measured* samples (post-seed
    EMA updates) that must accumulate before detection arms: with
    ``warmup=5`` the seed plus five measured samples pass unflagged and
    the seventh ``record`` is the first eligible straggler.  (The seed
    used to increment ``n``, which shifted the gate by one sample and
    skewed the step ids landing in ``stragglers``.)
    """

    def __init__(self, alpha: float = 0.1, factor: float = 2.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.factor = factor
        self.warmup = warmup
        self.ema: float | None = None
        self.n = 0  # measured samples: records *after* the EMA seed
        self.stragglers: list[int] = []

    def record(self, step: int, dt: float) -> bool:
        if self.ema is None:
            self.ema = dt  # calibration sample: not counted in n
            return False
        self.n += 1
        is_straggler = (self.n > self.warmup
                        and dt > self.factor * self.ema)
        # stragglers don't poison the EMA
        if not is_straggler:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        else:
            self.stragglers.append(step)
        return is_straggler
