"""SLO autoscaler for the determinant serving front.

Port of ``repro/launch/autoscale.py``, unchanged in its decisions: the
same snapshots and clock give the same actions.  The cold set is read
from each worker's ``DetQueue.snapshot()["plan_cache"]`` hit counts, the
plan store's ``store_hits`` included, so a worker prefilled from the
store (``DetFront(persist_dir=...)``) is hot from its first tick.  The
worker ceiling is the reference's core-count rule, not capped by the
card: on the card pass an explicit maximum (``det_serve --autoscale N``),
since every worker holds its own CUDA context on the one card.

The paper's O(n²) bound holds when the C(n, m) minor enumeration is
spread over however many workers are *currently* healthy — so the pool
size must track load, not the launch-time guess.  This module closes
that loop: a small controller samples the stats the serving tier
already emits (:meth:`DetFront.snapshot` — per-worker front-side
backlog, completion-latency EMAs, shed counters) and adds or retires
workers against an SLO target.

The controller is deliberately boring — a thresholded hysteresis loop,
no model, no prediction — because every actuator it drives is already
deterministic and safe:

* **scale-up** is :meth:`DetFront.grow` (the transport spawns a local
  worker or dials a standby daemon; a ``det_serve --join`` daemon
  dialing the front's ``--accept`` listener arrives through the same
  admission path).  Admission is atomic under the router lock and the
  sticky placer keeps every already-assigned plan family on the worker
  that planned it, so a join never moves in-flight work and results
  stay bit-identical (DESIGN_FRONT.md, "Dynamic membership").
* **scale-down** is :meth:`DetFront.retire_worker` — the graceful
  drain: the victim leaves the ring first, hands back its un-staged
  backlog for re-routing, and finishes in-flight batches.

Hysteresis, so the pool never flaps (the constants live in
:class:`AutoscalePolicy` and are documented in DESIGN_FRONT.md):
a scale-up needs ``up_ticks`` *consecutive* breach observations, a
scale-down needs ``idle_ticks`` consecutive idle observations, and any
membership action opens a ``cooldown_s`` window in which no further
action fires (the survivors' latency EMAs and the placer's load vector
need time to absorb a membership change before the next verdict).

The loop thread is guarded by a :class:`~repro_torch.runtime.watchdog
.Watchdog` — a controller wedged inside ``snapshot()`` (a degraded
pool can make it wait out its timeout) surfaces as a counted stall,
not a silently dead autoscaler.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, replace

from repro_torch.launch.det_queue import QueueClosedError
from repro_torch.runtime.elastic import choose_mesh
from repro_torch.runtime.watchdog import Watchdog

__all__ = ["Autoscaler", "AutoscalePolicy", "default_max_workers"]


def default_max_workers() -> int:
    """The host's physical worker ceiling: the largest power-of-two
    worker count the cores support (``choose_mesh``'s grid rule with
    the model axis pinned to 1 — one serving worker is one data-
    parallel slot; lost cores rarely leave a perfect grid)."""
    return choose_mesh(os.cpu_count() or 1, max_model=1).n_devices


@dataclass(frozen=True)
class AutoscalePolicy:
    """Thresholds and hysteresis constants (see DESIGN_FRONT.md).

    ``backlog_high`` is mean front-side pending per alive worker;
    ``slo_latency_s`` bounds any worker's completion-latency EMA
    (None disables the latency trigger); a tick is a *breach* when
    either bound is exceeded or requests were shed since the last
    tick, and *idle* when nothing is pending, nothing was submitted
    and nothing was shed since the last tick.

    Plan-cache temperature (DESIGN_PERSIST.md): a worker is *cold*
    while its combined engine+store hit rate
    ``(hits + store_hits) / (hits + misses)`` sits below
    ``cold_hit_rate`` — i.e. it is still paying plan misses that neither
    the LRU cache nor the plan store absorbed.  Cold workers are
    reported to the front (:meth:`DetFront.mark_cold_workers`), which
    shields them from the straggler sweep: a joiner's warm-up planning
    latency must never read as slowness and get it drained right after
    arrival.  A warm-started joiner (prefilled from the store) scores
    ``store_hits ≈ misses`` and is hot from its first tick — which is
    why scale-out through a populated store adds capacity without an
    entry cliff.  ``cold_grace_requests`` bounds the shield: past that
    many plan-cache lookups a worker has had its warm-up and competes
    on latency like everyone else.
    """
    min_workers: int = 1
    max_workers: int = 2
    backlog_high: float = 8.0
    slo_latency_s: float | None = None
    up_ticks: int = 2
    idle_ticks: int = 4
    cooldown_s: float = 10.0
    interval_s: float = 1.0
    cold_hit_rate: float = 0.5
    cold_grace_requests: int = 64

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if self.max_workers < self.min_workers:
            raise ValueError("max_workers must be >= min_workers")
        if not 0.0 <= self.cold_hit_rate <= 1.0:
            raise ValueError("cold_hit_rate must be in [0, 1]")
        if self.cold_grace_requests < 0:
            raise ValueError("cold_grace_requests must be >= 0")


class Autoscaler:
    """Scale a :class:`~repro_torch.launch.det_front.DetFront` between
    ``min_workers`` and ``max_workers`` against an SLO target.

    ``tick()`` is one observation + at most one membership action and
    is callable directly (the tests drive it with injected snapshots
    and clocks for determinism); ``start()`` runs it every
    ``interval_s`` on a daemon thread until ``stop()``.
    """

    # reprolint lock-discipline registry (see DESIGN_LINT.md): the
    # hysteresis state is shared between the loop thread, direct tick()
    # callers and the watchdog's stall callback.
    _GUARDED_BY = {
        "_breach_ticks": ("_lock",),
        "_idle_ticks": ("_lock",),
        "_last_action_t": ("_lock",),
        "_last_shed": ("_lock",),
        "_last_submitted": ("_lock",),
        "scaled_up": ("_lock",),
        "scaled_down": ("_lock",),
        "stalls": ("_lock",),
    }

    def __init__(self, front, policy: AutoscalePolicy | None = None,
                 **overrides):
        if policy is None:
            policy = AutoscalePolicy()
        if overrides:
            policy = replace(policy, **overrides)
        self.front = front
        self.policy = policy
        self._lock = threading.Lock()
        self._breach_ticks = 0
        self._idle_ticks = 0
        self._last_action_t = float("-inf")  # first action needs no cooldown
        self._last_shed: int | None = None
        self._last_submitted: int | None = None
        self.scaled_up = 0
        self.scaled_down = 0
        self.stalls = 0
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._wd: Watchdog | None = None

    # ------------------------------------------------------------- decision
    def _note_stall(self) -> None:
        with self._lock:
            self.stalls += 1

    def _cold_set(self, workers: dict) -> set[int]:
        """Worker ids still paying their warm-up plans: combined
        engine+store plan-cache hit rate below ``cold_hit_rate``, with
        the shield expiring after ``cold_grace_requests`` lookups.  A
        store-prefilled joiner scores ``store_hits == misses`` (rate
        1.0) and is never cold."""
        p = self.policy
        cold: set[int] = set()
        for wid, wsnap in workers.items():
            pc = wsnap.get("plan_cache") if isinstance(wsnap, dict) else None
            if not isinstance(pc, dict):
                continue
            hits = int(pc.get("hits", 0))
            misses = int(pc.get("misses", 0))
            store_hits = int(pc.get("store_hits", 0))
            if hits + misses > p.cold_grace_requests:
                continue
            rate = (hits + store_hits) / max(1, hits + misses)
            if rate < p.cold_hit_rate:
                cold.add(int(wid))
        return cold

    @staticmethod
    def _pick_victim(front_stats: dict) -> int | None:
        """The scale-down victim: the least plan-loaded routable worker
        (ties broken by id, so the choice is deterministic)."""
        load = front_stats.get("plan_load", {})
        if not load:
            return None
        return min(load, key=lambda wid: (load[wid], wid))

    def tick(self, snap: dict | None = None, now: float | None = None) -> str:
        """One control step; returns ``"up"``, ``"down"`` or ``"hold"``.

        ``snap``/``now`` default to a live ``front.snapshot()`` and the
        monotonic clock; tests inject both.
        """
        p = self.policy
        if now is None:
            now = time.monotonic()
        if snap is None:
            snap = self.front.snapshot(timeout=max(5.0, 5 * p.interval_s))
        f = snap["front"]
        # plan-cache temperature: report cold workers before the
        # membership verdict so the front's straggler sweep never
        # confuses a joiner's warm-up plans with slowness.  Injected
        # test snapshots may carry no per-worker section and stub
        # fronts may lack the hook — both degrade to "nobody is cold".
        mark_cold = getattr(self.front, "mark_cold_workers", None)
        if mark_cold is not None:
            mark_cold(self._cold_set(snap.get("workers") or {}))
        alive = int(f.get("workers_alive", 0))
        pending = sum(f.get("pending", {}).values())
        submitted = int(f.get("submitted", 0))
        shed = int(f.get("shed", 0))
        lat = max(f.get("latency_ema_s", {}).values(), default=0.0)

        with self._lock:
            # deltas survive a reset_stats(): a counter that went
            # backwards means the window restarted, not negative traffic
            shed_delta = (shed - self._last_shed
                          if self._last_shed is not None
                          and shed >= self._last_shed else 0)
            sub_delta = (submitted - self._last_submitted
                         if self._last_submitted is not None
                         and submitted >= self._last_submitted else 0)
            self._last_shed = shed
            self._last_submitted = submitted

            breach = (pending / max(1, alive) > p.backlog_high
                      or shed_delta > 0
                      or (p.slo_latency_s is not None
                          and lat > p.slo_latency_s))
            idle = pending == 0 and shed_delta == 0 and sub_delta == 0
            self._breach_ticks = self._breach_ticks + 1 if breach else 0
            self._idle_ticks = self._idle_ticks + 1 if idle else 0
            cooled = now - self._last_action_t >= p.cooldown_s

            action = "hold"
            if (breach and self._breach_ticks >= p.up_ticks and cooled
                    and alive < p.max_workers):
                action = "up"
            elif (idle and self._idle_ticks >= p.idle_ticks and cooled
                    and alive > p.min_workers):
                action = "down"
            if action != "hold":
                # the cooldown opens even if the actuator below falls
                # short (no spare daemon): hammering a capped transport
                # every tick is exactly the flap this window prevents
                self._last_action_t = now
                self._breach_ticks = 0
                self._idle_ticks = 0

        if action == "up":
            grown = self.front.grow(1)
            with self._lock:
                self.scaled_up += len(grown)
            if not grown:
                action = "hold"  # transport at capacity
        elif action == "down":
            victim = self._pick_victim(f)
            if victim is None:
                action = "hold"
            else:
                self.front.retire_worker(victim)
                with self._lock:
                    self.scaled_down += 1
        return action

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._wd = Watchdog(max(10 * self.policy.interval_s, 10.0),
                            self._note_stall).start()
        self._thread = threading.Thread(target=self._run,
                                        name="det-autoscaler", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop_evt.wait(self.policy.interval_s):
            try:
                self.tick()
            except QueueClosedError:
                return  # front closed under us: the loop's work is done
            except RuntimeError:
                return  # no live workers / front torn down mid-tick
            finally:
                if self._wd is not None:
                    self._wd.beat()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        if self._wd is not None:
            self._wd.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
