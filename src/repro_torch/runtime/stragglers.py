"""Grain scheduler with oversubscription + speculative tail re-execution.

Port of ``repro/runtime/stragglers.py`` (stdlib only, copied unchanged).

This is the runtime side of the paper's granularity scheme (Section 5):
work = contiguous rank grains of the Radic determinant (or any
embarrassingly-parallel partials).  Policy, mirroring classic
MapReduce-style backup tasks:

* grains are oversubscribed ``grains_per_worker``× so a slow worker holds
  less of the tail;
* when the queue drains, unfinished grains are *speculatively re-issued*
  to idle workers; first completion wins (grain partials are keyed by
  grain id → the reduction is idempotent, duplicates are dropped).

The scheduler is deliberately execution-agnostic (callables in, partials
out) so tests can inject slow/failing workers deterministically.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

__all__ = ["run_grains"]


def run_grains(grain_fns: Sequence[Callable[[], float]], n_workers: int,
               *, speculative: bool = True, max_attempts: int = 3,
               fail_on: set[tuple[int, int]] | None = None) -> list:
    """Execute grains on ``n_workers`` threads; returns per-grain results.

    ``max_attempts`` caps how many times one grain may be (re-)issued —
    a grain that fails every attempt surfaces in the terminal error with
    its attempt count instead of exhausting silently.

    ``fail_on``: {(worker_id, grain_id)} attempts that raise (test hook —
    simulates a node dying mid-grain).  With ``speculative=True`` the
    grain is re-issued; otherwise incomplete grains raise.
    """
    if max_attempts < 1:
        raise ValueError("max_attempts must be >= 1")
    n = len(grain_fns)
    results: list = [None] * n
    done = [False] * n
    attempts: list[int] = [0] * n
    lock = threading.Lock()
    fail_on = fail_on or set()

    def next_grain() -> int | None:
        with lock:
            # first pass: unissued grains; speculative pass: unfinished
            for g in range(n):
                if not done[g] and attempts[g] == 0:
                    attempts[g] += 1
                    return g
            if speculative:
                for g in range(n):
                    if not done[g] and attempts[g] < max_attempts:
                        attempts[g] += 1
                        return g
            return None

    def worker(wid: int):
        while True:
            g = next_grain()
            if g is None:
                return
            # the injected-failure check mutates the shared fail_on set,
            # so it happens under the scheduler lock: two workers
            # speculatively attempting the same grain must consume the
            # (wid, g) token exactly once
            with lock:
                fail = (wid, g) in fail_on
                if fail:
                    fail_on.discard((wid, g))
            try:
                if fail:
                    raise RuntimeError(f"simulated failure w{wid} g{g}")
                val = grain_fns[g]()
            except Exception:
                continue  # grain stays unfinished; someone re-issues it
            with lock:
                if not done[g]:       # first completion wins (idempotent)
                    done[g] = True
                    results[g] = val

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if not all(done):
        failed = [f"grain {g} after {attempts[g]} attempt(s)"
                  for g, d in enumerate(done) if not d]
        raise RuntimeError(
            f"grains never completed (max_attempts={max_attempts}): "
            + "; ".join(failed))
    return results
