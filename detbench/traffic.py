"""The one traffic generator: it reads a workload file and makes every
request's matrix and kind from ``--seed``.

The shape sequence is data: request k takes shape ``k mod S`` of the
workload's list of S shapes, so every seed puts the same work in the
window and only the entries of the matrices change.  Entries are standard
normal float32, drawn fresh for every request: requests are made in
blocks of ``BLOCK_ROUNDS`` rounds (a round is one request of each shape),
block b from its own stream of the seed, so that any request's matrix can
be made again after the window to check its answer.

With ``grad_period`` p > 0, request k is a gradient (cotangent
``cotangent``) when ``(k mod S + k div S) mod p == p - 1``: one request in
p of every shape and of every round, whatever S is.
"""

from __future__ import annotations

import heapq
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BLOCK_ROUNDS = 64
LOOPS = ("closed", "open")
# spawn keys of the seed's streams besides the blocks' (0, 1, ...)
_WARM_KEY = 1 << 40
_SAMPLE_KEY = 1 << 41


@dataclass(frozen=True)
class Workload:
    name: str
    config: str
    loop: str
    shapes: tuple[tuple[int, int], ...]
    grad_period: int
    cotangent: float
    outstanding: int | None
    rate: float | None
    check_per_shape: int

    @property
    def has_grads(self) -> bool:
        return self.grad_period > 0


def workload_from_dict(name: str, d: dict) -> Workload:
    """Validate a workload file's contents."""
    loop = d.get("loop", "closed")
    if loop not in LOOPS:
        raise ValueError(f"{name}: loop {loop!r} is not one of {LOOPS}")
    shapes = tuple((int(m), int(n)) for m, n in d["shapes"])
    if not shapes or any(not 1 <= m <= n for m, n in shapes):
        raise ValueError(f"{name}: shapes must be (m, n) with 1 <= m <= n")
    if len(set(shapes)) != len(shapes):
        raise ValueError(f"{name}: a shape is listed twice")
    grad_period = int(d.get("grad_period", 0))
    if grad_period < 0:
        raise ValueError(f"{name}: grad_period must be >= 0")
    outstanding = d.get("outstanding")
    rate = d.get("rate")
    if loop == "closed" and (outstanding is None or int(outstanding) < 1):
        raise ValueError(f"{name}: a closed loop needs outstanding >= 1")
    if loop == "open" and (rate is None or float(rate) <= 0):
        raise ValueError(f"{name}: an open loop needs a rate > 0")
    per_shape = int(d.get("check_per_shape", 1))
    if per_shape < 1:
        raise ValueError(f"{name}: check_per_shape must be >= 1")
    return Workload(name=name, config=str(d["config"]), loop=loop,
                    shapes=shapes, grad_period=grad_period,
                    cotangent=float(d.get("cotangent", 1.0)),
                    outstanding=None if outstanding is None
                    else int(outstanding),
                    rate=None if rate is None else float(rate),
                    check_per_shape=per_shape)


def load_workload(name: str, root: Path = HERE) -> Workload:
    return workload_from_dict(
        name, json.loads((root / "workloads" / f"{name}.json").read_text()))


def load_config(name: str, root: Path = HERE) -> dict:
    return json.loads((root / "configs" / f"{name}.json").read_text())


def seed_entropy(seed: int) -> list[int]:
    """Any whole number as a seed, negative or past 64 bits included."""
    return [abs(int(seed)), int(seed < 0)]


class Traffic:
    """Requests of one workload under one seed, in the order k = 0, 1, ..."""

    def __init__(self, workload: Workload, seed: int):
        self.w = workload
        self.seed = int(seed)
        self.S = len(workload.shapes)
        self._block: tuple[int, list[np.ndarray]] | None = None
        self._prio: dict[int, np.ndarray] = {}

    def _stream(self, key: int) -> np.random.Generator:
        return np.random.Generator(np.random.PCG64(np.random.SeedSequence(
            seed_entropy(self.seed), spawn_key=(key,))))

    def _make_block(self, key: int) -> list[np.ndarray]:
        rng = self._stream(key)
        return [rng.standard_normal((BLOCK_ROUNDS, m, n), dtype=np.float32)
                for m, n in self.w.shapes]

    def block(self, b: int) -> list[np.ndarray]:
        """Block b: one ``(BLOCK_ROUNDS, m, n)`` stack per shape."""
        if self._block is None or self._block[0] != b:
            self._block = (b, self._make_block(b))
        return self._block[1]

    def shape(self, k: int) -> tuple[int, int]:
        return self.w.shapes[k % self.S]

    def is_grad(self, k: int) -> bool:
        p = self.w.grad_period
        return p > 0 and (k % self.S + k // self.S) % p == p - 1

    def matrix(self, k: int) -> np.ndarray:
        r = k // self.S
        return self.block(r // BLOCK_ROUNDS)[k % self.S][r % BLOCK_ROUNDS]

    def requests(self, k0: int, count: int):
        """Requests k0 .. k0 + count - 1 as (matrices, [(grad, ct)])."""
        mats, kinds = [], []
        ct = self.w.cotangent
        for k in range(k0, k0 + count):
            mats.append(self.matrix(k))
            kinds.append((True, ct) if self.is_grad(k) else (False, 1.0))
        return mats, kinds

    def warm_requests(self, rounds: int):
        """``rounds`` rounds of every shape from a stream of their own (one
        batch of every shape at rounds = the queue's max_batch), and as
        many gradients of every shape where the workload sends them."""
        rng = self._stream(_WARM_KEY)
        mats, kinds = [], []
        for m, n in self.w.shapes:
            stack = rng.standard_normal((rounds, m, n), dtype=np.float32)
            mats.extend(stack)
            kinds.extend([(False, 1.0)] * rounds)
            if self.w.has_grads:
                mats.extend(stack)
                kinds.extend([(True, self.w.cotangent)] * rounds)
        return mats, kinds

    def priority(self, k: int) -> float:
        """Request k's place in the draw of the sample: uniform in [0, 1)
        from the seed, one stream per block."""
        b, i = divmod(k, BLOCK_ROUNDS * self.S)
        if b not in self._prio:
            if len(self._prio) > 8:
                self._prio.pop(min(self._prio))
            self._prio[b] = self._stream(_SAMPLE_KEY + 1 + b).random(
                BLOCK_ROUNDS * self.S)
        return float(self._prio[b][i])


class Sampler:
    """The requests whose answers are compared, drawn from the seed as
    they are answered: of every shape and kind (value, gradient), the
    ``check_per_shape`` answered requests of the lowest priority.  Which
    requests those are depends on the set answered, not on the order of
    the answers; only the sample's items are kept."""

    def __init__(self, traffic: Traffic):
        self.t = traffic
        self.per = traffic.w.check_per_shape
        self._heaps: dict[tuple[int, bool], list] = {}

    def offer(self, k: int, item=None) -> None:
        key = (k % self.t.S, self.t.is_grad(k))
        u = self.t.priority(k)
        h = self._heaps.setdefault(key, [])
        if len(h) < self.per:
            heapq.heappush(h, (-u, k, item))
        elif -h[0][0] > u:
            heapq.heapreplace(h, (-u, k, item))

    def chosen(self) -> dict[int, object]:
        """k → item of every request in the sample, in k order."""
        return dict(sorted((k, item) for h in self._heaps.values()
                           for _, k, item in h))
