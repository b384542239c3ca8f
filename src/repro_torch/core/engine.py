"""Plan/execute engine for every Radic determinant evaluation path.

Port of ``repro/core/engine.py``.  The paper's rank space C(n, m) factors
into independent work units; the engine factors the per-shape state
(validated rank count, Pascal table, clamped chunk) into one immutable
artifact (:class:`DetPlan`) and one router (:class:`DetEngine`) that
plans once and executes many.

A plan is keyed by everything that selects a distinct program:
``(m, n, batched, capacity, dtype, backend, chunk, kahan, device)``.
Planning performs *all* validation — ``m > n`` degeneracy, the
``C(n, m)`` integer-width guards, the kernel's bound on ``m`` — **before**
any backend dispatch.  The cache is LRU-bounded (``max_plans``); an
evicted shape re-plans and reproduces bit-identical results.

Every plan carries two executables over the same rank walk: the forward
and the cofactor-form VJP (DESIGN_GRAD.md).  Routing table:

* ``m > n`` (any backend): zeros on the plan's device; the pullback is
  zeros like the input.
* torch, scalar: ``radic._radic_det_flat`` (eager chunk walk);
  ``radic._radic_det_grad_flat`` (the walk replayed).
* torch, batched: ``radic._radic_det_batched_flat_impl``;
  ``radic._radic_det_batched_grad_flat``.
* cuda: ``kernels.ops.radic_det[_batched]_cuda``;
  ``kernels.ops.radic_det[_batched]_grad_cuda``.

``DetPlan.differentiable(A)`` is the forward as a ``torch.autograd.Function``
whose backward is the plan's ``grad_executable``; ``radic_det`` and
``radic_det_batched`` return it, so ``torch.autograd.grad`` works on every
backend.  The Function is ``once_differentiable``, like the reference's
kernel backend.

Not in this module yet: mesh plans and the durable plan store
(``persist_dir``/``prefill``).
"""

from __future__ import annotations

import functools
import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .pascal import INT32_MAX, INT64_MAX, binom_table, comb
from .radic import (_radic_det_batched_flat_impl,
                    _radic_det_batched_grad_flat, _radic_det_flat,
                    _radic_det_grad_flat, resolve_device)

__all__ = ["DetPlan", "DetEngine", "PlanKey", "default_engine",
           "set_default_engine", "stable_key_hash", "validate_rank_space",
           "rank_table", "plan_statics", "CUDA_MAX_M", "BACKENDS"]

BACKENDS = ("torch", "cuda")

# The CUDA kernel keeps each thread's m×m minor in registers and is
# compiled for m = 1..CUDA_MAX_M (kernels/csrc/radic_fused.cu).
CUDA_MAX_M = 16


def dtype_name(dtype) -> str:
    """Canonical dtype name (``"float32"``) for numpy and torch dtypes."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


# --------------------------------------------------------- shared validation
def validate_rank_space(m: int, n: int, *, backend: str = "cuda") -> int:
    """Validate that C(n, m) fits the backend's rank-integer width and
    return it.  This runs at *plan* time, before any backend dispatch.

    * ``cuda`` — the kernel computes ranks and reads the table in int32,
      so ``C(n, m) < 2**31`` is a hard requirement (the reference's
      ``pallas`` guard); the kernel is also compiled only for
      ``m <= CUDA_MAX_M``.
    * ``torch`` — int64 ranks (the reference's ``jnp`` backend under x64).
    """
    total = comb(n, m)
    if m > n:
        return total
    if backend == "cuda":
        if total > INT32_MAX:
            raise OverflowError(
                f"C({n},{m}) = {total} exceeds int32 (the CUDA kernel "
                "computes ranks in int32); use the torch backend.")
        if m > CUDA_MAX_M:
            raise ValueError(
                f"m = {m} exceeds the CUDA kernel's bound m <= "
                f"{CUDA_MAX_M}; use the torch backend.")
    elif total > INT64_MAX:
        raise OverflowError(f"C({n},{m}) = {total} exceeds int64.")
    return total


def rank_table(n: int, m: int, *, backend: str = "cuda",
               device=None) -> torch.Tensor:
    """The Pascal table at the rank dtype the backend computes in, on
    ``device`` (default: the CPU)."""
    tdtype = np.int32 if backend == "cuda" else np.int64
    return torch.as_tensor(binom_table(n, m, dtype=tdtype),
                           device=torch.device("cpu" if device is None
                                               else device))


def plan_statics(m: int, n: int, chunk: int, *, backend: str = "torch",
                 device=None):
    """``(total, table, clamped chunk)`` — the per-shape state every eager
    program binds, in one place."""
    total = validate_rank_space(m, n, backend=backend)
    table = rank_table(n, m, backend=backend, device=device)
    return total, table, int(min(chunk, max(total, 1)))


# ------------------------------------------------------------------ plan key
class PlanKey(NamedTuple):
    """Everything that selects a distinct program.  A plain tuple: it
    pickles, hashes by value and round-trips through ``tuple(key)``.  The
    reference's ``x64`` field is gone (``dtype`` carries the precision)
    and ``device`` is new (a plan binds its table on one device)."""

    m: int
    n: int
    batched: bool
    capacity: int | None        # one batch's exact size, or None
    dtype: str
    backend: str
    chunk: int                  # as requested (clamp is derived state)
    kahan: bool
    device: str


def _canonical_key_item(v):
    """Numpy scalars repr differently from the python values they equal
    (``np.int64(3)`` vs ``3`` under numpy >= 2), so a key built from an
    array's ``.shape`` member or decoded off the wire must hash like
    the plain-python key."""
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.str_):
        return str(v)
    if isinstance(v, tuple):
        return tuple(_canonical_key_item(x) for x in v)
    return v


def stable_key_hash(key) -> int:
    """Deterministic 64-bit hash of a key tuple: blake2b of the ``repr``
    of its canonicalised items.  Builtin ``hash()`` is salted per process
    for strings; this one agrees across processes, restarts and with the
    reference's ``stable_key_hash`` for equal tuples."""
    data = repr(tuple(_canonical_key_item(v) for v in key)).encode("utf-8")
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "big")


class _PlanDet(torch.autograd.Function):
    """The plan's forward, differentiable through its cofactor-form
    backward (the reference's ``_make_differentiable``, engine.py:198).
    The forward runs the plan's executable unchanged, so values are
    bit-identical to a plain call; only the input is saved."""

    @staticmethod
    def forward(ctx, A, plan):
        ctx.plan = plan
        ctx.save_for_backward(A)
        return plan.executable(A)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        (A,) = ctx.saved_tensors
        return ctx.plan.grad_executable(A, ct), None


def _zeros_grad(A: torch.Tensor, ct) -> torch.Tensor:
    """m > n ⇒ det ≡ 0 ⇒ the pullback is identically zero."""
    del ct
    return torch.zeros_like(A)


@dataclass(frozen=True, eq=False)
class DetPlan:
    """Immutable per-shape artifact: validated statics plus the forward
    and gradient executables.  Calling the plan runs the executable on
    the plan's device; host data is moved there first.  ``eq=False``:
    plans compare by identity (the engine guarantees one plan per key)."""

    key: PlanKey
    total: int                  # C(n, m)
    chunk: int                  # clamped to the rank space
    degenerate: bool            # m > n: executable returns zeros
    table: Any = field(repr=False)          # Pascal table tensor or None
    executable: Callable = field(repr=False)
    # ``grad_executable(A, ct) -> ∂/∂A``: the cofactor-form VJP over the
    # same rank walk (DESIGN_GRAD.md)
    grad_executable: Callable = field(repr=False)

    @property
    def m(self) -> int:
        return self.key.m

    @property
    def n(self) -> int:
        return self.key.n

    @property
    def capacity(self) -> int | None:
        return self.key.capacity

    @property
    def backend(self) -> str:
        return self.key.backend

    @property
    def device(self) -> torch.device:
        return torch.device(self.key.device)

    def _on_device(self, A) -> torch.Tensor:
        if not isinstance(A, torch.Tensor):
            A = torch.as_tensor(np.asarray(A))
        return A.to(self.device)

    def __call__(self, A) -> torch.Tensor:
        return self.executable(self._on_device(A))

    def grad(self, A, ct) -> torch.Tensor:
        """Pull the cotangent(s) back through the determinant: scalar
        plans take ``A (m, n)`` and a scalar ``ct``; batched plans take
        ``As (B, m, n)`` and ``cts (B,)`` and return ``(B, m, n)``."""
        A = self._on_device(A)
        return self.grad_executable(
            A, torch.as_tensor(ct, device=self.device))

    def differentiable(self, A) -> torch.Tensor:
        """The forward as a ``torch.autograd.Function`` whose backward is
        :meth:`grad` (once differentiable)."""
        return _PlanDet.apply(self._on_device(A), self)


# -------------------------------------------------------------- the engine
class DetEngine:
    """Plan once, execute many — with an LRU-bounded plan cache.

    Thread-safe: lookups and inserts are locked; building happens outside
    the lock, and a racing duplicate build keeps the first inserted plan.
    """

    _GUARDED_BY = {
        "_plans": ("_lock",),
        "_hits": ("_lock",),
        "_misses": ("_lock",),
        "_evictions": ("_lock",),
    }

    def __init__(self, max_plans: int = 128):
        if max_plans < 1:
            raise ValueError("max_plans must be >= 1")
        self.max_plans = max_plans
        self._plans: OrderedDict[PlanKey, DetPlan] = OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    # ------------------------------------------------------------- planning
    def plan(self, m: int, n: int, *, batched: bool = True,
             capacity: int | None = None, dtype=np.float32,
             chunk: int = 2048, backend: str = "cuda",
             kahan: bool = False, device=None) -> DetPlan:
        """Return the cached plan for this configuration, building it if
        absent.  All validation happens here, before backend dispatch.
        ``device`` defaults to ``"cuda"``."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if kahan and batched:
            raise ValueError("kahan compensation is flat-mode only")
        if capacity is not None and not batched:
            raise ValueError("capacity is a batched-plan parameter")
        dev = resolve_device(device)
        key = PlanKey(
            m=int(m), n=int(n), batched=batched,
            capacity=None if capacity is None else int(capacity),
            dtype=dtype_name(dtype), backend=backend, chunk=int(chunk),
            kahan=kahan, device=str(dev))
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self._hits += 1
                return plan
        built = self._build(key)
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:  # racing build: first insert wins
                self._plans.move_to_end(key)
                self._hits += 1
                return plan
            self._misses += 1
            self._plans[key] = built
            while len(self._plans) > self.max_plans:
                self._plans.popitem(last=False)
                self._evictions += 1
        return built

    # ------------------------------------------------------------- the cache
    def cache_info(self) -> dict:
        with self._lock:
            return {"size": len(self._plans), "max_plans": self.max_plans,
                    "hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions}

    def cached_keys(self) -> list[PlanKey]:
        """LRU order, oldest first (introspection/tests)."""
        with self._lock:
            return list(self._plans)

    def clear(self):
        with self._lock:
            self._plans.clear()

    # ------------------------------------------------------------- builders
    def _build(self, key: PlanKey) -> DetPlan:
        m, n = key.m, key.n
        total = validate_rank_space(m, n, backend=key.backend)
        if m > n:
            def execute(A, _batched=key.batched):
                shape = (A.shape[0],) if _batched else ()
                return torch.zeros(shape, dtype=A.dtype, device=A.device)
            return DetPlan(key=key, total=total, chunk=0, degenerate=True,
                           table=None, executable=execute,
                           grad_executable=_zeros_grad)
        if key.backend == "cuda":
            return self._build_cuda(key, total)
        return self._build_torch(key, total)

    def _build_torch(self, key: PlanKey, total: int) -> DetPlan:
        m, n = key.m, key.n
        _, table, chunk = plan_statics(m, n, key.chunk, backend="torch",
                                       device=key.device)
        if not key.batched:
            def execute(A, _t=table, _total=total, _c=chunk, _k=key.kahan):
                return _radic_det_flat(A, _t, _total, _c, _k)

            def grad_execute(A, ct, _t=table, _total=total, _c=chunk):
                return _radic_det_grad_flat(A, ct, _t, _total, _c)
        else:
            def check(As, _m=m, _n=n):
                if As.ndim != 3 or tuple(As.shape[1:]) != (_m, _n):
                    raise ValueError(
                        f"expected (B, {_m}, {_n}), got {tuple(As.shape)}")

            def execute(As, _t=table, _total=total, _c=chunk):
                check(As)
                if As.shape[0] == 0:
                    return torch.zeros((0,), dtype=As.dtype,
                                       device=As.device)
                return _radic_det_batched_flat_impl(As, _t, _total, _c)

            def grad_execute(As, cts, _t=table, _total=total, _c=chunk):
                check(As)
                return _radic_det_batched_grad_flat(As, cts, _t, _total, _c)
        return DetPlan(key=key, total=total, chunk=chunk, degenerate=False,
                       table=table, executable=execute,
                       grad_executable=grad_execute)

    def _build_cuda(self, key: PlanKey, total: int) -> DetPlan:
        from repro_torch.kernels import ops  # lazy: kernels depend on core
        table = rank_table(key.n, key.m, backend="cuda", device=key.device)
        fn, gfn = ((ops.radic_det_batched_cuda, ops.radic_det_batched_grad_cuda)
                   if key.batched
                   else (ops.radic_det_cuda, ops.radic_det_grad_cuda))
        execute = functools.partial(fn, q_start=0, count=total, table=table)
        grad_execute = functools.partial(gfn, q_start=0, count=total,
                                         table=table)
        return DetPlan(key=key, total=total,
                       chunk=int(min(key.chunk, max(total, 1))),
                       degenerate=False, table=table, executable=execute,
                       grad_executable=grad_execute)


# ------------------------------------------------------------ default engine
_default_engine: DetEngine | None = None
_default_lock = threading.Lock()


def default_engine() -> DetEngine:
    """The process-wide engine behind ``radic_det``/``radic_det_batched``."""
    global _default_engine
    with _default_lock:
        if _default_engine is None:
            _default_engine = DetEngine()
        return _default_engine


def set_default_engine(engine: DetEngine | None) -> None:
    """Swap (or with ``None``, reset) the process-wide engine."""
    global _default_engine
    with _default_lock:
        _default_engine = engine
