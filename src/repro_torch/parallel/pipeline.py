"""GPipe-style pipeline parallelism over a mesh axis.

Port of ``repro/parallel/pipeline.py``.  Layer-stacked params are split
into S contiguous stages; the batch is cut into M microbatches; at
schedule step t stage s computes microbatch t−s (when 0 ≤ t−s < M) and
passes its activation to stage s+1 — the classic (S+M−1)-step GPipe
fill/drain diagram with bubble fraction (S−1)/(S+M−1).

The reference runs the schedule under ``shard_map`` with a ``ppermute``
ring; the port runs the same schedule from one controller over a
:class:`~repro_torch.core.distributed.Mesh`: stage s's params and work
live on the mesh's device at position s of the stage axis (index 0 on
every other axis, over which the reference replicates), an activation
moves to the next stage's device with ``.to()``, and the last stage's
outputs are gathered in microbatch order on the mesh's first device
(the reference ``psum``\\ s them with zeros from the other stages; no
float is reduced across stages here).  It is plain autograd, so
:func:`pipeline_apply` is differentiable, as the reference's is.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

__all__ = ["gpipe_schedule", "pipeline_apply", "bubble_fraction"]


def gpipe_schedule(n_stages: int, n_micro: int):
    """[(step, stage, microbatch)] for the fill/drain schedule."""
    out = []
    for t in range(n_stages + n_micro - 1):
        for s in range(n_stages):
            m = t - s
            if 0 <= m < n_micro:
                out.append((t, s, m))
    return out


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_stages + n_micro - 1)


def stage_devices(mesh, stage_axis: str) -> list[torch.device]:
    """The device of each stage: position s of ``stage_axis``, index 0 on
    every other axis of the mesh."""
    ax = mesh.axis_names.index(stage_axis)
    index = [0] * len(mesh.axis_names)
    out = []
    for s in range(mesh.shape[stage_axis]):
        index[ax] = s
        out.append(mesh.devices[tuple(index)])
    return out


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, stage_axis: str, n_micro: int) -> torch.Tensor:
    """Run ``y = stage_{S-1}(...stage_0(x))`` pipelined over ``stage_axis``.

    ``stage_params``: pytree whose leaves have a leading stage dim S.
    ``x``: (n_micro, micro_batch, ...) microbatched input.  Returns the
    final-stage output for every microbatch, stacked in microbatch order
    on the mesh's first device.
    """
    S = mesh.shape[stage_axis]
    assert x.shape[0] == n_micro
    devs = stage_devices(mesh, stage_axis)
    params = [pytree.tree_map(lambda q, s=s: q[s].to(devs[s]), stage_params)
              for s in range(S)]
    buf: list[torch.Tensor | None] = [None] * S  # activation entering s
    outs: list[torch.Tensor | None] = [None] * n_micro
    for t in range(S + n_micro - 1):
        ys = {}
        for s in range(S):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            # stage 0 injects its own microbatch from the input stream
            h = x[m].to(devs[0]) if s == 0 else buf[s]
            ys[s] = stage_fn(params[s], h)
        # pass activations down the pipe (stage s -> s+1), in stage order;
        # the last stage records its finished microbatch
        for s, y in ys.items():
            if s == S - 1:
                outs[t - s] = y.to(mesh.first_device)
            else:
                buf[s + 1] = y.to(devs[s + 1])
    return torch.stack(outs)
