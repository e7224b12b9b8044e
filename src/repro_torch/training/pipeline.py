"""Pipeline parallelism (GPipe) over a process group.

Layers are split into ``n_stages`` contiguous stages; stage s is group
rank s.  Microbatches flow through a ring of ``ppermute`` calls: at
schedule tick t, stage s processes microbatch t - s (the classic GPipe
schedule with (n_stages - 1) bubble ticks on each side).

The port's copy of the JAX package's ``training/pipeline.py``, forward
only (JAX has no caller that takes its gradient), with its schedule kept
tick for tick: every stage runs ``stage_fn`` on each of the
``n_micro + n - 1`` ticks and masks its inactive ticks to zeros, stage 0
feeds microbatch ``clip(t)``, the carry goes round the whole ring, and a
final all-reduce gives every rank the last stage's outputs.  No train
step calls it, in either package (``ParallelConfig`` refuses
``pipeline_stages > 1``).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.sharding import collectives as C


def pipeline_body(stage_params, x_micro: torch.Tensor, *,
                  stage_fn: Callable, group) -> torch.Tensor:
    """This rank's part of the pipelined forward.  stage_params: this
    stage's params; x_micro: (n_micro, mb, ...) full input (only stage 0
    reads it).  Returns (n_micro, mb, ...) outputs, valid on every rank
    after the trailing all-reduce."""
    n = C.group_size(group)
    idx = dist.get_rank(group) if n > 1 else 0
    n_micro = x_micro.shape[0]
    mb_shape = x_micro.shape[1:]

    carry = torch.zeros(mb_shape, dtype=x_micro.dtype, device=x_micro.device)
    out = torch.zeros_like(x_micro)
    perm = [(i, (i + 1) % n) for i in range(n)]

    for t in range(n_micro + n - 1):
        mb_idx = t - idx
        feed = x_micro[min(max(t, 0), n_micro - 1)]
        inp = feed if idx == 0 else carry
        active = 0 <= mb_idx < n_micro
        y = stage_fn(stage_params, inp)
        if not active:
            y = torch.zeros_like(y)
        # last stage banks its finished microbatch
        bank = y if idx == n - 1 and active else torch.zeros_like(y)
        out[min(max(mb_idx, 0), n_micro - 1)] = bank
        carry = C.ppermute(y, perm, group)
    # everyone gets the last stage's outputs
    return C.all_reduce(out if idx == n - 1 else torch.zeros_like(out),
                        group)


def make_pipeline(stage_fn: Callable, *, group) -> Callable:
    """A pipelined forward ``fn(stage_params, x_micro)`` over ``group``.

    ``stage_fn(stage_params, x)`` applies ONE stage's layers.  Where JAX
    passes params with a leading stage dimension sharded over the stage
    axis and slices each device's ``[0]``, here each rank passes its own
    stage's params."""
    def run(stage_params, x_micro):
        return pipeline_body(stage_params, x_micro, stage_fn=stage_fn,
                             group=group)
    return run


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
