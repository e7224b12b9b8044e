"""Collectives of the sharded trainer over a ``launch.mesh.Mesh``, and the
autograd function the layout needs.

``gather`` is all-gather along one dimension in the forward and
reduce-scatter (sum) in the backward, so a tensor gathered before use
gets back, as its gradient, this rank's piece of the sum of every rank's
gradient of the whole.  The model gathers its sharded weights before a
block (``models/lm.py``), K/V along the sequence in context-parallel
attention (``layers/attention.py``) and a MoE block's input under
expert parallelism (``models/blocks.py``) through it.  ``scatter`` is
its transpose: reduce-scatter forward, all-gather backward (the expert
shards' partial outputs summed back to each rank's rows).

gloo runs ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` on
CPU tensors (``tests/test_torch_dist_train.py``) and on CUDA tensors
(``chip_smoke.py`` phase 4b), NCCL on CUDA tensors; a backend that does
not raises.

``COUNTS`` tallies the collectives issued here and the bytes of their
inputs.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import entry_axes

COUNTS = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0,
          "bytes": 0}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _count(op: str, t: torch.Tensor) -> None:
    COUNTS[op] += 1
    COUNTS["bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no-op for a group of one)."""
    if group_size(group) > 1:
        _count("all_reduce", t)
        dist.all_reduce(t, group=group)
    return t


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    _count("all_gather", xs)
    out = torch.empty((n * xs.shape[0],) + xs.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of the ranks' ``x``, cut along ``dim`` into group-size
    pieces: this rank's piece (in group-rank order)."""
    n = group_size(group)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"reduce_scatter: dimension {dim} of "
                         f"{tuple(x.shape)} does not split {n} ways")
    _count("reduce_scatter", xs)
    out = torch.empty((xs.shape[0] // n,) + xs.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` with reduce-scatter as its gradient (the
    identity for a group of one)."""
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, dim, group)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


def scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Reduce-scatter (sum) along ``dim`` with all-gather as its gradient
    (the identity for a group of one): each rank's piece of the ranks'
    summed partials, whose gradient is every rank's gradient of its
    piece, gathered."""
    if group_size(group) == 1:
        return x
    return _Scatter.apply(x, dim, group)


def gather_leaf(x: torch.Tensor, spec: tuple, mesh,
                differentiable: bool = True) -> torch.Tensor:
    """The whole of a leaf this rank holds a piece of under ``spec``."""
    fn = gather if differentiable else all_gather_dim
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axes:
            x = fn(x, dim, mesh.group(axes))
    return x


def gather_tree(tree, specs, mesh, differentiable: bool = True):
    """``gather_leaf`` over a tree of dicts and lists of tensors and its
    spec tree (``sharding.rules.param_sharding_tree``)."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], mesh, differentiable)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_tree(v, s, mesh, differentiable)
                for v, s in zip(tree, specs, strict=True)]
    return gather_leaf(tree, specs, mesh, differentiable)
