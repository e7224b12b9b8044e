"""Parameter initialisation, the dense projection and logical axes.

Parameters are nested dicts of tensors.  ``dense_init`` draws the same
distribution as the JAX package's ``layers/common.py`` (a float32 normal
scaled by ``in_dim ** -0.5``, cast to the parameter dtype) from an explicit
``torch.Generator``; the numbers differ, the distribution does not.  Each
layer also describes its parameters by *logical axes* in a parallel tree
(same structure, leaves ``(logical_axes_tuple, shape)``) that
``sharding/rules.py`` reads.
"""
from __future__ import annotations

from typing import Optional

import torch


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, scale: Optional[float] = None
               ) -> torch.Tensor:
    """An (in_dim, out_dim) weight used as ``x @ w``, on ``gen``'s device."""
    scale = scale if scale is not None else in_dim ** -0.5
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    return w.to(dtype)


def dense_logical(in_dim: int, out_dim: int, logical) -> tuple:
    return (tuple(logical), (in_dim, out_dim))


def stack_logical(logical_tree):
    """Add the 'layers' logical axis to every leaf of a logical tree (the
    JAX package's layout of a scanned segment; the port keeps a list of
    layers, so only the parity tests stack)."""
    from repro_torch.sharding.rules import is_logical_leaf, map_tree

    def add(leaf):
        logical, shape = leaf
        return (("layers",) + logical, (None,) + tuple(shape))
    return map_tree(add, logical_tree, is_logical_leaf)


def dense(x: torch.Tensor, w: torch.Tensor,
          bias: Optional[torch.Tensor] = None,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dtype = dtype or x.dtype
    y = x.to(dtype) @ w.to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y
