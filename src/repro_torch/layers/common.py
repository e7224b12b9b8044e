"""Parameter initialisation, the dense projection and logical axes.

Parameters are nested dicts of tensors.  ``dense_init`` draws the same
distribution as the JAX package's ``layers/common.py`` (a float32 normal
scaled by ``in_dim ** -0.5``, cast to the parameter dtype) from an explicit
``torch.Generator``; the numbers differ, the distribution does not.
With no generator (``gen=None``) an init draws nothing: every leaf is an
empty tensor of its shape and dtype on the meta device (``normal``), the
counterpart of JAX's ``jax.eval_shape(model.init, key)``.  Each
layer also describes its parameters by *logical axes* in a parallel tree
(same structure, leaves ``(logical_axes_tuple, shape)``) that
``sharding/rules.py`` reads.
"""
from __future__ import annotations

from typing import Optional

import torch


def device_of(gen: Optional[torch.Generator]) -> torch.device:
    """Where an init from ``gen`` puts its leaves: ``gen``'s device, or
    the meta device for ``gen=None``."""
    return torch.device("meta") if gen is None else gen.device


def normal(gen: Optional[torch.Generator], shape: tuple) -> torch.Tensor:
    """float32 N(0, 1) draws of ``shape`` from ``gen`` on its device; for
    ``gen=None`` an empty float32 tensor on the meta device (nothing
    drawn)."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: Optional[torch.Generator], in_dim: int, out_dim: int,
               dtype: torch.dtype, scale: Optional[float] = None
               ) -> torch.Tensor:
    """An (in_dim, out_dim) weight used as ``x @ w``, on ``gen``'s device
    (``device_of``)."""
    scale = scale if scale is not None else in_dim ** -0.5
    return (normal(gen, (in_dim, out_dim)) * scale).to(dtype)


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
