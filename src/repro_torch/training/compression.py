"""Gradient compression for a data-parallel all-reduce (int8 + error
feedback).

The port's copy of the JAX package's ``training/compression.py``: each
call quantizes (grad + residual) to int8 with one scale a tensor, sums the
payload over the group and keeps the quantization error as the next
call's residual.  As in JAX, the payload is summed as int32 -- four bytes
an element, the bytes of an f32 all-reduce, not a quarter of them -- and
every rank's int8 values are scaled by the mean of the ranks' scales.
No train step calls it, in either package (``ParallelConfig`` refuses
``grad_compression="int8_ef"``).
"""
from __future__ import annotations

import torch

from repro_torch.sharding import collectives as C
from repro_torch.training import tree


def quantize_int8(x: torch.Tensor):
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def residual(v: torch.Tensor, q: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """v - dequantize_int8(q, scale), rounded once: JAX's jitted
    ``compressed_psum`` contracts the product and the difference into one
    fused multiply-add on the CPU.  The difference is exact in float64
    (``q * scale`` has at most 31 significant bits and lies within
    ``scale / 2`` of ``v``), so rounding it to f32 gives that value."""
    return torch.addcmul(v.double(), q.double(), scale.double(),
                         value=-1).float()


def init_residuals(grads):
    return tree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads)


def compressed_psum(grads, residuals, group):
    """Error-feedback int8 all-reduce of this rank's ``grads`` (a tree)
    over ``group`` (a process group; None: this rank alone), with the
    residuals of the last call.  Both sums go through
    ``sharding.collectives.all_reduce``, so its ``COUNTS`` holds their
    bytes.

    Returns (reduced grads in f32, new residuals): the mean over the
    group of the int8 payloads, scaled by the mean scale."""
    n = C.group_size(group)

    def one(g, r):
        v = g.float() + r
        q, scale = quantize_int8(v)
        new_r = residual(v, q, scale)
        # sum int32 payloads; scales are tiny, reduce separately
        qsum = C.all_reduce(q.to(torch.int32), group)
        ssum = C.all_reduce(scale.reshape(1).clone(), group)[0] / n
        return qsum.float() * ssum / n, new_r

    out = [one(g, r) for g, r in zip(tree.leaves(grads),
                                     tree.leaves(residuals), strict=True)]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(residuals, [o[1] for o in out]))
