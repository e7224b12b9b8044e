"""Plain PyTorch versions for the decode kernels.

``decode_reference`` is the dense decode in f32 (masked softmax) over a
"bhsd" or "bshd" cache, or a slice of one from global position
``kv_start`` on (and, asked for it, the rows' log-sum-exp), the function
``csrc/flash_decode.cu`` computes;
``paged_gather`` materialises the dense (B, Hkv, S, D) view of a paged
pool and ``paged_decode_reference`` chains it with ``decode_reference``,
the function ``csrc/paged_decode.cu`` computes.  The CPU tests hold these
to the JAX package's ``flash_decode_fwd`` / ``paged_flash_decode_fwd``;
on the card the kernels are held to them.

One deliberate difference from the JAX oracle: a query row with no valid
key returns 0 here (as the CUDA kernels do), where the JAX oracle averages
the masked values.  Serving never reads such a row.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def paged_gather(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """pages: (Hkv, P, page_size, D); page_table: (B, n_kv) int32.

    Returns the dense per-sequence view (B, Hkv, n_kv * page_size, D).
    """
    g = pages[:, page_table.long()]            # (Hkv, B, n_kv, ps, D)
    hkv, b, n_kv, ps, d = g.shape
    return g.permute(1, 0, 2, 3, 4).reshape(b, hkv, n_kv * ps, d)


def softcap_logits(s: torch.Tensor, softcap: Optional[float]
                   ) -> torch.Tensor:
    if softcap is None:
        return s
    return softcap * torch.tanh(s / softcap)


def decode_reference(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None,
                     layout: str, kv_start: int = 0,
                     return_lse: bool = False):
    """Single-token decode attention in f32.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D) ["bhsd"] or (B, S, Hkv, D)
    ["bshd"], read in place through the einsum (no transposed copy),
    their row 0 at global position ``kv_start``; kv_len: (B,) current
    global lengths (the new token's position is kv_len - 1).  Returns
    (B, Hq, 1, D) in q's dtype; with ``return_lse`` it returns it in
    float32 (a cross-rank merge reads the partial unrounded) and also
    the rows' log-sum-exp (B, Hq, 1) float32 of their scaled (and
    softcapped) scores: NEG_INF where the slice holds no valid key (its
    output 0), so that the merge weighs it at zero.
    """
    b, hq, _, d = q.shape
    if layout == "bhsd":
        hkv, s = k_cache.shape[1], k_cache.shape[2]
    elif layout == "bshd":
        s, hkv = k_cache.shape[1], k_cache.shape[2]
    else:
        raise ValueError(f"unknown cache layout {layout!r}")
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.float().reshape(b, hkv, g, d)
    logits = torch.einsum(f"bhgd,{layout}->bhgs", qg,
                          k_cache.float()) * scale
    logits = softcap_logits(logits, softcap)
    pos = kv_start + torch.arange(s, device=q.device)[None, None, None, :]
    lens = kv_len.to(q.device).long().reshape(b, 1, 1, 1)
    mask = pos < lens
    if window is not None:
        mask = mask & (pos >= lens - window)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum(f"bhgs,{layout}->bhgd", p, v_cache.float())
    l_safe = torch.where(l == 0, 1.0, l)
    out = (out / l_safe).reshape(b, hq, 1, d)
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.where(l == 0, NEG_INF, m + torch.log(l_safe))
    return out, lse.reshape(b, hq, 1)


def paged_decode_reference(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, 1, D) against paged pools.  Returns (B, Hq, 1, D)."""
    k = paged_gather(k_pages, page_table)
    v = paged_gather(v_pages, page_table)
    return decode_reference(q, k, v, kv_len, window=window, softcap=softcap,
                            scale=scale, layout="bhsd")
