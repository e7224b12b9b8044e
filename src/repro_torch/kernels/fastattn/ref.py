"""Plain PyTorch versions for the paged prefill kernel.

``flash_reference_with_lse`` is the chunked online-softmax attention of the
JAX package's ``kernels/fastattn/ref.py`` (same masks, same block walk,
f32 throughout); ``paged_prefill_reference`` gathers the owned pages and
runs it with runtime per-sequence query offsets -- the function
``csrc/paged_prefill.cu`` computes.

As in ``flash_decode/ref.py``, a query row with no valid key returns 0
(the JAX oracle averages the masked values there); its lse is NEG_INF.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels.flash_decode.ref import (NEG_INF, paged_gather,
                                                  softcap_logits)


def flash_reference_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None,
                             q_offset: Union[int, torch.Tensor] = 0,
                             kv_len: Optional[torch.Tensor] = None,
                             block_kv: int = 512):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D).  Returns (out, lse).

    ``q_offset`` is a static int or a (B,) tensor of per-sequence global
    positions of query row 0; ``kv_len`` masks keys at or past it.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    qf = q.float().reshape(b, hkv, g, sq, d)

    block_kv = min(block_kv, skv)
    n_chunks = (skv + block_kv - 1) // block_kv
    if causal and isinstance(q_offset, int):
        # static skip: chunks wholly in the future of the last query row
        n_chunks = min(n_chunks, (q_offset + sq - 1) // block_kv + 1)

    offs = torch.as_tensor(q_offset, device=dev).long().reshape(-1, 1)
    q_pos = offs + torch.arange(sq, device=dev)                 # (B|1, Sq)
    eff = torch.as_tensor(skv if kv_len is None else kv_len, device=dev)
    eff = torch.clamp(eff.long(), max=skv).reshape(-1, 1, 1)      # (B|1,1,1)

    m = torch.full((b, hkv, g, sq), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, g, sq), device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), device=dev)
    for j in range(n_chunks):
        lo, hi = j * block_kv, min((j + 1) * block_kv, skv)
        k_j = k[:, :, lo:hi].float()
        v_j = v[:, :, lo:hi].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k_j) * scale
        s = softcap_logits(s, softcap)
        kv_pos = torch.arange(lo, hi, device=dev)
        mask = kv_pos[None, None, :] < eff                      # (B|1,1,K)
        if causal:
            mask = mask & (q_pos[:, :, None] >= kv_pos[None, None, :])
        if window is not None:
            mask = mask & (q_pos[:, :, None] - kv_pos[None, None, :]
                           < window)
        mask = mask[:, None, None]                              # (B,1,1,Sq,K)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd",
                                                    p, v_j)
        m = m_new
    l_safe = torch.where(l == 0, 1.0, l)
    out = (acc / l_safe[..., None]).reshape(b, hq, sq, d).to(q.dtype)
    lse = (m + torch.log(l_safe)).reshape(b, hq, sq)
    return out, lse


def paged_prefill_reference(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_table: torch.Tensor,
                            pos_start: torch.Tensor, kv_len: torch.Tensor, *,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None,
                            block_kv: int = 512) -> torch.Tensor:
    """Chunked-prefill attention over paged pools.

    q: (B, Hq, Sq, D) chunk queries; pages (Hkv, P, page_size, D);
    page_table (B, n_kv) int32; pos_start: (B,) int32 global position of
    each sequence's chunk start; kv_len: (B,) int32 valid KV length.
    Returns (B, Hq, Sq, D); rows past the valid chunk length are garbage
    (finite) and must be ignored by the caller.
    """
    k = paged_gather(k_pages, page_table)
    v = paged_gather(v_pages, page_table)
    out, _ = flash_reference_with_lse(
        q, k, v, causal=True, window=window, softcap=softcap, scale=scale,
        q_offset=pos_start, kv_len=kv_len, block_kv=block_kv)
    return out
