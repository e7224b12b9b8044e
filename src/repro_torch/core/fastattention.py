"""Public paged-attention API used by the model layers.

Model layers use (B, S, H, D) activations; kernels use (B, H, S, D).
This facade handles the transposition and the implementation choice:

* ``impl="paged"`` runs the CUDA kernel (its wrapper takes the plain
  PyTorch version only for CPU tensors);
* ``impl="paged_reference"`` runs the plain PyTorch version;
* ``impl=None`` means "paged" for CUDA tensors and "paged_reference" for
  CPU tensors.

Only the paged paths of the JAX facade are ported in this slice.
"""
from __future__ import annotations

from typing import Optional

import torch

PAGED_IMPLS = ("paged", "paged_reference")


def default_paged_impl(x: torch.Tensor) -> str:
    return "paged" if x.is_cuda else "paged_reference"


def _resolve(impl: Optional[str], x: torch.Tensor, what: str) -> str:
    impl = impl or default_paged_impl(x)
    if impl not in PAGED_IMPLS:
        raise ValueError(f"unknown paged {what} impl {impl!r}")
    return impl


def fast_attention_prefill_paged(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor,
                                 pos_start: torch.Tensor,
                                 kv_len: torch.Tensor, *,
                                 window: Optional[int] = None,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None,
                                 impl: Optional[str] = None) -> torch.Tensor:
    """Chunked-prefill attention of one prompt chunk against the paged
    KV pools (the chunk's own K/V rows must already be scattered in).

    q: (B, Sq, Hq, D) layer-layout chunk queries; pages
    (Hkv, P, page_size, D); page_table (B, n_kv) int32; pos_start /
    kv_len: (B,) int32 runtime offsets.  Returns (B, Sq, Hq, D).
    """
    impl = _resolve(impl, q, "prefill")
    qT = q.transpose(1, 2).contiguous()
    if impl == "paged_reference":
        from repro_torch.kernels.fastattn.ref import paged_prefill_reference
        out = paged_prefill_reference(
            qT, k_pages, v_pages, page_table, pos_start, kv_len,
            window=window, softcap=softcap, scale=scale)
    else:
        from repro_torch.kernels.fastattn.ops import fastattn_paged_prefill
        out = fastattn_paged_prefill(
            qT, k_pages, v_pages, page_table, pos_start, kv_len,
            window=window, softcap=softcap, scale=scale)
    return out.transpose(1, 2)


def fast_attention_decode(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, kv_len: torch.Tensor, *,
                          page_table: torch.Tensor,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          impl: Optional[str] = None) -> torch.Tensor:
    """Single-token decode attention against global page pools.

    q: (B, 1, Hq, D); pools (Hkv, P, page_size, D) shared by every
    sequence; ``page_table`` (B, n_kv) int32 maps each sequence's logical
    KV block to its physical page; kv_len (B,).  Returns (B, 1, Hq, D).
    """
    impl = _resolve(impl, q, "decode")
    if impl == "paged_reference":
        from repro_torch.kernels.flash_decode.ref import \
            paged_decode_reference
        out = paged_decode_reference(
            q.transpose(1, 2), k_pages, v_pages, page_table, kv_len,
            window=window, softcap=softcap, scale=scale)
        return out.transpose(1, 2)
    from repro_torch.kernels.flash_decode.ops import paged_flash_decode
    out = paged_flash_decode(
        q[:, 0].contiguous(), k_pages, v_pages, page_table, kv_len,
        window=window, softcap=softcap, scale=scale)
    return out[:, None]
