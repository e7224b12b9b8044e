"""Public attention API used by the model layers.

Model layers use (B, S, H, D) activations; kernels use (B, H, S, D).
This facade handles the transposition and the implementation choice.

Dense attention (training, full forward), ``fast_attention``:

* ``impl="kernel"`` (alias ``"pallas"``, the JAX package's name) runs the
  CUDA kernel ``fastattn_fwd`` with the plain recompute as its backward
  (its wrapper takes the plain PyTorch version only for CPU tensors);
* ``impl="reference"`` runs the plain PyTorch version;
* ``impl=None`` or ``"auto"`` means "kernel" for CUDA tensors and
  "reference" for CPU tensors.

Paged attention (serving), ``fast_attention_prefill_paged`` and
``fast_attention_decode`` with a ``page_table``:

* ``impl="paged"`` runs the CUDA kernel (its wrapper takes the plain
  PyTorch version only for CPU tensors);
* ``impl="paged_reference"`` runs the plain PyTorch version;
* ``impl=None`` means "paged" for CUDA tensors and "paged_reference" for
  CPU tensors.

Dense-cache decode, ``fast_attention_decode`` without a ``page_table``:

* ``impl="kernel"`` (alias ``"pallas"``) runs the CUDA kernel
  ``flash_decode`` on the cache in place, either layout;
* ``impl="reference"`` runs the JAX facade's einsum branch;
* ``impl=None`` or ``"auto"`` means "kernel" for CUDA tensors and
  "reference" for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

PAGED_IMPLS = ("paged", "paged_reference")


def fast_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   softcap: Optional[float] = None,
                   scale: Optional[float] = None, q_offset: int = 0,
                   kv_valid: Optional[int] = None,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Attention over (B, S, H, D) tensors, differentiable.  Returns
    (B, Sq, Hq, D).  ``kv_valid`` masks K/V rows past that length."""
    from repro_torch.kernels.fastattn.ops import fastattn
    qT, kT, vT = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = fastattn(qT, kT, vT, causal=causal, window=window,
                   softcap=softcap, scale=scale, q_offset=q_offset,
                   kv_valid=kv_valid, impl=impl)
    return out.transpose(1, 2)


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


def fast_attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          impl: Optional[str] = None,
                          layout: str = "bshd",
                          page_table: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Single-token decode attention.

    q: (B, 1, Hq, D); caches (B, S, Hkv, D) ["bshd"] or (B, Hkv, S, D)
    ["bhsd"]; kv_len (B,).  Returns (B, 1, Hq, D).

    With a ``page_table`` (B, n_kv) int32 the caches are instead global
    page pools (Hkv, P, page_size, D) shared by every sequence, and the
    table maps each sequence's logical KV block to its physical page
    (``serving/paged_cache`` owns it); ``impl`` is then a paged one, and
    otherwise one of ``fast_attention``'s.  The JAX facade's ``block_kv``
    (its kernel's tile) has no counterpart here: the CUDA kernel tiles on
    its own.
    """
    if page_table is not None:
        impl = _resolve(impl, q, "decode")
        if impl == "paged_reference":
            from repro_torch.kernels.flash_decode.ref import \
                paged_decode_reference
            out = paged_decode_reference(
                q.transpose(1, 2), k_cache, v_cache, page_table, kv_len,
                window=window, softcap=softcap, scale=scale)
            return out.transpose(1, 2)
        from repro_torch.kernels.flash_decode.ops import paged_flash_decode
        out = paged_flash_decode(
            q[:, 0].contiguous(), k_cache, v_cache, page_table, kv_len,
            window=window, softcap=softcap, scale=scale)
        return out[:, None]

    from repro_torch.kernels._launch import resolve_impl
    if resolve_impl(impl, q, "fastattn") == "kernel":
        from repro_torch.kernels.flash_decode.ops import flash_decode
        out = flash_decode(q[:, 0].contiguous(), k_cache, v_cache, kv_len,
                           window=window, softcap=softcap, scale=scale,
                           layout=layout)
        return out[:, None]

    # the JAX facade's reference branch: the cache is read in place (no
    # transpose, no GQA expansion); logits and PV accumulate in f32 and
    # the normalised P is rounded to the cache dtype before PV
    b, _, hq, d = q.shape
    if layout == "bhsd":
        hkv, s = k_cache.shape[1], k_cache.shape[2]
    else:
        s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, d).float()
    kv_eq = "bhsd" if layout == "bhsd" else "bshd"
    logits = torch.einsum(f"bhgd,{kv_eq}->bhgs", qg,
                          k_cache.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)[None, None, None, :]
    lens = kv_len.to(q.device).long().reshape(b, 1, 1, 1)
    mask = pos < lens
    if window is not None:
        mask = mask & (pos >= lens - window)
    logits = torch.where(mask, logits, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    p = (p / torch.where(l == 0, 1.0, l)).to(k_cache.dtype)
    out = torch.einsum(f"bhgs,{kv_eq}->bhgd", p.float(), v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)
