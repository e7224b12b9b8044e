"""Flash decode: the wrappers of ``csrc/flash_decode.cu`` (dense caches)
and ``csrc/paged_decode.cu`` (paged pools).

For CUDA tensors ``flash_decode`` and ``paged_flash_decode`` launch their
CUDA kernel (built at first use, see ``kernels/build.py``) or raise; for
CPU tensors they run the plain PyTorch version in ``ref.py``.
``<wrapper>.launches`` counts kernel launches (plain-version calls are not
counted).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _launch as L
from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import (decode_reference,
                                                  paged_decode_reference)

LAYOUTS = ("bshd", "bhsd")

_ARGTYPES = (L.P, L.P, L.P, L.P, L.P, L.P,        # q k v table kv_len out
             L.I, L.I, L.I, L.I, L.I, L.I, L.I,   # B hq hkv P ps d n_kv
             L.I, L.F, L.F, L.I, L.P)             # window softcap scale dt s
_DENSE_ARGTYPES = (L.P, L.P, L.P, L.P, L.P,     # q k v kv_len out
                   L.I, L.I, L.I, L.I, L.I,     # B hq hkv s_max d
                   L.L, L.L, L.L,               # stride b, s, h
                   L.I, L.F, L.F, L.I, L.P)     # window cap scale dt s


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None,
                 layout: str) -> torch.Tensor:
    """Decode attention: q (B, Hq, D) against dense caches (B, Hkv, S, D)
    ["bhsd"] or (B, S, Hkv, D) ["bshd"]; kv_len (B,) int32.  Returns
    (B, Hq, D).

    The kernel reads either layout in place through the caches' strides
    (batch, token, head); their head dim must be contiguous.  The JAX
    kernel's ``block_kv`` has no counterpart: the CUDA kernel walks the
    valid key range with its own tiling (4 keys per thread group in
    flight, ``csrc/flash_decode.cu``)."""
    if layout not in LAYOUTS:
        raise ValueError(f"flash_decode: unknown cache layout {layout!r}")
    b, hq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return decode_reference(
            q[:, :, None], k_cache, v_cache, kv_len, window=window,
            softcap=softcap, scale=scale, layout=layout)[:, :, 0]
    code = L.check_tensors("flash_decode", {"q": q}, {"kv_len": kv_len})
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        L.check_strided(name, t, q)
    if layout == "bhsd":
        cb, hkv, s_max, dk = k_cache.shape
        sb, sh, ss, _ = k_cache.stride()
    else:
        cb, s_max, hkv, dk = k_cache.shape
        sb, ss, sh, _ = k_cache.stride()
    if (cb != b or dk != d or v_cache.shape != k_cache.shape
            or v_cache.stride() != k_cache.stride() or hkv == 0
            or hq % hkv or kv_len.shape != (b,) or d not in L.HEAD_DIMS):
        raise ValueError(
            f"flash_decode: bad shapes q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)} with strides "
            f"{k_cache.stride()}/{v_cache.stride()} ({layout}), kv_len "
            f"{tuple(kv_len.shape)} (head_dim must be one of "
            f"{L.HEAD_DIMS})")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = build.library("flash_decode", _DENSE_ARGTYPES)
    status = lib.flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), b, hq, hkv, s_max, d, sb, ss, sh,
        L.opt_int(window), L.opt_float(softcap), float(scale), code,
        L.stream_ptr(q.device))
    L.check_status("flash_decode", status)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       kv_len: torch.Tensor, *,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over a paged cache: q (B, Hq, D), pages
    (Hkv, P, page_size, D), page_table (B, n_kv) int32, kv_len (B,) int32.
    Returns (B, Hq, D)."""
    b, hq, d = q.shape
    hkv, num_pages, page_size, dk = k_pages.shape
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return paged_decode_reference(
            q[:, :, None], k_pages, v_pages, page_table, kv_len,
            window=window, softcap=softcap, scale=scale)[:, :, 0]
    code = L.check_tensors(
        "paged_flash_decode", {"q": q, "k_pages": k_pages,
                               "v_pages": v_pages},
        {"page_table": page_table, "kv_len": kv_len})
    n_kv = page_table.shape[1]
    if (dk != d or v_pages.shape != k_pages.shape or hq % hkv
            or page_table.shape[0] != b or kv_len.shape != (b,)
            or d not in L.HEAD_DIMS):
        raise ValueError(
            f"paged_flash_decode: bad shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, table "
            f"{tuple(page_table.shape)}, kv_len {tuple(kv_len.shape)} "
            f"(head_dim must be one of {L.HEAD_DIMS})")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = build.library("paged_decode", _ARGTYPES)
    status = lib.paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        b, hq, hkv, num_pages, page_size, d, n_kv, L.opt_int(window),
        L.opt_float(softcap), float(scale), code, L.stream_ptr(q.device))
    L.check_status("paged_flash_decode", status)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
