"""Paged flash decode: the wrapper of ``csrc/paged_decode.cu``.

For CUDA tensors ``paged_flash_decode`` launches the CUDA kernel (built at
first use, see ``kernels/build.py``) or raises; for CPU tensors it runs
the plain PyTorch version in ``ref.py``.  ``paged_flash_decode.launches``
counts kernel launches (plain-version calls are not counted).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _launch as L
from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import paged_decode_reference

_ARGTYPES = (L.P, L.P, L.P, L.P, L.P, L.P,        # q k v table kv_len out
             L.I, L.I, L.I, L.I, L.I, L.I, L.I,   # B hq hkv P ps d n_kv
             L.I, L.F, L.F, L.I, L.P)             # window softcap scale dt s


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
