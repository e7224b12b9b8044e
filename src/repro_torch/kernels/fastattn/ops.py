"""Paged chunked prefill: the wrapper of ``csrc/paged_prefill.cu``.

For CUDA tensors ``fastattn_paged_prefill`` launches the CUDA kernel
(built at first use, see ``kernels/build.py``) or raises; for CPU tensors
it runs the plain PyTorch version in ``ref.py``.
``fastattn_paged_prefill.launches`` counts kernel launches (plain-version
calls are not counted).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _launch as L
from repro_torch.kernels import build
from repro_torch.kernels.fastattn.ref import paged_prefill_reference

_ARGTYPES = (L.P, L.P, L.P, L.P, L.P, L.P, L.P,   # q k v table start len out
             L.I, L.I, L.I, L.I, L.I, L.I, L.I,   # B hq sq hkv P ps d
             L.I, L.I, L.F, L.F, L.I, L.P)        # n_kv win cap scale dt s


def fastattn_paged_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos_start: torch.Tensor, kv_len: torch.Tensor, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill attention against the paged KV pools.

    q: (B, Hq, Sq, D); pages (Hkv, P, page_size, D); page_table (B, n_kv),
    pos_start (B,), kv_len (B,) int32.  The chunk's own K/V rows must
    already be in the pools.  Returns (B, Hq, Sq, D); rows past a
    sequence's valid chunk length are garbage, rows with no valid key
    (kv_len = 0) are 0.
    """
    b, hq, sq, d = q.shape
    hkv, num_pages, page_size, dk = k_pages.shape
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return paged_prefill_reference(
            q, k_pages, v_pages, page_table, pos_start, kv_len,
            window=window, softcap=softcap, scale=scale)
    code = L.check_tensors(
        "fastattn_paged_prefill", {"q": q, "k_pages": k_pages,
                                   "v_pages": v_pages},
        {"page_table": page_table, "pos_start": pos_start,
         "kv_len": kv_len})
    n_kv = page_table.shape[1]
    if (dk != d or v_pages.shape != k_pages.shape or hq % hkv
            or page_table.shape[0] != b or pos_start.shape != (b,)
            or kv_len.shape != (b,) or d not in L.HEAD_DIMS):
        raise ValueError(
            f"fastattn_paged_prefill: bad shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, table "
            f"{tuple(page_table.shape)}, pos_start {tuple(pos_start.shape)}"
            f", kv_len {tuple(kv_len.shape)} (head_dim must be one of "
            f"{L.HEAD_DIMS})")
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    lib = build.library("paged_prefill", _ARGTYPES)
    status = lib.paged_prefill(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), pos_start.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), b, hq, sq, hkv, num_pages, page_size, d, n_kv,
        L.opt_int(window), L.opt_float(softcap), float(scale), code,
        L.stream_ptr(q.device))
    L.check_status("fastattn_paged_prefill", status)
    fastattn_paged_prefill.launches += 1
    return out


fastattn_paged_prefill.launches = 0
