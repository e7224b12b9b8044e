"""Wrappers of the FastAttention CUDA kernels.

* ``fastattn_fwd`` -- the dense two-level-tiled forward,
  ``csrc/fastattn_fwd.cu`` (bf16 on the tensor cores through the mainloop
  of ``csrc/attn_sm90.cuh``, float32 on FP32 FMA tiles);
* ``fastattn`` -- the same op with a gradient (``torch.autograd.Function``
  whose backward recomputes through the plain ``flash_reference``, as the
  JAX package's ``_bwd`` does: there is no backward kernel to port);
* ``fastattn_paged_prefill`` -- chunked prefill against the paged KV
  pools, ``csrc/paged_prefill.cu`` (the same two instances).

For CUDA tensors a wrapper launches its CUDA kernel (built at first use,
see ``kernels/build.py``) or raises; for CPU tensors it runs the plain
PyTorch version in ``ref.py``.  ``<wrapper>.launches`` counts kernel
launches (plain-version calls are not counted).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.kernels import _launch as L
from repro_torch.kernels import build
from repro_torch.kernels.fastattn.ref import (flash_reference,
                                              paged_prefill_reference)

REF_BLOCK_KV = 1024       # the JAX package's block_kv1 default (ops.py:31)

_PREFILL_ARGTYPES = (L.P, L.P, L.P, L.P, L.P, L.P, L.P,   # q k v table s l o
                     L.I, L.I, L.I, L.I, L.I, L.I, L.I,   # B hq sq hkv P ps d
                     L.I, L.I, L.I, L.F, L.F,             # n_kv kv1 w cap sc
                     L.I, L.P)                            # dt s
_FWD_ARGTYPES = (L.P, L.P, L.P, L.P,                  # q k v out
                 L.I, L.I, L.I, L.I, L.I, L.I, L.I,   # B hq hkv sq skv d kv1
                 L.I, L.I, L.F, L.F,                  # causal win cap scale
                 L.I, L.I, L.I, L.P)                  # q_off kv_valid dt s


def fastattn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None, q_offset: int = 0,
                 kv_valid: Optional[int] = None) -> torch.Tensor:
    """Two-level-tiled FlashAttention-2 forward.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), Hq % Hkv == 0.  Any Sq/Skv
    (ragged edges are masked in the kernel); ``kv_valid`` masks the keys
    at or past it.  The dtype selects the kernel: bfloat16 the tensor-core
    (``wgmma``) instance, float32 the FP32 FMA one.  The level-1 block
    (keys a stage) comes from the Hopper planner (``core/tiling.py``), which
    describes the instance the dtype launches; block_q and block_kv2 are
    fixed by that instance's thread layout (bf16: 128 or 64 rows, 64-key
    sub-tiles; f32: 64 rows, 32-key sub-tiles).  A row with no visible key
    is 0.
    """
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kv_valid = skv if kv_valid is None else max(min(int(kv_valid), skv), 0)
    if q.device.type == "cpu":
        return flash_reference(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, q_offset=q_offset,
            kv_len=None if kv_valid == skv else kv_valid)
    code = L.check_tensors("fastattn_fwd", {"q": q, "k": k, "v": v}, {})
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or k.shape[1] == 0 or hq % k.shape[1] or d not in L.HEAD_DIMS
            or q_offset < 0):
        raise ValueError(
            f"fastattn_fwd: bad arguments q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, q_offset {q_offset} "
            f"(head_dim must be one of {L.HEAD_DIMS}, Hq a multiple of "
            "Hkv, q_offset >= 0)")
    block_kv1 = tiling.plan_two_level_tiling(
        sq, skv, d, dtype_bytes=q.element_size()).block_kv1
    if b == 0 or hq == 0 or sq == 0 or skv == 0:
        return torch.zeros_like(q)
    out = torch.empty_like(q)
    lib = build.library("fastattn_fwd", _FWD_ARGTYPES)
    status = lib.fastattn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        k.shape[1], sq, skv, d, block_kv1, int(causal), L.opt_int(window),
        L.opt_float(softcap), float(scale), int(q_offset), kv_valid, code,
        L.stream_ptr(q.device))
    L.check_status("fastattn_fwd", status)
    fastattn_fwd.launches += 1
    return out


fastattn_fwd.launches = 0


class _FastAttn(torch.autograd.Function):
    """Forward through ``fastattn_fwd``; backward recomputes the plain
    ``flash_reference`` on the saved q/k/v and differentiates it (same
    numerics as the JAX package's custom_vjp, linear memory in Skv per
    chunk)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, kv_valid):
        ctx.save_for_backward(q, k, v)
        ctx.mask, ctx.kv_valid = mask, kv_valid
        return fastattn_fwd(q, k, v, kv_valid=kv_valid, **mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_reference(*leaves, kv_len=ctx.kv_valid,
                                  block_kv=REF_BLOCK_KV, **ctx.mask)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None)


def fastattn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, window: Optional[int] = None,
             softcap: Optional[float] = None, scale: Optional[float] = None,
             q_offset: int = 0, kv_valid: Optional[int] = None,
             impl: Optional[str] = None) -> torch.Tensor:
    """FastAttention with a gradient: (B, Hq, Sq, D) x (B, Hkv, Skv, D) ->
    (B, Hq, Sq, D).

    impl "kernel" (alias "pallas") runs ``fastattn_fwd`` in the forward
    (its plain version for CPU tensors) and the plain recompute in the
    backward; "reference" differentiates ``flash_reference`` directly
    (chunks of 1024 keys, the JAX package's default).
    None or "auto": the kernel for CUDA tensors, the plain version for CPU.
    """
    mask = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                q_offset=q_offset)
    if L.resolve_impl(impl, q, "fastattn") == "reference":
        return flash_reference(q, k, v, kv_len=kv_valid,
                               block_kv=REF_BLOCK_KV, **mask)
    return _FastAttn.apply(q, k, v, mask, kv_valid)


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
    # keys a stage of the bf16 ring, planned for the longest key range a
    # sequence of this table can hold (the float32 kernel does not read it)
    block_kv1 = tiling.plan_two_level_tiling(
        sq, n_kv * page_size, d, dtype_bytes=q.element_size()).block_kv1
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    lib = build.library("paged_prefill", _PREFILL_ARGTYPES)
    status = lib.paged_prefill(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), pos_start.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), b, hq, sq, hkv, num_pages, page_size, d, n_kv,
        block_kv1, L.opt_int(window), L.opt_float(softcap), float(scale), code,
        L.stream_ptr(q.device))
    L.check_status("fastattn_paged_prefill", status)
    fastattn_paged_prefill.launches += 1
    return out


fastattn_paged_prefill.launches = 0
