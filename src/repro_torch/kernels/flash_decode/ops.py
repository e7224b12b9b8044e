"""Flash decode: the wrappers of ``csrc/flash_decode.cu`` (dense caches)
and ``csrc/paged_decode.cu`` (paged pools), both split-KV with one planner
(``plan_splits``) and one workspace (``split_workspace``).

For CUDA tensors ``flash_decode`` and ``paged_flash_decode`` launch their
CUDA kernel (built at first use, see ``kernels/build.py``) or raise; for
CPU tensors they run the plain PyTorch version in ``ref.py``.
``<wrapper>.launches`` counts kernel launches (plain-version calls are not
counted).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _launch as L
from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import (decode_reference,
                                                  paged_decode_reference)

LAYOUTS = ("bshd", "bhsd")

_ARGTYPES = (L.P, L.P, L.P, L.P, L.P, L.P,        # q k v table kv_len out
             L.P, L.P,                            # partials counters
             L.I, L.I, L.I, L.I, L.I, L.I, L.I,   # B hq hkv P ps d n_kv
             L.I, L.I, L.F, L.F, L.I, L.P)        # window split_keys cap
                                                  # scale dtype stream
_DENSE_ARGTYPES = (L.P, L.P, L.P, L.P, L.P,     # q k v kv_len out
                   L.P, L.P, L.P,               # partials counters lse
                   L.I, L.I, L.I, L.I, L.I,     # B hq hkv s_max kv_start
                   L.I,                         # d
                   L.L, L.L, L.L,               # stride b, s, h
                   L.I, L.I, L.F, L.F,          # window split_keys cap scale
                   L.I, L.P)                    # dtype stream


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None,
                 layout: str, kv_start: int = 0,
                 return_lse: bool = False):
    """Decode attention: q (B, Hq, D) against dense caches (B, Hkv, S, D)
    ["bhsd"] or (B, S, Hkv, D) ["bshd"]; kv_len (B,) int32.  Returns
    (B, Hq, D).

    The caches may be one rank's slice of a cache sharded along its
    sequence (context-parallel decode): ``kv_start`` is the global
    position of their row 0 and kv_len stays global.  With
    ``return_lse`` it returns (out, lse), both float32 (a cross-rank
    merge reads the partial unrounded): lse (B, Hq) the rows'
    log-sum-exp, NEG_INF (and out 0) where the slice holds no valid key.

    The kernel reads either layout in place through the caches' strides
    (batch, token, head); their head dim must be contiguous.  It splits
    each row's keys over CTAs as ``paged_flash_decode`` does
    (``plan_dense_splits``: the cache width S as the span) and merges the
    splits in the same launch through the shared ``split_workspace``.
    The JAX kernel's ``block_kv`` has no counterpart."""
    if layout not in LAYOUTS:
        raise ValueError(f"flash_decode: unknown cache layout {layout!r}")
    if kv_start < 0:
        raise ValueError(f"flash_decode: kv_start {kv_start} < 0")
    b, hq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        res = decode_reference(
            q[:, :, None], k_cache, v_cache, kv_len, window=window,
            softcap=softcap, scale=scale, layout=layout, kv_start=kv_start,
            return_lse=return_lse)
        if return_lse:
            return res[0][:, :, 0], res[1][:, :, 0]
        return res[:, :, 0]
    code = L.check_tensors("flash_decode", {"q": q}, {"kv_len": kv_len})
    L.check_strided("k_cache", k_cache, q)
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
    # v has k's shape and strides: its device, dtype and base address
    # are what is left to check (check_strided's full walk costs ~2 us)
    if (v_cache.device != q.device or v_cache.dtype != q.dtype
            or v_cache.data_ptr() % 16):
        L.check_strided("v_cache", v_cache, q)
    if return_lse:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    else:
        out, lse = torch.empty_like(q), None
    if b == 0:
        return (out, lse) if return_lse else out
    split_keys, n_split = plan_dense_splits(b, hq, hkv, s_max, window,
                                            _sm_count(q.device))
    part, cnt = split_workspace(q.device, b * hq * n_split * (d + 2), b * hq)
    lib = build.library("flash_decode", _DENSE_ARGTYPES)
    status = lib.flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), part.data_ptr(), cnt.data_ptr(),
        None if lse is None else lse.data_ptr(), b, hq, hkv, s_max,
        int(kv_start), d, sb, ss, sh, L.opt_int(window), split_keys,
        L.opt_float(softcap), float(scale), code, L.stream_ptr(q.device))
    L.check_status("flash_decode", status)
    flash_decode.launches += 1
    return (out, lse) if return_lse else out


flash_decode.launches = 0


# split-KV planning of ``paged_decode.cu`` and ``flash_decode.cu``
SPLIT_STEP = 32       # split_keys is a multiple of this many keys
# the grid aims at this many active CTAs an SM: what the register file
# holds of paged_decode.cu's 1-row bf16 instance (~123 registers x 128
# threads), so the longest rows run in one wave (``kernels_bench.py
# --sweep`` times 4 against 8-64 at its cases)
CTAS_PER_SM = 4
# flash_decode.cu's aim: a register-fed CTA keeps ~16 KB of K/V in flight,
# and about two an SM keep the ~32 KB an SM the card needs.  Just under 2,
# because plan_splits rounds the split count up (by up to one CTA a base
# row) and the 8-row instance fits only 2 an SM: the grid then stays one
# wave, and rows that already fill the card (phase 3b's B=8 x 32 heads)
# are not split, where a merge costs more than it saves
# (``kernels_bench.py --sweep`` times 1-8)
DENSE_CTAS_PER_SM = 1.9


def rows_per_cta(g: int) -> int:
    """Query rows of a GQA group one CTA of ``paged_decode.cu`` or
    ``flash_decode.cu`` takes (their ``dispatch_g``)."""
    return 1 if g == 1 else 2 if g == 2 else 4 if g <= 4 else 8


@functools.lru_cache(maxsize=1024)
def plan_splits(b: int, hkv: int, g: int, n_kv: int, page_size: int,
                window: Optional[int], sm_count: int,
                ctas_per_sm: Optional[float] = None) -> Tuple[int, int]:
    """(split_keys, n_split) of a split-KV decode launch, from the shapes
    alone: kv_len lives on the card, and reading it would stall the host.
    A paged launch passes its table width in pages; a dense one its cache
    width S as ``n_kv`` with ``page_size`` 1, and its own aim
    (DENSE_CTAS_PER_SM; None: CTAS_PER_SM).

    A row's valid keys are at most ``span`` = the table width
    ``n_kv * page_size`` (or the window, where smaller); split z of a row
    walks its keys kv_begin + z * split_keys onwards.  The grid
    (B, Hkv * ceil(g / G), n_split) aims at ``ctas_per_sm`` CTAs an SM, so
    the longest row is spread over several SMs; the splits a shorter row
    does not reach exit at once.  split_keys is a multiple of SPLIT_STEP, so
    there are at most ceil(span / SPLIT_STEP) splits."""
    width = n_kv * page_size
    span = min(window, width) if window and window > 0 else width
    base = b * hkv * math.ceil(g / rows_per_cta(g))
    aim = CTAS_PER_SM if ctas_per_sm is None else ctas_per_sm
    want = max(1, math.ceil(aim * sm_count / base))
    split_keys = max(SPLIT_STEP, SPLIT_STEP * math.ceil(
        math.ceil(span / want) / SPLIT_STEP))
    return split_keys, math.ceil(span / split_keys)


@functools.lru_cache(maxsize=1024)
def plan_dense_splits(b: int, hq: int, hkv: int, s_max: int,
                      window: Optional[int], sm_count: int
                      ) -> Tuple[int, int]:
    """(split_keys, n_split) of a ``flash_decode`` launch on caches of
    ``s_max`` tokens: ``plan_splits`` with the cache width as the span
    and DENSE_CTAS_PER_SM as the aim (cached: clear the cache after
    changing it)."""
    return plan_splits(b, hkv, hq // hkv, s_max, 1, window, sm_count,
                       DENSE_CTAS_PER_SM)


# per device: the SM count and the split-KV workspace (partials, counters)
_SM_COUNT: Dict[torch.device, int] = {}
_WORKSPACE: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _sm_count(device: torch.device) -> int:
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNT[device]


def split_workspace(device: torch.device, n_partial: int,
                    n_counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-KV workspace of ``device``: at least ``n_partial`` float32
    partial values and ``n_counters`` int32 counters (all 0).  Kept per
    device and grown when a launch needs more; the kernel leaves every
    counter at 0, so it is zeroed only when allocated.  Launches on one
    stream share it (a second stream running decode at once would race)."""
    part, cnt = _WORKSPACE.get(device, (None, None))
    if part is None or part.numel() < n_partial or cnt.numel() < n_counters:
        part = torch.empty(max(n_partial, 0 if part is None else
                               part.numel()), dtype=torch.float32,
                           device=device)
        cnt = torch.zeros(max(n_counters, 0 if cnt is None else cnt.numel()),
                          dtype=torch.int32, device=device)
        _WORKSPACE[device] = (part, cnt)
    return part, cnt


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       kv_len: torch.Tensor, *,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over a paged cache: q (B, Hq, D), pages
    (Hkv, P, page_size, D), page_table (B, n_kv) int32, kv_len (B,) int32.
    Returns (B, Hq, D).

    The kernel splits each row's keys over CTAs (``plan_splits``) and
    merges the splits in the same launch, through the per-device
    ``split_workspace``: B * Hq * n_split * (D + 2) float32 partials and
    B * Hq int32 counters."""
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
    split_keys, n_split = plan_splits(b, hkv, hq // hkv, n_kv, page_size,
                                      window, _sm_count(q.device))
    part, cnt = split_workspace(q.device, b * hq * n_split * (d + 2), b * hq)
    lib = build.library("paged_decode", _ARGTYPES)
    status = lib.paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        part.data_ptr(), cnt.data_ptr(), b, hq, hkv, num_pages, page_size,
        d, n_kv, L.opt_int(window), split_keys, L.opt_float(softcap),
        float(scale), code, L.stream_ptr(q.device))
    L.check_status("paged_flash_decode", status)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
