"""Context-parallel decode: attention over KV sharded along its sequence
dimension, merged exactly across ranks.

The paper tiles the KV sequence within one NPU; here the same
online-softmax decomposition is promoted to the distributed level.  Each
rank holds a slice of the KV, attends over it with a log-sum-exp, and the
partial outputs merge exactly:

    m   = all_reduce_max(lse_i)
    out = all_reduce_sum(exp(lse_i - m) * out_i)
          / all_reduce_sum(exp(lse_i - m))

(out_i is already normalised by its local softmax sum).  The paged
tensor-parallel path (``layers/attention.py``) merges a kv-head group's
page-row sub-shards this way; ``context_parallel_decode`` splits a dense
cache into contiguous slices, and ``cp_decode_body`` is one rank's share
of it: dense decode under a mesh with a model axis
(``layers/attention.apply_attention_decode``, the cache's ``kv_seq ->
model``) calls it on each layer's slice.  A rank's local attention is
``flash_decode`` with the slice's offset and the log-sum-exp output (the
kernel on CUDA tensors).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.tiled_allreduce import all_reduce
from repro_torch.kernels._launch import resolve_impl
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import decode_reference

NEG_INF = -1e30


def attend_with_positions(q, k, v, *, q_positions, kv_positions, kv_len,
                          causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None):
    """Attention over a KV slice whose global token positions are
    arbitrary (the paged-TP building block).

    A page-row sub-shard's gathered KV view is *strided* in global
    positions (it holds rows ``[si*ps_l, (si+1)*ps_l)`` of every page),
    so masks are driven by an explicit position vector.

    q: (B, Hq, Sq, D); k/v: (B, Hkv, K, D); q_positions: (B, Sq) global
    query positions; kv_positions: (K,) global key positions; kv_len:
    (B,) valid global lengths.  Returns ``(out, lse)`` -- out (B, Hq, Sq,
    D) float32, locally softmax-normalised (0 where no key is valid: the
    JAX package's averages the masked values there); lse (B, Hq, Sq) the
    local log-sum-exp, NEG_INF where no key was valid (so the cross-rank
    merge weighs the slice at zero).
    """
    b, hq, sq, d = q.shape
    n_rep = hq // k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    kf, vf = k.float(), v.float()
    if n_rep > 1:
        kf = kf.repeat_interleave(n_rep, dim=1)
        vf = vf.repeat_interleave(n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kv_pos = kv_positions.long()[None, None, :]               # (1, 1, K)
    q_pos = q_positions.long()[:, :, None]                    # (B, Sq, 1)
    mask = kv_pos < kv_len.long().reshape(-1, 1, 1)
    if causal:
        mask = mask & (q_pos >= kv_pos)
    if window is not None:
        mask = mask & (q_pos - kv_pos < window)
    maskb = mask[:, None]                                     # (B,1,Sq,K)
    s = torch.where(maskb, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(maskb, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0, 1.0, l)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf) / l_safe[..., None]
    lse = torch.where(l == 0, NEG_INF, m + torch.log(l_safe))
    return out, lse


def merge_partial_attention(out, lse, group=None):
    """Exact cross-rank merge of locally-normalised partial attention
    over ``group``: ``m = max(lse); w = exp(lse - m); sum(out * w) /
    sum(w)``, the two sums in one all-reduce.  out: lse.shape + (D,);
    returns the merged out, float32, the same on every rank of
    ``group``."""
    m = lse.clone()
    all_reduce(m, group, op=dist.ReduceOp.MAX)
    w = torch.exp(lse - m)
    acc = torch.cat([out * w[..., None], w[..., None]], dim=-1)
    all_reduce(acc, group)
    den = acc[..., -1:]
    return acc[..., :-1] / torch.where(den == 0, 1.0, den)


# ---------------------------------------------------------------------------
# paged helpers (the TP serving path)
# ---------------------------------------------------------------------------

def paged_local_view(pages, page_table):
    """A rank's gathered KV view of its pool block: pages (Hkv_local, P,
    ps_local, D), page_table (B, n_kv) -> (B, Hkv_local, n_kv * ps_local,
    D)."""
    g = pages[:, page_table.long()]          # (H, B, n_kv, ps_l, D)
    h, b, n_kv, psl, d = g.shape
    return g.permute(1, 0, 2, 3, 4).reshape(b, h, n_kv * psl, d)


def paged_shard_kv_positions(n_kv: int, page_size: int, rows_local: int,
                             shard_index: int, device=None):
    """Global token position of every row of a page-row sub-shard's
    gathered view: view row j sits in logical page ``j // rows_local``
    at within-page offset ``shard_index * rows_local + j % rows_local``.
    Returns (n_kv * rows_local,) int64."""
    j = torch.arange(n_kv * rows_local, device=device)
    return ((j // rows_local) * page_size
            + shard_index * rows_local + j % rows_local)


# ---------------------------------------------------------------------------
# context-parallel decode over a dense cache
# ---------------------------------------------------------------------------

def _local_decode_with_lse(q, k, v, start, stop, *, window, softcap, scale,
                           global_len, impl: Optional[str] = None):
    """Decode attention over a local KV slice covering global positions
    ``[start, stop)``.  q: (B, Hq, D); k/v: the slice, (B, S_local, Hkv,
    D) (the dense decode caches' "bshd" layout, ``layers/attention.
    KV_CACHE_LAYOUT``); global_len: (B,) the rows' global lengths.
    Returns (out, lse), both float32: out (B, Hq, D) locally normalised
    (0 where the slice holds no valid key), lse (B, Hq), NEG_INF there.

    ``flash_decode`` at ``kv_start=start``: on CUDA tensors the kernel
    (``csrc/flash_decode.cu``, which writes the log-sum-exp in the same
    launch), on CPU tensors its plain version; ``impl="reference"`` asks
    for the plain version (``decode_reference``) on either."""
    if stop - start != k.shape[1]:
        raise ValueError(f"slice [{start}, {stop}) holds {k.shape[1]} rows")
    glen = global_len.reshape(-1).to(device=q.device, dtype=torch.int32)
    kw = dict(window=window, softcap=softcap, scale=scale, layout="bshd",
              kv_start=int(start), return_lse=True)
    if resolve_impl(impl, q, "flash_decode") == "reference":
        out, lse = decode_reference(q[:, :, None], k, v, glen, **kw)
        return out[:, :, 0], lse[:, :, 0]
    return flash_decode(q.contiguous(), k, v, glen.contiguous(), **kw)


def cp_decode_body(q, k_shard, v_shard, kv_len, group=None, *,
                   window: Optional[int] = None,
                   softcap: Optional[float] = None,
                   scale: Optional[float] = None,
                   impl: Optional[str] = None):
    """One rank's context-parallel decode: q (B, Hq, D) whole, k/v the
    rank's contiguous slice of the caches' sequence, (B, S_local, Hkv,
    D); rank i of ``group`` holds positions ``[i * S_local, (i + 1) *
    S_local)``.  ``impl`` as in ``_local_decode_with_lse``.  The float32
    partials merge unrounded.  Returns (B, Hq, D) in q's dtype, the same
    on every rank of ``group``."""
    s_local = k_shard.shape[1]
    start = dist.get_rank(group) * s_local
    out, lse = _local_decode_with_lse(
        q, k_shard, v_shard, start, start + s_local, window=window,
        softcap=softcap, scale=scale, global_len=kv_len, impl=impl)
    return merge_partial_attention(out, lse, group).to(q.dtype)


def context_parallel_decode(q, k_cache, v_cache, kv_len, group=None, *,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None):
    """Distributed decode attention: q (B, Hq, D); caches (B, Hkv, S, D),
    S split into ``world`` contiguous slices, this rank attending over
    its own (read in place as a (B, S_local, Hkv, D) view).  Returns
    (B, Hq, D)."""
    n = dist.get_world_size(group)
    if k_cache.shape[2] % n:
        raise ValueError(f"cache length {k_cache.shape[2]} does not split "
                         f"into {n} slices")
    sl = k_cache.shape[2] // n
    r = dist.get_rank(group)
    return cp_decode_body(
        q, k_cache[:, :, r * sl:(r + 1) * sl].transpose(1, 2),
        v_cache[:, :, r * sl:(r + 1) * sl].transpose(1, 2), kv_len, group,
        window=window, softcap=softcap, scale=scale)
