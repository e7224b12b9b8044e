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
cache into contiguous slices.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.tiled_allreduce import all_reduce

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

def _local_decode_with_lse(q, k, v, start, *, window, softcap, scale,
                           global_len):
    """Decode attention over a local KV slice covering positions
    ``[start, start + k.shape[2])``.  q: (B, Hq, D); k/v: (B, Hkv,
    S_local, D); returns (out, lse), out locally normalised."""
    glen = global_len.reshape(-1).long()
    kv_pos = start + torch.arange(k.shape[2], device=k.device)
    # decode masks (pos < len, window back from len) are the causal and
    # window masks at q_position = len - 1
    out, lse = attend_with_positions(
        q[:, :, None], k, v, q_positions=(glen - 1)[:, None],
        kv_positions=kv_pos, kv_len=glen, causal=True, window=window,
        softcap=softcap, scale=scale)
    return out[:, :, 0], lse[:, :, 0]


def cp_decode_body(q, k_shard, v_shard, kv_len, group=None, *,
                   window: Optional[int] = None,
                   softcap: Optional[float] = None,
                   scale: Optional[float] = None):
    """One rank's context-parallel decode: q (B, Hq, D) whole, k/v
    (B, Hkv, S_local, D) the rank's contiguous slice (rank i holds
    positions ``[i * S_local, (i + 1) * S_local)``).  Returns (B, Hq, D)
    in q's dtype, the same on every rank of ``group``."""
    start = dist.get_rank(group) * k_shard.shape[2]
    out, lse = _local_decode_with_lse(
        q, k_shard, v_shard, start, window=window, softcap=softcap,
        scale=scale, global_len=kv_len)
    return merge_partial_attention(out, lse, group).to(q.dtype)


def context_parallel_decode(q, k_cache, v_cache, kv_len, group=None, *,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None):
    """Distributed decode attention: q (B, Hq, D); caches (B, Hkv, S, D),
    S split into ``world`` contiguous slices, this rank attending over
    its own.  Returns (B, Hq, D)."""
    n = dist.get_world_size(group)
    if k_cache.shape[2] % n:
        raise ValueError(f"cache length {k_cache.shape[2]} does not split "
                         f"into {n} slices")
    sl = k_cache.shape[2] // n
    r = dist.get_rank(group)
    return cp_decode_body(q, k_cache[:, :, r * sl:(r + 1) * sl],
                          v_cache[:, :, r * sl:(r + 1) * sl], kv_len, group,
                          window=window, softcap=softcap, scale=scale)
