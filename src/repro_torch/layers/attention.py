"""GQA attention layer: the dense training/full-forward path, the
dense-cache decode path and the paged KV-pool paths (all
non-tensor-parallel).

Caches and pools are updated IN PLACE (slice assignment, ``index_put_``
through a flat view): the JAX package wrote them functionally
(``dynamic_update_slice``, ``.at[].set``) and donated the old buffers to
the jitted step; here the step owns the only reference, so an in-place
write saves a copy of every cache per layer.  The functions still return
the cache so call sites read like their JAX counterparts.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.fastattention import (fast_attention,
                                            fast_attention_decode,
                                            fast_attention_prefill_paged)
from repro_torch.layers import common, rotary


# Dense decode cache layout: "bshd" (B, S_max, Hkv, D), token-major, as
# the JAX package keeps it.
KV_CACHE_LAYOUT = "bshd"


class KVCache(NamedTuple):
    # dense: (B, S_max, Hkv, D) ["bshd"];
    # paged: (Hkv, P, page_size, D) page pools shared by every sequence
    k: torch.Tensor
    v: torch.Tensor


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": common.dense_init(gen, d, qd, dtype),
        "wk": common.dense_init(gen, d, kvd, dtype),
        "wv": common.dense_init(gen, d, kvd, dtype),
        "wo": common.dense_init(gen, qd, d, dtype, scale=qd ** -0.5),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    b, s, _ = x.shape
    q = common.dense(x, params["wq"], params.get("bq"))
    k = common.dense(x, params["wk"], params.get("bk"))
    v = common.dense(x, params["wv"], params.get("bv"))
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    if cfg.rope_type == "rope":
        q = rotary.apply_rope(q, positions, theta=cfg.rope_theta)
        k = rotary.apply_rope(k, positions, theta=cfg.rope_theta)
    elif cfg.rope_type != "none":
        raise NotImplementedError(
            f"rope_type {cfg.rope_type!r} is not ported yet (M-RoPE comes "
            "with the qwen2-vl slice)")
    return q, k, v


def apply_attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, window: Optional[int] = None,
                    causal: bool = True,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Training / full-forward attention.  x: (B, S, D); positions (B, S).
    ``impl`` (default ``cfg.attention_impl``) as in ``fast_attention``."""
    impl = impl or cfg.attention_impl
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = fast_attention(q, k, v, causal=causal, window=window,
                         softcap=cfg.attn_logit_softcap, impl=impl)
    b, s = x.shape[:2]
    out = out.reshape(b, s, cfg.q_dim)
    return common.dense(out, params["wo"])


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype: torch.dtype, device: torch.device) -> KVCache:
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def apply_attention_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                           cache: KVCache, *, pos: int,
                           window: Optional[int] = None,
                           impl: Optional[str] = None):
    """One-token decode against dense caches.  x: (B, 1, D); pos: the
    scalar current position, shared by every row.  The new K/V row is
    written in place at ``pos`` for every row; attention then reads
    kv_len = pos + 1 tokens.  ``impl`` (default ``cfg.attention_impl``) as
    in the dense branches of ``fast_attention_decode``.  Returns
    (out (B, 1, D), cache)."""
    impl = impl or cfg.attention_impl
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        buf[:, pos] = new[:, 0].to(buf.dtype)
    kv_len = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    out = fast_attention_decode(
        q, cache.k, cache.v, kv_len, window=window,
        softcap=cfg.attn_logit_softcap, impl=impl, layout=KV_CACHE_LAYOUT)
    out = out.reshape(b, 1, cfg.q_dim)
    return common.dense(out, params["wo"]), cache


def init_kv_pages(cfg: ModelConfig, num_pages: int, page_size: int,
                  dtype: torch.dtype, device: torch.device) -> KVCache:
    """Global page pools (Hkv, P, page_size, D).  Every sequence's cache
    is a subset of pages named by its page-table row."""
    shape = (cfg.num_kv_heads, num_pages, page_size, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _table_pages(page_table: torch.Tensor,
                 positions: torch.Tensor, ps: int) -> torch.Tensor:
    """Physical page of every (b, s) position.  Logical blocks past the
    table width (padding rows of a sequence's last chunk) clamp to its
    last entry -- JAX clamps out-of-range gathers the same way; such rows
    are redirected to the scratch page by the caller anyway."""
    b = positions.shape[0]
    lp = torch.clamp(positions // ps, max=page_table.shape[1] - 1)
    rows = torch.arange(b, device=positions.device).reshape(b, -1)
    return page_table[rows, lp].long()


def scatter_kv_pages(cache: KVCache, k_new: torch.Tensor,
                     v_new: torch.Tensor, page_table: torch.Tensor,
                     positions: torch.Tensor,
                     n_valid: torch.Tensor) -> KVCache:
    """Scatter a chunk of new K/V rows into the paged pools, in place.

    k_new/v_new: (B, S, Hkv, D); positions: (B, S) global token positions;
    n_valid: (B,) -- rows past it (chunk padding) are redirected into the
    scratch page 0 so fixed-size chunks never touch pages owned by live
    sequences.
    """
    hkv, npages, ps, d = cache.k.shape
    b, s = positions.shape
    flat = _table_pages(page_table, positions, ps) * ps + positions % ps
    valid = torch.arange(s, device=positions.device)[None] < \
        n_valid.long()[:, None]
    flat = torch.where(valid, flat, 0).reshape(-1)
    for pool, new in ((cache.k, k_new), (cache.v, v_new)):
        rows = new.to(pool.dtype).permute(2, 0, 1, 3).reshape(hkv, b * s, d)
        pool.view(hkv, npages * ps, d)[:, flat] = rows
    return cache


def apply_attention_prefill_paged(params: dict, x: torch.Tensor,
                                  cfg: ModelConfig, cache: KVCache, *,
                                  page_table: torch.Tensor,
                                  pos_start: torch.Tensor,
                                  n_valid: torch.Tensor,
                                  window: Optional[int] = None,
                                  impl: Optional[str] = None):
    """Chunked prefill against paged KV pools.

    x: (B, S_chunk, D) -- a fixed-size chunk, possibly padded past
    ``n_valid``; pos_start: (B,) int32 global position of each sequence's
    chunk start; page_table: (B, n_kv) int32.  The chunk's K/V rows are
    scattered into their pages (padding rows into scratch), then the
    chunk attends to every cached position <= its own through the page
    table.  Returns (out (B, S_chunk, D), pools); output rows past
    ``n_valid`` are garbage and must be ignored.
    """
    b, s, _ = x.shape
    positions = pos_start.long()[:, None] + \
        torch.arange(s, device=x.device)[None]
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)
    cache = scatter_kv_pages(cache, k_new, v_new, page_table, positions,
                             n_valid)
    kv_len = (pos_start + n_valid).to(torch.int32)
    out = fast_attention_prefill_paged(
        q, cache.k, cache.v, page_table, pos_start, kv_len,
        window=window, softcap=cfg.attn_logit_softcap, impl=impl)
    out = out.reshape(b, s, cfg.q_dim)
    return common.dense(out, params["wo"]), cache


def apply_attention_decode_paged(params: dict, x: torch.Tensor,
                                 cfg: ModelConfig, cache: KVCache, *,
                                 page_table: torch.Tensor,
                                 pos: torch.Tensor,
                                 window: Optional[int] = None,
                                 impl: Optional[str] = None):
    """One-token decode against paged KV pools.

    x: (B, 1, D); pos: (B,) int32 per-sequence positions; page_table:
    (B, n_kv) int32.  The new K/V row is written into page
    ``page_table[b, pos // page_size]`` at offset ``pos % page_size``;
    attention then reads kv_len = pos + 1 tokens through the table.
    Returns (out (B, 1, D), pools).
    """
    b = x.shape[0]
    positions = pos.long()[:, None]
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)
    ps = cache.k.shape[2]
    page = _table_pages(page_table, positions, ps)[:, 0]
    off = positions[:, 0] % ps
    for pool, new in ((cache.k, k_new), (cache.v, v_new)):
        # (B, 1, Hkv, D) -> (Hkv, B, D) rows written at [:, page[b], off[b]]
        pool[:, page, off] = new[:, 0].to(pool.dtype).transpose(0, 1)
    kv_len = (pos + 1).to(torch.int32)
    out = fast_attention_decode(
        q, cache.k, cache.v, kv_len, page_table=page_table, window=window,
        softcap=cfg.attn_logit_softcap, impl=impl)
    out = out.reshape(b, 1, cfg.q_dim)
    return common.dense(out, params["wo"]), cache
