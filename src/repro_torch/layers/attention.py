"""GQA attention layer: the dense training/full-forward path (also
context-parallel under a training mesh), the encoder-decoder's
cross-attention, the dense-cache decode path and the paged KV-pool paths,
the latter also tensor-parallel.

Under a training mesh with a model axis (``sharding/rules.axis_rules``)
each rank holds its rows of the sequence: it projects Q, K and V on
them, all-gathers K and V along the sequence over the model axis
(reduce-scatter in the backward) and attends its queries to every key
with ``q_offset`` = its first row, as the JAX package's rules lay it out
(Q sharded along seq, K/V replicated, heads local).

At decode time under a mesh with a model axis the dense cache is
instead sharded along its *sequence* (``kv_seq -> model``): each rank
holds its B / data rows and S / model positions, the model rank that owns
the new position writes its K/V row, and attention is context-parallel
over the model group (``core/distributed_decode.cp_decode_body``: each
rank's slice through ``flash_decode`` with its offset and log-sum-exp,
then the LSE merge), the layout JAX's rules give the decode cache.

Caches and pools are updated IN PLACE (slice assignment, ``index_put_``
through a flat view): the JAX package wrote them functionally
(``dynamic_update_slice``, ``.at[].set``) and donated the old buffers to
the jitted step; here the step owns the only reference, so an in-place
write saves a copy of every cache per layer.  The functions still return
the cache so call sites read like their JAX counterparts.

Under an active tensor-parallel context (``sharding/tp.py``) the paged
paths run one rank's share: its sliced projections (``shard_params``),
its local pools (the kv heads of its group, its rows of every page), its
attention, and a row-parallel O-proj whose partial sums all-reduce over
every rank (``core/tiled_allreduce.py``).  With one page-row sub-shard
(``s == 1``) the rank's pools are ordinary pools and attention runs
through the paged kernels; with ``s > 1`` each rank attends over its
page rows in plain PyTorch and the group's sub-shards merge by their
log-sum-exp (``core/distributed_decode.py``), as the JAX package's TP
bodies do for every ``s``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.distributed_decode import (attend_with_positions,
                                                 cp_decode_body,
                                                 merge_partial_attention,
                                                 paged_local_view,
                                                 paged_shard_kv_positions)
from repro_torch.core.fastattention import (fast_attention,
                                            fast_attention_decode,
                                            fast_attention_prefill_paged)
from repro_torch.core.tiled_allreduce import matmul_allreduce
from repro_torch.layers import common, rotary
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import current_mesh
from repro_torch.sharding.tp import current_tp, local_pool_shape


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
            p[name] = torch.zeros((n,), dtype=dtype,
                                  device=common.device_of(gen))
    return p


def attention_logical(cfg: ModelConfig) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": (("attn_row", "heads"), (d, qd)),
        "wk": (("attn_row", "heads"), (d, kvd)),
        "wv": (("attn_row", "heads"), (d, kvd)),
        "wo": (("attn_row", "d_model"), (qd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = (("heads",), (qd,))
        p["bk"] = (("heads",), (kvd,))
        p["bv"] = (("heads",), (kvd,))
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
    elif cfg.rope_type == "mrope":
        q = rotary.apply_mrope(q, positions, sections=cfg.mrope_sections,
                               theta=cfg.rope_theta)
        k = rotary.apply_mrope(k, positions, sections=cfg.mrope_sections,
                               theta=cfg.rope_theta)
    return q, k, v


def rope_positions(positions: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """The rotary positions of text tokens at sequence ``positions``
    (B, S): themselves, or for M-RoPE their (3, B, S) broadcast (t = h =
    w = pos), as every JAX serving site treats a request."""
    if cfg.rope_type == "mrope":
        return positions.expand(3, *positions.shape)
    return positions


def apply_attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, window: Optional[int] = None,
                    causal: bool = True,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Training / full-forward attention.  x: (B, S, D); positions (B, S),
    or (3, B, S) for M-RoPE (used as given).  ``impl`` (default
    ``cfg.attention_impl``) as in ``fast_attention``.  Under a mesh with a model axis, x holds this rank's S rows of the
    sequence (context parallelism, above)."""
    impl = impl or cfg.attention_impl
    q, k, v = _project_qkv(params, x, cfg, positions)
    mesh = current_mesh()
    group = mesh.group(("model",)) if mesh is not None and \
        "model" in mesh.axis_names else None
    q_offset = 0
    if group is not None:
        k, v = C.gather(k, 1, group), C.gather(v, 1, group)
        q_offset = mesh.coords["model"] * x.shape[1]
    out = fast_attention(q, k, v, causal=causal, window=window,
                         softcap=cfg.attn_logit_softcap, q_offset=q_offset,
                         impl=impl)
    b, s = x.shape[:2]
    out = out.reshape(b, s, cfg.q_dim)
    return common.dense(out, params["wo"])


def apply_cross_attention(params: dict, x: torch.Tensor,
                          enc_k: torch.Tensor, enc_v: torch.Tensor,
                          cfg: ModelConfig, *,
                          impl: Optional[str] = None) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (B, S_enc,
    Hkv, D): non-causal, no window, the config's softcap.  x: (B, S, D)
    decoder states (S = 1 in a decode step).  ``impl`` as in
    ``apply_attention``.  Under a training mesh with a model axis x holds
    the rank's own decoder rows and the K/V every encoder row
    (``project_cross_kv`` gathers them): no row offset applies."""
    impl = impl or cfg.attention_impl
    b, s, _ = x.shape
    q = common.dense(x, params["wq"], params.get("bq"))
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    out = fast_attention(q, enc_k, enc_v, causal=False,
                         softcap=cfg.attn_logit_softcap, impl=impl)
    out = out.reshape(b, s, cfg.q_dim)
    return common.dense(out, params["wo"])


def project_cross_kv(params: dict, enc_states: torch.Tensor,
                     cfg: ModelConfig):
    """A cross-attention block's K and V of the encoder output
    (B, S_enc, D): each (B, S_enc, Hkv, D), the JAX package's layout.
    Under a training mesh with a model axis ``enc_states`` holds the
    rank's S_enc / model rows: K and V are projected on them and
    gathered whole along the sequence (reduce-scatter in the
    backward)."""
    b, s, _ = enc_states.shape
    k = common.dense(enc_states, params["wk"], params.get("bk"))
    v = common.dense(enc_states, params["wv"], params.get("bv"))
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    mesh = current_mesh()
    if mesh is not None and "model" in mesh.axis_names:
        group = mesh.group(("model",))
        k, v = C.gather(k, 1, group), C.gather(v, 1, group)
    return k, v


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype: torch.dtype, device: torch.device) -> KVCache:
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def apply_attention_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                           cache: KVCache, *, pos: int,
                           window: Optional[int] = None,
                           impl: Optional[str] = None, split: bool = True):
    """One-token decode against dense caches.  x: (B, 1, D); pos: the
    scalar current position, shared by every row.  The new K/V row is
    written in place at ``pos`` for every row; attention then reads
    kv_len = pos + 1 tokens.  ``impl`` (default ``cfg.attention_impl``) as
    in the dense branches of ``fast_attention_decode``.  Returns
    (out (B, 1, D), cache).

    Under a mesh with a model axis of n > 1 ranks x holds this rank's
    rows and the cache its (B, S / n, Hkv, D) slice of positions
    ``[m * S / n, (m + 1) * S / n)`` at model coordinate m: only the rank
    whose slice holds ``pos`` writes the new row, and attention merges
    every rank's slice over the model group (``cp_decode_body``).  Not
    ``split`` (the model axis does not divide the cache's width, so every
    model rank holds it whole): each rank decodes it as one device does.
    """
    impl = impl or cfg.attention_impl
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg,
                                   rope_positions(positions, cfg))
    mesh = current_mesh()
    n = mesh.shape.get("model", 1) if mesh is not None and split else 1
    row = pos - mesh.coords["model"] * cache.k.shape[1] if n > 1 else pos
    if n == 1 or 0 <= row < cache.k.shape[1]:
        for buf, new in ((cache.k, k_new), (cache.v, v_new)):
            buf[:, row] = new[:, 0].to(buf.dtype)
    kv_len = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    if n > 1:
        out = cp_decode_body(
            q[:, 0], cache.k, cache.v, kv_len, mesh.group(("model",)),
            window=window, softcap=cfg.attn_logit_softcap, impl=impl)
        return common.dense(out.reshape(b, 1, cfg.q_dim), params["wo"]), \
            cache
    out = fast_attention_decode(
        q, cache.k, cache.v, kv_len, window=window,
        softcap=cfg.attn_logit_softcap, impl=impl, layout=KV_CACHE_LAYOUT)
    out = out.reshape(b, 1, cfg.q_dim)
    return common.dense(out, params["wo"]), cache


def init_kv_pages(cfg: ModelConfig, num_pages: int, page_size: int,
                  dtype: torch.dtype, device: torch.device) -> KVCache:
    """Page pools (Hkv, P, page_size, D) shared by every sequence, each
    sequence's cache the pages named by its page-table row.  Under an
    active tensor-parallel context, this rank's share
    (``local_pool_shape``)."""
    shape = local_pool_shape(cfg, num_pages, page_size)
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


def _shard() -> tuple:
    """(page-row sub-shard index, sub-shards): (0, 1) without TP."""
    tpc = current_tp()
    return (0, 1) if tpc is None else (tpc.si, tpc.plan.s)


def _row_slots(pool: torch.Tensor, page_table: torch.Tensor,
               positions: torch.Tensor,
               write: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat row (page * local rows + local offset) of every (b, s)
    position in this rank's pool, where ``write`` holds (every position
    when None) and this rank owns the position's within-page offset; row
    0 of the scratch page elsewhere, so that padding rows and other
    sub-shards' rows never touch a live page."""
    si, s = _shard()
    psl = pool.shape[2]
    off = positions % (psl * s)
    flat = _table_pages(page_table, positions, psl * s) * psl
    if s == 1:
        flat, own = flat + off, write
    else:
        own = off // psl == si
        flat, own = flat + off % psl, own if write is None else own & write
    return flat if own is None else torch.where(own, flat, 0)


def scatter_kv_pages(cache: KVCache, k_new: torch.Tensor,
                     v_new: torch.Tensor, page_table: torch.Tensor,
                     positions: torch.Tensor,
                     n_valid: torch.Tensor) -> KVCache:
    """Scatter a chunk of new K/V rows into the paged pools, in place.

    k_new/v_new: (B, S, Hkv, D); positions: (B, S) global token positions;
    n_valid: (B,) -- rows past it (chunk padding) are redirected into the
    scratch page 0 so fixed-size chunks never touch pages owned by live
    sequences.  Under TP only the rows this rank's sub-shard owns are
    written (the rest go to its scratch slice).
    """
    hkv, npages, psl, d = cache.k.shape
    b, s = positions.shape
    valid = torch.arange(s, device=positions.device)[None] < \
        n_valid.long()[:, None]
    flat = _row_slots(cache.k, page_table, positions, valid).reshape(-1)
    for pool, new in ((cache.k, k_new), (cache.v, v_new)):
        rows = new.to(pool.dtype).permute(2, 0, 1, 3).reshape(hkv, b * s, d)
        pool.view(hkv, npages * psl, d)[:, flat] = rows
    return cache


def _merged_rows(q: torch.Tensor, cache: KVCache, page_table: torch.Tensor,
                 positions: torch.Tensor, kv_len: torch.Tensor,
                 window: Optional[int], cfg: ModelConfig) -> torch.Tensor:
    """Attention of a rank with page-row sub-shards (``s > 1``): its
    queries q (B, S, Hq_group, D) over its rows of every page, merged
    across its group's sub-shards by the log-sum-exp, then cut to the
    rank's 1/s of the query heads.  Returns (B, S, Hq_group/s * D) in
    q's dtype, the O-proj input of this rank's wo rows."""
    tpc = current_tp()
    si, s = tpc.si, tpc.plan.s
    psl = cache.k.shape[2]
    kv_pos = paged_shard_kv_positions(page_table.shape[1], psl * s, psl,
                                      si, device=q.device)
    out, lse = attend_with_positions(
        q.transpose(1, 2), paged_local_view(cache.k, page_table),
        paged_local_view(cache.v, page_table), q_positions=positions,
        kv_positions=kv_pos, kv_len=kv_len, causal=True, window=window,
        softcap=cfg.attn_logit_softcap)
    merged = merge_partial_attention(out, lse, tpc.seq_group)
    hq_s = merged.shape[1] // s
    mine = merged[:, si * hq_s:(si + 1) * hq_s].to(q.dtype)
    b, _, sq, d = mine.shape
    return mine.transpose(1, 2).reshape(b, sq, hq_s * d)


def _o_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out (B, S, F) @ wo; under TP the rank's partial sum, all-reduced
    over every rank (tiled or single, as the plan says)."""
    tpc = current_tp()
    if tpc is None:
        return common.dense(out, wo)
    plan = tpc.plan
    b, s, f = out.shape
    y = matmul_allreduce(out.reshape(b * s, f), wo.to(out.dtype),
                         tpc.world_group, mode=plan.collectives,
                         n_chunks=plan.ar_chunks,
                         first_chunk_frac=plan.first_chunk_frac)
    return y.reshape(b, s, -1)


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
    q, k_new, v_new = _project_qkv(params, x, cfg,
                                   rope_positions(positions, cfg))
    cache = scatter_kv_pages(cache, k_new, v_new, page_table, positions,
                             n_valid)
    kv_len = (pos_start + n_valid).to(torch.int32)
    if _shard()[1] > 1:
        out = _merged_rows(q, cache, page_table, positions, kv_len, window,
                           cfg)
    else:
        out = fast_attention_prefill_paged(
            q, cache.k, cache.v, page_table, pos_start, kv_len,
            window=window, softcap=cfg.attn_logit_softcap, impl=impl)
        out = out.reshape(b, s, -1)
    return _o_proj(out, params["wo"]), cache


def apply_attention_decode_paged(params: dict, x: torch.Tensor,
                                 cfg: ModelConfig, cache: KVCache, *,
                                 page_table: torch.Tensor,
                                 pos: torch.Tensor,
                                 window: Optional[int] = None,
                                 impl: Optional[str] = None):
    """One-token decode against paged KV pools.

    x: (B, 1, D); pos: (B,) int32 per-sequence positions; page_table:
    (B, n_kv) int32.  The new K/V row is written into page
    ``page_table[b, pos // page_size]`` at offset ``pos % page_size``
    (under TP by the one sub-shard that owns that offset; the others
    write their scratch slice); attention then reads kv_len = pos + 1
    tokens through the table.  Returns (out (B, 1, D), pools).
    """
    b = x.shape[0]
    positions = pos.long()[:, None]
    q, k_new, v_new = _project_qkv(params, x, cfg,
                                   rope_positions(positions, cfg))
    hkv, npages, psl, d = cache.k.shape
    flat = _row_slots(cache.k, page_table, positions)[:, 0]
    for pool, new in ((cache.k, k_new), (cache.v, v_new)):
        # (B, 1, Hkv, D) -> (Hkv, B, D) rows written at their flat rows
        pool.view(hkv, npages * psl, d)[:, flat] = \
            new[:, 0].to(pool.dtype).transpose(0, 1)
    kv_len = (pos + 1).to(torch.int32)
    if _shard()[1] > 1:
        out = _merged_rows(q, cache, page_table, positions, kv_len, window,
                           cfg)
    else:
        out = fast_attention_decode(
            q, cache.k, cache.v, kv_len, page_table=page_table,
            window=window, softcap=cfg.attn_logit_softcap, impl=impl)
        out = out.reshape(b, 1, -1)
    return _o_proj(out, params["wo"]), cache
