"""Per-layer attention blocks (kinds ``attn`` and ``attn_local``): the
training / full forward, the dense-cache decode and the paged serving
paths.

``moe``, ``hymba``, ``mlstm`` and ``slstm`` blocks are not ported yet and
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers import attention as attn_mod
from repro_torch.layers import mlp as mlp_mod
from repro_torch.layers.norms import apply_norm, init_norm

PORTED_KINDS = ("attn", "attn_local")


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.window_size if kind.endswith("local") else None


def check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (the port serves "
            f"{', '.join(PORTED_KINDS)})")


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype: torch.dtype) -> dict:
    check_kind(kind)
    d, dev = cfg.d_model, gen.device
    p: dict = {"ln1": init_norm(d, cfg.norm_type, dtype, dev),
               "attn": attn_mod.init_attention(gen, cfg, dtype),
               "ln2": init_norm(d, cfg.norm_type, dtype, dev)}
    if cfg.d_ff:
        p["mlp"] = mlp_mod.init_mlp(gen, d, cfg.d_ff, cfg.mlp_type, dtype)
    if cfg.post_norm:
        p["ln1_post"] = init_norm(d, cfg.norm_type, dtype, dev)
        p["ln2_post"] = init_norm(d, cfg.norm_type, dtype, dev)
    return p


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype: torch.dtype,
                     device: torch.device) -> attn_mod.KVCache:
    check_kind(kind)
    return attn_mod.init_kv_cache(cfg, batch, max_seq, dtype, device)


def init_block_pages(cfg: ModelConfig, kind: str, num_pages: int,
                     page_size: int, dtype: torch.dtype,
                     device: torch.device) -> attn_mod.KVCache:
    check_kind(kind)
    return attn_mod.init_kv_pages(cfg, num_pages, page_size, dtype, device)


def _attn_block_tail(params: dict, x: torch.Tensor, a: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Residual + FFN half of an attention block, shared by the training,
    prefill and decode paths so they cannot diverge."""
    if cfg.post_norm:
        a = apply_norm(params["ln1_post"], a, cfg.norm_type, cfg.norm_eps)
    x = x + a
    h2 = apply_norm(params["ln2"], x, cfg.norm_type, cfg.norm_eps)
    f = mlp_mod.apply_mlp(params["mlp"], h2, cfg.mlp_type)
    if cfg.post_norm:
        f = apply_norm(params["ln2_post"], f, cfg.norm_type, cfg.norm_eps)
    return x + f


def apply_block(params: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                *, positions: torch.Tensor,
                impl: Optional[str] = None) -> torch.Tensor:
    """Training / full forward of one block over (B, S, D)."""
    check_kind(kind)
    h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
    a = attn_mod.apply_attention(params["attn"], h, cfg, positions=positions,
                                 window=_window(cfg, kind), impl=impl)
    return _attn_block_tail(params, x, a, cfg)


def apply_block_prefill_paged(params: dict, x: torch.Tensor,
                              cfg: ModelConfig, kind: str, cache, *,
                              page_table: torch.Tensor,
                              pos_start: torch.Tensor,
                              n_valid: torch.Tensor,
                              impl: Optional[str] = None):
    """Chunked paged prefill: one prompt chunk (B, S, D) through the full
    block forward, K/V scattered into the paged pools.  Rows past
    ``n_valid`` are padding (their outputs are garbage, their K/V lands
    in scratch)."""
    check_kind(kind)
    h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
    a, cache = attn_mod.apply_attention_prefill_paged(
        params["attn"], h, cfg, cache, page_table=page_table,
        pos_start=pos_start, n_valid=n_valid, window=_window(cfg, kind),
        impl=impl)
    return _attn_block_tail(params, x, a, cfg), cache


def apply_block_decode_paged(params: dict, x: torch.Tensor,
                             cfg: ModelConfig, kind: str, cache, *,
                             page_table: torch.Tensor, pos: torch.Tensor,
                             impl: Optional[str] = None):
    """Paged one-token decode: positions are per-sequence (B,) and the KV
    cache is a shared page pool."""
    check_kind(kind)
    h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
    a, cache = attn_mod.apply_attention_decode_paged(
        params["attn"], h, cfg, cache, page_table=page_table, pos=pos,
        window=_window(cfg, kind), impl=impl)
    return _attn_block_tail(params, x, a, cfg), cache


def apply_block_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                       kind: str, cache, *, pos: int,
                       impl: Optional[str] = None):
    """Dense-cache one-token decode: x (B, 1, D), ``pos`` the scalar
    position shared by every row."""
    check_kind(kind)
    h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
    a, cache = attn_mod.apply_attention_decode(
        params["attn"], h, cfg, cache, pos=pos, window=_window(cfg, kind),
        impl=impl)
    return _attn_block_tail(params, x, a, cfg), cache
