"""Per-layer blocks: attention (kinds ``attn`` and ``attn_local``) and the
xLSTM recurrent kinds ``mlstm`` and ``slstm``; the training / full
forward, the dense-cache decode and (attention kinds only, as in the JAX
package) the paged serving paths.

``moe`` and ``hymba`` blocks are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers import attention as attn_mod
from repro_torch.layers import mlp as mlp_mod
from repro_torch.layers import ssm as ssm_mod
from repro_torch.layers.norms import apply_norm, init_norm

ATTN_KINDS = ("attn", "attn_local")
PORTED_KINDS = ATTN_KINDS + ("mlstm", "slstm")


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.window_size if kind.endswith("local") else None


def check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (the port serves "
            f"{', '.join(PORTED_KINDS)})")


def _check_paged(kind: str) -> None:
    """Recurrent kinds carry O(1) per-slot state -- nothing to page -- and
    are not wired into the paged engine (nor are they in the JAX
    package)."""
    check_kind(kind)
    if kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"paged serving supports attention-cache blocks only, got "
            f"{kind!r}")


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype: torch.dtype) -> dict:
    check_kind(kind)
    d, dev = cfg.d_model, gen.device
    p: dict = {"ln1": init_norm(d, cfg.norm_type, dtype, dev)}
    if kind == "mlstm":
        p["cell"] = ssm_mod.init_mlstm(gen, cfg, dtype)
        return p
    if kind == "slstm":
        p["cell"] = ssm_mod.init_slstm(gen, cfg, dtype)
        return p
    p["attn"] = attn_mod.init_attention(gen, cfg, dtype)
    p["ln2"] = init_norm(d, cfg.norm_type, dtype, dev)
    if cfg.d_ff:
        p["mlp"] = mlp_mod.init_mlp(gen, d, cfg.d_ff, cfg.mlp_type, dtype)
    if cfg.post_norm:
        p["ln1_post"] = init_norm(d, cfg.norm_type, dtype, dev)
        p["ln2_post"] = init_norm(d, cfg.norm_type, dtype, dev)
    return p


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype: torch.dtype, device: torch.device):
    """A block's dense decode cache: a KVCache for attention kinds, the
    float32 recurrent state for mlstm / slstm (``max_seq`` unused)."""
    check_kind(kind)
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "mlstm":
        di = ssm_mod._di(cfg)
        nh = cfg.num_heads
        hd = di // nh
        return ssm_mod.MLSTMState(
            c=torch.zeros((batch, nh, hd, hd), **f32),
            n=torch.zeros((batch, nh, hd), **f32),
            m=torch.full((batch, nh), -1e30, **f32),
            conv=torch.zeros((0,), dtype=dtype, device=device))
    if kind == "slstm":
        di = ssm_mod._di(cfg)
        return ssm_mod.SLSTMState(
            c=torch.zeros((batch, di), **f32),
            n=torch.zeros((batch, di), **f32),
            h=torch.zeros((batch, di), **f32),
            m=torch.full((batch, di), -1e30, **f32))
    return attn_mod.init_kv_cache(cfg, batch, max_seq, dtype, device)


def init_block_pages(cfg: ModelConfig, kind: str, num_pages: int,
                     page_size: int, dtype: torch.dtype,
                     device: torch.device) -> attn_mod.KVCache:
    _check_paged(kind)
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
    if kind == "mlstm":
        return x + ssm_mod.apply_mlstm(params["cell"], h, cfg, impl=impl)
    if kind == "slstm":
        return x + ssm_mod.apply_slstm(params["cell"], h, cfg)
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
    _check_paged(kind)
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
    _check_paged(kind)
    h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
    a, cache = attn_mod.apply_attention_decode_paged(
        params["attn"], h, cfg, cache, page_table=page_table, pos=pos,
        window=_window(cfg, kind), impl=impl)
    return _attn_block_tail(params, x, a, cfg), cache


def apply_block_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                       kind: str, cache, *, pos: int,
                       impl: Optional[str] = None):
    """Dense-cache one-token decode: x (B, 1, D), ``pos`` the scalar
    position shared by every row (recurrent kinds carry their state in
    ``cache`` and ignore it)."""
    check_kind(kind)
    h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
    if kind == "mlstm":
        y, cache = ssm_mod.apply_mlstm(params["cell"], h, cfg, state=cache,
                                       decode=True)
        return x + y, cache
    if kind == "slstm":
        y, cache = ssm_mod.apply_slstm(params["cell"], h, cfg, state=cache,
                                       decode=True)
        return x + y, cache
    a, cache = attn_mod.apply_attention_decode(
        params["attn"], h, cfg, cache, pos=pos, window=_window(cfg, kind),
        impl=impl)
    return _attn_block_tail(params, x, a, cfg), cache
