"""Per-layer blocks: attention (kinds ``attn`` and ``attn_local``),
attention with a mixture-of-experts FFN (``moe``), hymba's parallel
attention and Mamba heads (``hymba``, ``hymba_local``) and the xLSTM
recurrent kinds ``mlstm`` and ``slstm``; the training / full forward,
the dense-cache decode and (attention-cache kinds only, as in the JAX
package) the paged serving paths.

Under a training mesh with a model axis each block runs one rank's
share of its rows (``models/lm.py``): attention is context-parallel,
a MoE FFN runs the rank's experts on the gathered rows (``_moe_ffn``)
and a recurrent cell its channels or heads on the gathered rows
(``_channel_cell``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers import attention as attn_mod
from repro_torch.layers import mlp as mlp_mod
from repro_torch.layers import moe as moe_mod
from repro_torch.layers import ssm as ssm_mod
from repro_torch.layers.norms import apply_norm, init_norm, norm_logical
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import current_mesh

# the kinds whose cache is a KV cache: they serve paged
ATTN_KINDS = ("attn", "attn_local", "moe")
# the kinds that decode from a cache sharded along its sequence over the
# model axis (``kv_seq -> model``: layers/attention.apply_attention_decode)
MESH_DECODE_KINDS = ("attn", "attn_local")
HYMBA_KINDS = ("hymba", "hymba_local")
PORTED_KINDS = ATTN_KINDS + HYMBA_KINDS + ("mlstm", "slstm")
# a recurrent kind's cell: (its subtree in the block's params, the cell)
CELLS = {"mlstm": ("cell", "mlstm"), "slstm": ("cell", "slstm"),
         "hymba": ("mamba", "mamba"), "hymba_local": ("mamba", "mamba")}


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.window_size if kind.endswith("local") else None


def check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (the port serves "
            f"{', '.join(PORTED_KINDS)})")


def check_mesh_decode(kind: str, model: int) -> None:
    """Dense decode under a mesh whose model axis has ``model`` > 1 ranks
    runs the attention kinds only (context-parallel over the cache's
    sequence); the recurrent states, hymba's KV and Mamba channels and a
    MoE block's experts have no sharded decode yet."""
    check_kind(kind)
    if model > 1 and kind not in MESH_DECODE_KINDS:
        raise NotImplementedError(
            f"dense decode of {kind!r} blocks on a mesh with a model axis "
            f"of {model} is not ported (ROADMAP Queue 1 item 8); it runs "
            f"{', '.join(MESH_DECODE_KINDS)} blocks")


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
    if kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype)
    elif cfg.d_ff:
        p["mlp"] = mlp_mod.init_mlp(gen, d, cfg.d_ff, cfg.mlp_type, dtype)
    if cfg.post_norm:
        p["ln1_post"] = init_norm(d, cfg.norm_type, dtype, dev)
        p["ln2_post"] = init_norm(d, cfg.norm_type, dtype, dev)
    if kind in HYMBA_KINDS:
        p["mamba"] = ssm_mod.init_mamba(gen, cfg, dtype)
        p["norm_attn"] = init_norm(d, cfg.norm_type, dtype, dev)
        p["norm_mamba"] = init_norm(d, cfg.norm_type, dtype, dev)
    return p


def block_logical(cfg: ModelConfig, kind: str) -> dict:
    """Logical axes of every leaf of ``init_block``'s tree."""
    check_kind(kind)
    d = cfg.d_model
    p: dict = {"ln1": norm_logical(d, cfg.norm_type)}
    if kind == "mlstm":
        p["cell"] = ssm_mod.mlstm_logical(cfg)
        return p
    if kind == "slstm":
        p["cell"] = ssm_mod.slstm_logical(cfg)
        return p
    p["attn"] = attn_mod.attention_logical(cfg)
    p["ln2"] = norm_logical(d, cfg.norm_type)
    if kind == "moe":
        p["moe"] = moe_mod.moe_logical(cfg)
    elif cfg.d_ff:
        p["mlp"] = mlp_mod.mlp_logical(d, cfg.d_ff, cfg.mlp_type)
    if cfg.post_norm:
        p["ln1_post"] = norm_logical(d, cfg.norm_type)
        p["ln2_post"] = norm_logical(d, cfg.norm_type)
    if kind in HYMBA_KINDS:
        p["mamba"] = ssm_mod.mamba_logical(cfg)
        p["norm_attn"] = norm_logical(d, cfg.norm_type)
        p["norm_mamba"] = norm_logical(d, cfg.norm_type)
    return p


def block_cache_logical(cfg: ModelConfig, kind: str, batch: int,
                        max_seq: int):
    """Logical axes of every leaf of ``init_block_cache``'s tree."""
    check_kind(kind)
    if kind == "mlstm":
        di = ssm_mod._di(cfg)
        nh = cfg.num_heads
        hd = di // nh
        return ssm_mod.MLSTMState(
            c=(("batch", None, None, "channels"), (batch, nh, hd, hd)),
            n=(("batch", None, None), (batch, nh, hd)),
            m=(("batch", None), (batch, nh)),
            conv=((None,), (0,)))
    if kind == "slstm":
        s2 = (("batch", "channels"), (batch, ssm_mod._di(cfg)))
        return ssm_mod.SLSTMState(c=s2, n=s2, h=s2, m=s2)
    # attn_mod.KV_CACHE_LAYOUT == "bshd"
    kvshape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    axes = ("batch", "kv_seq", "heads", None)
    kv = attn_mod.KVCache(k=(axes, kvshape), v=(axes, kvshape))
    if kind in HYMBA_KINDS:
        di, n = cfg.q_dim, cfg.ssm_state_size
        return {"kv": kv, "mamba": ssm_mod.MambaState(
            h=(("batch", "channels", None), (batch, di, n)),
            conv=(("batch", None, "channels"),
                  (batch, cfg.conv_kernel - 1, di)))}
    return kv


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype: torch.dtype, device: torch.device):
    """A block's dense decode cache: a KVCache for attention kinds, the
    float32 recurrent state for mlstm / slstm (``max_seq`` unused), and
    ``{"kv": KVCache, "mamba": MambaState}`` for hymba kinds (the Mamba
    state's h float32, its conv history in ``dtype``)."""
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
    kv = attn_mod.init_kv_cache(cfg, batch, max_seq, dtype, device)
    if kind in HYMBA_KINDS:
        di = cfg.q_dim
        return {"kv": kv, "mamba": ssm_mod.MambaState(
            h=torch.zeros((batch, di, cfg.ssm_state_size), **f32),
            conv=torch.zeros((batch, cfg.conv_kernel - 1, di), dtype=dtype,
                             device=device))}
    return kv


def init_block_pages(cfg: ModelConfig, kind: str, num_pages: int,
                     page_size: int, dtype: torch.dtype,
                     device: torch.device) -> attn_mod.KVCache:
    _check_paged(kind)
    return attn_mod.init_kv_pages(cfg, num_pages, page_size, dtype, device)


def _attn_block_tail(params: dict, x: torch.Tensor, a: torch.Tensor,
                     cfg: ModelConfig, kind: str) -> torch.Tensor:
    """Residual + FFN half of an attention block, shared by the training,
    prefill and decode paths so they cannot diverge."""
    if cfg.post_norm:
        a = apply_norm(params["ln1_post"], a, cfg.norm_type, cfg.norm_eps)
    x = x + a
    h2 = apply_norm(params["ln2"], x, cfg.norm_type, cfg.norm_eps)
    if kind == "moe":
        f = _moe_ffn(params["moe"], h2, cfg)
    else:
        f = mlp_mod.apply_mlp(params["mlp"], h2, cfg.mlp_type)
    if cfg.post_norm:
        f = apply_norm(params["ln2_post"], f, cfg.norm_type, cfg.norm_eps)
    return x + f


def _moe_ffn(params: dict, h2: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """The MoE FFN of a block.  Under a training mesh with a model axis
    the rank holds S / model rows of each batch row, and JAX's capacity
    counts a whole row: ``h2`` is gathered along the sequence so that
    every model rank routes and dispatches whole rows as one device does.
    With the experts sharded over the model axis (``expert -> model``,
    ``params`` holding this rank's E / model of them) the rank runs its
    own experts' slots and the partial combines are reduce-scattered
    back to each rank's rows; the router's gradient on a rank then comes
    from its own experts' slots only, and the train step sums it over the
    mesh like every replicated leaf's.  Where E % model != 0 the rule
    table keeps the experts whole (gathered with the block): every rank
    runs every expert and keeps its rows."""
    mesh = current_mesh()
    n = mesh.shape.get("model", 1) if mesh is not None else 1
    if n == 1:
        return moe_mod.apply_moe(params, h2, cfg)
    group = mesh.group(("model",))
    m, s = mesh.coords["model"], h2.shape[1]
    whole = C.gather(h2, 1, group)
    el = params["w_up"].shape[0]
    if el == cfg.num_experts:
        return moe_mod.apply_moe(params, whole, cfg)[:, m * s:(m + 1) * s]
    part = moe_mod.apply_moe(params, whole, cfg,
                             experts=(m * el, (m + 1) * el))
    return C.scatter(part, 1, group)


def local_leaves(cfg: ModelConfig, kind: str, spec: dict,
                 model: int) -> dict:
    """The leaves of a block that a rank runs as its own pieces under a
    model axis of ``model`` (subtree -> leaf names; every other leaf is
    gathered whole): a MoE block's expert leaves sharded over the model
    axis (``_moe_ffn``), a recurrent cell's ``ssm.LOCAL_LEAVES`` where
    the model axis splits its recurrence (``_channel_cell``)."""
    if kind == "moe":
        return {"moe": {k for k, s in spec["moe"].items()
                        if s[:1] == ("model",)}}
    if kind in CELLS and model > 1:
        sub, cell = CELLS[kind]
        if ssm_mod.channel_shards(cfg, cell, model):
            return {sub: set(ssm_mod.LOCAL_LEAVES[cell])}
    return {}


def _channel_cell(params: dict, h: torch.Tensor, cfg: ModelConfig,
                  cell: str, **kw) -> torch.Tensor:
    """The recurrent ``cell`` ("mamba", "mlstm" or "slstm": ``ssm``'s
    ``apply_<cell>``) over the normed ``h``.  Under a training mesh with
    a model axis the rank holds S / model rows of each batch row and the
    recurrence needs them all: ``h`` is gathered along the sequence, and
    where the model axis splits the cell (``ssm.channel_shards``;
    ``params`` then holds the rank's pieces of the channel dim,
    ``local_leaves``) the cell runs the rank's channels or heads and the
    float32 partial out-projections are reduce-scattered back to each
    rank's rows.  Otherwise every rank runs it whole on the gathered rows
    and keeps its own."""
    fn = getattr(ssm_mod, f"apply_{cell}")
    mesh = current_mesh()
    n = mesh.shape.get("model", 1) if mesh is not None else 1
    if n == 1:
        return fn(params, h, cfg, **kw)
    group = mesh.group(("model",))
    m, s = mesh.coords["model"], h.shape[1]
    whole = C.gather(h, 1, group)
    if not ssm_mod.channel_shards(cfg, cell, n):
        return fn(params, whole, cfg, **kw)[:, m * s:(m + 1) * s]
    part = fn(params, whole, cfg, part=(m, n), **kw)
    return C.scatter(part, 1, group).to(h.dtype)


def _hymba_tail(params: dict, x: torch.Tensor, a: torch.Tensor,
                m: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """hymba's fusion of its attention and Mamba heads (each normed, then
    averaged) onto the residual, then the MLP half; shared by the
    training and decode paths."""
    fused = 0.5 * (
        apply_norm(params["norm_attn"], a, cfg.norm_type, cfg.norm_eps)
        + apply_norm(params["norm_mamba"], m, cfg.norm_type, cfg.norm_eps))
    x = x + fused
    h2 = apply_norm(params["ln2"], x, cfg.norm_type, cfg.norm_eps)
    return x + mlp_mod.apply_mlp(params["mlp"], h2, cfg.mlp_type)


def apply_block(params: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                *, positions: torch.Tensor,
                impl: Optional[str] = None) -> torch.Tensor:
    """Training / full forward of one block over (B, S, D)."""
    check_kind(kind)
    h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
    if kind == "mlstm":
        return x + _channel_cell(params["cell"], h, cfg, "mlstm", impl=impl)
    if kind == "slstm":
        return x + _channel_cell(params["cell"], h, cfg, "slstm")
    a = attn_mod.apply_attention(params["attn"], h, cfg, positions=positions,
                                 window=_window(cfg, kind), impl=impl)
    if kind in HYMBA_KINDS:
        m = _channel_cell(params["mamba"], h, cfg, "mamba")
        return _hymba_tail(params, x, a, m, cfg)
    return _attn_block_tail(params, x, a, cfg, kind)


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
    return _attn_block_tail(params, x, a, cfg, kind), cache


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
    return _attn_block_tail(params, x, a, cfg, kind), cache


def apply_block_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                       kind: str, cache, *, pos: int,
                       impl: Optional[str] = None):
    """Dense-cache one-token decode: x (B, 1, D), ``pos`` the scalar
    position shared by every row (recurrent kinds carry their state in
    ``cache`` and ignore it).  Under a mesh with a model axis the
    attention kinds decode from their slice of the cache's sequence."""
    mesh = current_mesh()
    check_mesh_decode(kind, mesh.shape.get("model", 1) if mesh else 1)
    h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
    if kind == "mlstm":
        y, cache = ssm_mod.apply_mlstm(params["cell"], h, cfg, state=cache,
                                       decode=True)
        return x + y, cache
    if kind == "slstm":
        y, cache = ssm_mod.apply_slstm(params["cell"], h, cfg, state=cache,
                                       decode=True)
        return x + y, cache
    if kind in HYMBA_KINDS:
        a, kv = attn_mod.apply_attention_decode(
            params["attn"], h, cfg, cache["kv"], pos=pos,
            window=_window(cfg, kind), impl=impl)
        m, mstate = ssm_mod.apply_mamba(params["mamba"], h, cfg,
                                        state=cache["mamba"], decode=True)
        return _hymba_tail(params, x, a, m, cfg), {"kv": kv,
                                                   "mamba": mstate}
    a, cache = attn_mod.apply_attention_decode(
        params["attn"], h, cfg, cache, pos=pos, window=_window(cfg, kind),
        impl=impl)
    return _attn_block_tail(params, x, a, cfg, kind), cache
