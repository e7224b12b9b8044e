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
(``_channel_cell``).  Dense decode under such a mesh runs each block on
the rank's slice of its cache, the rule table's (``block_cache_logical``):
attention over its slice of the KV cache's sequence, a recurrent cell on
its slice of the state's channels (``_cell_decode``), a MoE FFN on the
rank's experts (``_moe_ffn``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers import attention as attn_mod
from repro_torch.layers import mlp as mlp_mod
from repro_torch.layers import moe as moe_mod
from repro_torch.layers import ssm as ssm_mod
from repro_torch.layers.common import device_of
from repro_torch.layers.norms import apply_norm, init_norm, norm_logical
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (current_mesh, is_spec, local_shape,
                                        map_tree)

# the kinds whose cache is a KV cache: they serve paged
ATTN_KINDS = ("attn", "attn_local", "moe")
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
    d, dev = cfg.d_model, device_of(gen)
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


def _cache_leaves(cfg: ModelConfig, kind: str, batch: int, max_seq: int):
    """Every leaf of a block's dense decode cache as (logical axes, shape,
    fill, float32): a KVCache for attention kinds, the float32 recurrent
    state for mlstm / slstm (``max_seq`` unused), and ``{"kv": KVCache,
    "mamba": MambaState}`` for hymba kinds (the Mamba state's h float32,
    its conv history in the model's dtype)."""
    check_kind(kind)

    def f32(axes, shape, fill=0.0):
        return (axes, shape, fill, True)
    if kind == "mlstm":
        di = ssm_mod._di(cfg)
        nh = cfg.num_heads
        hd = di // nh
        return ssm_mod.MLSTMState(
            c=f32(("batch", None, None, "channels"), (batch, nh, hd, hd)),
            n=f32(("batch", None, None), (batch, nh, hd)),
            m=f32(("batch", None), (batch, nh), -1e30),
            conv=((None,), (0,), 0.0, False))
    if kind == "slstm":
        s2 = (("batch", "channels"), (batch, ssm_mod._di(cfg)))
        return ssm_mod.SLSTMState(c=f32(*s2), n=f32(*s2), h=f32(*s2),
                                  m=f32(*s2, -1e30))
    # attn_mod.KV_CACHE_LAYOUT == "bshd"
    kvshape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    axes = ("batch", "kv_seq", "heads", None)
    kv = attn_mod.KVCache(k=(axes, kvshape, 0.0, False),
                          v=(axes, kvshape, 0.0, False))
    if kind in HYMBA_KINDS:
        di, n = cfg.q_dim, cfg.ssm_state_size
        return {"kv": kv, "mamba": ssm_mod.MambaState(
            h=f32(("batch", "channels", None), (batch, di, n)),
            conv=(("batch", None, "channels"),
                  (batch, cfg.conv_kernel - 1, di), 0.0, False))}
    return kv


def _is_cache_leaf(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") \
        and len(x) == 4


def block_cache_logical(cfg: ModelConfig, kind: str, batch: int,
                        max_seq: int):
    """Logical axes of every leaf of ``init_block_cache``'s tree."""
    return map_tree(lambda leaf: leaf[:2],
                    _cache_leaves(cfg, kind, batch, max_seq), _is_cache_leaf)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype: torch.dtype, device: torch.device,
                     spec=None, mesh=None):
    """A block's dense decode cache (``_cache_leaves``), every leaf in
    ``dtype`` but the float32 state.  With ``spec`` (the block's entry of
    ``param_sharding_tree(cache_logical)``) and ``mesh``: each leaf is
    this rank's slice of it."""
    specs: list = []
    if spec is not None:
        map_tree(specs.append, spec, is_spec)
    specs = iter(specs)

    def alloc(leaf):
        _, shape, fill, f32 = leaf
        if spec is not None:
            shape = local_shape(shape, next(specs), mesh)
        return torch.full(shape, fill, device=device,
                          dtype=torch.float32 if f32 else dtype)
    return map_tree(alloc, _cache_leaves(cfg, kind, batch, max_seq),
                    _is_cache_leaf)


def init_block_pages(cfg: ModelConfig, kind: str, num_pages: int,
                     page_size: int, dtype: torch.dtype,
                     device: torch.device) -> attn_mod.KVCache:
    _check_paged(kind)
    return attn_mod.init_kv_pages(cfg, num_pages, page_size, dtype, device)


def _attn_block_tail(params: dict, x: torch.Tensor, a: torch.Tensor,
                     cfg: ModelConfig, kind: str,
                     decode: bool = False) -> torch.Tensor:
    """Residual + FFN half of an attention block, shared by the training,
    prefill and decode paths so they cannot diverge (``decode``: a dense
    decode step, whose rows a mesh's model ranks share)."""
    if cfg.post_norm:
        a = apply_norm(params["ln1_post"], a, cfg.norm_type, cfg.norm_eps)
    x = x + a
    h2 = apply_norm(params["ln2"], x, cfg.norm_type, cfg.norm_eps)
    if kind == "moe":
        f = _moe_ffn(params["moe"], h2, cfg, decode)
    else:
        f = mlp_mod.apply_mlp(params["mlp"], h2, cfg.mlp_type)
    if cfg.post_norm:
        f = apply_norm(params["ln2_post"], f, cfg.norm_type, cfg.norm_eps)
    return x + f


def _moe_ffn(params: dict, h2: torch.Tensor, cfg: ModelConfig,
             decode: bool = False) -> torch.Tensor:
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
    runs every expert and keeps its rows.

    At ``decode`` the model ranks of a row group hold the same rows, so
    nothing is gathered: each routes them whole and runs its experts'
    slots, the unsummed slots of the ranks (``combine``'s ``slots``: at
    most one rank's is nonzero) are summed exactly over the model group,
    and each token's k outputs are summed in one device's order -- the
    block's output bit for bit."""
    mesh = current_mesh()
    n = mesh.shape.get("model", 1) if mesh is not None else 1
    el = params["w_up"].shape[0]
    if n == 1 or (decode and el == cfg.num_experts):
        return moe_mod.apply_moe(params, h2, cfg)
    group = mesh.group(("model",))
    m, s = mesh.coords["model"], h2.shape[1]
    if decode:
        part = moe_mod.apply_moe(params, h2, cfg,
                                 experts=(m * el, (m + 1) * el), slots=True)
        whole = C.all_reduce(part.float(), group).to(h2.dtype)
        return moe_mod.sum_slots(lambda j: whole[..., j, :], whole.shape[-2])
    whole = C.gather(h2, 1, group)
    if el == cfg.num_experts:
        return moe_mod.apply_moe(params, whole, cfg)[:, m * s:(m + 1) * s]
    part = moe_mod.apply_moe(params, whole, cfg,
                             experts=(m * el, (m + 1) * el))
    return C.scatter(part, 1, group)


def local_leaves(cfg: ModelConfig, kind: str, spec: dict, model: int,
                 decode: bool = False) -> dict:
    """The leaves of a block that a rank runs as its own pieces under a
    model axis of ``model`` (subtree -> leaf names; every other leaf is
    gathered whole): a MoE block's expert leaves sharded over the model
    axis (``_moe_ffn``), and in training a recurrent cell's
    ``ssm.LOCAL_LEAVES`` where the model axis splits its recurrence
    (``_channel_cell``).  A decoding cell runs its slice of the state's
    channels, which those pieces do not match (the mLSTM's are heads, its
    state's dv within each head): it takes every leaf whole."""
    if kind == "moe":
        return {"moe": {k for k, s in spec["moe"].items()
                        if s[:1] == ("model",)}}
    if kind in CELLS and model > 1 and not decode:
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


def _cell_decode(params: dict, h: torch.Tensor, cfg: ModelConfig,
                 cell: str, state, logical):
    """One decode step of the recurrent ``cell`` from ``state``, whose
    logical axes and whole shapes are ``logical`` (its entry of
    ``block_cache_logical``).  Where the state's channel dim is narrower
    than the whole (the rule table's ``channels -> model`` under a mesh
    whose model axis divides it) the state is the rank's slice, and
    ``ssm``'s ``<cell>_decode`` steps it, all-gathering what the cell
    mixes across channels; otherwise the rank steps the whole state, as
    one device does."""
    axes, shape = logical[0]
    dim = axes.index("channels")
    step = getattr(ssm_mod, f"{cell}_decode")
    if state[0].shape[dim] == shape[dim]:
        return step(params, h, cfg, state)
    mesh = current_mesh()
    group = mesh.group(("model",))
    return step(params, h, cfg, state,
                (mesh.coords["model"], mesh.shape["model"]),
                lambda t: C.all_gather_dim(t, t.dim() - 1, group))


def apply_block_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                       kind: str, cache, *, pos: int,
                       impl: Optional[str] = None, kv_split: bool = True):
    """Dense-cache one-token decode: x (B, 1, D), ``pos`` the scalar
    position shared by every row (recurrent kinds carry their state in
    ``cache`` and ignore it).  Under a mesh with a model axis each block
    decodes from the rank's slice of its cache: attention from its slice
    of the KV cache's sequence (or, without ``kv_split``, from the whole
    cache every model rank holds), a recurrent cell from its slice of the
    state's channels (``_cell_decode``), a MoE FFN through the rank's
    experts."""
    check_kind(kind)
    h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
    logical = block_cache_logical(cfg, kind, 1, 1)
    if kind in ("mlstm", "slstm"):
        y, cache = _cell_decode(params["cell"], h, cfg, kind, cache,
                                logical)
        return x + y, cache
    if kind in HYMBA_KINDS:
        a, kv = attn_mod.apply_attention_decode(
            params["attn"], h, cfg, cache["kv"], pos=pos,
            window=_window(cfg, kind), impl=impl, split=kv_split)
        m, mstate = _cell_decode(params["mamba"], h, cfg, "mamba",
                                 cache["mamba"], logical["mamba"])
        return _hymba_tail(params, x, a, m, cfg), {"kv": kv,
                                                   "mamba": mstate}
    a, cache = attn_mod.apply_attention_decode(
        params["attn"], h, cfg, cache, pos=pos, window=_window(cfg, kind),
        impl=impl, split=kv_split)
    return _attn_block_tail(params, x, a, cfg, kind, decode=True), cache
