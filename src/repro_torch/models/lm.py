"""Decoder-only language model: training forward, dense-cache decode and
paged serving (attention and mixture-of-experts models; the xLSTM and
hymba blocks decode from their recurrent state -- hymba's beside its KV
cache -- and have no paged path).  A vision-stub model (qwen2-vl) also
takes precomputed patch embeddings through its frontend, with M-RoPE's
(3, B, S) positions; serving treats its requests as text.

Layers are a plain Python list (the JAX package stacked repeating units
and ran them under ``lax.scan``; eager PyTorch needs neither).  Parameters
are nested dicts of tensors:

    {"embedding": {"embed", ["lm_head"]}, "final_norm": {...},
     ["frontend": {"adapter", "pos_embed"}], "layers": [block params, ...]}

The model lives on ``device`` -- ``"cuda"`` unless the caller passes
another (the tests pass ``"cpu"``).  ``parallel.remat`` "full" (and
"selective", which runs as "full") recomputes each block in the backward
through ``torch.utils.checkpoint``.

Under an active training mesh (``sharding.rules.axis_rules(mesh=...)``,
entered by the train step) ``apply`` and ``loss`` run one rank's share:
its rows of the batch and of the sequence, against its pieces of every
parameter (``param_specs``: the JAX rule table's layout).  Each block
gathers its sharded weights over the model axis before use (again in
the backward's recompute under remat) -- but for the leaves a rank runs
as its own pieces (``blocks.local_leaves``): a MoE block's experts
sharded over the model axis (expert parallelism, ``blocks._moe_ffn``)
and a recurrent cell's channel pieces, ``channels -> model`` (the
mLSTM's and sLSTM's heads, hymba's Mamba channels: the cell runs the
rank's share on the gathered rows, ``blocks._channel_cell``).  The
embedding and LM head (and a vision model's frontend) are gathered
once, and attention is context-parallel (``layers/attention.py``).
The gathers' gradients come back to each rank as its piece of the sum
over the model axis.

Dense decode under a mesh (``init_cache``, ``decode_step``) holds the
rule table's slice of every cache: B / data rows, S / model positions of
each KV cache (``kv_seq -> model``) and C / model channels of each
recurrent state (``channels -> model``: Mamba's DI, the mLSTM's dv, the
sLSTM's DI; a dim the model axis does not divide stays whole).  Each
rank decodes its rows with every block's weights gathered (but a MoE
block's experts sharded over the model axis) and merges attention, the
cells' channels and the experts' combines over its model group
(``blocks.apply_block_decode``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.device import (check_generator, resolve_device,
                                torch_dtype)
from repro_torch.layers.embedding import (embed_tokens, embedding_logical,
                                          init_embedding, lm_logits)
from repro_torch.layers.frontend import (apply_frontend, frontend_logical,
                                         init_frontend)
from repro_torch.layers.norms import apply_norm, init_norm, norm_logical
from repro_torch.models import blocks as B
from repro_torch.models.sharded import MeshModel
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import param_sharding_tree


def _block_leaves(bp: dict, spec: dict, mesh, cfg: ModelConfig,
                  kind: str, decode: bool = False) -> dict:
    """A block's weights as it runs them under ``mesh`` (in training, or
    at ``decode``): every sharded leaf gathered whole, but those it runs
    as this rank's pieces (``blocks.local_leaves``: a MoE block's experts
    sharded over the model axis, a training cell's channel pieces) stay
    this rank's."""
    local = B.local_leaves(cfg, kind, spec, mesh.shape.get("model", 1),
                           decode)
    out = C.gather_tree({k: v for k, v in bp.items() if k not in local},
                        spec, mesh)
    for sub, keys in local.items():
        out[sub] = {k: v if k in keys else C.gather_leaf(v, spec[sub][k], mesh)
                    for k, v in bp[sub].items()}
    return out


class LM(MeshModel):
    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 parallel: Optional[ParallelConfig] = None):
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{cfg.name}: only decoder-only models are an LM (an "
                "encoder-decoder config builds an EncDec)")
        for kind in set(cfg.blocks()):
            B.check_kind(kind)
        self.cfg = cfg
        self.parallel = parallel or ParallelConfig()
        self.device = resolve_device(device)
        self._specs: dict = {}
        self._cache_seq: Optional[int] = None

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the model's device seeded with ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    # ------------------------------------------------------------------
    def init(self, gen: Optional[torch.Generator] = None) -> dict:
        """Random parameters from ``gen`` (on the model's device), drawn
        from the same distributions as the JAX package's ``LM.init``.
        On the meta device ``gen=None`` draws nothing: every leaf is made
        with its shape and dtype (the counterpart of JAX's
        ``jax.eval_shape(model.init, key)``)."""
        check_generator(gen, self.device)
        cfg = self.cfg
        dtype = torch_dtype(cfg.param_dtype)
        params = {"embedding": init_embedding(gen, cfg, dtype),
                  "final_norm": init_norm(cfg.d_model, cfg.norm_type, dtype,
                                          self.device)}
        if cfg.modality != "text":
            params["frontend"] = init_frontend(gen, cfg, dtype)
        params["layers"] = [B.init_block(gen, cfg, kind, dtype)
                            for kind in cfg.blocks()]
        return params

    # ------------------------------------------------------------------
    # logical axes and the rank's layout
    # ------------------------------------------------------------------
    def logical(self) -> dict:
        """Logical axes of every leaf of ``init``'s tree (the port's
        layout: a list of per-layer trees where JAX stacks segments)."""
        cfg = self.cfg
        tree = {"embedding": embedding_logical(cfg),
                "final_norm": norm_logical(cfg.d_model, cfg.norm_type)}
        if cfg.modality != "text":
            tree["frontend"] = frontend_logical(cfg)
        tree["layers"] = [B.block_logical(cfg, kind)
                          for kind in cfg.blocks()]
        return tree

    def cache_logical(self, batch: int, max_seq: int) -> List:
        """Logical axes of every leaf of ``init_cache``'s list."""
        return [B.block_cache_logical(self.cfg, kind, batch, max_seq)
                for kind in self.cfg.blocks()]

    # ------------------------------------------------------------------
    # training / full forward
    # ------------------------------------------------------------------
    def hidden_states(self, params: dict, x: torch.Tensor, *,
                      positions: torch.Tensor,
                      impl: Optional[str] = None) -> torch.Tensor:
        """Backbone forward: embedded input (B, S, D) -> final-norm hidden
        states.  Under remat each block is recomputed in the backward, so
        its attention or mLSTM kernel launches twice per step.  Under a
        mesh each block first gathers its sharded weights."""
        cfg = self.cfg
        kinds = cfg.blocks()

        def block(i, bp, h):
            return B.apply_block(bp, h, cfg, kinds[i], positions=positions,
                                 impl=impl)

        def leaves(i, bp, spec, mesh):
            return _block_leaves(bp, spec, mesh, cfg, kinds[i])
        x = self._run_blocks(params, "layers", block, x, leaves=leaves)
        return apply_norm(params["final_norm"], x, cfg.norm_type,
                          cfg.norm_eps)

    def apply(self, params: dict, tokens: Optional[torch.Tensor] = None, *,
              inputs_embeds: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None,
              impl: Optional[str] = None) -> torch.Tensor:
        """Forward to logits.  tokens: (B, S) int, or inputs_embeds
        (B, S, D) precomputed patch embeddings for the vision stub (through
        the frontend); returns (B, S, V).  positions: (B, S), or (3, B, S)
        for M-RoPE; by default each row's index (t = h = w for M-RoPE).
        Under a mesh: this rank's rows of the batch and of the sequence,
        positions (by default) their global ones."""
        cfg = self.cfg
        mesh = self._mesh()
        params = self._whole(params, ("embedding", "frontend"))
        emb = params["embedding"]
        if inputs_embeds is not None:
            x = inputs_embeds.to(torch_dtype(cfg.dtype))
            if "frontend" in params:
                s = x.shape[1]
                n_model = mesh.shape.get("model", 1) if mesh else 1
                x = apply_frontend(params["frontend"], x, cfg,
                                   seq_len=s * n_model,
                                   offset=self._offset(mesh, s))
        else:
            x = embed_tokens(emb, tokens, cfg)
        if positions is None:
            b, s = x.shape[:2]
            s0 = self._offset(mesh, s)
            positions = torch.arange(s0, s0 + s,
                                     device=x.device).expand(b, s)
            if cfg.rope_type == "mrope":
                positions = positions.expand(3, b, s)
        x = self.hidden_states(params, x, positions=positions, impl=impl)
        return lm_logits(emb, x, cfg)

    def loss(self, params: dict, tokens: Optional[torch.Tensor],
             labels: torch.Tensor, *,
             inputs_embeds: Optional[torch.Tensor] = None,
             positions: Optional[torch.Tensor] = None,
             impl: Optional[str] = None) -> torch.Tensor:
        """Mean next-token cross entropy; labels < 0 are masked.  The
        input is ``tokens``, or ``inputs_embeds`` and ``positions`` as in
        ``apply``.  Under a mesh: this rank's share of the global batch's
        mean -- its summed nll over the masked count of every rank -- so
        that the ranks' shares (and their gradients) sum to the mean."""
        return self._mean_nll(self.apply(
            params, tokens, inputs_embeds=inputs_embeds, positions=positions,
            impl=impl), labels)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> List:
        """Per-layer dense decode caches on the model's device: KV caches
        (``layers/attention.KV_CACHE_LAYOUT``) for attention blocks, the
        float32 recurrent state for mlstm / slstm blocks, and for hymba
        blocks ``{"kv": KV cache, "mamba": MambaState}``.  Under a mesh:
        this rank's slice of each, the rule table's slice of
        ``cache_logical`` -- whole along a dim the mesh does not divide:
        the batch over dp (``_decode_rows``), a KV cache's positions over
        the model axis (``_kv_split``)."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        mesh = self._mesh()
        specs = [None] * cfg.num_layers
        if mesh is not None:
            self._cache_seq = max_seq
            specs = param_sharding_tree(self.cache_logical(batch, max_seq),
                                        mesh)
        return [B.init_block_cache(cfg, kind, batch, max_seq, dtype,
                                   self.device, spec, mesh)
                for kind, spec in zip(cfg.blocks(), specs)]

    def init_paged_cache(self, num_pages: int, page_size: int) -> List:
        """Per-layer KV page pools (no batch dim -- the serving page
        manager owns the page table that carves the pools into
        per-sequence caches).  Raises NotImplementedError for models with
        recurrent (mlstm / slstm / hymba) blocks, as the JAX package
        does.  Under
        an active tensor-parallel context each pool is this rank's share,
        (Hkv/g, P, page_size/s, D) (``sharding/tp.local_pool_shape``)."""
        dtype = torch_dtype(self.cfg.dtype)
        return [B.init_block_pages(self.cfg, kind, num_pages, page_size,
                                   dtype, self.device)
                for kind in self.cfg.blocks()]

    def _cached_segments(self, params: dict, x: torch.Tensor, cache: List,
                         block_fn: Callable,
                         leaves: Optional[Callable] = None):
        """Thread (x, cache) through every layer, final-norm and project
        to logits.  ``block_fn(block_params, x, kind, block_cache) ->
        (x, block_cache)`` supplies the per-block forward, on
        ``leaves(i, block_params)`` where given (a mesh's gathered
        weights).  x: (B, S, D) embedded input; returns (logits (B, S, V),
        cache)."""
        cfg = self.cfg
        new_cache = []
        for i, (kind, bp, bc) in enumerate(zip(cfg.blocks(),
                                               params["layers"], cache)):
            if leaves is not None:
                bp = leaves(i, bp)
            x, bc = block_fn(bp, x, kind, bc)
            new_cache.append(bc)
        x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        return lm_logits(params["embedding"], x, cfg), new_cache

    def decode_step(self, params: dict, token: torch.Tensor, cache: List,
                    pos: int, *, impl: Optional[str] = None):
        """Dense-cache decode step.  token: (B,) int; pos: the scalar
        position shared by every row.  Each attention layer writes its K/V
        row at ``pos`` in place; a recurrent layer returns its new state.
        Returns (logits (B, V), cache).

        Under a mesh ``token`` is the whole batch and ``cache`` this
        rank's slice (``init_cache``): the rank decodes its rows of the
        batch (every row where dp does not divide the batch), each block
        on its weights gathered whole, and returns its rows' logits."""
        cfg = self.cfg
        mesh = self._mesh()
        leaves, split = None, True
        if mesh is not None:
            split = self._kv_split(mesh)
            r0, rows = self._decode_rows(mesh, token.shape[0])
            token = token[r0:r0 + rows]
            params = self._whole(params, ("embedding",))
            specs = self.param_specs(mesh)["layers"]
            kinds = cfg.blocks()

            def leaves(i, bp):
                return _block_leaves(bp, specs[i], mesh, cfg, kinds[i],
                                     decode=True)

        def block_fn(bp, x, kind, bc):
            return B.apply_block_decode(bp, x, cfg, kind, bc, pos=pos,
                                        impl=impl, kv_split=split)
        x = embed_tokens(params["embedding"], token[:, None], cfg)
        logits, cache = self._cached_segments(params, x, cache, block_fn,
                                              leaves)
        return logits[:, 0], cache

    def decode_step_paged(self, params: dict, token: torch.Tensor,
                          cache: List, page_table: torch.Tensor,
                          pos: torch.Tensor, *, impl: Optional[str] = None):
        """Paged decode step.  token: (B,) int; pos: (B,) int32
        per-sequence positions (ragged batch); page_table: (B, n_kv)
        int32.  Returns (logits (B, V), cache) with cache = the pools."""
        def block_fn(bp, x, kind, bc):
            return B.apply_block_decode_paged(
                bp, x, self.cfg, kind, bc, page_table=page_table, pos=pos,
                impl=impl)
        x = embed_tokens(params["embedding"], token[:, None], self.cfg)
        logits, cache = self._cached_segments(params, x, cache, block_fn)
        return logits[:, 0], cache

    def prefill_chunk_paged(self, params: dict, tokens: torch.Tensor,
                            cache: List, page_table: torch.Tensor,
                            pos_start: torch.Tensor, n_valid: torch.Tensor,
                            *, impl: Optional[str] = None):
        """Chunked paged prefill: one fixed-size prompt chunk through the
        full transformer forward, writing K/V into the paged pools.

        tokens: (B, C) int chunk (padded past ``n_valid``); page_table:
        (B, n_kv) int32; pos_start / n_valid: (B,) int32 runtime offsets.
        Returns (logits (B, C, V), cache); logit rows past ``n_valid`` are
        garbage (their K/V went to the scratch page).
        """
        def block_fn(bp, x, kind, bc):
            return B.apply_block_prefill_paged(
                bp, x, self.cfg, kind, bc, page_table=page_table,
                pos_start=pos_start, n_valid=n_valid, impl=impl)
        x = embed_tokens(params["embedding"], tokens, self.cfg)
        return self._cached_segments(params, x, cache, block_fn)
