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
the backward's recompute under remat), the embedding and LM head (and a
vision model's frontend) are gathered once, and attention is
context-parallel (``layers/attention.py``).  The gathers' gradients come back to each
rank as its piece of the sum over the model axis.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.layers.embedding import (embed_tokens, embedding_logical,
                                          init_embedding, lm_logits)
from repro_torch.layers.frontend import (apply_frontend, frontend_logical,
                                         init_frontend)
from repro_torch.layers.norms import apply_norm, init_norm, norm_logical
from repro_torch.models import blocks as B
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (axis_rules, current_mesh,
                                        current_rules, param_sharding_tree)

RECURRENT_KINDS = ("mlstm", "slstm", "hymba", "hymba_local")


def check_model_axis(cfg: ModelConfig, model: int) -> None:
    """The model axis shards attention blocks only: the recurrent cells'
    ``channels -> model`` layout (mLSTM / sLSTM, hymba's Mamba heads) and
    the experts' ``expert -> model`` (expert parallelism) are not
    ported."""
    if model <= 1:
        return
    kinds = set(cfg.blocks())
    if kinds & set(RECURRENT_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: a model axis of {model} over recurrent blocks "
            f"({', '.join(sorted(kinds & set(RECURRENT_KINDS)))}: their "
            "channels -> model layout) is not ported; use data "
            "parallelism")
    if "moe" in kinds:
        raise NotImplementedError(
            f"{cfg.name}: a model axis of {model} over moe blocks (expert "
            "parallelism, expert -> model) is not ported; use data "
            "parallelism")


class LM:
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
        check_model_axis(cfg, self.parallel.model)
        self.device = resolve_device(device)
        self._specs: dict = {}

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the model's device seeded with ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator) -> dict:
        """Random parameters from ``gen`` (on the model's device), drawn
        from the same distributions as the JAX package's ``LM.init``."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
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

    def param_specs(self, mesh) -> dict:
        """``param_sharding_tree`` of ``logical()`` on ``mesh`` (cached
        per mesh shape)."""
        key = (mesh.axis_names, tuple(mesh.shape.values()))
        if key not in self._specs:
            self._specs[key] = param_sharding_tree(self.logical(), mesh)
        return self._specs[key]

    def _mesh(self):
        """The active training mesh of more than one rank, or None."""
        mesh = current_mesh()
        if mesh is None or mesh.world == 1:
            return None
        check_model_axis(self.cfg, mesh.shape.get("model", 1))
        return mesh

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
        mesh = self._mesh()
        specs = self.param_specs(mesh)["layers"] if mesh else None
        remat = self.parallel.remat != "none" and torch.is_grad_enabled()
        for i, (kind, bp) in enumerate(zip(cfg.blocks(), params["layers"])):
            def run(h, bp=bp, kind=kind, i=i):
                if mesh is None:
                    return B.apply_block(bp, h, cfg, kind,
                                         positions=positions, impl=impl)
                # entered here again: the backward's recompute may run on
                # autograd's device thread, which has no context of ours
                with axis_rules(current_rules(), mesh):
                    return B.apply_block(C.gather_tree(bp, specs[i], mesh),
                                         h, cfg, kind, positions=positions,
                                         impl=impl)
            x = checkpoint(run, x, use_reentrant=False) if remat else run(x)
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
        specs = self.param_specs(mesh) if mesh is not None else None
        emb = params["embedding"]
        if mesh is not None:
            emb = C.gather_tree(emb, specs["embedding"], mesh)
        if inputs_embeds is not None:
            x = inputs_embeds.to(torch_dtype(cfg.dtype))
            if "frontend" in params:
                front = params["frontend"]
                if mesh is not None:
                    front = C.gather_tree(front, specs["frontend"], mesh)
                n_model = mesh.shape.get("model", 1) if mesh else 1
                x = apply_frontend(front, x, cfg,
                                   seq_len=x.shape[1] * n_model)
        else:
            x = embed_tokens(emb, tokens, cfg)
        if positions is None:
            b, s = x.shape[:2]
            s0 = mesh.coords.get("model", 0) * s if mesh else 0
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
        logits = self.apply(params, tokens, inputs_embeds=inputs_embeds,
                            positions=positions, impl=impl).float()
        mask = labels >= 0
        lab = torch.clamp(labels, min=0).long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        nll = (logz - gold) * mask
        count = mask.sum()
        mesh = self._mesh()
        if mesh is not None:
            C.all_reduce(count, mesh.group(mesh.axis_names))
        return nll.sum() / torch.clamp(count, min=1)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> List:
        """Per-layer dense decode caches on the model's device: KV caches
        (``layers/attention.KV_CACHE_LAYOUT``) for attention blocks, the
        float32 recurrent state for mlstm / slstm blocks, and for hymba
        blocks ``{"kv": KV cache, "mamba": MambaState}``."""
        dtype = torch_dtype(self.cfg.dtype)
        return [B.init_block_cache(self.cfg, kind, batch, max_seq, dtype,
                                   self.device)
                for kind in self.cfg.blocks()]

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
                         block_fn: Callable):
        """Thread (x, cache) through every layer, final-norm and project
        to logits.  ``block_fn(block_params, x, kind, block_cache) ->
        (x, block_cache)`` supplies the per-block forward.
        x: (B, S, D) embedded input; returns (logits (B, S, V), cache)."""
        cfg = self.cfg
        new_cache = []
        for kind, bp, bc in zip(cfg.blocks(), params["layers"], cache):
            x, bc = block_fn(bp, x, kind, bc)
            new_cache.append(bc)
        x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        return lm_logits(params["embedding"], x, cfg), new_cache

    def decode_step(self, params: dict, token: torch.Tensor, cache: List,
                    pos: int, *, impl: Optional[str] = None):
        """Dense-cache decode step.  token: (B,) int; pos: the scalar
        position shared by every row.  Each attention layer writes its K/V
        row at ``pos`` in place; a recurrent layer returns its new state.
        Returns (logits (B, V), cache)."""
        def block_fn(bp, x, kind, bc):
            return B.apply_block_decode(bp, x, self.cfg, kind, bc, pos=pos,
                                        impl=impl)
        x = embed_tokens(params["embedding"], token[:, None], self.cfg)
        logits, cache = self._cached_segments(params, x, cache, block_fn)
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
