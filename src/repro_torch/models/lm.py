"""Decoder-only language model: training forward, dense-cache decode and
paged serving (attention models; the xLSTM blocks decode from their
recurrent state and have no paged path).

Layers are a plain Python list (the JAX package stacked repeating units
and ran them under ``lax.scan``; eager PyTorch needs neither).  Parameters
are nested dicts of tensors:

    {"embedding": {"embed", ["lm_head"]}, "final_norm": {...},
     "layers": [block params, ...]}

The model lives on ``device`` -- ``"cuda"`` unless the caller passes
another (the tests pass ``"cpu"``).  ``parallel.remat`` "full" (and
"selective", which runs as "full") recomputes each block in the backward
through ``torch.utils.checkpoint``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.layers.embedding import (embed_tokens, init_embedding,
                                          lm_logits)
from repro_torch.layers.norms import apply_norm, init_norm
from repro_torch.models import blocks as B


class LM:
    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 parallel: Optional[ParallelConfig] = None):
        if cfg.modality != "text" or cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{cfg.name}: only text decoder-only models are ported")
        for kind in set(cfg.blocks()):
            B.check_kind(kind)
        self.cfg = cfg
        self.parallel = parallel or ParallelConfig()
        self.device = resolve_device(device)

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
        return {
            "embedding": init_embedding(gen, cfg, dtype),
            "final_norm": init_norm(cfg.d_model, cfg.norm_type, dtype,
                                    self.device),
            "layers": [B.init_block(gen, cfg, kind, dtype)
                       for kind in cfg.blocks()],
        }

    # ------------------------------------------------------------------
    # training / full forward
    # ------------------------------------------------------------------
    def hidden_states(self, params: dict, x: torch.Tensor, *,
                      positions: torch.Tensor,
                      impl: Optional[str] = None) -> torch.Tensor:
        """Backbone forward: embedded input (B, S, D) -> final-norm hidden
        states.  Under remat each block is recomputed in the backward, so
        its attention or mLSTM kernel launches twice per step."""
        cfg = self.cfg
        remat = self.parallel.remat != "none" and torch.is_grad_enabled()
        for kind, bp in zip(cfg.blocks(), params["layers"]):
            def run(h, bp=bp, kind=kind):
                return B.apply_block(bp, h, cfg, kind, positions=positions,
                                     impl=impl)
            x = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        return apply_norm(params["final_norm"], x, cfg.norm_type,
                          cfg.norm_eps)

    def apply(self, params: dict, tokens: torch.Tensor, *,
              positions: Optional[torch.Tensor] = None,
              impl: Optional[str] = None) -> torch.Tensor:
        """Forward to logits.  tokens: (B, S) int; returns (B, S, V)."""
        x = embed_tokens(params["embedding"], tokens, self.cfg)
        if positions is None:
            b, s = tokens.shape
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self.hidden_states(params, x, positions=positions, impl=impl)
        return lm_logits(params["embedding"], x, self.cfg)

    def loss(self, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
             *, impl: Optional[str] = None) -> torch.Tensor:
        """Mean next-token cross entropy; labels < 0 are masked."""
        logits = self.apply(params, tokens, impl=impl).float()
        mask = labels >= 0
        lab = torch.clamp(labels, min=0).long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        nll = (logz - gold) * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> List:
        """Per-layer dense decode caches on the model's device: KV caches
        (``layers/attention.KV_CACHE_LAYOUT``) for attention blocks, the
        float32 recurrent state for mlstm / slstm blocks."""
        dtype = torch_dtype(self.cfg.dtype)
        return [B.init_block_cache(self.cfg, kind, batch, max_seq, dtype,
                                   self.device)
                for kind in self.cfg.blocks()]

    def init_paged_cache(self, num_pages: int, page_size: int) -> List:
        """Per-layer KV page pools (no batch dim -- the serving page
        manager owns the page table that carves the pools into
        per-sequence caches).  Raises NotImplementedError for models with
        recurrent (mlstm / slstm) blocks, as the JAX package does."""
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
