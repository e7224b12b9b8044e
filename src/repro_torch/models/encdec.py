"""Encoder-decoder model (whisper-small backbone), the JAX package's
``models/encdec.py``.

Encoder: bidirectional attention blocks over stub frame embeddings (the
conv frontend is a linear adapter, ``layers/frontend.py``).  Decoder:
causal self-attention, cross-attention over the encoder states, MLP.
Decoder positions are sinusoidal (``sinusoid``), as in JAX.

Each stack is a plain Python list of per-layer parameter trees (the JAX
package stacks them and runs ``lax.scan``):

    {"frontend": {...}, "embedding": {...}, "enc_blocks": [...],
     "enc_norm": {...}, "dec_blocks": [...], "final_norm": {...}}

The model lives on ``device`` -- ``"cuda"`` unless the caller passes
another (the tests pass ``"cpu"``).  On CUDA tensors every attention (the
encoder's, the decoder's causal self-attention and its cross-attention)
runs ``fastattn_fwd.cu`` and a decode step's self-attention
``flash_decode.cu``; ``impl="reference"`` runs the plain versions.
``parallel.remat`` "full" (and "selective", which runs as "full")
recomputes each block in the backward through ``torch.utils.checkpoint``.

Under an active training mesh (``sharding.rules.axis_rules(mesh=...)``,
entered by the train step) ``apply`` and ``loss`` run one rank's share,
as ``LM``'s do: its rows of the batch, of the frames and of the decoder
tokens, against its pieces of every parameter (``param_specs``).  Each
block gathers its weights over the model axis (again in the backward's
recompute under remat); the encoder's self-attention is context-parallel
and non-causal (the rank's frames against every frame), the decoder's
causal at the rank's q_offset; the frontend's position rows and the
decoder's sinusoids start at the rank's global offset; each
cross-attention gathers its K and V of every frame
(``attention.project_cross_kv``) for the rank's decoder rows.

Dense decode under a mesh (``init_cache``, ``decode_step``) holds the
rule table's slice of the cache: each self cache's B / data rows and S /
model positions (``kv_seq -> model``), each cross K/V's B / data rows
and every encoder frame.  Each rank decodes its rows with every block's
weights gathered: self-attention context-parallel over its model group,
cross-attention whole.

Not ported: the paged engine, which JAX cannot run on this model either
(``EngineCore`` refuses it).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.device import (check_generator, resolve_device,
                                torch_dtype)
from repro_torch.layers import attention as attn_mod
from repro_torch.layers import mlp as mlp_mod
from repro_torch.layers.common import device_of
from repro_torch.layers.embedding import (embed_tokens, embedding_logical,
                                          init_embedding, lm_logits)
from repro_torch.layers.frontend import (apply_frontend, frontend_logical,
                                         init_frontend)
from repro_torch.layers.norms import apply_norm, init_norm, norm_logical
from repro_torch.models.sharded import MeshModel
from repro_torch.sharding import collectives as C


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions (B, S) -> (B, S, d) float32 embedding, ``[sin | cos]``
    concatenated; frequencies exp(-log(1e4) * i / max(d/2 - 1, 1)), every
    step in float32 as in JAX."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    log1e4 = torch.tensor(10000.0, device=positions.device).log()
    freqs = torch.exp(-log1e4 * i / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_enc_block(gen: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype) -> dict:
    d, dev = cfg.d_model, device_of(gen)
    return {"ln1": init_norm(d, cfg.norm_type, dtype, dev),
            "attn": attn_mod.init_attention(gen, cfg, dtype),
            "ln2": init_norm(d, cfg.norm_type, dtype, dev),
            "mlp": mlp_mod.init_mlp(gen, d, cfg.d_ff, cfg.mlp_type, dtype)}


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype) -> dict:
    d, dev = cfg.d_model, device_of(gen)
    return {"ln1": init_norm(d, cfg.norm_type, dtype, dev),
            "self_attn": attn_mod.init_attention(gen, cfg, dtype),
            "ln_x": init_norm(d, cfg.norm_type, dtype, dev),
            "cross_attn": attn_mod.init_attention(gen, cfg, dtype),
            "ln2": init_norm(d, cfg.norm_type, dtype, dev),
            "mlp": mlp_mod.init_mlp(gen, d, cfg.d_ff, cfg.mlp_type, dtype)}


def _block_logical_enc(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": norm_logical(d, cfg.norm_type),
            "attn": attn_mod.attention_logical(cfg),
            "ln2": norm_logical(d, cfg.norm_type),
            "mlp": mlp_mod.mlp_logical(d, cfg.d_ff, cfg.mlp_type)}


def _block_logical_dec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": norm_logical(d, cfg.norm_type),
            "self_attn": attn_mod.attention_logical(cfg),
            "ln_x": norm_logical(d, cfg.norm_type),
            "cross_attn": attn_mod.attention_logical(cfg),
            "ln2": norm_logical(d, cfg.norm_type),
            "mlp": mlp_mod.mlp_logical(d, cfg.d_ff, cfg.mlp_type)}


class EncDec(MeshModel):
    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 parallel: Optional[ParallelConfig] = None):
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
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
        from the same distributions as the JAX package's ``EncDec.init``.
        On the meta device ``gen=None`` draws nothing: every leaf is made
        with its shape and dtype (the counterpart of JAX's
        ``jax.eval_shape(model.init, key)``)."""
        check_generator(gen, self.device)
        cfg = self.cfg
        dtype = torch_dtype(cfg.param_dtype)
        return {
            "frontend": init_frontend(gen, cfg, dtype),
            "embedding": init_embedding(gen, cfg, dtype),
            "enc_blocks": [_init_enc_block(gen, cfg, dtype)
                           for _ in range(cfg.encoder_layers)],
            "enc_norm": init_norm(cfg.d_model, cfg.norm_type, dtype,
                                  self.device),
            "dec_blocks": [_init_dec_block(gen, cfg, dtype)
                           for _ in range(cfg.num_layers)],
            "final_norm": init_norm(cfg.d_model, cfg.norm_type, dtype,
                                    self.device),
        }

    def logical(self) -> dict:
        """Logical axes of every leaf of ``init``'s tree (the port's
        layout: a list of per-layer trees where JAX stacks the layers)."""
        cfg = self.cfg
        return {
            "frontend": frontend_logical(cfg),
            "embedding": embedding_logical(cfg),
            "enc_blocks": [_block_logical_enc(cfg)
                           for _ in range(cfg.encoder_layers)],
            "enc_norm": norm_logical(cfg.d_model, cfg.norm_type),
            "dec_blocks": [_block_logical_dec(cfg)
                           for _ in range(cfg.num_layers)],
            "final_norm": norm_logical(cfg.d_model, cfg.norm_type),
        }

    def encode(self, params: dict, enc_embeds: torch.Tensor, *,
               impl: Optional[str] = None) -> torch.Tensor:
        """enc_embeds (B, S_enc, D) frame embeddings -> encoder states
        (B, S_enc, D) in ``cfg.dtype``; under a mesh the rank's frames
        and their states."""
        return self._encode(self._whole(params, ("frontend", "enc_norm")),
                            enc_embeds, impl)

    def _encode(self, params: dict, enc_embeds: torch.Tensor,
                impl: Optional[str]) -> torch.Tensor:
        cfg = self.cfg
        mesh = self._mesh()
        b, s = enc_embeds.shape[:2]
        s0 = self._offset(mesh, s)
        # the rank's frames take the position rows at their global offset
        kw = {} if mesh is None else dict(
            seq_len=s * mesh.shape.get("model", 1), offset=s0)
        x = apply_frontend(params["frontend"],
                           enc_embeds.to(torch_dtype(cfg.dtype)), cfg, **kw)
        pos = torch.arange(s0, s0 + s, device=x.device).expand(b, s)

        def block(i, p, x):
            h = apply_norm(p["ln1"], x, cfg.norm_type, cfg.norm_eps)
            x = x + attn_mod.apply_attention(p["attn"], h, cfg, positions=pos,
                                             causal=False, impl=impl)
            h = apply_norm(p["ln2"], x, cfg.norm_type, cfg.norm_eps)
            return x + mlp_mod.apply_mlp(p["mlp"], h, cfg.mlp_type)

        x = self._run_blocks(params, "enc_blocks", block, x)
        return apply_norm(params["enc_norm"], x, cfg.norm_type, cfg.norm_eps)

    def decode_states(self, params: dict, tokens: torch.Tensor,
                      enc_out: torch.Tensor, *,
                      impl: Optional[str] = None) -> torch.Tensor:
        """Teacher-forced decoder: tokens (B, S) against the encoder
        states -> final-norm hidden states (B, S, D).  Each block projects
        its cross K/V from ``enc_out`` itself.  Under a mesh the rank's
        tokens (at their global positions) against its rows of the
        encoder states."""
        return self._decode_states(
            self._whole(params, ("embedding", "final_norm")), tokens,
            enc_out, impl)

    def _decode_states(self, params: dict, tokens: torch.Tensor,
                       enc_out: torch.Tensor,
                       impl: Optional[str]) -> torch.Tensor:
        cfg = self.cfg
        mesh = self._mesh()
        x = embed_tokens(params["embedding"], tokens, cfg)
        b, s = x.shape[:2]
        s0 = self._offset(mesh, s)
        pos = torch.arange(s0, s0 + s, device=x.device).expand(b, s)
        x = x + sinusoid(pos, cfg.d_model).to(x.dtype)

        def block(i, p, x, enc_out):
            h = apply_norm(p["ln1"], x, cfg.norm_type, cfg.norm_eps)
            x = x + attn_mod.apply_attention(p["self_attn"], h, cfg,
                                             positions=pos, impl=impl)
            h = apply_norm(p["ln_x"], x, cfg.norm_type, cfg.norm_eps)
            ek, ev = attn_mod.project_cross_kv(p["cross_attn"], enc_out, cfg)
            x = x + attn_mod.apply_cross_attention(p["cross_attn"], h, ek, ev,
                                                   cfg, impl=impl)
            h = apply_norm(p["ln2"], x, cfg.norm_type, cfg.norm_eps)
            return x + mlp_mod.apply_mlp(p["mlp"], h, cfg.mlp_type)

        x = self._run_blocks(params, "dec_blocks", block, x, enc_out)
        return apply_norm(params["final_norm"], x, cfg.norm_type,
                          cfg.norm_eps)

    def apply(self, params: dict, enc_embeds: torch.Tensor,
              dec_tokens: torch.Tensor, *,
              impl: Optional[str] = None) -> torch.Tensor:
        """Encode, then decode teacher-forced: logits (B, S, V).  Under a
        mesh: the rank's rows of the batch, of the frames and of the
        decoder tokens; its logits."""
        params = self._whole(params, ("frontend", "embedding", "enc_norm",
                                      "final_norm"))
        enc_out = self._encode(params, enc_embeds, impl)
        x = self._decode_states(params, dec_tokens, enc_out, impl)
        return lm_logits(params["embedding"], x, self.cfg)

    def loss(self, params: dict, enc_embeds: torch.Tensor,
             dec_tokens: torch.Tensor, labels: torch.Tensor, *,
             impl: Optional[str] = None) -> torch.Tensor:
        """Mean next-token cross entropy; labels < 0 are masked.  Under a
        mesh: this rank's share of the global batch's mean -- its summed
        nll over the masked count of every rank (``MeshModel._mean_nll``)."""
        return self._mean_nll(
            self.apply(params, enc_embeds, dec_tokens, impl=impl), labels)

    # ------------------------------------------------------------------
    # serving: a self-attention KV cache and the cross K/V per layer
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, *,
                   enc_out: Optional[torch.Tensor] = None,
                   params: Optional[dict] = None) -> dict:
        """``{"self": [KVCache], "cross": [(k, v)]}``, one entry a decoder
        layer, on the model's device.  With ``enc_out`` (and ``params``)
        each layer's cross K/V are projected once from it
        (``project_cross_kv``); without, they are zeros of
        ``encoder_seq`` rows (one tensor, shared: the cache never writes
        them), as JAX's dense engine runs the model.  Under a mesh: the
        rank's slice (whole along a dim the mesh does not divide, as in
        ``LM.init_cache``), ``params`` its pieces and ``enc_out`` the
        states of its rows and frames (``encode``'s), whose K/V are
        gathered over the frames."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        mesh = self._mesh()
        if mesh is not None:
            self._cache_seq = max_seq
            _, batch = self._decode_rows(mesh, batch)
            if self._kv_split(mesh):
                max_seq //= mesh.shape["model"]
        self_kv = [attn_mod.init_kv_cache(cfg, batch, max_seq, dtype,
                                          self.device)
                   for _ in range(cfg.num_layers)]
        if enc_out is not None:
            cross = [attn_mod.project_cross_kv(p["cross_attn"], enc_out, cfg)
                     for p in self._dec_blocks(params)]
        else:
            z = torch.zeros((batch, cfg.encoder_seq, cfg.num_kv_heads,
                             cfg.head_dim), dtype=dtype, device=self.device)
            cross = [(z, z)] * cfg.num_layers
        return {"self": self_kv, "cross": cross}

    def _dec_blocks(self, params: dict):
        """The decoder blocks' weights, each gathered whole under a mesh
        when it is reached."""
        mesh = self._mesh()
        if mesh is None:
            yield from params["dec_blocks"]
            return
        specs = self.param_specs(mesh)["dec_blocks"]
        for p, spec in zip(params["dec_blocks"], specs, strict=True):
            yield C.gather_tree(p, spec, mesh)

    def cache_logical(self, batch: int, max_seq: int) -> dict:
        """Logical axes of every leaf of ``init_cache``'s tree (each
        layer's cross (k, v) a KVCache here: the rule functions walk
        NamedTuples, not plain tuples)."""
        cfg = self.cfg
        kvshape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        crshape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        kv_ax = ("batch", "kv_seq", "heads", None)
        cr_ax = ("batch", None, "heads", None)
        return {"self": [attn_mod.KVCache(k=(kv_ax, kvshape),
                                          v=(kv_ax, kvshape))
                         for _ in range(cfg.num_layers)],
                "cross": [attn_mod.KVCache(k=(cr_ax, crshape),
                                           v=(cr_ax, crshape))
                          for _ in range(cfg.num_layers)]}

    def decode_step(self, params: dict, token: torch.Tensor, cache: dict,
                    pos: int, *, impl: Optional[str] = None):
        """One decoder token.  token: (B,) int; pos: the scalar position
        shared by every row.  Each layer writes its self-attention K/V row
        at ``pos`` in place and attends to the cross K/V.  Returns
        (logits (B, V), cache).  Under a mesh ``token`` is the whole
        batch and ``cache`` the rank's slice (``init_cache``): the rank
        decodes its rows, each block on its weights gathered whole, and
        returns its rows' logits."""
        cfg = self.cfg
        mesh = self._mesh()
        split = True
        if mesh is not None:
            split = self._kv_split(mesh)
            r0, rows = self._decode_rows(mesh, token.shape[0])
            token = token[r0:r0 + rows]
            params = self._whole(params, ("embedding", "final_norm"))
        x = embed_tokens(params["embedding"], token[:, None], cfg)
        b = x.shape[0]
        posv = torch.full((b, 1), int(pos), device=x.device)
        x = x + sinusoid(posv, cfg.d_model).to(x.dtype)
        new_kv = []
        for p, kv, (ck, cv) in zip(self._dec_blocks(params), cache["self"],
                                   cache["cross"]):
            h = apply_norm(p["ln1"], x, cfg.norm_type, cfg.norm_eps)
            a, kv = attn_mod.apply_attention_decode(
                p["self_attn"], h, cfg, kv, pos=pos, impl=impl, split=split)
            x = x + a
            new_kv.append(kv)
            h = apply_norm(p["ln_x"], x, cfg.norm_type, cfg.norm_eps)
            x = x + attn_mod.apply_cross_attention(p["cross_attn"], h, ck, cv,
                                                   cfg, impl=impl)
            h = apply_norm(p["ln2"], x, cfg.norm_type, cfg.norm_eps)
            x = x + mlp_mod.apply_mlp(p["mlp"], h, cfg.mlp_type)
        x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        logits = lm_logits(params["embedding"], x, cfg)
        return logits[:, 0], {"self": new_kv, "cross": cache["cross"]}
