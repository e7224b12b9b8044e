"""Token embedding + LM head."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers.common import normal


def init_embedding(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> dict:
    """Same distributions as the JAX package's ``init_embedding``."""
    scale = cfg.d_model ** -0.5
    p = {"embed": (normal(gen, (cfg.vocab_size, cfg.d_model))
                   * scale).to(dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = (normal(gen, (cfg.d_model, cfg.vocab_size))
                        * scale).to(dtype)
    return p


def embedding_logical(cfg: ModelConfig) -> dict:
    p = {"embed": (("vocab", "d_model"), (cfg.vocab_size, cfg.d_model))}
    if not cfg.tie_embeddings:
        p["lm_head"] = (("d_model", "vocab"),
                        (cfg.d_model, cfg.vocab_size))
    return p


def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embed_scale:
        # the scale is rounded to the activation dtype first, as in JAX
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def lm_logits(params: dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w.to(x.dtype)
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
