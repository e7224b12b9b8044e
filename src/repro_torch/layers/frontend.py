"""Modality frontend stubs: a linear adapter from precomputed frame (or
patch) embeddings into d_model, the JAX package's ``layers/frontend.py``.

The adapter is a bias-free d_model x d_model dense; ``pos_embed`` holds
``encoder_seq`` rows for the audio stub (1 otherwise), drawn N(0, 1) x
0.02 in float32 and cast, and is added only to an input with exactly
that many rows -- an input of any other length gets no positions, as in
JAX.  A text model has no frontend (``{}``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers import common


def _rows(cfg: ModelConfig) -> int:
    return cfg.encoder_seq if cfg.modality == "audio_stub" else 1


def init_frontend(gen: torch.Generator, cfg: ModelConfig,
                  dtype: torch.dtype) -> dict:
    if cfg.modality == "text":
        return {}
    d = cfg.d_model
    pos = common.normal(gen, (_rows(cfg), d)) * 0.02
    return {"adapter": common.dense_init(gen, d, d, dtype),
            "pos_embed": pos.to(dtype)}


def frontend_logical(cfg: ModelConfig) -> dict:
    if cfg.modality == "text":
        return {}
    d = cfg.d_model
    return {"adapter": (("d_model", None), (d, d)),
            "pos_embed": ((None, "d_model"), (_rows(cfg), d))}


def apply_frontend(params: dict, embeds: torch.Tensor, cfg: ModelConfig,
                   seq_len: Optional[int] = None,
                   offset: int = 0) -> torch.Tensor:
    """embeds: precomputed (B, S, D) frame/patch embeddings.  ``seq_len``
    (default S) is the whole input's length where ``embeds`` holds one
    rank's rows of the sequence, from row ``offset`` on: the whole length
    decides whether the position rows apply, and the rank's rows take
    theirs at their global offset."""
    x = common.dense(embeds, params["adapter"])
    pe = params["pos_embed"]
    if pe.shape[0] == (x.shape[1] if seq_len is None else seq_len):
        x = x + pe[offset:offset + x.shape[1]][None].to(x.dtype)
    return x
