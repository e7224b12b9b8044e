"""The dry run's abstract inputs: meta tensors (shape and dtype, no
storage) for every argument of the step a cell runs, the port's copy of
the JAX package's ``launch/specs.py`` (``ShapeDtypeStruct`` there).

    train    -> train_step(state, batch)
    prefill  -> apply(params, tokens / embeds)
    decode   -> decode_step(params, token, cache, pos)

``batch_specs`` and ``batch_logical`` are JAX's, entry for entry (the
same dtypes: int32 tokens, labels and M-RoPE positions, bfloat16
embeddings).  The parameters and caches come from the model's own
allocating code on the meta device -- ``init()`` with no generator,
``init_cache`` -- so that what the dry run counts is what the model
allocates.  Under ``axis_rules(mesh=...)`` ``abstract_cache`` is the
rank's slice of every cache leaf, as ``init_cache`` makes it there.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import ModelConfig, ShapeConfig


def meta(shape, dtype: torch.dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on the meta device."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The whole training / prefill batch of an architecture."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        return {"enc_embeds": meta((b, cfg.encoder_seq, cfg.d_model),
                                   torch.bfloat16),
                "tokens": meta((b, s), torch.int32),
                "labels": meta((b, s), torch.int32)}
    if cfg.modality == "vision_stub":
        return {"inputs_embeds": meta((b, s, cfg.d_model), torch.bfloat16),
                "positions": meta((3, b, s), torch.int32),
                "labels": meta((b, s), torch.int32)}
    return {"tokens": meta((b, s), torch.int32),
            "labels": meta((b, s), torch.int32)}


def batch_logical(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Logical axes of the batch (its batch dim over the data axes)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        return {"enc_embeds": (("batch", None, None),
                               (b, cfg.encoder_seq, cfg.d_model)),
                "tokens": (("batch", None), (b, s)),
                "labels": (("batch", None), (b, s))}
    if cfg.modality == "vision_stub":
        return {"inputs_embeds": (("batch", None, None),
                                  (b, s, cfg.d_model)),
                "positions": ((None, "batch", None), (3, b, s)),
                "labels": (("batch", None), (b, s))}
    return {"tokens": (("batch", None), (b, s)),
            "labels": (("batch", None), (b, s))}


def abstract_params(model) -> Any:
    """The whole parameter tree of a model on the meta device."""
    return model.init()


def abstract_cache(model, batch: int, max_seq: int) -> Any:
    """The dense decode cache of a model on the meta device (an
    encoder-decoder's cross K/V the zeros of ``encoder_seq`` frames)."""
    return model.init_cache(batch, max_seq)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, model):
    """(token (B,) int32, the cache, pos: a scalar int32)."""
    b, s = shape.global_batch, shape.seq_len
    return (meta((b,), torch.int32), abstract_cache(model, b, s),
            meta((), torch.int32))
