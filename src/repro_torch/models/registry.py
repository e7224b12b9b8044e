"""Model factory: config -> model object (LM or EncDec)."""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None,
                parallel: Optional[ParallelConfig] = None
                ) -> Union[LM, EncDec]:
    """The model for ``cfg`` on ``device`` (default ``"cuda"``; raises
    without a GPU unless the caller passes ``device="cpu"``): an
    ``EncDec`` for an encoder-decoder config, else an ``LM``."""
    if cfg.is_encoder_decoder:
        return EncDec(cfg, device=device, parallel=parallel)
    return LM(cfg, device=device, parallel=parallel)
