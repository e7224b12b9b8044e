"""Model factory: config -> model object."""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.models.lm import LM


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None,
                parallel: Optional[ParallelConfig] = None) -> LM:
    """The model for ``cfg`` on ``device`` (default ``"cuda"``; raises
    without a GPU unless the caller passes ``device="cpu"``)."""
    return LM(cfg, device=device, parallel=parallel)
