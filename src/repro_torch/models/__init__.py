"""Decoder-only language model: training forward and paged serving."""
from repro_torch.models.registry import build_model  # noqa: F401
