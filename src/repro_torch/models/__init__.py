"""Decoder-only language model on paged KV pools."""
from repro_torch.models.registry import build_model  # noqa: F401
