"""Rotary position embeddings (split-half rotation): standard RoPE and
Qwen2-VL's M-RoPE.

M-RoPE splits the head_dim/2 frequency channels into (temporal, height,
width) sections; positions are (3, B, S) -- text tokens use t=h=w=index,
vision patch tokens their 3-D coordinates (the caller supplies them).
At t=h=w it computes what ``apply_rope`` does, bit for bit.
"""
from __future__ import annotations

from typing import Sequence

import torch


def rope_freqs(head_dim: int, theta: float = 10_000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, sin: torch.Tensor,
            cos: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)             # (D/2,)
    angles = positions[..., None].float() * freqs             # (B,S,D/2)
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    return _rotate(x.float(), sin, cos).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, *,
                sections: Sequence[int],
                theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions3: (3, B, S) int (t, h, w)."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    freqs = rope_freqs(d, theta, device=x.device)             # (D/2,)
    # section s of the frequency channels uses position component s
    comp = torch.cat([torch.full((sec,), i, dtype=torch.long,
                                 device=x.device)
                      for i, sec in enumerate(sections)])
    pos = positions3.index_select(0, comp)                    # (D/2, B, S)
    angles = pos.permute(1, 2, 0).float() * freqs             # (B,S,D/2)
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    return _rotate(x.float(), sin, cos).to(x.dtype)
