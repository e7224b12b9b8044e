"""RMSNorm / LayerNorm (f32 statistics, cast back to activation dtype)."""
from __future__ import annotations

import torch


def init_norm(d: int, norm_type: str, dtype: torch.dtype,
              device: torch.device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_logical(d: int, norm_type: str) -> dict:
    p = {"scale": (("d_model",), (d,))}
    if norm_type == "layernorm":
        p["bias"] = (("d_model",), (d,))
    return p


def apply_norm(params: dict, x: torch.Tensor, norm_type: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if norm_type == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * (var + eps) ** -0.5 * params["scale"].float()
        return y.to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * (var + eps) ** -0.5
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)
