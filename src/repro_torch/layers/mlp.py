"""Dense MLP blocks: SwiGLU / GeGLU / GELU (the non-tensor-parallel path).

``jax.nn.gelu`` is the tanh approximation, hence ``approximate="tanh"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers import common


def init_mlp(gen: torch.Generator, d: int, f: int, mlp_type: str,
             dtype: torch.dtype) -> dict:
    p = {"w_up": common.dense_init(gen, d, f, dtype),
         "w_down": common.dense_init(gen, f, d, dtype)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = common.dense_init(gen, d, f, dtype)
    return p


def apply_mlp(params: dict, x: torch.Tensor,
              mlp_type: str = "swiglu") -> torch.Tensor:
    h = common.dense(x, params["w_up"])
    if mlp_type == "swiglu":
        h = F.silu(common.dense(x, params["w_gate"])) * h
    elif mlp_type == "geglu":
        h = F.gelu(common.dense(x, params["w_gate"]), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return common.dense(h, params["w_down"])
