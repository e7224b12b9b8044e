"""Dense MLP blocks: SwiGLU / GeGLU / GELU, column->row parallel on
``ff`` under tensor parallelism.

``jax.nn.gelu`` is the tanh approximation, hence ``approximate="tanh"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tiled_allreduce import matmul_allreduce
from repro_torch.layers import common
from repro_torch.sharding.tp import current_tp


def init_mlp(gen: torch.Generator, d: int, f: int, mlp_type: str,
             dtype: torch.dtype) -> dict:
    p = {"w_up": common.dense_init(gen, d, f, dtype),
         "w_down": common.dense_init(gen, f, d, dtype)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = common.dense_init(gen, d, f, dtype)
    return p


def mlp_logical(d: int, f: int, mlp_type: str) -> dict:
    p = {"w_up": (("d_model", "ff"), (d, f)),
         "w_down": (("ff", "d_model"), (f, d))}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = (("d_model", "ff"), (d, f))
    return p


def apply_mlp(params: dict, x: torch.Tensor,
              mlp_type: str = "swiglu") -> torch.Tensor:
    """Under an active tensor-parallel context whose plan shards the MLP
    (``TPContext.shard_mlp``), ``params`` hold this rank's 1/tp of the
    up/gate columns and down rows (``shard_params``): the activation
    runs on the rank's ff slice and the down-proj partial sums
    all-reduce over every rank with the tiling-AllReduce.  Otherwise
    every rank runs the MLP whole."""
    h = common.dense(x, params["w_up"])
    if mlp_type == "swiglu":
        h = F.silu(common.dense(x, params["w_gate"])) * h
    elif mlp_type == "geglu":
        h = F.gelu(common.dense(x, params["w_gate"]), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    tpc = current_tp()
    if tpc is None or not tpc.shard_mlp:
        return common.dense(h, params["w_down"])
    plan = tpc.plan
    b, s, f = h.shape
    y = matmul_allreduce(h.reshape(b * s, f), params["w_down"].to(h.dtype),
                         tpc.world_group, mode=plan.collectives,
                         n_chunks=plan.ar_chunks,
                         first_chunk_frac=plan.first_chunk_frac)
    return y.reshape(b, s, -1)
