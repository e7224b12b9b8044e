"""Recurrent layers: the xLSTM mLSTM and sLSTM blocks.

A copy of the xLSTM half of the JAX package's ``layers/ssm.py``.  The
mLSTM trains and prefills through the chunkwise kernel
(``kernels/mlstm``: the CUDA ``mlstm_chunkwise_fwd`` on the card, the plain
version on the CPU) and decodes through the plain recurrent cell; the
sLSTM runs a Python loop over time steps where the JAX package runs
``lax.scan``.  The ``*_logical`` sharding trees are not ported (the port
runs on one device), and Mamba (hymba's block) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.mlstm import ref as mref
from repro_torch.kernels.mlstm.ops import mlstm_chunkwise
from repro_torch.layers.common import dense, dense_init


# ===========================================================================
# xLSTM mLSTM block
# ===========================================================================

class MLSTMState(NamedTuple):
    c: torch.Tensor          # (B, H, dk, dv)
    n: torch.Tensor          # (B, H, dk)
    m: torch.Tensor          # (B, H)
    conv: torch.Tensor       # placeholder for API symmetry


def _di(cfg: ModelConfig) -> int:
    return int(cfg.d_model * cfg.mlstm_proj_factor)


def init_mlstm(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    d, di, nh = cfg.d_model, _di(cfg), cfg.num_heads
    b_if = torch.cat([torch.zeros((nh,)), torch.full((nh,), 3.0)])
    return {
        "w_up": dense_init(gen, d, di, dtype),
        "w_gate": dense_init(gen, d, di, dtype),
        "wq": dense_init(gen, di, di, dtype),
        "wk": dense_init(gen, di, di, dtype),
        "wv": dense_init(gen, di, di, dtype),
        "w_if": dense_init(gen, di, 2 * nh, dtype),
        "b_if": b_if.to(device=gen.device, dtype=dtype),
        "w_down": dense_init(gen, di, d, dtype, scale=di ** -0.5),
    }


def apply_mlstm(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                chunk: int = 128, state: Optional[MLSTMState] = None,
                decode: bool = False, impl: Optional[str] = None):
    """xLSTM mLSTM block body (norm handled by the caller).  x: (B, S, D).

    Train/prefill (``decode=False``): the chunkwise form through
    ``mlstm_chunkwise`` (``impl`` as there, default ``cfg.attention_impl``)
    reading the (B, S, H, hd) projections in place; returns (B, S, D).
    Decode: the recurrent cell from ``state``; returns (out, new state).
    """
    b, s, _ = x.shape
    di = _di(cfg)
    nh = cfg.num_heads
    hd = di // nh
    xin = dense(x, params["w_up"])
    z = dense(x, params["w_gate"])
    q = dense(xin, params["wq"]).reshape(b, s, nh, hd)
    k = dense(xin, params["wk"]).reshape(b, s, nh, hd)
    v = dense(xin, params["wv"]).reshape(b, s, nh, hd)
    gif = (dense(xin, params["w_if"])
           + params["b_if"].to(x.dtype)).float()
    ig, fg = torch.split(gif, nh, dim=-1)                  # (B, S, H)
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))    # (B, H, S, hd)
    igT, fgT = ig.transpose(1, 2), fg.transpose(1, 2)

    if decode:
        init = None if state is None else (state.c, state.n, state.m)
        h_out, st = mref.mlstm_recurrent(qT, kT, vT, igT, fgT,
                                         initial_state=init)
        new_state = MLSTMState(c=st[0], n=st[1], m=st[2],
                               conv=torch.zeros((0,), dtype=x.dtype,
                                                device=x.device))
    else:
        h_out = mlstm_chunkwise(qT, kT, vT, igT, fgT, chunk,
                                impl=impl or cfg.attention_impl)
    h_out = h_out.transpose(1, 2).reshape(b, s, di).to(x.dtype)
    out = dense(h_out * F.silu(z), params["w_down"])
    if decode:
        return out, new_state
    return out


# ===========================================================================
# xLSTM sLSTM block (inherently sequential: recurrent gate connections)
# ===========================================================================

class SLSTMState(NamedTuple):
    c: torch.Tensor          # (B, DI)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def init_slstm(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    d, di, nh = cfg.d_model, _di(cfg), cfg.num_heads
    hd = di // nh
    dev = gen.device
    return {
        "w_up": dense_init(gen, d, di, dtype),
        "w_gates": dense_init(gen, di, 4 * di, dtype),
        # block-diagonal recurrent weights, one (hd, hd) block per head
        "r_gates": (torch.randn((4, nh, hd, hd), generator=gen, device=dev,
                                dtype=torch.float32)
                    * hd ** -0.5).to(dtype),
        "b_gates": torch.zeros((4 * di,), dtype=dtype, device=dev),
        "w_down": dense_init(gen, di, d, dtype, scale=di ** -0.5),
    }


def apply_slstm(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                state: Optional[SLSTMState] = None, decode: bool = False):
    """xLSTM sLSTM block body.  x: (B, S, D).  A loop over the S time
    steps (each step's gates read the previous step's h through the
    block-diagonal recurrent weights).  Returns (B, S, D), and with
    ``decode`` also the new state."""
    b = x.shape[0]
    di = _di(cfg)
    nh = cfg.num_heads
    hd = di // nh
    xin = dense(x, params["w_up"])
    pre = (dense(xin, params["w_gates"])
           + params["b_gates"].to(x.dtype)).float()       # (B, S, 4 DI)

    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        c, n, h = (torch.zeros((b, di), **f32) for _ in range(3))
        m = torch.full((b, di), -1e30, **f32)
    else:
        c, n, h, m = state

    # (4, NH, hd, hd) -> (NH, hd, 4 hd): one batched product a step gives
    # every head's four gate inputs, laid out (B, 4, NH, hd) like ``pre``
    r = params["r_gates"].float().permute(1, 2, 0, 3).reshape(nh, hd, 4 * hd)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    hs = []
    # unbind, not pre[:, t]: the backward of one slice a step would build
    # and add a full (B, S, 4 DI) gradient every step
    for pre_t in pre.unbind(1):
        rec = torch.bmm(h.reshape(b, nh, hd).transpose(0, 1), r)
        rec = rec.reshape(nh, b, 4, hd).permute(1, 2, 0, 3).reshape(b, 4 * di)
        zi, ii, fi, oi = torch.split(pre_t + rec, di, dim=-1)
        zt = torch.tanh(zi)
        o = torch.sigmoid(oi)
        logf = F.logsigmoid(fi)
        m_new = torch.maximum(logf + m, ii)
        i_p = torch.exp(ii - m_new)
        f_p = torch.exp(logf + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = o * c / torch.maximum(torch.abs(n), one)
        m = m_new
        hs.append(h)
    out = dense(torch.stack(hs, dim=1).to(x.dtype), params["w_down"])
    if decode:
        return out, SLSTMState(c=c, n=n, h=h, m=m)
    return out
