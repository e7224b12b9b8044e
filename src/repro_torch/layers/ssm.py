"""Recurrent layers: Mamba (S6, hymba's parallel head) and the xLSTM
mLSTM and sLSTM blocks.

A copy of the JAX package's ``layers/ssm.py``.  Mamba's selective scan is
plain PyTorch, as the JAX package computes it outside any kernel: within
a chunk a log-depth (Hillis-Steele) scan with JAX's combine over the
per-step (decay, drive) pairs, chunks in order carrying the state.  The
mLSTM trains and prefills through the chunkwise kernel
(``kernels/mlstm``: the CUDA ``mlstm_chunkwise_fwd`` on the card, the plain
version on the CPU) and decodes through the plain recurrent cell; the
sLSTM runs a Python loop over time steps where the JAX package runs
``lax.scan``.  The ``*_logical`` sharding trees are the JAX package's.

Each cell decodes through ``<cell>_decode`` (steps from a state, which
returns the new one).  Under a mesh's model axis a cell trains on the
rank's channels or heads (``apply_<cell>``'s ``part``) and decodes on
the rank's slice of its state's channels (``<cell>_decode``'s ``part``:
the rule table's ``channels -> model`` on the decode cache,
``models/blocks.block_cache_logical``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.mlstm import ref as mref
from repro_torch.kernels.mlstm.ops import mlstm_chunkwise
from repro_torch.layers.common import dense, dense_init, device_of, normal

# the leaves a rank holds and uses as its own pieces of the channel dim
# under ``part`` (each cell's other leaves arrive whole)
LOCAL_LEAVES = {"mamba": ("dt_bias", "a_log", "d_skip", "w_out"),
                "mlstm": ("w_gate", "wq", "wk", "wv", "w_down"),
                "slstm": ("w_down",)}


def channel_shards(cfg: ModelConfig, cell: str, n: int) -> bool:
    """Whether ``n`` ranks split ``cell``'s recurrence: Mamba's channels
    are independent (diagonal A), so n must divide DI; the mLSTM and
    sLSTM mix within a head, so n must divide the heads.  Otherwise
    every rank runs the whole cell."""
    if cell == "mamba":
        return cfg.q_dim % n == 0
    return cfg.num_heads % n == 0


def _whole(t: torch.Tensor) -> torch.Tensor:
    """The ``gather`` of a cell that decodes its whole state."""
    return t


def _span(part: Optional[Tuple[int, int]], width: int) -> slice:
    """Rank m's contiguous share of ``width`` under ``part`` = (m, n)."""
    if part is None:
        return slice(0, width)
    m, n = part
    return slice(m * width // n, (m + 1) * width // n)


# ===========================================================================
# Mamba (S6) -- used by the hymba parallel-head block
# ===========================================================================

class MambaState(NamedTuple):
    h: torch.Tensor          # (B, DI, N) ssm state, float32
    conv: torch.Tensor       # (B, K-1, DI) rolling conv inputs


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    """The JAX package's ``init_mamba``: its distributions from ``gen``,
    its deterministic leaves exactly (``a_log`` stays float32)."""
    d, di = cfg.d_model, cfg.q_dim          # channels mirror attention heads
    n, kconv = cfg.ssm_state_size, cfg.conv_kernel
    dev = device_of(gen)
    w_in = dense_init(gen, d, 2 * di, dtype)
    conv_w = (normal(gen, (kconv, di)) * kconv ** -0.5).to(dtype)
    w_bc = dense_init(gen, di, 2 * n, dtype)
    w_dt = dense_init(gen, di, di, dtype, scale=di ** -0.5)
    w_out = dense_init(gen, di, d, dtype, scale=di ** -0.5)
    # log(1..N) rounded once from float64: the same bits on every device
    # (XLA's float32 log on the CPU is one ulp off at 7)
    log_n = torch.log(torch.arange(1, n + 1, dtype=torch.float64)).float()
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "w_bc": w_bc,
        "w_dt": w_dt,
        "dt_bias": torch.full((di,), -4.0, dtype=dtype, device=dev),
        "a_log": log_n.to(dev).expand(di, n).clone(),
        "d_skip": torch.ones((di,), dtype=dtype, device=dev),
        "w_out": w_out,
    }


def mamba_logical(cfg: ModelConfig) -> dict:
    d, di, n, kconv = (cfg.d_model, cfg.q_dim, cfg.ssm_state_size,
                       cfg.conv_kernel)
    return {
        "w_in": (("d_model", "channels"), (d, 2 * di)),
        "conv_w": ((None, "channels"), (kconv, di)),
        "conv_b": (("channels",), (di,)),
        "w_bc": (("channels", None), (di, 2 * n)),
        "w_dt": (("channels", None), (di, di)),
        "dt_bias": (("channels",), (di,)),
        "a_log": (("channels", None), (di, n)),
        "d_skip": (("channels",), (di,)),
        "w_out": (("channels", "d_model"), (di, d)),
    }


def _scan(decay: torch.Tensor, drive: torch.Tensor):
    """Inclusive scan along dim 1 of the pairs (decay, drive) under JAX's
    combine ``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)`` (element 1 the
    earlier): ceil(log2 L) rounds, each combining every position with the
    one ``d`` before it (Hillis-Steele)."""
    length, d = decay.shape[1], 1
    while d < length:
        a_prev, b_prev = decay[:, :-d], drive[:, :-d]
        a_cur, b_cur = decay[:, d:], drive[:, d:]
        drive = torch.cat([drive[:, :d], b_prev * a_cur + b_cur], dim=1)
        decay = torch.cat([decay[:, :d], a_prev * a_cur], dim=1)
        d *= 2
    return decay, drive


def mamba_scan_chunk(h0: torch.Tensor, xc: torch.Tensor, dtc: torch.Tensor,
                     bc: torch.Tensor, cc: torch.Tensor, a: torch.Tensor):
    """The selective scan within one chunk, float32.

    xc, dtc: (B, L, DI); bc, cc: (B, L, N); a: (DI, N); h0: (B, DI, N).
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t;  y_t = h_t C_t.  As JAX: the
    pairs scanned from zero, then ``h = dec * h0 + drv``.  Returns
    (y (B, L, DI), h at the chunk's last step)."""
    decay = torch.exp(dtc[..., None] * a)                   # (B, L, DI, N)
    drive = (dtc * xc)[..., None] * bc[:, :, None, :]       # (B, L, DI, N)
    dec, drv = _scan(decay, drive)
    h = dec * h0[:, None] + drv
    y = torch.einsum("bldn,bln->bld", h, cc)
    return y, h[:, -1]


def _conv(xin_ext: torch.Tensor, conv_w: torch.Tensor,
          conv_b: torch.Tensor, s: int) -> torch.Tensor:
    """The causal depthwise conv over [history | x] (B, K - 1 + S, C) and
    its SiLU, in x's dtype, the K taps summed in order (as JAX)."""
    conv_w = conv_w.to(xin_ext.dtype)                       # (K, C)
    xc = sum(xin_ext[:, i:i + s] * conv_w[i] for i in range(len(conv_w)))
    return F.silu(xc + conv_b.to(xin_ext.dtype))


def apply_mamba(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                chunk: int = 256, state: Optional[MambaState] = None,
                part: Optional[Tuple[int, int]] = None):
    """x: (B, S, D) -> (B, S, D), from ``state`` (zero where None).

    In-projection, a causal depthwise conv over [history | x] in x's
    dtype (the taps summed in order, as JAX), dt / B / C projections, the
    float32 selective scan -- one chunk when S == 1, else chunks of
    ``chunk`` steps with S zero-padded to a multiple (a padded step has
    decay 1 and drive 0) -- the skip, the SiLU gate and the
    out-projection.

    ``part`` = (m, n) (training only): the scan, the skip and the gate
    run over channels [m DI/n, (m+1) DI/n) -- of x, and of z at DI past
    them in ``w_in``'s [x | z] columns -- and the float32 partial
    out-projection is returned (module docstring).  The conv and the dt /
    B / C projections read every channel of xc, so each rank computes
    them whole."""
    b, s, _ = x.shape
    di, n = cfg.q_dim, cfg.ssm_state_size
    kconv = cfg.conv_kernel
    own = _span(part, di)
    xz = dense(x, params["w_in"])
    xin, z = torch.split(xz, di, dim=-1)                    # (B, S, DI)
    z = z[..., own]

    if state is None:
        conv_hist = torch.zeros((b, kconv - 1, di), dtype=xin.dtype,
                                device=x.device)
        h0 = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    else:
        conv_hist, h0 = state.conv, state.h
    h0 = h0[:, own]

    xin_ext = torch.cat([conv_hist, xin], dim=1)
    xc = _conv(xin_ext, params["conv_w"], params["conv_b"], s)

    dt = F.softplus(dense(xc, params["w_dt"][:, own])
                    + params["dt_bias"].to(xc.dtype))
    bc_cc = dense(xc, params["w_bc"]).float()
    bmat, cmat = torch.split(bc_cc, n, dim=-1)
    xc = xc[..., own]
    a = -torch.exp(params["a_log"].float())                 # (DI, N)
    xcf, dtf = xc.float(), dt.float()

    if s == 1:
        y, _ = mamba_scan_chunk(h0, xcf, dtf, bmat, cmat, a)
    else:
        chunk = min(chunk, s)
        pad = (-s) % chunk
        if pad:
            xcf, dtf, bmat, cmat = (F.pad(t, (0, 0, 0, pad))
                                    for t in (xcf, dtf, bmat, cmat))
        h, ys = h0, []
        for j in range(0, s + pad, chunk):
            cut = slice(j, j + chunk)
            y, h = mamba_scan_chunk(h, xcf[:, cut], dtf[:, cut],
                                    bmat[:, cut], cmat[:, cut], a)
            ys.append(y)
        y = torch.cat(ys, dim=1)[:, :s]

    y = y.to(x.dtype) + xc * params["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    if part is not None:
        return dense(y, params["w_out"], dtype=torch.float32)
    return dense(y, params["w_out"])


def mamba_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[MambaState] = None,
                 part: Tuple[int, int] = (0, 1),
                 gather: Callable = _whole):
    """Decode steps of the Mamba cell from ``state`` (zero where None),
    its selective scan one chunk: x (B, S, D) -> (out (B, S, D), the new
    state); every weight whole.

    ``part`` = (m, n): the state holds channels [m DI/n, (m+1) DI/n).
    The conv runs on the rank's channels from their history; dt and B/C
    read every channel of the conv's output, so ``gather`` (an
    all-gather of the last dim over the model ranks) makes it whole and
    they are computed whole, as one device does.  The scan, the skip and
    the gate run on the rank's channels, whose outputs are gathered for
    the whole out-projection."""
    b, s, _ = x.shape
    di, n = cfg.q_dim, cfg.ssm_state_size
    own = _span(part, di)
    xin, z = torch.split(dense(x, params["w_in"]), di, dim=-1)
    if state is None:
        w = own.stop - own.start
        state = MambaState(
            h=torch.zeros((b, w, n), dtype=torch.float32, device=x.device),
            conv=torch.zeros((b, cfg.conv_kernel - 1, w), dtype=xin.dtype,
                             device=x.device))
    xin_ext = torch.cat([state.conv, xin[..., own]], dim=1)
    xc = _conv(xin_ext, params["conv_w"][:, own], params["conv_b"][own], s)
    xc_all = gather(xc)                                     # (B, S, DI)
    dt = F.softplus(dense(xc_all, params["w_dt"])
                    + params["dt_bias"].to(xc.dtype))[..., own]
    bmat, cmat = torch.split(dense(xc_all, params["w_bc"]).float(), n,
                             dim=-1)
    a = -torch.exp(params["a_log"][own].float())
    y, h = mamba_scan_chunk(state.h, xc.float(), dt.float(), bmat, cmat, a)
    y = y.to(x.dtype) + xc * params["d_skip"][own].to(x.dtype)
    y = y * F.silu(z[..., own])
    return dense(gather(y), params["w_out"]), \
        MambaState(h=h, conv=xin_ext[:, s:])


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
        "b_if": b_if.to(device=device_of(gen), dtype=dtype),
        "w_down": dense_init(gen, di, d, dtype, scale=di ** -0.5),
    }


def mlstm_logical(cfg: ModelConfig) -> dict:
    d, di, h = cfg.d_model, _di(cfg), cfg.num_heads
    return {
        "w_up": (("d_model", "channels"), (d, di)),
        "w_gate": (("d_model", "channels"), (d, di)),
        "wq": ((None, "channels"), (di, di)),
        "wk": ((None, "channels"), (di, di)),
        "wv": ((None, "channels"), (di, di)),
        "w_if": (("channels", None), (di, 2 * h)),
        "b_if": ((None,), (2 * h,)),
        "w_down": (("channels", "d_model"), (di, d)),
    }


def apply_mlstm(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                chunk: int = 128, impl: Optional[str] = None,
                part: Optional[Tuple[int, int]] = None):
    """xLSTM mLSTM block body (norm handled by the caller).  x: (B, S, D).

    Train/prefill: the chunkwise form through ``mlstm_chunkwise``
    (``impl`` as there, default ``cfg.attention_impl``) reading the (B,
    S, H, hd) projections in place; returns (B, S, D).  Decode is
    ``mlstm_decode``.

    ``part`` = (m, n) (training only): heads [m H/n, (m+1) H/n) go
    through the kernel -- q, k, v and z from the rank's columns of
    ``wq``, ``wk``, ``wv``, ``w_gate``, its heads' i and f gates from the
    whole ``w_if`` (which mixes every channel of xin into each head) --
    and the float32 partial out-projection over its rows of ``w_down``
    is returned."""
    b, s, _ = x.shape
    di = _di(cfg)
    nh = cfg.num_heads
    hd = di // nh
    heads = _span(part, nh)
    nl = heads.stop - heads.start
    xin = dense(x, params["w_up"])
    z = dense(x, params["w_gate"])
    q = dense(xin, params["wq"]).reshape(b, s, nl, hd)
    k = dense(xin, params["wk"]).reshape(b, s, nl, hd)
    v = dense(xin, params["wv"]).reshape(b, s, nl, hd)
    gif = (dense(xin, params["w_if"])
           + params["b_if"].to(x.dtype)).float()
    ig, fg = torch.split(gif, nh, dim=-1)                  # (B, S, H)
    ig, fg = ig[..., heads], fg[..., heads]
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))    # (B, H, S, hd)
    igT, fgT = ig.transpose(1, 2), fg.transpose(1, 2)

    h_out = mlstm_chunkwise(qT, kT, vT, igT, fgT, chunk,
                            impl=impl or cfg.attention_impl)
    h_out = h_out.transpose(1, 2).reshape(b, s, nl * hd).to(x.dtype)
    if part is not None:
        return dense(h_out * F.silu(z), params["w_down"],
                     dtype=torch.float32)
    return dense(h_out * F.silu(z), params["w_down"])


def mlstm_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[MLSTMState] = None,
                 part: Tuple[int, int] = (0, 1),
                 gather: Callable = _whole):
    """Decode steps of the mLSTM cell through the plain recurrent cell
    from ``state`` (none where None): x (B, S, D) -> (out (B, S, D), the
    new state); every weight whole.

    ``part`` = (m, n): the state holds dv columns [m hd/n, (m+1) hd/n)
    of every head's C beside the whole n and m.  q, k, the gates, n and
    m are computed whole on every rank; v is cut to the rank's columns,
    C and h updated there.  ``gather`` (an all-gather of the last dim
    over the model ranks) makes h whole for the gate and the whole
    out-projection."""
    b, s, _ = x.shape
    di, nh = _di(cfg), cfg.num_heads
    hd = di // nh
    xin = dense(x, params["w_up"])
    z = dense(x, params["w_gate"])
    q, k, v = (dense(xin, params[w]).reshape(b, s, nh, hd).transpose(1, 2)
               for w in ("wq", "wk", "wv"))
    gif = (dense(xin, params["w_if"]) + params["b_if"].to(x.dtype)).float()
    ig, fg = (g.transpose(1, 2) for g in torch.split(gif, nh, dim=-1))
    h_out, (c, n, m) = mref.mlstm_recurrent(
        q, k, v[..., _span(part, hd)], ig, fg,
        initial_state=None if state is None else state[:3])
    h_out = gather(h_out.to(x.dtype))                       # (B, H, S, hd)
    h_out = h_out.transpose(1, 2).reshape(b, s, di)
    return dense(h_out * F.silu(z), params["w_down"]), MLSTMState(
        c=c, n=n, m=m, conv=torch.zeros((0,), dtype=x.dtype,
                                        device=x.device))


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
    dev = device_of(gen)
    return {
        "w_up": dense_init(gen, d, di, dtype),
        "w_gates": dense_init(gen, di, 4 * di, dtype),
        # block-diagonal recurrent weights, one (hd, hd) block per head
        "r_gates": (normal(gen, (4, nh, hd, hd)) * hd ** -0.5).to(dtype),
        "b_gates": torch.zeros((4 * di,), dtype=dtype, device=dev),
        "w_down": dense_init(gen, di, d, dtype, scale=di ** -0.5),
    }


def slstm_logical(cfg: ModelConfig) -> dict:
    d, di, nh = cfg.d_model, _di(cfg), cfg.num_heads
    hd = di // nh
    return {
        "w_up": (("d_model", "channels"), (d, di)),
        "w_gates": (("channels", None), (di, 4 * di)),
        "r_gates": ((None, "heads", None, None), (4, nh, hd, hd)),
        "b_gates": ((None,), (4 * di,)),
        "w_down": (("channels", "d_model"), (di, d)),
    }


def slstm_recurrence(pre: torch.Tensor, r: torch.Tensor,
                     state: Optional[SLSTMState] = None):
    """The sLSTM's loop over time.  pre: (B, S, 4 C) float32 gate inputs
    laid out [z | i | f | o], each C = NH x hd channels wide; r: (4, NH,
    hd, hd) float32 block-diagonal recurrent weights.  Returns (h of every
    step (B, S, C), the final state)."""
    b, c = pre.shape[0], pre.shape[2] // 4
    nh, hd = r.shape[1], r.shape[2]
    if state is None:
        f32 = dict(dtype=torch.float32, device=pre.device)
        cs, n, h = (torch.zeros((b, c), **f32) for _ in range(3))
        m = torch.full((b, c), -1e30, **f32)
    else:
        cs, n, h, m = state

    # (4, NH, hd, hd) -> (NH, hd, 4 hd): one batched product a step gives
    # every head's four gate inputs, laid out (B, 4, NH, hd) like ``pre``
    r = r.permute(1, 2, 0, 3).reshape(nh, hd, 4 * hd)
    one = torch.ones((), dtype=torch.float32, device=pre.device)
    hs = []
    # unbind, not pre[:, t]: the backward of one slice a step would build
    # and add a full (B, S, 4 C) gradient every step
    for pre_t in pre.unbind(1):
        rec = torch.bmm(h.reshape(b, nh, hd).transpose(0, 1), r)
        rec = rec.reshape(nh, b, 4, hd).permute(1, 2, 0, 3).reshape(b, 4 * c)
        zi, ii, fi, oi = torch.split(pre_t + rec, c, dim=-1)
        zt = torch.tanh(zi)
        o = torch.sigmoid(oi)
        logf = F.logsigmoid(fi)
        m_new = torch.maximum(logf + m, ii)
        i_p = torch.exp(ii - m_new)
        f_p = torch.exp(logf + m - m_new)
        cs = f_p * cs + i_p * zt
        n = f_p * n + i_p
        h = o * cs / torch.maximum(torch.abs(n), one)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), SLSTMState(c=cs, n=n, h=h, m=m)


def apply_slstm(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                part: Optional[Tuple[int, int]] = None):
    """xLSTM sLSTM block body.  x: (B, S, D).  A loop over the S time
    steps (each step's gates read the previous step's h through the
    block-diagonal recurrent weights).  Returns (B, S, D); decode is
    ``slstm_decode``.

    ``part`` = (m, n) (training only): the loop walks heads
    [m NH/n, (m+1) NH/n) only, their four gate inputs from the rank's
    four column slices of the whole ``w_gates`` (its [z | i | f | o] each
    DI wide) and their blocks of ``r_gates``, and the float32 partial
    out-projection over the rank's rows of ``w_down`` is returned."""
    di = _di(cfg)
    nh = cfg.num_heads
    own, heads = _span(part, di), _span(part, nh)
    xin = dense(x, params["w_up"])
    w_gates, b_gates = params["w_gates"], params["b_gates"]
    if part is not None:
        w_gates = w_gates.reshape(di, 4, di)[..., own].reshape(di, -1)
        b_gates = b_gates.reshape(4, di)[:, own].reshape(-1)
    pre = (dense(xin, w_gates) + b_gates.to(x.dtype)).float()
    hs, _ = slstm_recurrence(pre, params["r_gates"][:, heads].float())
    if part is not None:
        return dense(hs.to(x.dtype), params["w_down"], dtype=torch.float32)
    return dense(hs.to(x.dtype), params["w_down"])


def slstm_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[SLSTMState] = None,
                 part: Tuple[int, int] = (0, 1),
                 gather: Callable = _whole):
    """Decode steps of the sLSTM cell from ``state`` (zero, m -1e30,
    where None): x (B, S, D) -> (out (B, S, D), the new state); every
    weight whole.

    ``part`` = (m, n): the state holds channels [m DI/n, (m+1) DI/n) of
    its four states.  The gate inputs are computed whole and cut to the
    rank's channels.  Where n divides the heads the loop walks the
    rank's heads (their blocks of ``r_gates``); otherwise the slice cuts
    a head, whose recurrence reads all of its h: the state is gathered
    whole, stepped whole and cut.  ``gather`` is an all-gather of the
    last dim over the model ranks; the new h is gathered for the whole
    out-projection."""
    b, s, _ = x.shape
    di, nh = _di(cfg), cfg.num_heads
    own = _span(part, di)
    xin = dense(x, params["w_up"])
    pre = (dense(xin, params["w_gates"])
           + params["b_gates"].to(x.dtype)).float()         # (B, S, 4 DI)
    r = params["r_gates"].float()
    if nh % part[1] == 0:
        pre = pre.reshape(b, s, 4, di)[..., own].reshape(b, s, -1)
        hs, new = slstm_recurrence(pre, r[:, _span(part, nh)], state)
        return dense(gather(hs.to(x.dtype)), params["w_down"]), new
    whole = SLSTMState(*gather(torch.stack(state)).unbind(0))
    hs, new = slstm_recurrence(pre, r, whole)
    return dense(hs.to(x.dtype), params["w_down"]), \
        SLSTMState(*(t[:, own] for t in new))
