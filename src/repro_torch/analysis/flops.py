"""Analytic parameter model: the port's own copy of the JAX package's
``analysis/flops.py`` ``_block_params`` / ``param_count``, formula for
formula (``tests/test_torch_offload.py`` holds the two equal).  The
offload planner (``core/offload.py``) reads it.  The FLOP models of that
module (``model_flops``, ``attention_flops``) are not copied: nothing in
the port calls them.
"""
from __future__ import annotations

from repro_torch.config import ModelConfig


def _block_params(cfg: ModelConfig, kind: str, active_only: bool) -> int:
    d = cfg.d_model
    h = cfg.q_dim
    kv = cfg.kv_dim
    n = 0
    if kind in ("attn", "attn_local", "moe", "hymba", "hymba_local"):
        n += d * h + 2 * d * kv + h * d          # Wq, Wk, Wv, Wo
        if cfg.qkv_bias:
            n += h + 2 * kv
    if kind in ("hymba", "hymba_local"):
        # mamba branch: in-proj (x,z), conv, dt/B/C projections, out-proj
        dn = cfg.ssm_state_size
        n += d * h * 2                            # in proj (x and gate)
        n += h * cfg.conv_kernel                  # depthwise conv
        n += h * (2 * dn + 1) + h                 # B, C, dt proj + A diag
        n += h * d                                # out proj
    if kind in ("attn", "attn_local", "hymba", "hymba_local"):
        f = cfg.d_ff
        if f:
            mult = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
            n += mult * d * f
    if kind == "moe":
        f = cfg.moe_dff or cfg.d_ff               # the JAX expert_dff
        mult = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        n += d * cfg.num_experts                  # router
        e = cfg.num_experts_per_tok if active_only else cfg.num_experts
        n += e * mult * d * f
    if kind == "mlstm":
        pf = cfg.mlstm_proj_factor
        di = int(d * pf)
        n += 2 * d * di                           # up (cell input + gate)
        n += 3 * di                               # i,f,o gate vectors
        # the JAX model's placeholder term, kept for equal counts
        n += 3 * di * di // max(cfg.num_heads, 1) * cfg.num_heads \
            // cfg.num_heads
        n += di * d                               # down-proj
        n += 3 * di * di                          # q,k,v projections
    if kind == "slstm":
        pf = cfg.mlstm_proj_factor
        di = int(d * pf)
        n += 2 * d * di + di * d
        n += 4 * di * di // max(1, cfg.num_heads)  # recurrent, per head
        n += 4 * di                                # gate biases
    # norms
    n += 2 * d
    return n


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    n = cfg.vocab_size * cfg.d_model              # embedding
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model         # lm head
    for kind in cfg.blocks():
        n += _block_params(cfg, kind, active_only)
    if cfg.is_encoder_decoder:
        for _ in range(cfg.encoder_layers):
            n += _block_params(cfg, "attn", active_only)
        # cross attention in the decoder, counted once per decoder layer
        n += cfg.num_layers * (2 * cfg.d_model * cfg.q_dim
                               + 2 * cfg.d_model * cfg.kv_dim)
    n += cfg.d_model                              # final norm
    return n
