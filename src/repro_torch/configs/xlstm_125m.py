"""xlstm-125m [ssm] -- sLSTM + mLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H (kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks carry
their own up/down projections (proj factor 2) instead of a separate FFN.
Block pattern follows the paper's mostly-mLSTM ratio: one sLSTM block per
six layers (layers 2 and 8 here).
"""
from repro_torch.config import ModelConfig, register


def config() -> ModelConfig:
    pattern = ["mlstm"] * 12
    pattern[2] = "slstm"
    pattern[8] = "slstm"
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab_size=50304,
        block_pattern=tuple(pattern),
        rope_type="none",
        norm_type="layernorm",
        mlp_type="gelu",
        tie_embeddings=True,
    )


register("xlstm-125m", config)
