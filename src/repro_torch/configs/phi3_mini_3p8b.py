"""phi3-mini-3.8b [dense] -- RoPE SwiGLU GQA [arXiv:2404.14219].

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
"""
from repro_torch.config import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        block_pattern=("attn",),
        mlp_type="swiglu",
        norm_type="rmsnorm",
        tie_embeddings=False,
    )


register("phi3-mini-3.8b", config)
