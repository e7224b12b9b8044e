"""qwen2.5-32b [dense] -- GQA, QKV bias [hf:Qwen/Qwen2.5-*].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from repro_torch.config import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=27648,
        vocab_size=152064,
        block_pattern=("attn",),
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        tie_embeddings=False,
    )


register("qwen2.5-32b", config)
