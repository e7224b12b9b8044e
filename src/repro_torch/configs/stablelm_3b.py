"""stablelm-3b [dense] [hf:stabilityai/stablelm-*].

32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.  LayerNorm + SwiGLU,
partial-rotary in the HF model; we use full rotary (head_dim=80).
"""
from repro_torch.config import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab_size=50304,
        block_pattern=("attn",),
        mlp_type="swiglu",
        norm_type="layernorm",
        tie_embeddings=False,
    )


register("stablelm-3b", config)
