"""qwen3-moe-30b-a3b [moe] -- 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) d_ff=768(per-expert) vocab=151936.
128 experts divide the model axis (16) -> expert parallelism.
"""
from repro_torch.config import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        block_pattern=("moe",),
        num_experts=128,
        num_experts_per_tok=8,
        moe_dff=768,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


register("qwen3-moe-30b-a3b", config)
