"""grok-1-314b [moe] -- 8 experts top-2 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
Experts (8) do not divide the model axis (16), so expert FFNs are
tensor-sharded along d_ff instead of expert-parallel (see sharding/rules).
631 GB in bf16: the port runs it reduced only.
"""
from repro_torch.config import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab_size=131072,
        block_pattern=("moe",),
        num_experts=8,
        num_experts_per_tok=2,
        attn_logit_softcap=30.0,    # grok uses attn logit softcapping
        mlp_type="geglu",           # 3-matrix gated expert MLP (-> ~314B total)
        norm_type="rmsnorm",
        tie_embeddings=True,
    )


register("grok-1-314b", config)
