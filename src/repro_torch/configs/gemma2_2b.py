"""gemma2-2b [dense] -- local+global alternating, logit softcap [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.  Sliding window 4096
on local layers; attn softcap 50, final softcap 30; GeGLU; post-block norms.
"""
from repro_torch.config import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        block_pattern=("attn_local", "attn"),
        window_size=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        mlp_type="geglu",
        norm_type="rmsnorm",
        post_norm=True,
        embed_scale=True,
        tie_embeddings=True,
    )


register("gemma2-2b", config)
