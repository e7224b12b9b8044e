"""qwen2-vl-72b [vlm] -- M-RoPE, dynamic resolution [arXiv:2409.12191].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.  The transformer
backbone only: the vision frontend is a stub -- the caller feeds
precomputed patch embeddings (``LM.apply(inputs_embeds=...)``), and
positions are 3-component (temporal/height/width) for M-RoPE.
"""
from repro_torch.config import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        block_pattern=("attn",),
        qkv_bias=True,
        rope_type="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        modality="vision_stub",
        tie_embeddings=False,
    )


register("qwen2-vl-72b", config)
