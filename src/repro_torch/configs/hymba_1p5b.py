"""hymba-1.5b [hybrid] -- parallel attn+mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each block runs attention heads and mamba heads in parallel on the same
input and fuses their (normalized) outputs.  Most layers use sliding-window
attention; the first, middle and last layers are global (per the Hymba
paper's 3-global-layer design scaled to 32L).
"""
from repro_torch.config import ModelConfig, register


def config() -> ModelConfig:
    pattern = ["hymba_local"] * 32
    for i in (0, 15, 31):           # first / middle / last layers global
        pattern[i] = "hymba"
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        block_pattern=tuple(pattern),
        window_size=1024,
        ssm_state_size=16,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        tie_embeddings=True,
    )


register("hymba-1.5b", config)
