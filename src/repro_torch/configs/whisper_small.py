"""whisper-small [audio] -- enc-dec, conv frontend stub [arXiv:2212.04356].

12L d_model=768 12H d_ff=3072 vocab=51865.  Encoder (12L, bidirectional)
consumes precomputed frame embeddings (conv stub); decoder (12L) has causal
self-attention + cross-attention over encoder states.
"""
from repro_torch.config import ModelConfig, register


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,              # decoder layers
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        block_pattern=("attn",),
        is_encoder_decoder=True,
        encoder_layers=12,
        encoder_seq=1500,
        rope_type="none",           # whisper uses learned/sinusoidal pos
        norm_type="layernorm",
        mlp_type="gelu",
        modality="audio_stub",
        tie_embeddings=True,
    )


register("whisper-small", config)
