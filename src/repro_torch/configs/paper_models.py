"""The paper's own evaluation models (Table 1) as configs.

PanGu-38B / PanGu-71B / LLaMA2-7B / LLaMA2-70B / LLaMA-65B / OPT-30B.
Used by the benchmark harness to reproduce the paper's tables at the
operator level and (scaled-down) end to end.
"""
from repro_torch.config import ModelConfig, register


def pangu_38b() -> ModelConfig:
    return ModelConfig(
        name="pangu-38b", family="dense", num_layers=40, d_model=5120,
        num_heads=40, num_kv_heads=40, head_dim=128, d_ff=20480,
        vocab_size=100000, mlp_type="gelu", norm_type="layernorm",
        tie_embeddings=False,
    )


def pangu_71b() -> ModelConfig:
    return ModelConfig(
        name="pangu-71b", family="dense", num_layers=64, d_model=6144,
        num_heads=48, num_kv_heads=48, head_dim=128, d_ff=24576,
        vocab_size=100000, mlp_type="gelu", norm_type="layernorm",
        tie_embeddings=False,
    )


def llama2_7b() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b", family="dense", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=32, head_dim=128, d_ff=11008,
        vocab_size=32000, mlp_type="swiglu", norm_type="rmsnorm",
        tie_embeddings=False,
    )


def llama2_70b() -> ModelConfig:
    return ModelConfig(
        name="llama2-70b", family="dense", num_layers=80, d_model=8192,
        num_heads=64, num_kv_heads=8, head_dim=128, d_ff=28672,
        vocab_size=32000, mlp_type="swiglu", norm_type="rmsnorm",
        tie_embeddings=False,
    )


def llama_65b() -> ModelConfig:
    return ModelConfig(
        name="llama-65b", family="dense", num_layers=80, d_model=8192,
        num_heads=64, num_kv_heads=64, head_dim=128, d_ff=22016,
        vocab_size=32000, mlp_type="swiglu", norm_type="rmsnorm",
        tie_embeddings=False,
    )


def opt_30b() -> ModelConfig:
    return ModelConfig(
        name="opt-30b", family="dense", num_layers=48, d_model=7168,
        num_heads=56, num_kv_heads=56, head_dim=128, d_ff=28672,
        vocab_size=50272, mlp_type="gelu", norm_type="layernorm",
        rope_type="none", tie_embeddings=False,
    )


for _f in (pangu_38b, pangu_71b, llama2_7b, llama2_70b, llama_65b, opt_30b):
    register(_f().name, _f)
