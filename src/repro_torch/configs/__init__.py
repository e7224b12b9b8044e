"""Built-in architecture configs the port serves.

Each module defines its config functions and registers them, as the JAX
package's ``repro.configs`` does (copies of the same numbers).
"""
from repro_torch.configs import (  # noqa: F401
    gemma2_2b,
    grok1_314b,
    hymba_1p5b,
    paper_models,
    phi3_mini_3p8b,
    qwen2_vl_72b,
    qwen3_moe_30b_a3b,
    qwen25_32b,
    stablelm_3b,
    whisper_small,
    xlstm_125m,
)
