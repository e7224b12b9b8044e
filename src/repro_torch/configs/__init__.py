"""Built-in architecture configs the port serves.

Each module defines its config functions and registers them, as the JAX
package's ``repro.configs`` does (copies of the same numbers).
"""
from repro_torch.configs import (  # noqa: F401
    gemma2_2b,
    grok1_314b,
    paper_models,
    phi3_mini_3p8b,
    qwen3_moe_30b_a3b,
    qwen25_32b,
    stablelm_3b,
    xlstm_125m,
)
