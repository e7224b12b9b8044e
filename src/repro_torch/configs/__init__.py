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

# the assigned architectures, in the JAX package's order (the dry run's
# cells, ``launch/dryrun.py``)
ASSIGNED_ARCHS = (
    "xlstm-125m",
    "qwen2.5-32b",
    "phi3-mini-3.8b",
    "gemma2-2b",
    "stablelm-3b",
    "grok-1-314b",
    "qwen3-moe-30b-a3b",
    "hymba-1.5b",
    "qwen2-vl-72b",
    "whisper-small",
)
