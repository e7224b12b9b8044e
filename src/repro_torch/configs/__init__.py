"""Built-in architecture configs the port serves.

Each module defines its config functions and registers them, as the JAX
package's ``repro.configs`` does (copies of the same numbers).
"""
from repro_torch.configs import (  # noqa: F401
    gemma2_2b,
    paper_models,
    qwen25_32b,
    xlstm_125m,
)
