"""Token data pipeline (own copy of the JAX package's, numpy only)."""
