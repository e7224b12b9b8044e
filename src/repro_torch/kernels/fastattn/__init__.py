"""FastAttention kernels (dense two-level-tiled forward, paged chunked
prefill): CUDA sources, wrappers and plain PyTorch versions."""
