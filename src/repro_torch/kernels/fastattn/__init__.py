"""Paged chunked prefill: CUDA kernel, wrapper and plain PyTorch version."""
