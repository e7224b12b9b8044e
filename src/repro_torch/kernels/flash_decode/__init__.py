"""Paged flash decode: CUDA kernel, wrapper and plain PyTorch version."""
