"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch versions."""
