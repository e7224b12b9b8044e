"""Chunkwise mLSTM (xLSTM) kernel: CUDA source, wrappers and plain
PyTorch versions."""
