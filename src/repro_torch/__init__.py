"""PyTorch + CUDA port of the FastAttention serving and training stack
(H100).

The package mirrors the JAX package's file layout: ``config``,
``layers``, ``kernels`` (hand-written CUDA kernels for sm_90a, each with a
plain PyTorch version beside it), ``core``, ``models``, ``serving``,
``data``, ``training`` and ``launch``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
