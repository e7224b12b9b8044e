"""Tensor-parallel plan, per-rank context and weight slicing."""
