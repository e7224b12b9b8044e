"""Attention facade used by the model layers."""
