"""Attention facade used by the model layers, the tiling-mask rules and the
Hopper two-level tiling planner."""
