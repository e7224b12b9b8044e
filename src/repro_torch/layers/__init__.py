"""Model layers on tensors with parameter dicts (non-tensor-parallel paths)."""
