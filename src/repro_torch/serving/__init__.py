"""Paged continuous-batching serving engine and its host-side state."""
