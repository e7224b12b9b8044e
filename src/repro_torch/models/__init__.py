"""The models: the decoder-only LM (training, dense and paged serving)
and the encoder-decoder EncDec (training and dense serving)."""
from repro_torch.models.registry import build_model  # noqa: F401
