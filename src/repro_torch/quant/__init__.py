"""Weight-only int8 quantization (``quant/int8.py``)."""
from repro_torch.quant.int8 import (dequantize_tree, quantize_tree,  # noqa: F401
                                    quantized_size_bytes)
