"""Quantized weight storage for serving (port of ``deepspeed_tpu/linear``:
``QuantizationConfig`` and the flat layout of ``QuantizedParameter``)."""

from .config import QuantizationConfig
from .quantization import QuantizedParameter
