"""Quantization config (port of ``deepspeed_tpu/linear/config.py:62``
``QuantizationConfig``; the LoRA config is not ported)."""

from dataclasses import dataclass


@dataclass
class QuantizationConfig:
    """Blockwise quantization of a frozen weight: ``q_bits`` per value,
    one fp32 scale per ``group_size`` values of the flattened weight."""
    q_bits: int = 8
    group_size: int = 512
