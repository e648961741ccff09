"""Quantized parameter storage (port of ``deepspeed_tpu/linear/
quantization.py:29`` ``QuantizedParameter``, int8 in the flat layout).

The weight is flattened row-major, cut into ``group_size`` blocks and
quantized by K6 (``ops/quantizer.py``): int8 values and one fp32 scale per
block. ``dequantized()`` restores the weight in its dtype at use. The JAX
class also holds fp6 and int4 and a shard-major layout for tensor
parallelism; those raise ``NotImplementedError`` here.
"""

from typing import Tuple

import torch

from ..ops.quantizer import dequantize_int8_blockwise, quantize_int8_blockwise
from .config import QuantizationConfig

_UNPORTED_BITS = {6: "fp6 e3m2", 4: "int4"}


class QuantizedParameter:
    """int8 ``values [rows * block_size]`` and fp32 ``scales [rows]`` of a
    weight of ``shape`` and ``dtype``."""

    def __init__(self, values, scales, shape: Tuple[int, ...], block_size: int,
                 dtype=torch.bfloat16, q_bits: int = 8, shard_dim=None,
                 shards: int = 1):
        _check_layout(q_bits, shard_dim, shards)
        self.values = values
        self.scales = scales
        self.shape = tuple(shape)
        self.block_size = block_size
        self.dtype = dtype
        self.q_bits = q_bits
        self.shard_dim = shard_dim
        self.shards = int(shards)

    @staticmethod
    def quantize(w: torch.Tensor, config: QuantizationConfig = None,
                 shard_dim=None, shards: int = 1) -> "QuantizedParameter":
        """Quantize ``w`` as stored (never a transpose): block i holds
        elements ``[i*group_size, (i+1)*group_size)`` of ``w.reshape(-1)``."""
        config = config or QuantizationConfig()
        _check_layout(config.q_bits, shard_dim, shards)
        values, scales = quantize_int8_blockwise(w, block_size=config.group_size)
        return QuantizedParameter(values, scales, w.shape, config.group_size,
                                  dtype=w.dtype, q_bits=config.q_bits)

    def dequantized(self, out: torch.Tensor = None) -> torch.Tensor:
        """The weight in ``self.dtype``, written into ``out`` when given (a
        contiguous tensor of that shape and dtype, reused across calls)."""
        return dequantize_int8_blockwise(self.values, self.scales, self.shape,
                                         self.block_size, dtype=self.dtype,
                                         out=out)

    @property
    def nbytes(self) -> int:
        return int(self.values.numel() * self.values.element_size()
                   + self.scales.numel() * self.scales.element_size())


def _check_layout(q_bits: int, shard_dim, shards: int) -> None:
    if q_bits in _UNPORTED_BITS:
        raise NotImplementedError(
            f"QuantizedParameter: q_bits={q_bits} ({_UNPORTED_BITS[q_bits]}) "
            "is not ported yet; int8 is")
    if q_bits != 8:
        raise ValueError(f"q_bits must be one of [4, 6, 8] (int8 / fp6-e3m2 / "
                         f"int4), got {q_bits}")
    if shard_dim is not None and int(shards) > 1:
        raise NotImplementedError(
            "QuantizedParameter: the shard-major layout (shard_dim, shards > 1) "
            "serves tensor parallelism, which is not ported yet")
