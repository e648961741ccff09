"""Blockwise int8 quantization (port of ``deepspeed_tpu/ops/quantizer.py``
:29-91: K6 ``quantize_int8_blockwise`` and its inverse).

The tensor is flattened row-major and cut into ``block_size`` blocks, the
last one padded with zeros (``_pad_to_blocks``). Each block is scaled by
its absmax / 127 (scale 1 for an all-zero block), rounded half to even and
clipped to +-127. Returns int8 values ``[rows * block_size]`` (the padding
included) and fp32 scales ``[rows]``.

Both functions dispatch on the tensor's device: a CPU tensor takes the
plain PyTorch version (``*_reference``), a CUDA tensor launches
``csrc/quantizer.cu`` or raises. Each counts its kernel launches in
``.launches``. The dequantize kernel is no port of a Pallas kernel (the JAX
package leaves it to XLA, which fuses it into the matmul that consumes
it): eager PyTorch would make three passes over the weight at every use.
"""

import math

import torch
import torch.nn.functional as F

from . import _build

FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def _pad_to_blocks(flat, block_size: int):
    pad = (-flat.shape[0]) % block_size
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def true_div_127(t):
    """``t / 127`` rounded once. PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which can land one ulp off; a tensor
    divisor on ``t``'s device divides."""
    return t / t.new_full((), 127.0)


def quantize_int8_blockwise_reference(x, block_size: int = 2048):
    flat, _ = _pad_to_blocks(x.reshape(-1), block_size)
    xf = flat.reshape(-1, block_size).float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.where(absmax == 0, torch.ones_like(absmax), true_div_127(absmax))
    v = torch.round(xf / s).clamp_(-127, 127).to(torch.int8)
    return v.reshape(-1), s.reshape(-1)


def dequantize_int8_blockwise_reference(values, scales, shape,
                                        block_size: int = 2048,
                                        dtype=torch.float32):
    rows = values.shape[0] // block_size
    x = values.reshape(rows, block_size).float() * scales.reshape(rows, 1)
    return x.reshape(-1)[:math.prod(shape)].reshape(shape).to(dtype)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_int8_blockwise(x, block_size: int = 2048):
    """Symmetric per-block int8 quantization of ``x`` (fp32 or bf16).
    Returns ``(values int8 [rows * block_size], scales fp32 [rows])``."""
    if x.device.type == "cpu":
        return quantize_int8_blockwise_reference(x, block_size)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8_blockwise: unsupported device {x.device}")
    if block_size <= 0:
        raise ValueError(f"quantize_int8_blockwise: block_size {block_size} <= 0")
    if x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"quantize_int8_blockwise: the kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8_blockwise: x must be contiguous")
    n = x.numel()
    rows = -(-n // block_size)
    values = torch.empty(rows * block_size, dtype=torch.int8, device=x.device)
    scales = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return values, scales
    with torch.cuda.device(x.device):
        err = _build.lib().dstt_quantize_int8(
            x.data_ptr(), n, block_size, _build.dtype_code(x.dtype),
            values.data_ptr(), scales.data_ptr(), _stream(x))
    _build.check(err, "quantize_int8_blockwise")
    quantize_int8_blockwise.launches += 1
    return values, scales


def dequantize_int8_blockwise(values, scales, shape, block_size: int = 2048,
                              dtype=torch.float32, out=None):
    """Inverse of :func:`quantize_int8_blockwise`: ``values * scale`` of
    each block in fp32, rounded to ``dtype``, the padding dropped. Writes
    into ``out`` (contiguous, ``shape`` and ``dtype``) when given."""
    shape = tuple(shape)
    if out is not None and (tuple(out.shape) != shape or out.dtype != dtype
                            or not out.is_contiguous()):
        raise ValueError(f"dequantize_int8_blockwise: out must be a contiguous "
                         f"{dtype} {shape}, got {out.dtype} {tuple(out.shape)}")
    if values.device.type == "cpu":
        ref = dequantize_int8_blockwise_reference(values, scales, shape,
                                                  block_size, dtype)
        return ref if out is None else out.copy_(ref)
    if values.device.type != "cuda":
        raise ValueError(f"dequantize_int8_blockwise: unsupported device {values.device}")
    n = math.prod(shape)
    rows = values.numel() // block_size if block_size > 0 else 0
    if (values.dtype != torch.int8 or scales.dtype != torch.float32
            or values.dim() != 1 or scales.dim() != 1
            or values.numel() != rows * block_size or scales.numel() != rows
            or n > values.numel()):
        raise ValueError("dequantize_int8_blockwise: values must be int8 "
                         "[rows * block_size] and scales fp32 [rows] covering "
                         f"{shape}, got {values.dtype} {tuple(values.shape)} and "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if scales.device != values.device or (out is not None and out.device != values.device):
        raise ValueError("dequantize_int8_blockwise: all tensors must be on one device")
    if not (values.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize_int8_blockwise: inputs must be contiguous")
    if dtype not in FLOAT_DTYPES:
        raise TypeError(f"dequantize_int8_blockwise: the kernel writes float32 "
                        f"or bfloat16, got {dtype}")
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=values.device)
    if n == 0:
        return out
    with torch.cuda.device(values.device):
        err = _build.lib().dstt_dequantize_int8(
            values.data_ptr(), scales.data_ptr(), n, block_size, out.data_ptr(),
            _build.dtype_code(dtype), _stream(values))
    _build.check(err, "dequantize_int8_blockwise")
    dequantize_int8_blockwise.launches += 1
    return out


quantize_int8_blockwise.launches = 0
dequantize_int8_blockwise.launches = 0
