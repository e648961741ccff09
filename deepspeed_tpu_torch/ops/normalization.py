"""RMSNorm and LayerNorm (port of ``deepspeed_tpu/ops/normalization.py``
``rms_norm`` and ``layer_norm``).

Each wrapper dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version (``rms_norm_reference``, ``layer_norm_reference``),
a CUDA tensor launches the hand-written kernel (``csrc/row_norm.cuh``, built
in ``csrc/rms_norm.cu`` and ``csrc/layer_norm.cu``), or raises.
``rms_norm.launches`` and ``layer_norm.launches`` count kernel launches;
``rms_norm`` with a bf16 x and an fp32 weight (Gemma's ``1 + w``, as the JAX
kernel casts any weight to fp32) counts in ``rms_norm.fp32_scale_launches``
instead.

The kernel plans each launch itself (``csrc/row_norm.cuh``
``launch_row_norm``): the row in registers on one block's warps where its
width and pointers allow, else a scalar kernel.
"""

import torch

from . import _build

# the kernel's own plan of the weight loads (before or after the statistic)
_PLAN = -1


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """y = x / rms(x) * weight with fp32 statistics, output in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = (x - mean) * rsqrt(var + eps) * weight + bias with fp32
    statistics (var of the centred values), weight and bias cast to fp32,
    output in x's dtype."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * weight.float() + bias.float()).to(x.dtype)


def _check_row_call(name: str, x: torch.Tensor, *params: torch.Tensor,
                    fp32_params: bool = False) -> int:
    """The rows of ``x`` a norm kernel takes with ``params`` (each ``[d]``):
    one CUDA device, contiguous, all float32 or all bfloat16, or with
    ``fp32_params`` also a bfloat16 x with float32 params."""
    if x.device.type != "cuda" or any(p.device != x.device for p in params):
        raise ValueError(f"{name}: x on {x.device}, params on "
                         f"{[str(p.device) for p in params]}; all must be on "
                         "one CUDA device")
    d = x.shape[-1]
    for p in params:
        if p.shape != (d, ):
            raise ValueError(f"{name}: param shape {tuple(p.shape)} != ({d},)")
    if not x.is_contiguous() or not all(p.is_contiguous() for p in params):
        raise ValueError(f"{name}: x and its params must be contiguous")
    widened = fp32_params and x.dtype == torch.bfloat16 and \
        all(p.dtype == torch.float32 for p in params)
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            (any(p.dtype != x.dtype for p in params) and not widened):
        raise TypeError(f"{name}: x {x.dtype} / params "
                        f"{[str(p.dtype) for p in params]}; the kernel takes "
                        "all float32 or all bfloat16"
                        + (", or a bfloat16 x with float32 params" if fp32_params else ""))
    return x.numel() // d if d else 0


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = x / rms(x) * weight over the last dim (reference rms_norm.cu);
    the weight in x's dtype, or fp32 beside a bf16 x."""
    if x.device.type == "cpu":
        return rms_norm_reference(x, weight, eps)
    rows = _check_row_call("rms_norm", x, weight, fp32_params=True)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.dstt_rms_norm(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, x.shape[-1],
            float(eps), _build.dtype_code(x.dtype), _build.dtype_code(weight.dtype),
            _PLAN, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rms_norm")
    if weight.dtype != x.dtype:
        rms_norm.fp32_scale_launches += 1
    else:
        rms_norm.launches += 1
    return out


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Standard LayerNorm with scale and bias over the last dim (reference
    layer_norm.cu)."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    rows = _check_row_call("layer_norm", x, weight, bias)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.dstt_layer_norm(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            rows, x.shape[-1], float(eps), _build.dtype_code(x.dtype),
            _PLAN, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "layer_norm")
    layer_norm.launches += 1
    return out


rms_norm.launches = 0
rms_norm.fp32_scale_launches = 0
layer_norm.launches = 0
