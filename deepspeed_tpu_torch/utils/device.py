"""The device an entry point runs on."""

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; a CUDA request on a host
    without CUDA raises instead of quietly running on the CPU."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path on the "
            "CPU")
    return dev
