"""The port's ops (counterpart of ``deepspeed_tpu/ops``): each module holds
a kernel's wrapper and its plain version. The fused optimizer steps keep
the JAX package's entry points (``deepspeed_tpu/ops/__init__.py:15``)."""

from .fused_optimizer import fused_adam_step, fused_lamb_step, fused_lion_step

__all__ = ["fused_adam_step", "fused_lion_step", "fused_lamb_step"]
