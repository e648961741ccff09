"""HF checkpoint conversion (port of ``deepspeed_tpu/module_inject``):
``policy_for(arch).config_from_hf`` and ``convert_hf_checkpoint``."""

from .replace_module import convert_hf_checkpoint  # noqa: F401
from .replace_policy import (BLOOM_7B1, GEMMA2_9B, MISTRAL_7B, STARCODER2_7B,  # noqa: F401
                             policy_for)
