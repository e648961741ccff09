"""Inference-v2 configuration (port of ``deepspeed_tpu/inference/v2/
config_v2.py``): the same field names, defaults and validation errors, as
plain dataclasses. Only the knobs of the ported serving path are here;
tensor parallelism, resilience, durability, continuous fusion,
disaggregation, observability, tenants and adapters are not ported
yet."""

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class KVCacheConfig:
    """Per-token cache geometry (reference manager_configs.py:28)."""
    type: str = "dense"
    block_size: int = 128
    num_allocation_groups: int = 1
    # (num_layers, num_kv_heads, head_size) per token
    cache_shape: Tuple[int, int, int] = (1, 1, 64)
    cache_dtype: str = "bfloat16"
    max_blocks_per_allocation_group: int = 64


@dataclasses.dataclass
class DSStateManagerConfig:
    """Reference manager_configs.py:DSStateManagerConfig."""
    max_tracked_sequences: int = 2048
    """Max sequences the state manager tracks (KV + metadata slots)."""

    max_ragged_batch_size: int = 768
    """Max total tokens in one ragged forward (Dynamic SplitFuse budget)."""

    max_ragged_sequence_count: int = 512
    """Max distinct sequences composable into one ragged batch."""

    max_context: int = 8192
    """Max per-sequence length (history + new)."""

    memory_config_mode: str = "reserve"
    memory_config_size: float = 0.85
    """'reserve': fraction of free device memory for KV blocks;
    'allocate': block count."""

    offload: bool = False

    def __post_init__(self):
        if self.max_ragged_sequence_count > self.max_tracked_sequences:
            raise ValueError("max_ragged_sequence_count cannot exceed max_tracked_sequences")
        if self.max_ragged_sequence_count > self.max_ragged_batch_size:
            raise ValueError("max_ragged_sequence_count cannot exceed max_ragged_batch_size")
        if self.offload:
            raise ValueError("KV-cache offload is not supported")
        if self.memory_config_mode == "reserve":
            if not 0.0 < self.memory_config_size <= 1.0:
                raise ValueError(
                    "memory_config_mode='reserve' takes a fraction of free "
                    f"HBM: 0 < memory_config_size <= 1, got {self.memory_config_size}")
        elif self.memory_config_mode == "allocate":
            if self.memory_config_size < 1 or self.memory_config_size != int(self.memory_config_size):
                raise ValueError(
                    "memory_config_mode='allocate' takes an integral block "
                    f"count >= 1, got {self.memory_config_size}")
        else:
            raise ValueError("memory_config_mode must be 'reserve' or 'allocate'")


@dataclasses.dataclass
class QuantizationConfig:
    """Reference config_v2.py:QuantizationConfig. ``build_llama_engine``
    maps the mode onto its ``quantize`` argument ("int8"; "wf6af16"/"fp6"
    and "int4" are not ported yet)."""
    quantization_mode: Optional[str] = None


@dataclasses.dataclass
class SamplingConfig:
    """On-device sampling, the fused decode window and the speculative
    knobs (the JAX config_v2.py:SamplingConfig)."""

    device_sampling: bool = True
    """Run temperature/top-k/top-p sampling and the logit controls on the
    device (ops/sampling) for requests without a host
    ``logits_processor``. False keeps the per-step numpy sampler
    everywhere."""

    fused_sampled_decode: bool = True
    """Let device-sampled requests ride the fused decode window (sampling
    inside the captured step). Requires ``device_sampling``. False keeps
    the window greedy-only."""

    fused_speculative_decode: bool = True
    """Run speculative requests through the fused draft/verify window:
    prompt-lookup drafting from a per-sequence token-history ring on the
    device, window verification and rejection sampling inside one captured
    step replayed K times (one host fetch per K windows). False keeps the
    per-token draft/verify path, the parity oracle, for every speculative
    request."""

    spec_history_window: int = 128
    """Token-history window for prompt-lookup drafting: the device ring
    holds this many trailing tokens per sequence, and the per-token path
    bounds its backward n-gram scan to the same window. Widened to at
    least ``2 * (1 + num_draft_tokens) + spec_max_ngram``
    (``spec_ring_window``)."""

    spec_max_ngram: int = 8
    """Largest ``draft_ngram`` the fused matcher takes (its comparison is
    masked over this static width). Requests with a larger n-gram take the
    per-token path."""


@dataclasses.dataclass
class RaggedInferenceEngineConfig:
    """Reference config_v2.py:RaggedInferenceEngineConfig, reduced to the
    state manager, the KV block count, weight quantization, prefix caching
    and sampling.
    ``state_manager``, ``quantization`` and ``sampling`` also take a dict
    of their fields."""
    state_manager: DSStateManagerConfig = dataclasses.field(
        default_factory=DSStateManagerConfig)

    # number of KV blocks to allocate (overrides memory_config sizing when
    # set — tests and CPU runs need deterministic small caches)
    num_kv_blocks: Optional[int] = None

    quantization: QuantizationConfig = dataclasses.field(
        default_factory=QuantizationConfig)

    # automatic prefix caching: content-addressed reuse of prompt KV blocks
    # across sequences (ragged/prefix_cache.py). Disabled for sliding-window
    # models, whose trailing-window release would free shared blocks.
    enable_prefix_caching: bool = False

    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)

    def __post_init__(self):
        if isinstance(self.state_manager, dict):
            self.state_manager = DSStateManagerConfig(**self.state_manager)
        if isinstance(self.quantization, dict):
            self.quantization = QuantizationConfig(**self.quantization)
        if isinstance(self.sampling, dict):
            self.sampling = SamplingConfig(**self.sampling)
