"""Paged (blocked) KV cache on device (port of ``deepspeed_tpu/inference/
v2/ragged/kv_cache.py``).

ONE tensor shaped ``[2 * num_layers, num_blocks * block_size,
num_kv_heads * head_dim]``: k at row ``2l``, v at row ``2l+1``, flat slot
addressing (``block_table[pos // bs] * bs + pos % bs``) — the JAX
package's layout, so the paged-attention kernel reads it the same way. The
forward writes new K/V into it IN PLACE (``index_copy_`` along the slot
dim), where the JAX package donated the buffer and got a new one back.

An int8 cache is a pair ``(data, scales)``: data int8 in that shape and
fp32 scales ``[2 * num_layers, slots, num_kv_heads]``, slot-major like the
data, one per (k|v row, slot, head); ``head_dim + 4`` bytes per vector in
place of ``2 * head_dim`` in bf16.
"""

import torch

from ..config_v2 import KVCacheConfig
from ....utils.dtypes import resolve_dtype


class BlockedKVCache:

    def __init__(self, config: KVCacheConfig, num_blocks: int, device=None):
        self._config = config
        self.num_blocks = num_blocks
        self.block_size = config.block_size
        n_layers, n_kv, head_dim = config.cache_shape
        self.quantized = str(config.cache_dtype) == "int8"
        self.dtype = resolve_dtype(config.cache_dtype, torch.bfloat16)
        slots = num_blocks * config.block_size
        self.shape = (2 * n_layers, slots, n_kv * head_dim)
        self.scales_shape = (2 * n_layers, slots, n_kv)
        device = torch.device(device or "cuda")
        data = torch.zeros(self.shape, dtype=self.dtype, device=device)
        self.cache = ((data, torch.zeros(self.scales_shape, dtype=torch.float32,
                                         device=device))
                      if self.quantized else data)

    @property
    def per_token_bytes(self) -> int:
        return per_token_kv_bytes(self._config)


def per_token_kv_bytes(config: KVCacheConfig) -> int:
    """KV bytes per token: int8 data + fp32 per-vector scale, or the plain
    dtype itemsize."""
    n_layers, n_kv, head_dim = config.cache_shape
    if str(config.cache_dtype) == "int8":
        return n_layers * 2 * n_kv * (head_dim * 1 + 4)  # int8 + scale
    itemsize = resolve_dtype(config.cache_dtype, torch.bfloat16).itemsize
    return n_layers * 2 * n_kv * head_dim * itemsize


def estimate_kv_blocks(config: KVCacheConfig, hbm_bytes: int, fraction: float) -> int:
    """Size the cache from a device-memory budget (reference memory_config
    'reserve')."""
    per_block = per_token_kv_bytes(config) * config.block_size
    return max(1, int(hbm_bytes * fraction) // per_block)
