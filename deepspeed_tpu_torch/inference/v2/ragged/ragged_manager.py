"""Persistent state manager for ragged serving (port of
``deepspeed_tpu/inference/v2/ragged/ragged_manager.py``, without the prefix
cache): tracks live sequences, owns the block allocator and the paged KV
cache."""

from typing import Dict, Optional

import torch

from ..config_v2 import DSStateManagerConfig, KVCacheConfig
from .blocked_allocator import BlockedAllocator
from .kv_cache import BlockedKVCache, estimate_kv_blocks
from .sequence_descriptor import DSSequenceDescriptor


class DSStateManager:

    def __init__(self,
                 config: DSStateManagerConfig,
                 kv_config: KVCacheConfig,
                 num_blocks: Optional[int] = None,
                 device=None):
        self._config = config
        self._kv_config = kv_config
        device = torch.device(device or "cuda")
        if num_blocks is None:
            num_blocks = self._size_from_memory_config(config, kv_config, device)
        self._allocator = BlockedAllocator(num_blocks)
        self._kv_cache = BlockedKVCache(kv_config, num_blocks, device=device)
        self._seqs: Dict[int, DSSequenceDescriptor] = {}

    @staticmethod
    def _size_from_memory_config(config: DSStateManagerConfig,
                                 kv_config: KVCacheConfig, device) -> int:
        """'allocate' = memory_config_size IS the block count; 'reserve' =
        that fraction of the CUDA device's free memory becomes KV blocks.
        On the CPU the deterministic default keeps tests from sizing a
        cache off host RAM."""
        if config.memory_config_mode == "allocate":
            return max(1, int(config.memory_config_size))
        if device.type == "cuda":
            free, _total = torch.cuda.mem_get_info(device)
            return max(64, estimate_kv_blocks(kv_config, free,
                                              config.memory_config_size))
        return max(64, config.max_tracked_sequences)

    # ---- sequence tracking ----

    @property
    def n_tracked_sequences(self) -> int:
        return len(self._seqs)

    def get_sequence(self, uid: int) -> Optional[DSSequenceDescriptor]:
        return self._seqs.get(uid)

    def get_or_create_sequence(self, uid: int) -> DSSequenceDescriptor:
        seq = self._seqs.get(uid)
        if seq is not None:
            return seq
        return self._create_sequence(uid)

    def _create_sequence(self, uid: int) -> DSSequenceDescriptor:
        if uid in self._seqs:
            raise ValueError(f"Sequence {uid} already exists")
        if len(self._seqs) >= self._config.max_tracked_sequences:
            raise RuntimeError("max_tracked_sequences exceeded")
        max_blocks = (self._config.max_context + self._kv_config.block_size - 1) \
            // self._kv_config.block_size
        seq = DSSequenceDescriptor(uid, max_blocks)
        self._seqs[uid] = seq
        return seq

    def flush_sequence(self, uid: int) -> None:
        """Free a sequence's KV blocks and its tracking."""
        seq = self._seqs.pop(uid, None)
        if seq is None:
            return
        blocks = seq.kv_blocks
        if blocks:
            self._allocator.free(blocks)

    # ---- KV accounting ----

    @property
    def free_blocks(self) -> int:
        return self._allocator.free_blocks

    @property
    def kv_cache(self) -> BlockedKVCache:
        return self._kv_cache

    @property
    def block_size(self) -> int:
        return self._kv_config.block_size

    def allocate_blocks(self, n_blocks: int):
        return self._allocator.allocate(n_blocks)

    def release_blocks(self, blocks) -> None:
        """Return single blocks in the middle of a sequence (the
        trailing-window release, ``model.maybe_free_kv``) without touching
        sequence tracking."""
        if len(blocks):
            self._allocator.free(blocks)
