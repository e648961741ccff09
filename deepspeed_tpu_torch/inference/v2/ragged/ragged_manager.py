"""Persistent state manager for ragged serving (port of
``deepspeed_tpu/inference/v2/ragged/ragged_manager.py``): tracks live
sequences, owns the block allocator, the paged KV cache and, with prefix
caching on, the radix prefix cache (``prefix_cache.PrefixKVCache``),
whose blocks count as free to the scheduler and are evicted on demand."""

from typing import Dict, Optional

import torch

from ..config_v2 import DSStateManagerConfig, KVCacheConfig
from .blocked_allocator import BlockedAllocator
from .kv_cache import BlockedKVCache, estimate_kv_blocks
from .prefix_cache import PrefixKVCache
from .sequence_descriptor import DSSequenceDescriptor


class DSStateManager:

    def __init__(self,
                 config: DSStateManagerConfig,
                 kv_config: KVCacheConfig,
                 num_blocks: Optional[int] = None,
                 device=None,
                 enable_prefix_caching: bool = False):
        self._config = config
        self._kv_config = kv_config
        device = torch.device(device or "cuda")
        if num_blocks is None:
            num_blocks = self._size_from_memory_config(config, kv_config, device)
        self._allocator = BlockedAllocator(num_blocks)
        self._kv_cache = BlockedKVCache(kv_config, num_blocks, device=device)
        self._seqs: Dict[int, DSSequenceDescriptor] = {}
        self.prefix_cache = (PrefixKVCache(kv_config.block_size)
                             if enable_prefix_caching else None)

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

    @property
    def tracked_sequences(self) -> Dict[int, DSSequenceDescriptor]:
        return self._seqs

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
        """Free a sequence's KV blocks and its tracking. With prefix
        caching on, adopted blocks drop their reference and registered
        blocks pass to the cache instead of the allocator."""
        seq = self._seqs.pop(uid, None)
        if seq is None:
            return
        blocks = seq.kv_blocks
        if self.prefix_cache is not None:
            adopted = seq.adopted_blocks
            self.prefix_cache.release([b for b in blocks if b in adopted])
            self._register_tail(seq, blocks, adopted)
            kept = set(self.prefix_cache.take_ownership(
                [b for b in blocks if b not in adopted]))
            blocks = [b for b in blocks if b not in adopted and b not in kept]
        if blocks:
            self._allocator.free(blocks)

    def _register_tail(self, seq, blocks, adopted) -> None:
        """At flush, hand the sequence's sub-block tail to the cache as a
        partial (fork-source) entry, before ``take_ownership`` so that the
        tail block passes with the rest. A sequence whose staged tail no
        longer matches its history (a flush mid-rollback) registers
        nothing."""
        pend = seq.pending_tokens
        start = int(seq.chain_blocks)
        bs = self.block_size
        if (not 0 < len(pend) < bs or start >= len(blocks)
                or seq.seen_tokens != start * bs + len(pend)):
            return
        tail_block = blocks[start]
        if tail_block in adopted:
            return
        self.prefix_cache.register_tail(seq.chain_key, pend, tail_block)

    # ---- KV accounting ----

    @property
    def free_blocks(self) -> int:
        """Free in the allocator, plus what evicting cached prefixes could
        reclaim: the scheduler's view (``allocate_blocks`` evicts on
        demand)."""
        n = self._allocator.free_blocks
        if self.prefix_cache is not None:
            n += self.prefix_cache.reclaimable_blocks
        return n

    @property
    def kv_cache(self) -> BlockedKVCache:
        return self._kv_cache

    @property
    def block_size(self) -> int:
        return self._kv_config.block_size

    def reset_prefix_cache(self) -> None:
        """Invalidate every cached prefix (KV computed under other weights
        must never be adopted). Live sequences are flushed first: their
        history is old-weight state too, and the flush settles every
        reference, so ``clear`` frees only blocks no sequence holds."""
        if self.prefix_cache is None:
            return
        for uid in list(self._seqs):
            self.flush_sequence(uid)
        freed = self.prefix_cache.clear()
        if freed:
            self._allocator.free(freed)

    def allocate_blocks(self, n_blocks: int):
        """``n_blocks`` from the allocator, evicting least recently used
        cached prefixes (leaf first) when it holds too few; a shortfall
        eviction cannot cover raises ``SchedulingError``."""
        if self.prefix_cache is not None and n_blocks > self._allocator.free_blocks:
            evicted = self.prefix_cache.evict(n_blocks - self._allocator.free_blocks)
            if evicted:
                self._allocator.free(evicted)
            if n_blocks > self._allocator.free_blocks:
                from ..scheduling_utils import SchedulingError, SchedulingResult
                raise SchedulingError(SchedulingResult.KVCacheLimitExceeded)
        return self._allocator.allocate(n_blocks)

    def release_blocks(self, blocks) -> None:
        """Return single blocks in the middle of a sequence (the
        trailing-window release, ``model.maybe_free_kv``) without touching
        sequence tracking."""
        if len(blocks):
            self._allocator.free(blocks)
