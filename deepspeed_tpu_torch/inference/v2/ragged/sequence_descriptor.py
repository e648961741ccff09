"""Host-side sequence metadata (port of ``deepspeed_tpu/inference/v2/
ragged/sequence_descriptor.py``; reference DSSequenceDescriptor /
PlaceholderSequenceDescriptor). All metadata stays host numpy and reaches
the device once per forward inside the RaggedBatch arrays.

With prefix caching a descriptor also carries the radix cache's
bookkeeping: ``adopted_blocks`` (the cached blocks it adopted read-only),
``chain_key`` and ``chain_blocks`` (the last registered chain entry and
how many of its leading blocks the chain covers) and ``pending_tokens``
(the fed tokens past ``chain_blocks`` not registered yet, under one
block)."""

from typing import List

import numpy as np


class BaseSequenceDescriptor:

    @property
    def seen_tokens(self) -> int:
        raise NotImplementedError()

    @property
    def cur_allocated_blocks(self) -> int:
        raise NotImplementedError()


class PlaceholderSequenceDescriptor(BaseSequenceDescriptor):
    """Stand-in for unknown UIDs during scheduling dry runs."""

    def __init__(self, seen_tokens: int = 0, cur_allocated_blocks: int = 0):
        self._seen_tokens = seen_tokens
        self._cur_allocated_blocks = cur_allocated_blocks

    @property
    def seen_tokens(self) -> int:
        return self._seen_tokens

    @property
    def cur_allocated_blocks(self) -> int:
        return self._cur_allocated_blocks


class DSSequenceDescriptor(BaseSequenceDescriptor):

    def __init__(self, uid: int, max_blocks_per_seq: int):
        self.uid = uid
        self._seen_tokens = 0
        self._in_flight_tokens = 0
        self._max_blocks = max_blocks_per_seq
        self._blocks: List[int] = []
        self._freed_through = 0  # table indices < this are released (None)
        self._table_cache = {}  # width -> padded np table (decode hot path)
        self.adopted_blocks = set()
        self.chain_key = None
        self.chain_blocks = 0
        self.pending_tokens = np.zeros(0, np.int32)

    @property
    def seen_tokens(self) -> int:
        return self._seen_tokens

    @property
    def in_flight_tokens(self) -> int:
        return self._in_flight_tokens

    @property
    def cur_allocated_blocks(self) -> int:
        return len(self._blocks)

    @property
    def kv_blocks(self) -> List[int]:
        """LIVE block ids (prefix entries released by free_prefix_blocks are
        excluded — they belong to the allocator again)."""
        return [b for b in self._blocks if b is not None]

    def block_table(self, width: int) -> np.ndarray:
        """Dense int32 block table padded to `width` with 0 (padded entries
        are masked out by position bounds in the attention kernel; freed
        prefix entries keep their POSITION with a 0 placeholder). Cached per
        width; callers must not mutate the returned array."""
        t = self._table_cache.get(width)
        if t is None:
            t = np.zeros(width, dtype=np.int32)
            n = min(len(self._blocks), width)
            t[:n] = [0 if b is None else b for b in self._blocks[:n]]
            self._table_cache[width] = t
        return t

    def free_prefix_blocks(self, through_block: int) -> List[int]:
        """Release the blocks at table indices [0, through_block) — their
        whole token range has fallen out of every attention window. Returns
        the freed block ids; table positions are retained."""
        freed = []
        for i in range(self._freed_through, min(through_block, len(self._blocks))):
            if self._blocks[i] is not None:
                freed.append(self._blocks[i])
                self._blocks[i] = None
        self._freed_through = max(self._freed_through,
                                  min(through_block, len(self._blocks)))
        if freed:
            self._table_cache.clear()
        return freed

    def extend_kv_cache(self, new_blocks) -> None:
        blocks = [int(b) for b in np.atleast_1d(new_blocks)]
        if len(self._blocks) + len(blocks) > self._max_blocks:
            raise ValueError(f"Sequence {self.uid} exceeds max_blocks_per_seq={self._max_blocks}")
        self._blocks.extend(blocks)
        self._table_cache.clear()

    def pre_forward(self, num_tokens: int) -> None:
        """Record in-flight tokens."""
        self._in_flight_tokens = num_tokens

    def post_forward(self) -> None:
        """Commit in-flight tokens to history."""
        self._seen_tokens += self._in_flight_tokens
        self._in_flight_tokens = 0

    def rollback(self, n: int) -> None:
        """Drop the last ``n`` tokens from history (speculative drafts the
        verifier rejected). Their KV slots stay
        allocated and are overwritten in place by the next tokens at the
        same positions (slot = f(position))."""
        if not 0 <= n <= self._seen_tokens:
            raise ValueError(f"rollback({n}) with seen={self._seen_tokens}")
        self._seen_tokens -= n
