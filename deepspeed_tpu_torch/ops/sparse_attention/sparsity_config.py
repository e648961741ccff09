"""Block-sparse attention layouts (port of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``: ``SparsityConfig``
:17, ``DenseSparsityConfig`` :40, ``FixedSparsityConfig`` :49,
``BigBirdSparsityConfig`` :95, ``BSLongformerSparsityConfig`` :133 and
``VariableSparsityConfig`` :168).

A config emits a block-level layout ``[heads, nblocks, nblocks]`` (1 =
compute this q-block x k-block tile), consumed as a dense mask by the
dense path of ``sparse_self_attention.py`` or as the block tables of the
splash kernel (``splash.py``). The layout math is host-side numpy with the
JAX package's defaults and its use of ``np.random.default_rng(seed)``, so
the two packages give equal layouts element for element; the port keeps
its own copy rather than importing the JAX package.
"""

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base (reference sparsity_config.py SparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} must be divisible by block {self.block}")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), dtype=np.int64)

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    def _apply_causal(self, layout: np.ndarray) -> np.ndarray:
        nb = layout.shape[1]
        return layout * np.tril(np.ones((nb, nb), dtype=np.int64))


class DenseSparsityConfig(SparsityConfig):
    """All blocks on (reference DenseSparsityConfig)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Local windows + periodic global blocks (reference
    FixedSparsityConfig; Sparse Transformer-style)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        L = self.num_local_blocks
        G = self.num_global_blocks
        for h in range(self.num_heads):
            # which G blocks of each window act as global, rotated per head
            pattern = (h % self.num_different_global_patterns
                       if self.different_layout_per_head else 0)
            for i in range(nb):
                w = i // L
                layout[h, i, w * L:min((w + 1) * L, nb)] = 1  # local window
                # the global blocks of every window up to and including ours
                for ww in range(w + 1):
                    g_end = min((ww + 1) * L - pattern * G, nb)
                    g_start = max(g_end - G, ww * L)
                    if g_start < g_end:
                        layout[h, i, g_start:g_end] = 1
            if self.horizontal_global_attention:  # global blocks also attend to all
                for ww in range((nb + L - 1) // L):
                    g_end = min((ww + 1) * L - pattern * G, nb)
                    g_start = max(g_end - G, ww * L)
                    if g_start < g_end:
                        layout[h, g_start:g_end, :] = 1
        if self.attention == "unidirectional":
            layout = self._apply_causal(layout)
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding window + global (reference BigBirdSparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1, num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, attention: str = "bidirectional",
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_heads):
            r = rng if self.different_layout_per_head else np.random.default_rng(self.seed)
            # sliding window
            for i in range(nb):
                layout[h, i, max(0, i - w):min(nb, i + w + 1)] = 1
            # global rows+cols
            g = min(self.num_global_blocks, nb)
            layout[h, :g, :] = 1
            layout[h, :, :g] = 1
            # random blocks per row
            for i in range(nb):
                cols = r.choice(nb, size=min(self.num_random_blocks, nb), replace=False)
                layout[h, i, cols] = 1
        if self.attention == "unidirectional":
            layout = self._apply_causal(layout)
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + designated global blocks (reference
    BSLongformerSparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for i in range(nb):
            layout[:, i, max(0, i - w):min(nb, i + w + 1)] = 1
        if self.global_block_end_indices:
            spans = zip(self.global_block_indices, self.global_block_end_indices)
        else:
            spans = ((i, i + 1) for i in self.global_block_indices)
        for start, end in spans:
            start, end = min(start, nb), min(end, nb)
            layout[:, start:end, :] = 1
            layout[:, :, start:end] = 1
        if self.attention == "unidirectional":
            layout = self._apply_causal(layout)
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Per-row-group variable windows + global + random (reference
    VariableSparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional", seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        # consecutive local windows of varying size; last size repeats
        start = 0
        widx = 0
        while start < nb:
            size = self.local_window_blocks[min(widx, len(self.local_window_blocks) - 1)]
            end = min(start + size, nb)
            layout[:, start:end, start:end] = 1
            start = end
            widx += 1
        if self.global_block_end_indices:
            spans = zip(self.global_block_indices, self.global_block_end_indices)
        else:
            spans = ((i, i + 1) for i in self.global_block_indices)
        for s, e in spans:
            s, e = min(s, nb), min(e, nb)
            layout[:, s:e, :] = 1
            layout[:, :, s:e] = 1
        if self.num_random_blocks:
            shared = np.random.default_rng(self.seed)
            for h in range(self.num_heads):
                # identical layout per head unless different_layout_per_head
                # (same contract as BigBirdSparsityConfig)
                rng = shared if self.different_layout_per_head \
                    else np.random.default_rng(self.seed)
                for i in range(nb):
                    cols = rng.choice(nb, size=min(self.num_random_blocks, nb),
                                      replace=False)
                    layout[h, i, cols] = 1
        if self.attention == "unidirectional":
            layout = self._apply_causal(layout)
        return layout
