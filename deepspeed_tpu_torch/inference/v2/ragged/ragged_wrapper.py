"""Ragged batch construction (port of ``deepspeed_tpu/inference/v2/ragged/
ragged_wrapper.py``).

Host-side assembly of the dense metadata one ragged forward needs, padded
to the same power-of-two buckets as the JAX package so both see identical
arrays. Arrays shipped to the device per forward:
  tokens[T], token_seq[T], token_pos[T], token_slot[T] (flat KV write index;
  padding points one past the end), seq_start[S], seq_n_new[S],
  seq_seen[S], block_table[S, B], last_token_idx[S], q_tok_idx[S, N].
All ten travel in ONE host-to-device copy of a packed int32 buffer. The
batch also carries ``n_tokens``, the count of real tokens on the host: the
KV write indexes only those, since an out-of-range slot is a device fault
in PyTorch, where XLA dropped it.

:func:`decode_batch` builds a pure-decode batch (one new token per
sequence) from device tensors instead, as the JAX package's fused decode
loop builds it in its trace (``model.py:1294-1300``); the fused window's
captured step runs it on its static buffers. It gives the same arrays as
``finalize``'s pure-decode fast path, at the same buckets.
:func:`spec_batch` builds the fused speculative window's batch the same
way (the JAX ``model.py:1374-1387``): ``1 + d`` tokens per sequence, the
input token and its drafts, unbucketed (``T = S * (1 + d)``).
"""

from typing import List, NamedTuple

import numpy as np
import torch

from ..config_v2 import DSStateManagerConfig
from .sequence_descriptor import DSSequenceDescriptor


def _bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class RaggedBatch(NamedTuple):
    """Device-side dense view of one ragged batch."""
    tokens: torch.Tensor        # int32 [T]
    token_seq: torch.Tensor     # int32 [T] slot in [0, S)
    token_pos: torch.Tensor     # int32 [T] absolute position in sequence
    token_slot: torch.Tensor    # int32 [T] flat KV slot (OOB for padding)
    seq_start: torch.Tensor     # int32 [S] first token index
    seq_n_new: torch.Tensor     # int32 [S] new tokens this forward (0 = pad)
    seq_seen: torch.Tensor      # int32 [S] history length
    block_table: torch.Tensor   # int32 [S, B]
    last_token_idx: torch.Tensor  # int32 [S] token index of final token
    q_tok_idx: torch.Tensor     # int32 [S, N] token index of each seq's n-th
    # new token (N buckets the max burst: 1 for pure decode)
    n_tokens: int = 0           # real tokens (host int); the rest is padding

    @property
    def bucket_key(self):
        return (self.tokens.shape[0], self.seq_start.shape[0],
                self.block_table.shape[1], self.q_tok_idx.shape[1])


def decode_batch(tokens: torch.Tensor, seq_lens: torch.Tensor, live: torch.Tensor,
                 block_table: torch.Tensor, *, n_tokens: int, block_size: int,
                 total_slots: int) -> RaggedBatch:
    """The pure-decode :class:`RaggedBatch` of ``n_tokens`` live sequences
    from ``[S]`` int32 device tensors (each row's input token, history
    length and live flag, 0 on padding rows) and the ``[S, B]`` block
    table; ``T = _bucket(n_tokens)`` as in ``finalize``. Each live row's
    token writes its KV at ``block_table[s, lens // bs] * bs + lens % bs``;
    padding rows and tokens carry zeros and the one-past-the-end slot."""
    S = tokens.shape[0]
    T = _bucket(max(1, n_tokens))
    on = live > 0
    zero = torch.zeros_like(tokens)
    ar = torch.arange(S, dtype=torch.int32, device=tokens.device)
    slot = block_table.gather(1, (seq_lens // block_size).long()[:, None])[:, 0] \
        * block_size + seq_lens % block_size

    def per_token(x, fill=0):  # [S] -> [T]: padding tokens after the rows
        return torch.cat([x, x.new_full((T - S, ), fill)])

    seen = torch.where(on, seq_lens, zero)
    rows = torch.where(on, ar, zero)
    return RaggedBatch(
        tokens=per_token(torch.where(on, tokens, zero)), token_seq=per_token(rows),
        token_pos=per_token(seen),
        token_slot=per_token(torch.where(on, slot, total_slots), total_slots),
        seq_start=rows, seq_n_new=on.to(torch.int32), seq_seen=seen,
        block_table=torch.where(on[:, None], block_table, 0), last_token_idx=rows,
        q_tok_idx=rows[:, None], n_tokens=n_tokens)


def spec_batch(tokens: torch.Tensor, drafts: torch.Tensor, seq_lens: torch.Tensor,
               live: torch.Tensor, block_table: torch.Tensor, *, n_tokens: int,
               block_size: int, total_slots: int) -> RaggedBatch:
    """The :class:`RaggedBatch` of one speculative window from ``[S]``
    int32 device tensors (each row's input token, history length and live
    flag) and its ``[S, d]`` drafts: row s feeds its token then its drafts
    at positions ``seq_lens[s] + j``, each writing its KV at the slot its
    position gives, and ``q_tok_idx`` names all ``1 + d`` of them (the
    window logits). ``n_tokens`` counts the live rows' tokens, which come
    first; padding rows carry zeros and the one-past-the-end slot."""
    S, d = drafts.shape
    Np1 = 1 + d
    dev = tokens.device
    on = live > 0
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    jw = torch.arange(Np1, dtype=torch.int32, device=dev)
    feed = torch.cat([tokens[:, None], drafts.to(tokens.dtype)], dim=1)
    seen = torch.where(on, seq_lens, 0)
    pos = seen[:, None] + jw[None, :]
    table = torch.where(on[:, None], block_table, 0)
    slot = table.gather(1, (pos // block_size).long()) * block_size + pos % block_size
    slot = torch.where(on[:, None], slot, total_slots)
    start = ar * Np1
    return RaggedBatch(
        tokens=torch.where(on[:, None], feed, 0).reshape(-1),
        token_seq=ar.repeat_interleave(Np1), token_pos=pos.reshape(-1),
        token_slot=slot.reshape(-1), seq_start=start, seq_n_new=on.to(torch.int32) * Np1,
        seq_seen=seen, block_table=table, last_token_idx=start,
        q_tok_idx=start[:, None] + jw[None, :], n_tokens=n_tokens)


class RaggedBatchWrapper:

    def __init__(self, config: DSStateManagerConfig, block_size: int = 128,
                 device=None):
        self._config = config
        self._block_size = block_size
        self._device = torch.device(device or "cuda")
        self.clear()

    def clear(self) -> None:
        self._token_lists: List[np.ndarray] = []
        self._seqs: List[DSSequenceDescriptor] = []

    def insert_sequence(self, seq_desc: DSSequenceDescriptor, tokens, do_checks: bool = True) -> None:
        tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        if do_checks:
            if len(self._seqs) + 1 > self._config.max_ragged_sequence_count:
                raise RuntimeError("batch sequence limit exceeded")
            if self.current_tokens + tokens.size > self._config.max_ragged_batch_size:
                raise RuntimeError("batch token limit exceeded")
        self._token_lists.append(tokens)
        self._seqs.append(seq_desc)

    @property
    def current_tokens(self) -> int:
        return int(sum(t.size for t in self._token_lists))

    def finalize(self, total_slots: int) -> RaggedBatch:
        """Build the padded dense arrays. `total_slots` = num_blocks *
        block_size of the KV cache (the slot value padding tokens carry)."""
        bs = self._block_size
        S = _bucket(max(1, len(self._seqs)), floor=1)
        T = _bucket(max(1, self.current_tokens))
        max_blocks = max((s.cur_allocated_blocks for s in self._seqs), default=1)
        B = _bucket(max(1, max_blocks), floor=1)
        N = _bucket(max((t.size for t in self._token_lists), default=1), floor=1)

        # one packed host buffer; each array is a view into it
        shapes = ((T, ), (T, ), (T, ), (T, ), (S, ), (S, ), (S, ), (S, B),
                  (S, ), (S, N))
        sizes = [int(np.prod(s)) for s in shapes]
        offsets = np.cumsum([0] + sizes)
        packed = np.zeros(offsets[-1], dtype=np.int32)
        (tokens, token_seq, token_pos, token_slot, seq_start, seq_n_new,
         seq_seen, block_table, last_token_idx, q_tok_idx) = [
            packed[offsets[i]:offsets[i + 1]].reshape(shapes[i])
            for i in range(len(shapes))]
        token_slot[:] = total_slots  # padding: one past the last slot

        Sq = len(self._seqs)
        if Sq and all(t.size == 1 for t in self._token_lists):
            # pure-decode fast path: one token per sequence, token index ==
            # sequence index
            ar = np.arange(Sq, dtype=np.int32)
            seen = np.fromiter((s.seen_tokens for s in self._seqs),
                               np.int32, Sq)
            for i, seq in enumerate(self._seqs):
                block_table[i] = seq.block_table(B)
            tokens[:Sq] = np.fromiter((t[0] for t in self._token_lists),
                                      np.int32, Sq)
            token_seq[:Sq] = ar
            token_pos[:Sq] = seen
            token_slot[:Sq] = block_table[ar, seen // bs] * bs + seen % bs
            seq_start[:Sq] = ar
            seq_n_new[:Sq] = 1
            seq_seen[:Sq] = seen
            last_token_idx[:Sq] = ar
            q_tok_idx[:Sq, 0] = ar
        else:
            cursor = 0
            for i, (seq, toks) in enumerate(zip(self._seqs, self._token_lists)):
                n = toks.size
                seq_start[i] = cursor
                seq_n_new[i] = n
                seq_seen[i] = seq.seen_tokens
                bt = seq.block_table(B)
                block_table[i] = bt
                tokens[cursor:cursor + n] = toks
                token_seq[cursor:cursor + n] = i
                pos = seq.seen_tokens + np.arange(n, dtype=np.int32)
                token_pos[cursor:cursor + n] = pos
                token_slot[cursor:cursor + n] = bt[pos // bs] * bs + pos % bs
                last_token_idx[i] = cursor + n - 1
                q_tok_idx[i, :n] = cursor + np.arange(n, dtype=np.int32)
                cursor += n

        dev = torch.from_numpy(packed).to(self._device)
        arrays = [dev[offsets[i]:offsets[i + 1]].view(shapes[i])
                  for i in range(len(shapes))]
        return RaggedBatch(*arrays, n_tokens=self.current_tokens)
