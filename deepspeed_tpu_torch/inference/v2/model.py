"""Ragged (paged-KV) Llama model for the v2 engine (port of
``deepspeed_tpu/inference/v2/model.py``: ``RaggedLlamaModel`` :246 and
``_ragged_forward`` :915, the rmsnorm/rope/swiglu/GQA path with the paged
attention backend).

One forward: embed → L × (rmsnorm → q/k/v → rope → paged KV write → paged
attention → o_proj → residual → rmsnorm → swiglu MLP → residual) → final
rmsnorm → fp32 logits for each sequence's last token. The two Pallas
kernels of the JAX path become the CUDA kernels in ``ops/`` (paged
attention once per layer, RMSNorm 2L+1 times); the matmuls, embedding
gather, rope and KV write stay plain PyTorch, as they were plain XLA.

Type promotion follows the JAX program: projections run in the model
dtype, rope multiplies by the fp32 tables (bf16 × fp32 → fp32) and casts
back, attention returns the query dtype, and the unembed multiplies the
fp32 final hidden rows by an fp32 ``lm_head`` (held in fp32, as the JAX
engine holds it), so the logits are the same fp32 product.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from .config_v2 import KVCacheConfig
from .ragged.ragged_wrapper import RaggedBatch
from .ragged.sequence_descriptor import BaseSequenceDescriptor
from ...models.llama import (LLAMA_FAMILY, LlamaConfig, LlamaModel,
                             check_supported, precompute_rope)
from ...ops.normalization import rms_norm
from ...ops.paged_attention import paged_attention


def _rope_tok(x, c, s):
    """Token-major half-split rope: x [T, H, D]; c, s [T, 1, D/2] the fp32
    cos/sin rows at each token's position. bf16 x times the fp32 tables
    promotes to fp32, then casts back (as in JAX)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


class RaggedLlamaModel:
    """Paged-KV decode/prefill model over a :class:`LlamaModel`."""

    def __init__(self, config: LlamaConfig, model: LlamaModel,
                 dtype=torch.bfloat16, kv_block_size: int = 64):
        check_supported(config, "RaggedLlamaModel", LLAMA_FAMILY)
        self.config = config
        self.model = model
        self.dtype = dtype
        self.kv_block_size = kv_block_size
        self.device = model.embed_tokens.weight.device
        # the JAX forward rebuilds this table at every trace; here it is
        # computed once, on the model's device
        self.rope_cos, self.rope_sin = precompute_rope(
            config.head_dim_, config.max_position_embeddings,
            config.rope_theta, device=self.device)
        self._state_manager = None

    # ---- state-manager plumbing (reference inference_model_base) ----

    def set_state_manager(self, state_manager) -> None:
        self._state_manager = state_manager

    def kv_cache_config(self) -> KVCacheConfig:
        cfg = self.config
        return KVCacheConfig(
            block_size=self.kv_block_size,
            cache_shape=(cfg.num_hidden_layers, cfg.num_key_value_heads,
                         cfg.head_dim_),
            cache_dtype="bfloat16" if self.dtype == torch.bfloat16 else "float32")

    # ---- scheduling arithmetic (reference get_kv_requirements) ----

    def get_kv_requirements(self, seq_desc: BaseSequenceDescriptor, max_new_tokens: int,
                            max_new_blocks: int) -> Tuple[int, int]:
        """How many of `max_new_tokens` fit given `max_new_blocks` free
        blocks; returns (schedulable_tokens, blocks_needed)."""
        bs = self.kv_block_size
        total = seq_desc.seen_tokens + max_new_tokens
        req_blocks = (total + bs - 1) // bs - seq_desc.cur_allocated_blocks
        if req_blocks <= max_new_blocks:
            return max_new_tokens, max(0, req_blocks)
        capacity = (seq_desc.cur_allocated_blocks + max_new_blocks) * bs - seq_desc.seen_tokens
        return max(0, capacity), max_new_blocks

    def maybe_allocate_kv(self, seq_desc, n_new_tokens: int) -> None:
        _, req = self.get_kv_requirements(seq_desc, n_new_tokens,
                                          self._state_manager.free_blocks)
        if req > 0:
            seq_desc.extend_kv_cache(self._state_manager.allocate_blocks(req))

    def maybe_free_kv(self, seq_desc) -> None:
        """No-op: global attention keeps every block until flush. The
        trailing-window release comes with K4's window option."""

    # ---- forward ----

    def forward(self, batch: RaggedBatch) -> torch.Tensor:
        """One ragged forward; returns fp32 logits ``[S, vocab]`` for each
        sequence's final token and updates the KV cache in place."""
        return _ragged_forward(self.model, self._state_manager.kv_cache.cache,
                               batch, config=self.config,
                               block_size=self.kv_block_size,
                               cos=self.rope_cos, sin=self.rope_sin)


@torch.inference_mode()
def _ragged_forward(model: LlamaModel, cache: torch.Tensor, batch: RaggedBatch,
                    *, config: LlamaConfig, block_size: int, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """One ragged step: embed → L×(paged attn + mlp) → final-token logits.
    Writes this step's K/V into ``cache`` in place."""
    cfg = config
    T = batch.tokens.shape[0]
    S = batch.block_table.shape[0]
    hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
    eps = cfg.rms_norm_eps
    n_real = batch.n_tokens

    x = model.embed_tokens.weight[batch.tokens]  # [T, E]
    q_tok_idx = batch.q_tok_idx
    N = q_tok_idx.shape[1]
    seq_lens = batch.seq_seen + batch.seq_n_new  # valid key region per seq
    # token → (seq, rel) gather-back indices
    rel = batch.token_pos - batch.seq_seen[batch.token_seq]  # [T]
    ctx_rows = (batch.token_seq, rel.clamp(0, N - 1))
    # rope rows of this step's positions, shared by every layer
    rope_c = cos[batch.token_pos][:, None, :]
    rope_s = sin[batch.token_pos][:, None, :]
    # KV write: real tokens only (padding carries slot == total_slots)
    slots = batch.token_slot[:n_real].long()

    for l, layer in enumerate(model.layers):
        attn = layer.self_attn
        h = rms_norm(x, layer.input_layernorm.weight, eps)
        q = (h @ attn.q_proj.kernel).reshape(T, nq, hd)
        k = (h @ attn.k_proj.kernel).reshape(T, nkv, hd)
        v = (h @ attn.v_proj.kernel).reshape(T, nkv, hd)
        q = _rope_tok(q, rope_c, rope_s)
        k = _rope_tok(k, rope_c, rope_s)

        # paged write into [2L, slot, KV*D]: k row 2l, v row 2l+1
        cache[2 * l].index_copy_(
            0, slots, k.reshape(T, nkv * hd)[:n_real].to(cache.dtype))
        cache[2 * l + 1].index_copy_(
            0, slots, v.reshape(T, nkv * hd)[:n_real].to(cache.dtype))

        q_s = q[q_tok_idx]  # [S, N, nq, hd], head-major, kv-major heads
        ctx = paged_attention(q_s, cache, l, batch.block_table,
                              batch.seq_seen, seq_lens, page_size=block_size,
                              attn_scale=cfg.attn_scale)
        ctx = ctx.to(x.dtype).reshape(S, N, nq * hd)

        ctx_tok = ctx[ctx_rows]  # [T, H*D]
        x = x + ctx_tok @ attn.o_proj.kernel
        h2 = rms_norm(x, layer.post_attention_layernorm.weight, eps)
        mlp = layer.mlp
        inner = F.silu(h2 @ mlp.gate_proj.kernel) * (h2 @ mlp.up_proj.kernel)
        x = x + inner @ mlp.down_proj.kernel

    x = rms_norm(x, model.norm.weight, eps)
    final = x[batch.last_token_idx].float()  # [S, E]
    if model.lm_head is None:  # tied embeddings
        return final @ model.embed_tokens.weight.float().T
    return final @ model.lm_head.kernel
