"""Ragged (paged-KV) decoder model for the v2 engine (port of
``deepspeed_tpu/inference/v2/model.py``: ``_norm_tok`` :195, ``_mlp_tok``
:218, ``RaggedLlamaModel`` :246 with ``maybe_free_kv`` :543 and
``_uniform_window`` :564, and ``_ragged_forward`` :915 with the paged
attention backend). It serves the Llama family (rmsnorm, rope, swiglu, GQA),
StarCoder2's knobs, BLOOM's and Gemma-2's (``SERVING_FAMILY`` in
``models/llama.py``).

One forward: embed (→ embedding LayerNorm) → L × (norm → q/k/v (+ bias) →
rope → paged KV write → paged attention (sliding window per layer, or
ALiBi) → o_proj (+ bias) → residual → norm → MLP → residual) → final norm →
fp32 logits for each sequence's last token. The MLP is swiglu or the biased
fc1 → tanh-gelu → fc2 form; the norm is RMSNorm or LayerNorm with scale and
bias. With ``pos_embedding="alibi"`` (BLOOM) no rope is applied and K4 adds
the ALiBi bias; with ``embed_layernorm`` a LayerNorm follows the embedding
gather (the JAX forward's ``:950-952``). Gemma-2 (the JAX forward's
``:948-949``, ``:1216-1220`` and ``:1252-1254``): the embedding scale after
the gather, the (1 + w) RMSNorm (K5's fp32-scale instance: the sum is made
in fp32 once at build, since in bf16 its ~1e-3 deltas round away against
1.0), the tanh-gelu gated MLP, the sandwich norms (4L+1 norms per forward),
K4's softcap, and the final softcap on the fp32 logits. The Pallas kernels of the JAX path
become the CUDA kernels in ``ops/`` (paged attention once per layer, the
norm 2L+1 times, 2L+2 with the embedding LayerNorm: K5 RMSNorm, or K5b
LayerNorm, which the JAX forward computes in jnp with the same
arithmetic); the matmuls, embedding gather, rope and KV write stay plain
PyTorch, as they were plain XLA.

``forward(batch, window_logits=True)`` returns the fp32 logits at every
fed token, ``[S, N, vocab]`` (the JAX forward's ``:1236-1241``), for the
speculative verifier and ``score``. ``cow_copy_block`` copies one KV
block (and an int8 cache's scales) inside the paged pool: the prefix
cache's copy-on-write fork (the JAX ``:675``, plain XLA there, plain
indexing here).

With a sliding window on every layer, ``maybe_free_kv`` returns a
sequence's leading KV blocks to the allocator once every later query is
past their window, as the JAX engine does; their block-table entries read
0 from then on, and the kernel never reads those pages.

Type promotion follows the JAX program: projections run in the model
dtype, rope multiplies by the fp32 tables (bf16 × fp32 → fp32) and casts
back, attention returns the query dtype, and the unembed multiplies the
fp32 final hidden rows by an fp32 ``lm_head`` (held in fp32, as the JAX
engine holds it), so the logits are the same fp32 product. Tied embeddings
unembed through an fp32 copy of the embedding table made once at build
(the JAX forward casts it in the traced program).

Two int8 options, as in the JAX model. ``quantize="int8"`` (weight-only):
every layer kernel is held as int8 + per-block scales (K6 at build) and
dequantized at each use into one scratch buffer (the JAX forward
dequantizes in-graph, where XLA fuses it into the matmul).
``kv_cache_dtype="int8"``: K/V are stored as int8 with one fp32 scale per
(token, head) vector, quantized at the KV write, and K4 dequantizes pages
as it reads them.

The fused decode window (``fused_decode``, the JAX ``:706`` and its
``_fused_decode_loop`` ``:1258``): K decode steps with one host fetch. The
step builds its batch on the device from static buffers (``ragged_wrapper.
decode_batch``), runs the ragged forward, picks the next token (argmax, or
the logit controls and ``ops/sampling.sample_core``) and advances tokens,
lengths and output counts in place. On a CUDA engine each (live count,
block-table width, sampled statics) key is captured once into a
``torch.cuda.CUDAGraph`` (all graphs share one memory pool) and replayed;
the key's first step runs eagerly, as its warm-up, and is a real step of
the window. On the CPU the same step runs eagerly each time: that is the
plain version. A capture or replay error raises; nothing falls back.

The fused speculative window (``fused_spec_decode``, the JAX ``:806`` and
its ``_fused_spec_decode_loop`` ``:1340``) is built the same way: one step
per key (live count, block-table width, history ring width, draft width
``d``, ``max_ngram``, sampled or greedy) drafts from the ring on the
device (``ops/sampling.ngram_draft_ring``), builds the ``1 + d``-token
batch from the static buffers (``ragged_wrapper.spec_batch``), runs the
forward with window logits, verifies the drafts (argmax match, or
``spec_verify_window`` with the window's hashed draws), appends the
emitted tokens to the ring and advances the lengths and output counts by
the emitted count. Every window runs at the worst-case table width, the
blocks of ``K * (1 + d)`` tokens being reserved up front; a rejected
draft's KV is overwritten in place by the next window, which starts at
the accepted position.
"""

import math
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config_v2 import KVCacheConfig
from .ragged.ragged_wrapper import RaggedBatch, _bucket, decode_batch, spec_batch
from .ragged.sequence_descriptor import BaseSequenceDescriptor
from ...linear.config import QuantizationConfig
from ...linear.quantization import QuantizedParameter
from ...models.llama import (SERVING_FAMILY, LlamaConfig, LlamaModel, RMSNormWeight,
                             _layer_window, check_supported, embed_scale, final_softcap,
                             gate_act, precompute_rope)
from ...ops.normalization import layer_norm, rms_norm
from ...ops.paged_attention import paged_attention
from ...ops.quantizer import dequantize_int8_blockwise, true_div_127
from ...ops.sampling import (apply_logit_controls, greedy_verify_window, gumbel_noise,
                             ngram_draft_ring, ring_append, sample_core, spec_draws,
                             spec_verify_window)
from ...utils.dtypes import resolve_dtype


def _rope_tok(x, c, s):
    """Token-major half-split rope: x [T, H, D]; c, s [T, 1, D/2] the fp32
    cos/sin rows at each token's position. bf16 x times the fp32 tables
    promotes to fp32, then casts back (as in JAX)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def quantize_kv(w):
    """Per-vector symmetric int8 of ``w [..., D]`` at the KV write (the
    JAX forward's ``model.py:1059-1071``): one scale per (token, head),
    ``max(absmax / 127, 1e-8)`` (a floor, where K6 gives an all-zero block
    scale 1), codes ``round(w / scale)`` clipped to +-127."""
    wf = w.float()
    sc = true_div_127(wf.abs().amax(dim=-1)).clamp_min(1e-8)
    codes = torch.round(wf / sc[..., None]).clamp_(-127, 127).to(torch.int8)
    return codes, sc


def _norm_tok(x, norm, cfg, norm_scales=None):
    """K5b LayerNorm (``scale``, ``bias``) or K5 RMSNorm (``weight``, or
    for Gemma's (1 + w) norms its fp32 scale from ``norm_scales``), per
    ``cfg.norm_type``."""
    if cfg.norm_type == "layernorm":
        return layer_norm(x, norm.scale, norm.bias, cfg.rms_norm_eps)
    w = norm_scales[norm] if norm_scales is not None else norm.weight
    return rms_norm(x, w, cfg.rms_norm_eps)


def _proj(x, dense, kernel):
    """``x @ kernel(dense)``, plus the bias after the product in the model
    dtype where the projection has one (the JAX forward's :1029-1030)."""
    y = x @ kernel(dense)
    return y if dense.bias is None else y + dense.bias


def _mlp_tok(x, mlp, kernel):
    """swiglu or Gemma's tanh-gelu gate (``geglu_tanh``), or the fc form:
    fc1 (+ bias), tanh-approximate gelu, fc2 (+ bias) (the JAX
    ``_mlp_tok``'s ``gelu_tanh_fc``)."""
    if mlp.fc:
        return _proj(F.gelu(_proj(x, mlp.fc1, kernel), approximate="tanh"),
                     mlp.fc2, kernel)
    inner = gate_act(x @ kernel(mlp.gate_proj), mlp.mlp_type) * (x @ kernel(mlp.up_proj))
    return inner @ kernel(mlp.down_proj)


def layer_kernels(layer):
    """The projection modules of a decoder layer that weight-only
    quantization covers: q/k/v/o and the MLP's (gate/up/down, or fc1/fc2)."""
    attn, mlp = layer.self_attn, layer.mlp
    return (attn.q_proj, attn.k_proj, attn.v_proj, attn.o_proj) + (
        (mlp.fc1, mlp.fc2) if mlp.fc else
        (mlp.gate_proj, mlp.up_proj, mlp.down_proj))


class RaggedLlamaModel:
    """Paged-KV decode/prefill model over a :class:`LlamaModel`.

    ``quantize``: None or "int8" (weight-only int8; "fp6" and "int4" are
    not ported yet). The layer kernels of ``model`` are replaced by their
    int8 form: each projection module's ``kernel`` becomes None and its
    ``quantized`` holds the :class:`QuantizedParameter`.
    ``kv_cache_dtype``: None (the model dtype) or "int8"."""

    def __init__(self, config: LlamaConfig, model: LlamaModel,
                 dtype=torch.bfloat16, kv_block_size: int = 64,
                 quantize: Optional[str] = None,
                 kv_cache_dtype: Optional[str] = None):
        check_supported(config, "RaggedLlamaModel", SERVING_FAMILY)
        if quantize not in (None, "int8", "fp6", "int4"):
            raise ValueError("quantize must be None, 'int8', 'fp6' or 'int4', "
                             f"got {quantize!r}")
        if quantize in ("fp6", "int4"):
            raise NotImplementedError(f"RaggedLlamaModel: quantize={quantize!r} "
                                      "is not ported yet; 'int8' is")
        if kv_cache_dtype not in (None, "int8", "bfloat16", "float32"):
            raise ValueError("kv_cache_dtype must be None/int8/bfloat16/"
                             f"float32, got {kv_cache_dtype!r}")
        if kv_cache_dtype in ("bfloat16", "float32") and \
                resolve_dtype(kv_cache_dtype) != dtype:
            raise NotImplementedError(
                f"RaggedLlamaModel: a {kv_cache_dtype} KV cache under a {dtype} "
                "model is not ported yet (the cache takes the model dtype or int8)")
        self.config = config
        self.model = model
        self.dtype = dtype
        self.kv_block_size = kv_block_size
        self.device = model.embed_tokens.weight.device
        self._kv_cache_dtype = kv_cache_dtype
        # the JAX forward rebuilds this table at every trace; here it is
        # computed once, on the model's device (none under ALiBi)
        self.rope_cos = self.rope_sin = None
        if config.pos_embedding == "rope":
            self.rope_cos, self.rope_sin = precompute_rope(
                config.head_dim_, config.max_position_embeddings,
                config.rope_theta, device=self.device)
        # tied embeddings: the fp32 unembed, cast once here and not in
        # every forward (0.9 GB at StarCoder2-7B's width)
        self._tied_unembed = (model.embed_tokens.weight.detach().float()
                              if model.lm_head is None else None)
        # Gemma's (1 + w) norms: each fp32 scale, summed once here
        self._norm_scales = ({m: m.scale() for m in model.modules()
                              if isinstance(m, RMSNormWeight)}
                             if config.norm_plus_one else None)
        self._layer_windows = [_layer_window(config, l)
                               for l in range(config.num_hidden_layers)]
        # the window when EVERY layer attends locally, else None: one global
        # layer pins the whole history
        self._uniform_window = (None if None in self._layer_windows
                                else max(self._layer_windows))
        self._state_manager = None
        self._scratch = None
        if quantize is not None:
            self._quantize_layers()
        # the fused window: static buffers per live count, step graphs per
        # key, their shared pool and what the captures reserved in it
        self._decode_states = {}
        self._spec_states = {}
        self._graphs = {}
        self._graph_pool = self._capture_stream = None
        self.graph_pool_bytes = 0
        self.graph_capture_s = 0.0

    @torch.no_grad()
    def _quantize_layers(self) -> None:
        """Weight-only int8 (the JAX model's ``:398-451``): each layer
        kernel, cast to the model dtype as the JAX model casts its tree
        first, is quantized as stored (``[in, out]`` row-major, 512-value
        blocks) and its float tensor released, one at a time, so the float
        layers are never held twice. Embeddings, norms and the fp32
        ``lm_head`` stay as they are."""
        qcfg = QuantizationConfig(q_bits=8)
        largest = 0
        for layer in self.model.layers:
            for dense in layer_kernels(layer):
                dense.quantized = QuantizedParameter.quantize(
                    dense.kernel.detach().to(self.dtype), qcfg)
                dense.kernel = None
                largest = max(largest, math.prod(dense.quantized.shape))
        # every dequantized kernel lands here, used by its matmul before the
        # next one overwrites it (one stream orders the two)
        self._scratch = torch.empty(largest, dtype=self.dtype, device=self.device)

    def _kernel(self, dense) -> torch.Tensor:
        """A projection's ``[in, out]`` weight: the float kernel, or the int8
        one dequantized into the scratch buffer."""
        qp = getattr(dense, "quantized", None)
        if qp is None:
            return dense.kernel
        return qp.dequantized(out=self._scratch[:math.prod(qp.shape)].view(qp.shape))

    def layer_weight_bytes(self) -> int:
        """Bytes of the layers' projection weights as held (int8 values and
        scales, or the float kernels)."""
        total = 0
        for layer in self.model.layers:
            for dense in layer_kernels(layer):
                qp = getattr(dense, "quantized", None)
                total += (qp.nbytes if qp is not None else
                          dense.kernel.numel() * dense.kernel.element_size())
        return total

    # ---- state-manager plumbing (reference inference_model_base) ----

    def set_state_manager(self, state_manager) -> None:
        self._state_manager = state_manager
        self._graphs.clear()  # they hold the old cache's addresses

    def kv_cache_config(self) -> KVCacheConfig:
        cfg = self.config
        return KVCacheConfig(
            block_size=self.kv_block_size,
            cache_shape=(cfg.num_hidden_layers, cfg.num_key_value_heads,
                         cfg.head_dim_),
            cache_dtype=(self._kv_cache_dtype
                         or ("bfloat16" if self.dtype == torch.bfloat16
                             else "float32")))

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
        """Trailing-window block release (the JAX model's :543-561). Global
        attention keeps every block until flush. When every layer attends
        through a window W, the next query (position ``seen``) sees keys
        ``> seen - W``, so the blocks wholly below ``seen - W + 1`` are dead
        and go back to the allocator while the sequence keeps decoding."""
        W = self._uniform_window
        if W is None:
            return
        first_needed = seq_desc.seen_tokens - W + 1
        if first_needed <= 0:
            return
        freed = seq_desc.free_prefix_blocks(first_needed // self.kv_block_size)
        if freed:
            self._state_manager.release_blocks(freed)

    # ---- forward ----

    def forward(self, batch: RaggedBatch, window_logits: bool = False) -> torch.Tensor:
        """One ragged forward; returns fp32 logits ``[S, vocab]`` for each
        sequence's final token (``window_logits``: ``[S, N, vocab]`` at
        every fed token, the ``q_tok_idx`` bucket) and updates the KV cache
        in place."""
        return self._forward(batch, window_logits)

    def _forward(self, batch: RaggedBatch, window_logits: bool = False) -> torch.Tensor:
        cache = self._state_manager.kv_cache.cache
        cache, scales = cache if isinstance(cache, tuple) else (cache, None)
        return _ragged_forward(self.model, cache, batch, config=self.config,
                               block_size=self.kv_block_size,
                               cos=self.rope_cos, sin=self.rope_sin,
                               kernel=self._kernel, windows=self._layer_windows,
                               tied_unembed=self._tied_unembed,
                               cache_scales=scales, norm_scales=self._norm_scales,
                               window_logits=window_logits)

    @torch.inference_mode()
    def cow_copy_block(self, src_block: int, dst_block: int) -> None:
        """Copy KV block ``src_block``'s slots into ``dst_block`` (every
        layer's K and V rows, and an int8 cache's scales): the prefix
        cache's copy-on-write fork. The whole block is copied even where
        only its first ``p`` slots are shared: under causal attention those
        are what the forking sequence would compute, and its own prefill
        overwrites the rest before ``seen_tokens`` lets a read reach
        them."""
        bs = self.kv_block_size
        src = slice(src_block * bs, (src_block + 1) * bs)
        dst = slice(dst_block * bs, (dst_block + 1) * bs)
        cache = self._state_manager.kv_cache.cache
        for arr in (cache if isinstance(cache, tuple) else (cache, )):
            arr[:, dst].copy_(arr[:, src])

    # ---- the fused decode window ----

    @torch.inference_mode()
    def fused_decode(self, tokens, seq_lens, block_table, n_steps: int, *, widths,
                     sampling: Optional[dict] = None):
        """``n_steps`` decode steps of ``n = len(tokens)`` live sequences
        with no host fetch; returns the device tensors ``(tokens [n_steps,
        n] int32, logprobs [n_steps, n] fp32 or None)``.

        ``tokens``/``seq_lens``: each sequence's input token and history
        length; ``block_table`` ``[n, B]`` int32 covering ``seq_lens +
        n_steps`` tokens (the engine reserves the blocks first). Step ``j``
        runs at block-table width ``widths[j]``, the first columns of the
        table: the engine passes the width a per-step ``put`` would have,
        so each step's K4 plan is the per-step path's.

        ``sampling=None`` picks the argmax of each row. Otherwise a dict of
        per-sequence host arrays, ``temps``/``top_ps``/``penalties`` f32,
        ``top_ks``/``eos_ids``/``n_out``/``min_new`` int, ``seeds`` (32-bit
        values), optional ``seen_mask`` ``[n, vocab]`` bool, and the static
        flags ``want_logprobs``/``use_penalty``/``use_eos_mask``: each step
        runs the logit controls (eos masked while ``n_out < min_new``) and
        ``sample_core`` with the noise of token ``n_out`` of each
        sequence's seed, and ``n_out`` counts up."""
        n = len(tokens)
        S = _bucket(n, floor=1)
        B = block_table.shape[1]
        widths = [int(w) for w in widths]
        if len(widths) != n_steps or not all(1 <= w <= B for w in widths):
            raise ValueError(f"fused_decode: {n_steps} widths within 1..{B} "
                             f"expected, got {widths}")
        st = self._decode_states.get(n)
        if st is None:
            st = self._decode_states[n] = _DecodeState(n, S, self.device)
        statics = None
        if sampling is not None:
            statics = (bool(sampling["want_logprobs"]), bool(sampling["use_penalty"]),
                       bool(sampling["use_eos_mask"]))
        st.load(tokens, seq_lens, block_table, sorted(set(widths)), sampling,
                self.config.vocab_size)
        out = torch.empty(n_steps, S, dtype=torch.int32, device=self.device)
        lps = (torch.empty(n_steps, S, dtype=torch.float32, device=self.device)
               if statics is not None else None)
        for j, width in enumerate(widths):
            self._run_step(st, width, statics)
            out[j].copy_(st.tokens)
            if lps is not None:
                lps[j].copy_(st.lps)
        return out[:, :n], (lps[:, :n] if lps is not None else None)

    def _run_step(self, st, width: int, statics) -> None:
        """One step of the window: eagerly on the CPU; on CUDA by replaying
        the key's graph, captured after the key's first (eager) step."""
        self._run((st.n, width, statics), lambda: self._decode_step(st, width, statics))

    def _run(self, key, step) -> None:
        """``step()`` (one window step on static buffers) under ``key``:
        eagerly on the CPU; on CUDA eagerly at the key's first call, which
        then captures it, and by replaying its graph after that."""
        if self.device.type != "cuda":
            step()
            return
        graph = self._graphs.get(key)
        if graph is None:
            step()
            self._graphs[key] = self._capture(step)
            return
        graph.replay()

    def _capture(self, step) -> "_StepGraph":
        """Capture one decode step into the shared pool, on a side stream
        (``torch.cuda.graph`` would empty the allocator's cache before every
        capture). The wrappers count their launches while the step is
        recorded; the counts go back to what they were and the step's graph
        adds the change at each replay."""
        t = time.monotonic()
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        reserved = torch.cuda.memory_reserved(self.device)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=self._graph_pool)
            try:
                step()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.graph_pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        after = _launch_counts()
        for (fn, name), count in before.items():
            setattr(fn, name, count)
        self.graph_capture_s += time.monotonic() - t
        return _StepGraph(graph, {k: after[k] - before[k] for k in before
                                  if after[k] != before[k]})

    def _decode_step(self, st, width: int, statics) -> None:
        """The step the window captures: the batch from the static buffers,
        the forward, the next token, then tokens, lengths and output counts
        advance in place (padding rows keep theirs)."""
        kv = self._state_manager.kv_cache
        batch = decode_batch(st.tokens, st.lens, st.live, st.tables[width], n_tokens=st.n,
                             block_size=self.kv_block_size,
                             total_slots=kv.num_blocks * kv.block_size)
        logits = self._forward(batch)
        if statics is None:
            nxt = torch.argmax(logits, dim=-1).int()
        else:
            want_lp, use_pen, use_eos = statics
            ctrl = apply_logit_controls(
                logits, seen_mask=st.seen_mask if use_pen else None,
                penalties=st.penalties if use_pen else None,
                eos_ids=st.eos_ids if use_eos else None,
                block_eos=(st.n_out < st.min_new) if use_eos else None)
            nxt, lps = sample_core(ctrl, gumbel_noise(st.seeds, st.n_out, logits.shape[-1]),
                                   st.temps, st.top_ks, st.top_ps, want_logprobs=want_lp)
            st.lps.copy_(lps)
        on = st.live > 0
        nxt = torch.where(on, nxt, st.tokens)
        if statics is not None and statics[1]:
            # the sampled token joins its row's history before the next step
            idx = (torch.arange(st.S, device=nxt.device), nxt.long())
            st.seen_mask.index_put_(idx, st.seen_mask[idx] | on)
        st.tokens.copy_(nxt)
        st.lens.add_(st.live)
        st.n_out.add_(st.live)

    # ---- the fused speculative window ----

    @torch.inference_mode()
    def fused_spec_decode(self, tokens, seq_lens, block_table, hist, hist_len, ngrams,
                          max_drafts, n_steps: int, draft_width: int, max_ngram: int,
                          sampling: Optional[dict] = None):
        """``n_steps`` speculative windows of ``n = len(tokens)`` live
        sequences with no host fetch; returns the device tensors ``(out
        [n_steps, n, 1 + d] int32, n_emit [n_steps, n] int32, dlen [n_steps,
        n] int32)``: window w of row i emitted ``out[w, i, :n_emit[w, i]]``
        after drafting ``dlen[w, i]`` tokens.

        ``tokens``/``seq_lens``: each row's next input token and history
        length; ``block_table`` ``[n, B]`` covering ``seq_lens + n_steps *
        (1 + d)`` tokens; ``hist`` ``[n, W]`` the history ring (logical
        position p at ``p % W``), ``hist_len`` its length, ``ngrams`` and
        ``max_drafts`` per row. ``sampling=None`` verifies greedily; else a
        dict of per-row ``temps``/``top_ps`` f32, ``top_ks``, ``seeds``,
        ``n_out`` (the output count at the window's start, which keys the
        draws) and ``max_new`` int, and ``max_context``: a sampled window
        drafts at most ``max_new - n_out - 1`` and ``max_context - seen -
        2`` tokens (the per-token path's caps)."""
        n, d = len(tokens), int(draft_width)
        S = _bucket(n, floor=1)
        W = np.asarray(hist).shape[1]
        if W < 1 + d:
            raise ValueError(f"fused_spec_decode: ring width {W} under the window 1 + {d}")
        key = (n, W, d, int(max_ngram))
        st = self._spec_states.get(key)
        if st is None:
            st = self._spec_states[key] = _SpecState(n, S, W, d, int(max_ngram), self.device)
        st.load(tokens, seq_lens, block_table, hist, hist_len, ngrams, max_drafts, sampling)
        B = block_table.shape[1]
        statics = sampling is not None
        out = torch.empty(n_steps, S, 1 + d, dtype=torch.int32, device=self.device)
        counts = torch.empty(n_steps, 2, S, dtype=torch.int32, device=self.device)
        for j in range(n_steps):
            self._run(("spec", ) + key + (B, statics),
                      lambda: self._spec_step(st, B, statics))
            out[j].copy_(st.out)
            counts[j, 0].copy_(st.n_emit)
            counts[j, 1].copy_(st.dlen)
        return out[:, :n], counts[:, 0, :n], counts[:, 1, :n]

    def _spec_step(self, st, width: int, sampled: bool) -> None:
        """The step the speculative window captures: draft, the ``1 +
        d``-token batch, the forward with window logits, the verify, then
        the ring, tokens, lengths and output counts advance in place by
        each row's emitted count (padding rows emit nothing)."""
        kv = self._state_manager.kv_cache
        d = st.d
        max_drafts = st.max_drafts
        if sampled:  # the per-token path's caps: output budget, context
            max_drafts = torch.minimum(max_drafts, torch.minimum(
                st.max_new - st.n_out - 1, st.max_context - st.lens - 2)).clamp_min(0)
        drafts, dlen = ngram_draft_ring(st.hist, st.hist_len, st.ngrams, max_drafts,
                                        max_ngram=st.max_ngram, d=d)
        on = st.live > 0
        dlen = torch.where(on, dlen, 0)
        batch = spec_batch(st.tokens, drafts, st.lens, st.live, st.tables[width],
                           n_tokens=st.n * (1 + d), block_size=self.kv_block_size,
                           total_slots=kv.num_blocks * kv.block_size)
        logits = self._forward(batch, window_logits=True)  # [S, 1 + d, V]
        if sampled:
            uniforms, gumbel = spec_draws(st.seeds, st.n_out, d, logits.shape[-1])
            out, n_emit = spec_verify_window(logits, drafts, dlen, uniforms, gumbel, st.temps,
                                             st.top_ks, st.top_ps, d=d)
        else:
            out, n_emit = greedy_verify_window(logits, drafts, dlen, d=d)
        n_emit = torch.where(on, n_emit, 0)
        last = out.gather(1, (n_emit - 1).clamp_min(0).long()[:, None])[:, 0]
        st.tokens.copy_(torch.where(on, last, st.tokens))
        ring_append(st.hist, st.hist_len, out, n_emit)
        st.hist_len.add_(n_emit)
        st.lens.add_(n_emit)
        st.n_out.add_(n_emit)
        st.out.copy_(out)
        st.n_emit.copy_(n_emit)
        st.dlen.copy_(dlen)


# every wrapper whose launches a captured step counts
_COUNTED = (paged_attention, rms_norm, layer_norm, dequantize_int8_blockwise)


def _launch_counts() -> dict:
    return {(fn, name): count for fn in _COUNTED for name, count in vars(fn).items()
            if name.endswith("launches")}


class _StepGraph:
    """A captured decode step and the launch counts one run of it adds."""

    def __init__(self, graph, counts: dict):
        self.graph = graph
        self.counts = counts

    def replay(self) -> None:
        self.graph.replay()
        for (fn, name), n in self.counts.items():
            setattr(fn, name, getattr(fn, name) + n)


class _DecodeState:
    """The fused window's static buffers at one live count ``n`` (``S =
    _bucket(n, floor=1)`` rows; rows past ``n`` are padding): the step
    graphs read and advance these, so their addresses never change. One
    block table per width. The penalty's history mask ``[S, vocab]`` is
    made at the first window that uses it."""

    @torch.inference_mode()
    def __init__(self, n: int, S: int, device):
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.n, self.S, self.device = n, S, device
        self.tokens, self.lens, self.n_out = (torch.zeros(S, **i32) for _ in range(3))
        self.live = torch.zeros(S, **i32)
        self.live[:n] = 1
        self.tables = {}
        self.temps, self.lps = torch.zeros(S, **f32), torch.zeros(S, **f32)
        self.top_ps, self.penalties = torch.ones(S, **f32), torch.ones(S, **f32)
        self.top_ks, self.min_new, self.seeds = (torch.zeros(S, **i32) for _ in range(3))
        self.eos_ids = torch.full((S, ), -1, **i32)
        self.seen_mask = None

    def load(self, tokens, seq_lens, block_table, widths, sampling, vocab: int) -> None:
        """A window's inputs into the buffers: one host-to-device copy of
        the int32 fields (the fp32 ones by their bits), then device copies;
        the history mask in a copy of its own."""
        n, S = self.n, self.S
        block_table = np.asarray(block_table, np.int32)

        def col(x, fill=0, dtype=np.int32):  # [n] -> [S] int32 words
            a = np.full(S, fill, dtype)
            a[:n] = x
            return a.view(np.int32)

        fields = [(self.tokens, col(tokens)), (self.lens, col(seq_lens)),
                  (self.n_out, col(0 if sampling is None else sampling["n_out"]))]
        for w in widths:
            if w not in self.tables:
                self.tables[w] = torch.zeros(S, w, dtype=torch.int32, device=self.device)
            t = np.zeros((S, w), np.int32)
            t[:n] = block_table[:, :w]
            fields.append((self.tables[w], t.reshape(-1)))
        if sampling is not None:
            fields += [(self.temps, col(sampling["temps"], 0.0, np.float32)),
                       (self.top_ps, col(sampling["top_ps"], 1.0, np.float32)),
                       (self.penalties, col(sampling["penalties"], 1.0, np.float32)),
                       (self.top_ks, col(sampling["top_ks"])),
                       (self.eos_ids, col(sampling["eos_ids"], -1)),
                       (self.min_new, col(sampling["min_new"])),
                       (self.seeds, col(sampling["seeds"], 0, np.uint32))]
        _load_packed(fields, self.device)
        if sampling is not None and sampling.get("use_penalty"):
            if self.seen_mask is None:
                self.seen_mask = torch.zeros(S, vocab, dtype=torch.bool, device=self.device)
            mask = np.zeros((S, vocab), bool)
            mask[:n] = sampling["seen_mask"]
            self.seen_mask.copy_(torch.from_numpy(mask))


def _load_packed(fields, device) -> None:
    """``(buffer, host int32 words)`` pairs into their device buffers: one
    host-to-device copy of the packed words, then device copies."""
    packed = torch.from_numpy(np.concatenate([a for _, a in fields])).to(device)
    ofs = 0
    for buf, a in fields:
        buf.view(-1).copy_(packed[ofs:ofs + a.size].view(buf.dtype).view(-1))
        ofs += a.size


class _SpecState:
    """The speculative window's static buffers at one key (``n`` live rows
    of ``S``, ring width ``W``, draft width ``d``, ``max_ngram``): its step
    graphs read and advance these. One block table per width."""

    @torch.inference_mode()
    def __init__(self, n: int, S: int, W: int, d: int, max_ngram: int, device):
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.n, self.S, self.W, self.d, self.max_ngram = n, S, W, d, max_ngram
        self.device = device
        self.tokens, self.lens, self.n_out, self.hist_len = (torch.zeros(S, **i32)
                                                              for _ in range(4))
        self.ngrams, self.max_drafts, self.top_ks, self.seeds = (torch.zeros(S, **i32)
                                                                 for _ in range(4))
        self.max_new, self.max_context = torch.zeros(S, **i32), torch.zeros(S, **i32)
        self.live = torch.zeros(S, **i32)
        self.live[:n] = 1
        self.hist = torch.zeros(S, W, **i32)
        self.temps, self.top_ps = torch.zeros(S, **f32), torch.ones(S, **f32)
        self.tables = {}
        self.out = torch.zeros(S, 1 + d, **i32)
        self.n_emit, self.dlen = torch.zeros(S, **i32), torch.zeros(S, **i32)

    def load(self, tokens, seq_lens, block_table, hist, hist_len, ngrams, max_drafts,
             sampling) -> None:
        n, S = self.n, self.S
        block_table = np.asarray(block_table, np.int32)
        B = block_table.shape[1]

        def col(x, fill=0, dtype=np.int32):  # [n] -> [S] int32 words
            a = np.full(S, fill, dtype)
            a[:n] = x
            return a.view(np.int32)

        if B not in self.tables:
            self.tables[B] = torch.zeros(S, B, dtype=torch.int32, device=self.device)
        table = np.zeros((S, B), np.int32)
        table[:n] = block_table
        ring = np.zeros((S, self.W), np.int32)
        ring[:n] = hist
        fields = [(self.tokens, col(tokens)), (self.lens, col(seq_lens)),
                  (self.hist_len, col(hist_len)), (self.ngrams, col(ngrams)),
                  (self.max_drafts, col(max_drafts)), (self.tables[B], table.reshape(-1)),
                  (self.hist, ring.reshape(-1))]
        if sampling is not None:
            fields += [(self.n_out, col(sampling["n_out"])),
                       (self.temps, col(sampling["temps"], 0.0, np.float32)),
                       (self.top_ps, col(sampling["top_ps"], 1.0, np.float32)),
                       (self.top_ks, col(sampling["top_ks"])),
                       (self.seeds, col(sampling["seeds"], 0, np.uint32)),
                       (self.max_new, col(sampling["max_new"])),
                       (self.max_context, col(sampling["max_context"]))]
        _load_packed(fields, self.device)


@torch.inference_mode()
def _ragged_forward(model: LlamaModel, cache: torch.Tensor, batch: RaggedBatch,
                    *, config: LlamaConfig, block_size: int, cos: torch.Tensor,
                    sin: torch.Tensor, kernel, windows,
                    tied_unembed: Optional[torch.Tensor] = None,
                    cache_scales: Optional[torch.Tensor] = None,
                    norm_scales: Optional[dict] = None,
                    window_logits: bool = False) -> torch.Tensor:
    """One ragged step: embed → L×(paged attn + mlp) → final-token logits
    (``window_logits``: the logits at every fed token, ``[S, N, vocab]``).
    Writes this step's K/V into ``cache`` (and an int8 cache's
    ``cache_scales``) in place. ``kernel(module)`` gives a projection's
    weight; ``windows[l]`` is layer l's sliding window (None = global);
    ``tied_unembed`` the fp32 embedding table when the embeddings are
    tied; ``cos``/``sin`` the rope tables (None under ALiBi, which K4
    adds); ``norm_scales`` each RMSNorm's fp32 scale under Gemma's
    (1 + w) norms."""
    cfg = config
    T = batch.tokens.shape[0]
    S = batch.block_table.shape[0]
    hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
    n_real = batch.n_tokens

    x = model.embed_tokens.weight[batch.tokens]  # [T, E]
    if cfg.embed_scale is not None:  # Gemma, rounded to the model dtype
        x = x * embed_scale(cfg, x.dtype)
    if cfg.embed_layernorm:  # BLOOM word_embeddings_layernorm, through K5b
        ln = model.embed_layernorm
        x = layer_norm(x, ln.scale, ln.bias, cfg.rms_norm_eps)
    q_tok_idx = batch.q_tok_idx
    N = q_tok_idx.shape[1]
    seq_lens = batch.seq_seen + batch.seq_n_new  # valid key region per seq
    # token → (seq, rel) gather-back indices
    rel = batch.token_pos - batch.seq_seen[batch.token_seq]  # [T]
    ctx_rows = (batch.token_seq, rel.clamp(0, N - 1))
    # rope rows of this step's positions, shared by every layer (none
    # under ALiBi, whose positions may pass the rope table's length)
    alibi = cfg.pos_embedding == "alibi"
    if not alibi:
        rope_c = cos[batch.token_pos][:, None, :]
        rope_s = sin[batch.token_pos][:, None, :]
    # KV write: real tokens only (padding carries slot == total_slots)
    slots = batch.token_slot[:n_real].long()

    def norm(x, mod):
        return _norm_tok(x, mod, cfg, norm_scales)

    for l, layer in enumerate(model.layers):
        attn = layer.self_attn
        h = norm(x, layer.input_layernorm)
        q = _proj(h, attn.q_proj, kernel).reshape(T, nq, hd)
        k = _proj(h, attn.k_proj, kernel).reshape(T, nkv, hd)
        v = _proj(h, attn.v_proj, kernel).reshape(T, nkv, hd)
        if not alibi:
            q = _rope_tok(q, rope_c, rope_s)
            k = _rope_tok(k, rope_c, rope_s)

        # paged write into [2L, slot, KV*D]: k row 2l, v row 2l+1
        for row, w in ((2 * l, k), (2 * l + 1, v)):
            if cache_scales is None:
                cache[row].index_copy_(
                    0, slots, w.reshape(T, nkv * hd)[:n_real].to(cache.dtype))
            else:
                codes, sc = quantize_kv(w[:n_real])
                cache[row].index_copy_(0, slots, codes.reshape(n_real, nkv * hd))
                cache_scales[row].index_copy_(0, slots, sc)

        q_s = q[q_tok_idx]  # [S, N, nq, hd], head-major, kv-major heads
        ctx = paged_attention(q_s, cache, l, batch.block_table,
                              batch.seq_seen, seq_lens, page_size=block_size,
                              window=windows[l], attn_scale=cfg.attn_scale,
                              use_alibi=alibi, cache_scales=cache_scales,
                              softcap=cfg.attn_logit_softcapping)
        ctx = ctx.to(x.dtype).reshape(S, N, nq * hd)

        ctx_tok = ctx[ctx_rows]  # [T, H*D]
        attn_out = _proj(ctx_tok, attn.o_proj, kernel)
        if cfg.sandwich_norm:  # Gemma-2: each sublayer's output normed too
            x = x + norm(attn_out, layer.post_attention_layernorm)
            mlp_out = _mlp_tok(norm(x, layer.pre_feedforward_layernorm), layer.mlp, kernel)
            x = x + norm(mlp_out, layer.post_feedforward_layernorm)
            continue
        x = x + attn_out
        x = x + _mlp_tok(norm(x, layer.post_attention_layernorm), layer.mlp, kernel)

    x = norm(x, model.norm)
    # the speculative verifier and score need every fed token's logits;
    # decode and prefill only each sequence's last
    final = x[q_tok_idx if window_logits else batch.last_token_idx].float()
    unembed = tied_unembed.T if tied_unembed is not None else model.lm_head.kernel
    return final_softcap(final @ unembed, cfg.final_logit_softcapping)
