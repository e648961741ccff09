"""Llama-family decoder (port of ``deepspeed_tpu/models/llama.py``:
``LlamaConfig`` :35-172, ``precompute_rope`` :175, ``apply_rope`` :182,
``RMSNorm`` :206 (with Gemma's ``plus_one``), ``alibi_slopes`` :225,
``_BarrierDense`` :257 with its bias, ``_make_norm`` :285, ``_layer_window``
:296, ``LlamaAttention`` :308 (the flash branch), ``LlamaMLP`` :440 (swiglu,
Gemma's tanh-gelu gate and the fc form), ``LlamaDecoderLayer`` :522 (the
pre-norm branch and Gemma-2's sandwich norms), ``LMHead`` :566,
``LlamaModel`` :625 (with Gemma's embedding scale and Gemma-2's final
logit softcap, and ``remat``/``remat_policy`` as ``_remat_layer_cls``
:597), ``cross_entropy_loss`` :713, ``LlamaForCausalLM`` :725 and the
``init_llama`` initializers). With an ``attn_mask`` (``[b, s]`` key
padding) attention takes the JAX layer's dense branch (``:371-415``),
plain PyTorch as there it is XLA: ``masked_attention``.

The modules hold the weights in the JAX package's layout and names — a
projection's ``kernel`` is ``[in, out]`` and applies as ``x @ kernel`` —
so a JAX param tree loads one-to-one (``models/convert.py``). Their
``forward`` is the training forward; the serving forward over the same
weights lives in ``inference/v2/model.py``. The compute dtype is the
parameters' dtype: the training engine holds fp32 masters and hands the
model their cast (``runtime/engine.py``), as the JAX engine casts the tree
before ``apply``.
"""

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention
from ..ops.chunked_ce import causal_targets, chunked_cross_entropy_loss, matmul_fp32
from ..ops.normalization import layer_norm_reference
from ..runtime.activation_checkpointing.checkpointing import (checkpoint_with,
                                                              resolve_policy)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Decoder-family config, same fields and defaults as the JAX package's.
    The port trains the Llama subset (rmsnorm, rope, swiglu, GQA) with
    Mistral's sliding window and Gemma-2's knobs (``TRAINING_FAMILY``), and
    serves the Llama subset, the StarCoder2 knobs, BLOOM's and Gemma-2's
    (``SERVING_FAMILY``); the other variant knobs are kept so configs carry
    over, and the models refuse the ones they do not implement yet."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: Optional[int] = None
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    attention_out_bias: bool = False
    norm_type: str = "rmsnorm"
    pos_embedding: str = "rope"
    embed_layernorm: bool = False
    pos_offset: int = 0
    rotary_dim: Optional[int] = None
    rope_interleaved: bool = False
    sliding_window: Optional[int] = None
    sliding_window_layers: Optional[Tuple[int, ...]] = None
    attn_scale: Optional[float] = None
    clip_qkv: Optional[float] = None
    logit_scale: Optional[float] = None
    qk_norm: bool = False
    post_norm: bool = False
    sandwich_norm: bool = False
    norm_plus_one: bool = False
    embed_scale: Optional[float] = None
    attn_logit_softcapping: Optional[float] = None
    final_logit_softcapping: Optional[float] = None
    mlp_type: str = "swiglu"
    mlp_bias: bool = False
    parallel_residual: bool = False
    parallel_residual_norms: int = 1
    lm_head_bias: bool = False
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    moe_renormalize: bool = True
    router_aux_loss_coef: float = 0.0
    shared_expert_intermediate_size: Optional[int] = None
    moe_grouped: bool = True
    attn_impl: str = "auto"
    dtype: Any = torch.bfloat16
    scan_layers: bool = False
    scan_chunk_size: int = 1
    remat: bool = False
    remat_policy: Optional[str] = None
    ce_chunk_size: Optional[int] = None

    @property
    def head_dim_(self):
        return self.head_dim or self.hidden_size // self.num_attention_heads

    # ---- presets ----
    @staticmethod
    def tiny(**over):
        return LlamaConfig(**{**dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                                     num_hidden_layers=2, num_attention_heads=4,
                                     num_key_value_heads=2, max_position_embeddings=128,
                                     rope_theta=10000.0), **over})

    @staticmethod
    def llama3_8b(**over):
        return LlamaConfig(**{**dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                                     num_hidden_layers=32, num_attention_heads=32,
                                     num_key_value_heads=8), **over})

    @staticmethod
    def llama3_70b(**over):
        return LlamaConfig(**{**dict(vocab_size=128256, hidden_size=8192, intermediate_size=28672,
                                     num_hidden_layers=80, num_attention_heads=64,
                                     num_key_value_heads=8, scan_layers=True), **over})


# LlamaConfig knobs whose non-default values the training forward does not
# run yet: it runs the Llama rmsnorm/rope/swiglu/GQA family
LLAMA_FAMILY = dict(
    attention_bias=False, attention_out_bias=False, norm_type="rmsnorm",
    pos_embedding="rope", embed_layernorm=False, rotary_dim=None,
    rope_interleaved=False, sliding_window=None, clip_qkv=None,
    logit_scale=None, qk_norm=False, post_norm=False, sandwich_norm=False,
    norm_plus_one=False, embed_scale=None, attn_logit_softcapping=None,
    final_logit_softcapping=None, mlp_type="swiglu", mlp_bias=False,
    parallel_residual=False, lm_head_bias=False, num_local_experts=0)
# Gemma's and Gemma-2's knobs, which both forwards run: the (1 + w) RMSNorm,
# the embedding scale, the tanh-gelu gated MLP, the sandwich norms, the
# attention-logit softcap (into the attention kernels) and the final logit
# softcap; a knob missing from a family takes any value
GEMMA_KNOBS = ("norm_plus_one", "embed_scale", "sandwich_norm", "attn_logit_softcapping",
               "final_logit_softcapping")
# what the training forward runs: the Llama family with a sliding window
# (on all or some layers, Mistral) and Gemma-2's knobs; a tuple lists the
# values it takes
TRAINING_FAMILY = {**{k: v for k, v in LLAMA_FAMILY.items()
                      if k not in ("sliding_window", ) + GEMMA_KNOBS},
                   "mlp_type": ("swiglu", "geglu_tanh")}
# what the serving forward runs: the Llama family, StarCoder2's knobs
# (LayerNorm with bias, q/k/v/o biases, the biased gelu-tanh fc MLP, sliding
# windows on all or some layers), BLOOM's (ALiBi in place of rope, the
# embedding LayerNorm) and Gemma-2's
SERVING_FAMILY = {
    **{k: v for k, v in LLAMA_FAMILY.items() if k not in ("sliding_window", ) + GEMMA_KNOBS},
    "norm_type": ("rmsnorm", "layernorm"), "attention_bias": (False, True),
    "attention_out_bias": (False, True),
    "mlp_type": ("swiglu", "geglu_tanh", "gelu_tanh_fc"),
    "mlp_bias": (False, True), "pos_embedding": ("rope", "alibi"),
    "embed_layernorm": (False, True)}


def check_supported(config, who: str, family: dict) -> None:
    """Raise ``NotImplementedError`` naming every option of ``config``
    outside ``family`` (option -> its one value, or a tuple of values)."""
    bad = {k: getattr(config, k) for k, v in family.items()
           if getattr(config, k) not in (v if isinstance(v, tuple) else (v, ))}
    if bad:
        raise NotImplementedError(
            f"{who}: config options {bad} are not ported yet")


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes (HF ``build_alibi_tensor`` formula, including the
    non-power-of-2 interpolation). Press et al., "Train Short, Test Long"."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = base ** np.arange(1, closest + 1)
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        extra = extra_base ** np.arange(1, 2 * (n_heads - closest), 2)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


def _layer_window(cfg, layer_idx: int):
    """Sliding window for this layer (None = global attention)."""
    if cfg.sliding_window is None:
        return None
    if (cfg.sliding_window_layers is not None
            and layer_idx not in cfg.sliding_window_layers):
        return None
    return cfg.sliding_window


def precompute_rope(head_dim: int, max_len: int, theta: float,
                    dtype=torch.float32, device=None):
    """cos/sin tables ``[max_len, head_dim/2]``: fp32 inverse frequencies,
    fp32 outer product with the positions, then cos and sin."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x, cos, sin, positions):
    """Half-split rotary embedding of x ``[b, s, h, d]`` at ``positions``
    ``[b, s]``: the fp32 table rows promote the product to fp32, cast back
    to x's dtype (as in JAX)."""
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


class Dense(nn.Module):
    """Projection weight ``kernel`` of shape ``[in, out]`` (the flax
    layout), applied as ``x @ kernel`` in the kernel's dtype, and with
    ``bias`` a ``[out]`` bias (zeros, as flax initializes it) added after
    the product."""

    def __init__(self, fan_in: int, fan_out: int, dtype, device,
                 bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(fan_in, fan_out, dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(fan_out, dtype=dtype, device=device))
                     if bias else None)

    def forward(self, x):
        y = x.to(self.kernel.dtype) @ self.kernel
        return y if self.bias is None else y + self.bias


class RMSNormWeight(nn.Module):
    """RMSNorm (``RMSNorm :206``): fp32 statistics, scaled by the fp32
    cast of ``weight``, output in x's dtype. With ``plus_one`` (Gemma) the
    stored ``weight`` is the scale less one, zeros at init, and the scale
    is ``1 + weight`` summed in fp32. Plain PyTorch: the JAX training
    model runs it as jnp, not as the K5 kernel."""

    def __init__(self, dim: int, dtype, device, eps: float = 1e-5,
                 plus_one: bool = False):
        super().__init__()
        self.eps = eps
        self.plus_one = plus_one
        init = torch.zeros if plus_one else torch.ones
        self.weight = nn.Parameter(init(dim, dtype=dtype, device=device))

    def scale(self) -> torch.Tensor:
        """The fp32 scale: ``1 + weight`` with ``plus_one``, else the
        weight's cast."""
        w = self.weight.float()
        return 1.0 + w if self.plus_one else w

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale()).to(x.dtype)


class LayerNormWeight(nn.Module):
    """LayerNorm with ``scale`` and ``bias`` (flax ``nn.LayerNorm``, the
    ``norm_type="layernorm"`` branch of ``_make_norm``): fp32 statistics
    with the centred variance, output in x's dtype. Plain PyTorch: the
    serving forward sends it to K5b (``ops/normalization.layer_norm``)."""

    def __init__(self, dim: int, dtype, device, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x):
        return layer_norm_reference(x, self.scale, self.bias, self.eps)


def _make_norm(cfg: LlamaConfig, dtype, device) -> nn.Module:
    if cfg.norm_type == "layernorm":
        return LayerNormWeight(cfg.hidden_size, dtype, device, cfg.rms_norm_eps)
    return RMSNormWeight(cfg.hidden_size, dtype, device, cfg.rms_norm_eps,
                         plus_one=cfg.norm_plus_one)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype, device, layer_idx: int = 0):
        super().__init__()
        h, hd = cfg.hidden_size, cfg.head_dim_
        nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        self.config = cfg
        self.layer_idx = layer_idx
        bias = cfg.attention_bias
        self.q_proj = Dense(h, nq * hd, dtype, device, bias)
        self.k_proj = Dense(h, nkv * hd, dtype, device, bias)
        self.v_proj = Dense(h, nkv * hd, dtype, device, bias)
        self.o_proj = Dense(nq * hd, h, dtype, device, cfg.attention_out_bias)

    def forward(self, x, cos, sin, positions, attn_mask=None):
        """The flash branch of the JAX layer (``:365-368``): the attention
        route (``ops/attention.flash_attention``) with this layer's window
        and the attention-logit softcap; with ``attn_mask`` the dense
        branch (``masked_attention``), which never reaches the kernels."""
        cfg = self.config
        b, s, _ = x.shape
        hd = cfg.head_dim_
        q = self.q_proj(x).reshape(b, s, cfg.num_attention_heads, hd)
        k = self.k_proj(x).reshape(b, s, cfg.num_key_value_heads, hd)
        v = self.v_proj(x).reshape(b, s, cfg.num_key_value_heads, hd)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        window = _layer_window(cfg, self.layer_idx)
        if attn_mask is not None:
            attn = masked_attention(q, k, v, attn_mask, positions, scale=cfg.attn_scale,
                                    window=window, softcap=cfg.attn_logit_softcapping)
        else:
            attn = flash_attention(q, k, v, causal=True, scale=cfg.attn_scale,
                                   window=window, softcap=cfg.attn_logit_softcapping)
        return self.o_proj(attn.reshape(b, s, -1))


def masked_attention(q, k, v, attn_mask, positions, scale=None, window=None,
                     softcap=None):
    """Causal attention under a ``[b, s]`` key-padding mask, the JAX
    layer's dense branch: q ``[b, s, H, D]``, k/v ``[b, s, KV, D]``. fp32
    scores of the compute-dtype operands. Without a softcap it is
    ``jax.nn.dot_product_attention(mask=..., is_causal=True)``'s XLA form:
    the scaled scores where the mask, the causal triangle and the window
    keep them, else ``-0.7 * max(fp32)``, an fp32 softmax, probabilities cast
    to v's dtype. With one (Gemma-2, ``:371-395``): ``cap * tanh(s / cap)``,
    masked to ``-1e30`` by position. A query row that sees no key spreads
    evenly over all keys in both, as in JAX."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    scl = scale if scale is not None else 1.0 / math.sqrt(hd)
    keep = attn_mask[:, None, None, :].bool()  # [b, 1, 1, s]
    if window is not None:
        keep = keep & ((positions[:, None, :, None] - positions[:, None, None, :]) < window)
    qg = q.reshape(b, s, nkv, g, hd).float()
    scores = torch.einsum("bqkgd,blkd->bkgql", qg, k.float()) * scl
    if softcap is None:
        causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        keep_all = keep[:, :, None] & causal  # [b, 1 or KV, 1, s, s] over (k, g)
        scores = torch.where(keep_all, scores,
                             -0.7 * torch.finfo(torch.float32).max)
        probs = torch.softmax(scores, -1).to(v.dtype)
        out = torch.einsum("bkgql,blkd->bqkgd", probs.float(), v.float()).to(q.dtype)
    else:
        scores = softcap * torch.tanh(scores / softcap)
        causal = (positions[:, :, None] >= positions[:, None, :])[:, None, None]
        scores = torch.where(causal & keep[:, :, None], scores, -1e30)
        probs = torch.softmax(scores, -1)
        out = torch.einsum("bkgql,blkd->bqkgd", probs, v.float()).to(q.dtype)
    return out.reshape(b, s, nq, hd)


def gate_act(gate, mlp_type: str):
    """The gated MLP's activation of its gate projection: silu (swiglu) or
    the tanh-approximate gelu (``geglu_tanh``)."""
    return F.silu(gate) if mlp_type == "swiglu" else F.gelu(gate, approximate="tanh")


class LlamaMLP(nn.Module):
    """swiglu (``gate_proj``, ``up_proj``, ``down_proj``), the same gated
    form with a tanh-approximate gelu gate for ``mlp_type="geglu_tanh"``
    (Gemma), or, for ``mlp_type="gelu_tanh_fc"``, the fc form: ``fc1``,
    tanh-approximate gelu, ``fc2``, each with a bias when ``mlp_bias``."""

    def __init__(self, cfg: LlamaConfig, dtype, device):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.mlp_type = cfg.mlp_type
        self.fc = cfg.mlp_type == "gelu_tanh_fc"
        if self.fc:
            self.fc1 = Dense(h, i, dtype, device, cfg.mlp_bias)
            self.fc2 = Dense(i, h, dtype, device, cfg.mlp_bias)
        else:
            self.gate_proj = Dense(h, i, dtype, device)
            self.up_proj = Dense(h, i, dtype, device)
            self.down_proj = Dense(i, h, dtype, device)

    def forward(self, x):
        if self.fc:
            return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
        return self.down_proj(gate_act(self.gate_proj(x), self.mlp_type) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype, device, layer_idx: int = 0):
        super().__init__()
        self.input_layernorm = _make_norm(cfg, dtype, device)
        self.self_attn = LlamaAttention(cfg, dtype, device, layer_idx)
        self.post_attention_layernorm = _make_norm(cfg, dtype, device)
        self.mlp = LlamaMLP(cfg, dtype, device)
        self.sandwich = cfg.sandwich_norm
        if self.sandwich:
            self.pre_feedforward_layernorm = _make_norm(cfg, dtype, device)
            self.post_feedforward_layernorm = _make_norm(cfg, dtype, device)

    def forward(self, x, cos, sin, positions, attn_mask=None):
        """The pre-norm branch (``:548-563``), or Gemma-2's sandwich norms
        (``:529-536``): the attention's and the MLP's outputs are normed
        too, before each residual add."""
        attn = self.self_attn(self.input_layernorm(x), cos, sin, positions, attn_mask)
        if self.sandwich:
            h = x + self.post_attention_layernorm(attn)
            return h + self.post_feedforward_layernorm(
                self.mlp(self.pre_feedforward_layernorm(h)))
        h = x + attn
        return h + self.mlp(self.post_attention_layernorm(h))


class _MatmulFp32(torch.autograd.Function):
    """``matmul_fp32`` with its backward: each cotangent product again
    takes operands in the compute dtype with fp32 accumulation."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return matmul_fp32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (matmul_fp32(g, b.t()).to(a.dtype),
                matmul_fp32(a.t(), g).to(b.dtype))


class LlamaModel(nn.Module):
    """A Llama decoder, named as the JAX tree's ``model`` node:
    ``embed_tokens.weight`` ``[vocab, hidden]`` (the tree's
    ``embed_tokens/embedding``), with ``embed_layernorm`` (``scale``,
    ``bias``) where the config sets it (BLOOM's word-embeddings LayerNorm),
    ``layers[i]`` (``layers_{i}``), ``norm`` and ``lm_head``. For serving (``trainable=False``) the weights take no
    gradient and ``lm_head`` is held in fp32: the serving forward computes
    fp32 logits of fp32 operands, as the JAX engine does. For training
    every weight takes a gradient and ``lm_head`` is in ``dtype`` like
    the rest (the unembed multiplies compute-dtype operands into fp32
    logits, ``LMHead :566``)."""

    def __init__(self, cfg: LlamaConfig, dtype=None, device=None,
                 trainable: bool = False):
        super().__init__()
        dtype = dtype or cfg.dtype
        self.config = cfg
        # no draw at construction (the initializers or a checkpoint fill the
        # table): the default CUDA generator may be unusable after a failed
        # graph capture elsewhere in the process
        table = torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=dtype, device=device)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, _weight=table)
        self.embed_layernorm = (LayerNormWeight(cfg.hidden_size, dtype, device,
                                                cfg.rms_norm_eps)
                                if cfg.embed_layernorm else None)
        if cfg.scan_layers:  # the JAX model's errors (``:657-667``)
            if cfg.sliding_window_layers is not None:
                raise ValueError(
                    "scan_layers requires homogeneous layers; per-layer "
                    "sliding_window_layers patterns need scan_layers=False")
            if cfg.num_hidden_layers % cfg.scan_chunk_size != 0:
                raise ValueError(
                    f"num_hidden_layers={cfg.num_hidden_layers} not divisible "
                    f"by scan_chunk_size={cfg.scan_chunk_size}")
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, dtype, device, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = _make_norm(cfg, dtype, device)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else Dense(cfg.hidden_size, cfg.vocab_size,
                                   dtype if trainable else torch.float32, device))
        for p in self.parameters():
            p.requires_grad_(trainable)

    def gather_units(self):
        """The layers chunk by chunk: one layer each, or with
        ``scan_layers`` chunks of ``scan_chunk_size`` (the JAX scan's step,
        ZeRO-3's gather unit, ``runtime/zero3.py``)."""
        cfg = self.config
        c = cfg.scan_chunk_size if cfg.scan_layers else 1
        return [list(self.layers[i:i + c]) for i in range(0, len(self.layers), c)]

    def forward(self, input_ids, positions=None, attn_mask=None, return_unembed=False):
        """Logits ``[b, s, vocab]`` fp32, or with ``return_unembed`` the
        final hidden states and the unembed weight ``[hidden, vocab]`` for
        the chunked CE. With ``remat`` each layer's activations are
        recomputed in the backward, under ``remat_policy`` (``nn.remat``
        of ``LlamaDecoderLayer``, ``_remat_layer_cls :597``)."""
        cfg = self.config
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device)
            positions = positions[None, :].expand(input_ids.shape)
        x = self.embed_tokens(input_ids)
        if cfg.embed_scale is not None:
            x = x * embed_scale(cfg, x.dtype)
        cos, sin = precompute_rope(cfg.head_dim_, cfg.max_position_embeddings,
                                   cfg.rope_theta, device=x.device)
        for layer in self.layers:
            if cfg.remat:
                x = checkpoint_with(cfg.remat_policy, layer, x, cos, sin, positions,
                                    attn_mask)
            else:
                x = layer(x, cos, sin, positions, attn_mask)
        x = self.norm(x)
        w = (self.embed_tokens.weight.t() if cfg.tie_word_embeddings
             else self.lm_head.kernel)
        if return_unembed:
            return x, w
        b, s, h = x.shape
        logits = _MatmulFp32.apply(x.reshape(b * s, h), w.to(x.dtype)).reshape(b, s, -1)
        return final_softcap(logits, cfg.final_logit_softcapping)


def embed_scale(cfg: LlamaConfig, dtype) -> torch.Tensor:
    """Gemma's embedding scale (sqrt of the hidden size) rounded to the
    compute dtype first, as HF and the JAX model do (``:640-642``):
    sqrt(3584) = 59.866 is 59.75 in bf16."""
    return torch.tensor(cfg.embed_scale, dtype=dtype)


def final_softcap(logits, cap):
    """Gemma-2's final logit softcap ``cap * tanh(logits / cap)`` on fp32
    logits (``:707-709``); the logits as they are without a cap."""
    return logits if cap is None else cap * torch.tanh(logits / cap)


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Token-mean CE with shift-by-one (causal LM), in fp32."""
    logits = logits[:, :-1].float()
    targets, mask = causal_targets(labels, ignore_index)
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    return ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)


class LlamaForCausalLM(nn.Module):
    """The engine contract: the scalar loss when ``labels`` are given,
    else the fp32 logits. Trainable weights under ``model``, as the JAX
    tree. ``ce_chunk_size`` selects the chunked CE."""

    def __init__(self, config: LlamaConfig, dtype=None, device=None):
        super().__init__()
        check_supported(config, "LlamaForCausalLM", TRAINING_FAMILY)
        if config.remat:
            resolve_policy(config.remat_policy)
        self.config = config
        self.model = LlamaModel(config, dtype, device, trainable=True)

    def forward(self, input_ids, labels=None, positions=None, attn_mask=None):
        cfg = self.config
        if labels is not None and cfg.ce_chunk_size:
            x, w = self.model(input_ids, positions, attn_mask, return_unembed=True)
            return chunked_cross_entropy_loss(x, w, labels, cfg.ce_chunk_size,
                                              compute_dtype=x.dtype,
                                              softcap=cfg.final_logit_softcapping)
        logits = self.model(input_ids, positions, attn_mask)
        if labels is None:
            return logits
        return cross_entropy_loss(logits, labels)

    def gather_units(self):
        return self.model.gather_units()

    def loss_token_count(self, input_ids, labels=None, positions=None, attn_mask=None,
                         ignore_index: int = -100):
        """The number of targets the loss averages over (the CE's
        ``causal_targets`` weights summed), or None without labels: the
        engine's weight of this batch in a global token mean."""
        if labels is None:
            return None
        return causal_targets(labels, ignore_index)[1].sum()


def _lecun_normal_(t: torch.Tensor, gen: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal at two standard deviations,
    variance 1/fan_in (fan_in = the kernel's first dim), drawn in fp32."""
    std = math.sqrt(1.0 / t.shape[0]) / 0.87962566103423978
    buf = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(buf, std=std, a=-2 * std, b=2 * std, generator=gen)
    t.copy_(buf)


@torch.no_grad()
def _init_weights(model: LlamaModel, seed: int) -> None:
    device = model.embed_tokens.weight.device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    emb = torch.empty(model.embed_tokens.weight.shape, dtype=torch.float32,
                      device=device)
    emb.normal_(0.0, 0.02, generator=gen)
    model.embed_tokens.weight.copy_(emb)
    del emb
    for mod in model.modules():
        if isinstance(mod, Dense):
            _lecun_normal_(mod.kernel, gen)


def init_llama(config: LlamaConfig, seed: int = 0, dtype=None,
               device=None) -> LlamaModel:
    """Seeded random serving weights on ``device`` (default ``cuda``),
    following ``init_llama``'s initializers: lecun-normal projection
    kernels, normal(0.02) embeddings, ones for norm scales (zeros for
    Gemma's ``1 + w`` norms), zeros for biases (projections' and
    LayerNorm's). The numbers
    differ from JAX's (another generator); load JAX weights through
    ``models/convert.params_from_jax`` to compare the two."""
    model = LlamaModel(config, dtype=dtype, device=torch.device(device or "cuda"))
    _init_weights(model, seed)
    return model


def init_llama_for_causal_lm(config: LlamaConfig, seed: int = 0, dtype=None,
                             device=None) -> LlamaForCausalLM:
    """Seeded random trainable weights on ``device`` (default ``cuda``),
    with ``init_llama``'s initializers."""
    model = LlamaForCausalLM(config, dtype=dtype,
                             device=torch.device(device or "cuda"))
    _init_weights(model.model, seed)
    return model
