"""Per-architecture HF checkpoint policies (port of
``deepspeed_tpu/module_inject/replace_policy.py``: ``HFCheckpointPolicy``
:23, ``GemmaPolicy`` :262, ``Gemma2Policy`` :280, ``BloomPolicy`` :825,
``Starcoder2Policy`` :1035, ``policy_for`` :1343).

A policy maps an HF config dict onto a :class:`LlamaConfig` and names, for
every HF tensor, the parameter it fills in the JAX package's tree layout
(``layers_3/self_attn/q_proj/kernel``) and whether it is transposed (torch
``Linear`` stores ``[out, in]``, the kernels ``[in, out]``). The port keeps
the layout, so ``replace_module.convert_hf_checkpoint`` loads the same
names. A policy may also name fused HF tensors (``special_hf_names``) that
its ``convert_special`` splits into several parameters (BLOOM's
``query_key_value``). Only the architectures the port runs are registered:
Llama, Mistral (trained), Gemma and Gemma-2 (served and trained),
StarCoder2 and BLOOM (served). Every other one raises
``NotImplementedError``.
"""

import dataclasses
from typing import Dict, Tuple

import numpy as np

from ..models.llama import LlamaConfig

# bigcode/starcoder2-7b config.json, as published. tie_word_embeddings is
# absent there, so the policy reads it as tied (its default), which matches
# the model's 7.17 B parameters. Assumed: nothing else; keys the port does
# not read (dropouts, initializer_range, token ids, torch_dtype) are left
# out.
STARCODER2_7B = {
    "architectures": ["Starcoder2ForCausalLM"],
    "model_type": "starcoder2",
    "vocab_size": 49152,
    "hidden_size": 4608,
    "intermediate_size": 18432,
    "num_hidden_layers": 32,
    "num_attention_heads": 36,
    "num_key_value_heads": 4,
    "max_position_embeddings": 16384,
    "rope_theta": 1000000,
    "sliding_window": 4096,
    "norm_epsilon": 1e-05,
    "use_bias": True,
    "hidden_act": "gelu_pytorch_tanh",
}


class HFCheckpointPolicy:
    """Base policy, and Llama's: the Llama weight map (LLaMA 2/3)."""

    arch: str = "llama"

    def config_from_hf(self, hf_config: Dict) -> LlamaConfig:
        """Map an HF config dict to LlamaConfig."""
        return LlamaConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["hidden_size"],
            intermediate_size=hf_config["intermediate_size"],
            num_hidden_layers=hf_config["num_hidden_layers"],
            num_attention_heads=hf_config["num_attention_heads"],
            num_key_value_heads=hf_config.get("num_key_value_heads",
                                              hf_config["num_attention_heads"]),
            max_position_embeddings=hf_config.get("max_position_embeddings", 8192),
            rms_norm_eps=hf_config.get("rms_norm_eps", 1e-5),
            rope_theta=hf_config.get("rope_theta", 10000.0),
            tie_word_embeddings=hf_config.get("tie_word_embeddings", False),
        )

    def weight_map(self, layer: int, attention_bias: bool = False
                   ) -> Dict[str, Tuple[str, bool]]:
        """HF name -> (tree path under the model, transpose?)."""
        p = f"model.layers.{layer}."
        f = f"layers_{layer}/"
        out = {}
        if attention_bias:  # 1-D: no transpose
            for proj in ("q_proj", "k_proj", "v_proj"):
                out[p + f"self_attn.{proj}.bias"] = (f + f"self_attn/{proj}/bias", False)
        out.update({
            p + "self_attn.q_proj.weight": (f + "self_attn/q_proj/kernel", True),
            p + "self_attn.k_proj.weight": (f + "self_attn/k_proj/kernel", True),
            p + "self_attn.v_proj.weight": (f + "self_attn/v_proj/kernel", True),
            p + "self_attn.o_proj.weight": (f + "self_attn/o_proj/kernel", True),
            p + "mlp.gate_proj.weight": (f + "mlp/gate_proj/kernel", True),
            p + "mlp.up_proj.weight": (f + "mlp/up_proj/kernel", True),
            p + "mlp.down_proj.weight": (f + "mlp/down_proj/kernel", True),
            p + "input_layernorm.weight": (f + "input_layernorm/weight", False),
            p + "post_attention_layernorm.weight": (f + "post_attention_layernorm/weight",
                                                    False),
        })
        return out

    def global_map(self, tie_embeddings: bool) -> Dict[str, Tuple[str, bool]]:
        out = {
            "model.embed_tokens.weight": ("embed_tokens/embedding", False),
            "model.norm.weight": ("norm/weight", False),
        }
        if not tie_embeddings:
            out["lm_head.weight"] = ("lm_head/kernel", True)
        return out


# mistralai/Mistral-7B-v0.1 config.json, as published; keys the port does
# not read (dropouts, initializer_range, token ids, torch_dtype,
# hidden_act "silu", which is the swiglu MLP's) are left out
MISTRAL_7B = {
    "architectures": ["MistralForCausalLM"],
    "model_type": "mistral",
    "vocab_size": 32000,
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-05,
    "rope_theta": 10000.0,
    "sliding_window": 4096,
    "tie_word_embeddings": False,
}


class MistralPolicy(HFCheckpointPolicy):
    """Mistral: the Llama graph with sliding-window attention; Llama's
    weight map."""
    arch = "mistral"

    def config_from_hf(self, hf_config):
        cfg = super().config_from_hf(hf_config)
        return dataclasses.replace(cfg, sliding_window=hf_config.get("sliding_window"))


# google/gemma-2-9b config.json, as published; keys the port does not read
# (dropouts, initializer_range, token ids, torch_dtype, cache_implementation,
# hidden_act) are left out. hidden_activation "gelu_pytorch_tanh" is the
# policy's tanh-gelu gate; tie_word_embeddings is absent there and the
# policy ties them, as Gemma does. 9,241,705,984 parameters.
GEMMA2_9B = {
    "architectures": ["Gemma2ForCausalLM"],
    "model_type": "gemma2",
    "vocab_size": 256000,
    "hidden_size": 3584,
    "intermediate_size": 14336,
    "num_hidden_layers": 42,
    "num_attention_heads": 16,
    "num_key_value_heads": 8,
    "head_dim": 256,
    "max_position_embeddings": 8192,
    "rms_norm_eps": 1e-06,
    "rope_theta": 10000.0,
    "sliding_window": 4096,
    "query_pre_attn_scalar": 256,
    "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0,
    "hidden_activation": "gelu_pytorch_tanh",
}


class GemmaPolicy(HFCheckpointPolicy):
    """Gemma (v1): the Llama graph with the (1 + w) RMSNorm, the sqrt(hidden)
    embedding scale (rounded through the compute dtype, as HF does), the
    tanh-gelu gated MLP, an explicit head_dim and tied embeddings; Llama's
    weight map."""
    arch = "gemma"

    def config_from_hf(self, hf_config):
        cfg = super().config_from_hf(hf_config)
        return dataclasses.replace(
            cfg, tie_word_embeddings=True, norm_plus_one=True,
            head_dim=hf_config.get(
                "head_dim", hf_config["hidden_size"] // hf_config["num_attention_heads"]),
            embed_scale=float(hf_config["hidden_size"]) ** 0.5,
            mlp_type="geglu_tanh")


class Gemma2Policy(GemmaPolicy):
    """Gemma-2: Gemma with the sandwich norms (pre and post around both
    sublayers), the attention and final logit softcaps, the scale from
    query_pre_attn_scalar, and a sliding window on every even layer (HF:
    ``not bool(layer_idx % 2)``)."""
    arch = "gemma2"

    def config_from_hf(self, hf_config):
        cfg = super().config_from_hf(hf_config)
        return dataclasses.replace(
            cfg, sandwich_norm=True,
            attn_scale=float(hf_config.get("query_pre_attn_scalar", 256)) ** -0.5,
            attn_logit_softcapping=hf_config.get("attn_logit_softcapping", 50.0),
            final_logit_softcapping=hf_config.get("final_logit_softcapping", 30.0),
            sliding_window=hf_config.get("sliding_window"),
            sliding_window_layers=tuple(range(0, hf_config["num_hidden_layers"], 2)))

    def weight_map(self, layer: int, attention_bias: bool = False):
        out = super().weight_map(layer, attention_bias)
        p = f"model.layers.{layer}."
        f = f"layers_{layer}/"
        for norm in ("pre_feedforward_layernorm", "post_feedforward_layernorm"):
            out[p + f"{norm}.weight"] = (f + f"{norm}/weight", False)
        return out


class Starcoder2Policy(HFCheckpointPolicy):
    """StarCoder2: GQA, LayerNorm with bias, biased gelu-tanh fc MLP,
    sliding window, tied embeddings."""
    arch = "starcoder2"

    def config_from_hf(self, hf_config):
        bias = hf_config.get("use_bias", True)
        return LlamaConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["hidden_size"],
            intermediate_size=hf_config["intermediate_size"],
            num_hidden_layers=hf_config["num_hidden_layers"],
            num_attention_heads=hf_config["num_attention_heads"],
            num_key_value_heads=hf_config.get("num_key_value_heads",
                                              hf_config["num_attention_heads"]),
            max_position_embeddings=hf_config.get("max_position_embeddings", 4096),
            rms_norm_eps=hf_config.get("norm_epsilon", 1e-5),
            rope_theta=hf_config.get("rope_theta", 10000.0),
            tie_word_embeddings=hf_config.get("tie_word_embeddings", True),
            attention_bias=bias,
            attention_out_bias=bias,
            norm_type="layernorm",
            mlp_type="gelu_tanh_fc",  # HF "gelu_pytorch_tanh"
            mlp_bias=bias,
            sliding_window=hf_config.get("sliding_window"),
        )

    def weight_map(self, layer: int, attention_bias: bool = False):
        p = f"model.layers.{layer}."
        f = f"layers_{layer}/"
        out = {}
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[p + f"self_attn.{proj}.weight"] = (f + f"self_attn/{proj}/kernel", True)
            if attention_bias:
                out[p + f"self_attn.{proj}.bias"] = (f + f"self_attn/{proj}/bias", False)
        if attention_bias:
            out[p + "mlp.c_fc.bias"] = (f + "mlp/fc1/bias", False)
            out[p + "mlp.c_proj.bias"] = (f + "mlp/fc2/bias", False)
        out.update({
            p + "mlp.c_fc.weight": (f + "mlp/fc1/kernel", True),
            p + "mlp.c_proj.weight": (f + "mlp/fc2/kernel", True),
            p + "input_layernorm.weight": (f + "input_layernorm/scale", False),
            p + "input_layernorm.bias": (f + "input_layernorm/bias", False),
            p + "post_attention_layernorm.weight": (f + "post_attention_layernorm/scale",
                                                    False),
            p + "post_attention_layernorm.bias": (f + "post_attention_layernorm/bias",
                                                  False),
        })
        return out

    def global_map(self, tie_embeddings: bool):
        out = {
            "model.embed_tokens.weight": ("embed_tokens/embedding", False),
            "model.norm.weight": ("norm/scale", False),
            "model.norm.bias": ("norm/bias", False),
        }
        if not tie_embeddings:
            out["lm_head.weight"] = ("lm_head/kernel", True)
        return out


# bigscience/bloom-7b1 config.json, as published; keys the port does not
# read (dropouts, initializer_range, token ids, the fused-kernel flags,
# offset_alibi, pretraining_tp) are left out. seq_length is absent there,
# so the policy reads 2048, the length BLOOM was trained at.
BLOOM_7B1 = {
    "architectures": ["BloomForCausalLM"],
    "model_type": "bloom",
    "vocab_size": 250880,
    "hidden_size": 4096,
    "n_layer": 30,
    "n_head": 32,
    "layer_norm_epsilon": 1e-05,
    "apply_residual_connection_post_layernorm": False,
}


class BloomPolicy(HFCheckpointPolicy):
    """BLOOM: ALiBi positions, embedding LayerNorm, per-head-interleaved
    fused query_key_value, gelu-tanh MLP, biases everywhere, tied
    embeddings."""
    arch = "bloom"

    def config_from_hf(self, hf_config):
        if hf_config.get("apply_residual_connection_post_layernorm"):
            raise ValueError("bloom apply_residual_connection_post_layernorm=True "
                             "is not supported (pre-LN residual only)")
        h = hf_config.get("hidden_size") or hf_config["n_embed"]
        return LlamaConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=h,
            intermediate_size=4 * h,
            num_hidden_layers=hf_config["n_layer"],
            num_attention_heads=hf_config["n_head"],
            num_key_value_heads=hf_config["n_head"],
            max_position_embeddings=hf_config.get("seq_length", 2048),
            rms_norm_eps=hf_config.get("layer_norm_epsilon", 1e-5),
            tie_word_embeddings=True,
            attention_bias=True,
            attention_out_bias=True,
            norm_type="layernorm",
            pos_embedding="alibi",
            embed_layernorm=True,
            mlp_type="gelu_tanh_fc",  # BloomGelu = tanh approximation
            mlp_bias=True,
        )

    def weight_map(self, layer: int, attention_bias: bool = False):
        p = f"transformer.h.{layer}."
        f = f"layers_{layer}/"
        return {
            p + "input_layernorm.weight": (f + "input_layernorm/scale", False),
            p + "input_layernorm.bias": (f + "input_layernorm/bias", False),
            p + "post_attention_layernorm.weight": (f + "post_attention_layernorm/scale",
                                                    False),
            p + "post_attention_layernorm.bias": (f + "post_attention_layernorm/bias",
                                                  False),
            p + "self_attention.dense.weight": (f + "self_attn/o_proj/kernel", True),
            p + "self_attention.dense.bias": (f + "self_attn/o_proj/bias", False),
            p + "mlp.dense_h_to_4h.weight": (f + "mlp/fc1/kernel", True),
            p + "mlp.dense_h_to_4h.bias": (f + "mlp/fc1/bias", False),
            p + "mlp.dense_4h_to_h.weight": (f + "mlp/fc2/kernel", True),
            p + "mlp.dense_4h_to_h.bias": (f + "mlp/fc2/bias", False),
        }

    def special_hf_names(self, layer: int):
        p = f"transformer.h.{layer}.self_attention.query_key_value."
        return [p + "weight", p + "bias"]

    def convert_special(self, layer: int, cfg: LlamaConfig, get_tensor, put):
        """Fused qkv rows are grouped per head as [q_i | k_i | v_i]."""
        p = f"transformer.h.{layer}.self_attention.query_key_value."
        hd = cfg.head_dim_
        nq = cfg.num_attention_heads
        w = np.asarray(get_tensor(p + "weight")).reshape(nq, 3, hd, cfg.hidden_size)
        b = np.asarray(get_tensor(p + "bias")).reshape(nq, 3, hd)
        f = f"layers_{layer}/self_attn/"
        for i, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            put(f + f"{proj}/kernel", w[:, i].reshape(nq * hd, cfg.hidden_size).T)
            put(f + f"{proj}/bias", b[:, i].reshape(nq * hd))

    def global_map(self, tie_embeddings: bool):
        return {
            "transformer.word_embeddings.weight": ("embed_tokens/embedding", False),
            "transformer.word_embeddings_layernorm.weight": ("embed_layernorm/scale",
                                                             False),
            "transformer.word_embeddings_layernorm.bias": ("embed_layernorm/bias", False),
            "transformer.ln_f.weight": ("norm/scale", False),
            "transformer.ln_f.bias": ("norm/bias", False),
        }


_POLICIES = {
    "llama": HFCheckpointPolicy,
    "LlamaForCausalLM": HFCheckpointPolicy,
    "mistral": MistralPolicy,
    "MistralForCausalLM": MistralPolicy,
    "gemma": GemmaPolicy,
    "GemmaForCausalLM": GemmaPolicy,
    "gemma2": Gemma2Policy,
    "Gemma2ForCausalLM": Gemma2Policy,
    "starcoder2": Starcoder2Policy,
    "Starcoder2ForCausalLM": Starcoder2Policy,
    "bloom": BloomPolicy,
    "BloomForCausalLM": BloomPolicy,
}


def policy_for(arch_or_model_type: str) -> HFCheckpointPolicy:
    """The policy of an HF ``model_type`` or architecture name."""
    pol = _POLICIES.get(arch_or_model_type)
    if pol is None:
        raise NotImplementedError(
            f"no HF checkpoint policy for '{arch_or_model_type}' in the port "
            f"yet; ported: {sorted(_POLICIES)}")
    return pol()
