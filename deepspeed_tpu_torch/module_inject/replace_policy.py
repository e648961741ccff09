"""Per-architecture HF checkpoint policies (port of
``deepspeed_tpu/module_inject/replace_policy.py``: ``HFCheckpointPolicy``
:23, ``Starcoder2Policy`` :1035, ``policy_for`` :1343).

A policy maps an HF config dict onto a :class:`LlamaConfig` and names, for
every HF tensor, the parameter it fills in the JAX package's tree layout
(``layers_3/self_attn/q_proj/kernel``) and whether it is transposed (torch
``Linear`` stores ``[out, in]``, the kernels ``[in, out]``). The port keeps
the layout, so ``replace_module.convert_hf_checkpoint`` loads the same
names. Only the architectures the port runs are registered: Llama,
Mistral (trained) and StarCoder2 (served). Every other one raises
``NotImplementedError``.
"""

import dataclasses
from typing import Dict, Tuple

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


_POLICIES = {
    "llama": HFCheckpointPolicy,
    "LlamaForCausalLM": HFCheckpointPolicy,
    "mistral": MistralPolicy,
    "MistralForCausalLM": MistralPolicy,
    "starcoder2": Starcoder2Policy,
    "Starcoder2ForCausalLM": Starcoder2Policy,
}


def policy_for(arch_or_model_type: str) -> HFCheckpointPolicy:
    """The policy of an HF ``model_type`` or architecture name."""
    pol = _POLICIES.get(arch_or_model_type)
    if pol is None:
        raise NotImplementedError(
            f"no HF checkpoint policy for '{arch_or_model_type}' in the port "
            f"yet; ported: {sorted(_POLICIES)}")
    return pol()
