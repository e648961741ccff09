"""Load a JAX Llama param tree into the port's modules.

The tree is the one ``deepspeed_tpu.models.llama.init_llama`` returns (or a
checkpoint of it), with numpy leaves: ``tree['model']['layers_0']
['self_attn']['q_proj']['kernel']`` of shape ``[in, out]``,
``['model']['embed_tokens']['embedding']`` of shape ``[vocab, hidden]``,
RMSNorm scales under ``['weight']``, LayerNorm ones under ``['scale']`` and
``['bias']`` (BLOOM's embedding LayerNorm too, as ``['model']
['embed_layernorm']``), projection biases (q/k/v/o, ``mlp/fc1``,
``mlp/fc2``) under ``['bias']``. Shapes carry over unchanged, because the
port keeps the flax layout; :func:`jax_key_path` maps a port parameter
name onto its path in the tree. The tree of a scanned model
(``scan_layers``) holds each layer's leaves stacked: ``['model']['layers']
['layer']`` with a leading ``[L]`` axis, or with ``scan_chunk_size`` c
``['layer_0']`` .. ``['layer_{c-1}']`` with ``[L / c]``, layer ``j`` at
index ``j // c`` of ``layer_{j % c}``; :func:`lookup` reads both.
:func:`quantized_from_jax` carries a JAX
``QuantizedParameter``'s stored int8 values and scales over as they are.
"""

from typing import List

import numpy as np
import torch

from ..linear.quantization import QuantizedParameter
from ..utils.dtypes import resolve_dtype
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel


def jax_key_path(name: str) -> List[str]:
    """The JAX tree path of a port parameter name, relative to the tree
    the module mirrors: ``layers.3.mlp.up_proj.kernel`` ->
    ``['layers_3', 'mlp', 'up_proj', 'kernel']``,
    ``model.embed_tokens.weight`` -> ``['model', 'embed_tokens',
    'embedding']``."""
    parts = name.split(".")
    path = []
    i = 0
    while i < len(parts):
        if parts[i] == "layers":
            path.append(f"layers_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    if path[-2:] == ["embed_tokens", "weight"]:
        path[-1] = "embedding"
    return path


def universal_name(name: str) -> str:
    """A port parameter's name in the universal checkpoint layout
    (``checkpoint/universal.py``): its JAX tree path, dotted, as the JAX
    package's ``_flatten`` of the param tree writes it
    (``model.layers.0.mlp.up_proj.kernel`` ->
    ``model.layers_0.mlp.up_proj.kernel``)."""
    return ".".join(jax_key_path(name))


def lookup(tree, name: str):
    """The leaf of ``tree`` that port parameter ``name`` mirrors (a slice
    of a stacked leaf for a layer of a scanned model)."""
    node, index = tree, None
    for key in jax_key_path(name):
        if key.startswith("layers_") and key not in node and "layers" in node:
            j = int(key[len("layers_"):])
            scanned = node["layers"]
            c = 1 if "layer" in scanned else len(scanned)
            node, index = scanned["layer" if c == 1 else f"layer_{j % c}"], j // c
        else:
            node = node[key]
    return node if index is None else node[index]


@torch.no_grad()
def params_from_jax(tree, config: LlamaConfig, dtype=None, device=None,
                    training: bool = False):
    """A module holding ``tree``'s values, cast to ``dtype`` (default
    ``config.dtype``) on ``device`` (default ``cuda``). For serving, a
    :class:`LlamaModel` with an fp32 ``lm_head``; with ``training``, a
    :class:`LlamaForCausalLM` whose weights all take gradients, ``lm_head``
    in ``dtype`` too."""
    device = torch.device(device or "cuda")
    if training:
        module = LlamaForCausalLM(config, dtype=dtype, device=device)
        root = tree if "model" in tree else {"model": tree}
    else:
        module = LlamaModel(config, dtype=dtype, device=device)
        root = tree["model"] if "model" in tree else tree
    for name, dst in module.named_parameters():
        arr = np.array(lookup(root, name), dtype=np.float32)  # a writable copy
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} != port shape "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr))
    return module


def quantized_from_jax(qp, device=None) -> QuantizedParameter:
    """The port's :class:`QuantizedParameter` holding the values and scales
    of ``qp``, a ``deepspeed_tpu.linear.quantization.QuantizedParameter``
    (any object with its fields, arrays convertible by numpy), on
    ``device`` (default ``cuda``)."""
    device = torch.device(device or "cuda")
    values = torch.from_numpy(np.array(qp.values, dtype=np.int8)).to(device)
    scales = torch.from_numpy(np.array(qp.scales, dtype=np.float32)).to(device)
    return QuantizedParameter(values, scales, tuple(qp.shape), int(qp.block_size),
                              dtype=resolve_dtype(np.dtype(qp.dtype).name),
                              q_bits=int(qp.q_bits), shard_dim=qp.shard_dim,
                              shards=int(qp.shards))
