"""HF checkpoint conversion (port of
``deepspeed_tpu/module_inject/replace_module.py:38 convert_hf_checkpoint``).

An HF state dict becomes the port's :class:`LlamaModel`, whose parameters
keep the JAX package's names and layout, so the policies' maps carry over
as they are. Each HF tensor is converted on its own and copied into its
parameter, so the host holds one fp32 tensor at a time, not a second copy
of the checkpoint.
"""

import logging
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.convert import jax_key_path
from ..models.llama import LlamaConfig, LlamaModel
from .replace_policy import policy_for

logger = logging.getLogger(__name__)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x)


@torch.no_grad()
def convert_hf_checkpoint(arch: str, hf_state_dict: Dict[str, Any],
                          hf_config: Dict, dtype=torch.bfloat16,
                          device=None) -> Tuple[LlamaConfig, LlamaModel]:
    """HF state dict (torch tensors or numpy arrays) and HF config dict ->
    ``(LlamaConfig, LlamaModel)`` for serving, the weights in ``dtype`` on
    ``device`` (default ``cuda``; the unembed in fp32, as
    ``build_llama_engine`` holds it). Torch ``[out, in]`` weights are
    transposed to ``[in, out]``. Fused tensors the policy names in
    ``special_hf_names`` go through its ``convert_special`` (the JAX
    converter's ``:72-81``), which splits each into several parameters. A
    name the policy maps that the state dict lacks raises ``KeyError``;
    tensors no map names are logged and skipped."""
    policy = policy_for(arch)
    cfg = policy.config_from_hf(hf_config)
    model = LlamaModel(cfg, dtype=dtype, device=torch.device(device or "cuda"))
    params = {"/".join(jax_key_path(name)): p for name, p in model.named_parameters()}
    maps = dict(policy.global_map(cfg.tie_word_embeddings))
    for layer in range(cfg.num_hidden_layers):
        maps.update(policy.weight_map(layer, attention_bias=cfg.attention_bias))
    filled = set()
    consumed = set(maps)

    def get_tensor(hf_name):
        if hf_name not in hf_state_dict:
            raise KeyError(f"HF checkpoint missing '{hf_name}' (arch={arch})")
        consumed.add(hf_name)
        return _to_numpy(hf_state_dict[hf_name]).astype(np.float32)

    def put(path, w, source):
        dst = params[path]
        if tuple(w.shape) != tuple(dst.shape):
            raise ValueError(f"{source}: shape {w.shape} != {tuple(dst.shape)} "
                             f"of {path}")
        dst.copy_(torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32)))
        filled.add(path)

    for hf_name, (path, transpose) in maps.items():
        w = get_tensor(hf_name)
        # torch Linear [out, in] -> kernel [in, out]
        put(path, w.T if transpose else w, hf_name)
    if hasattr(policy, "convert_special"):
        for layer in range(cfg.num_hidden_layers):
            policy.convert_special(layer, cfg, get_tensor,
                                   lambda path, w: put(path, np.asarray(w), path))
    unfilled = sorted(set(params) - filled)
    if unfilled:
        raise ValueError(f"{arch}: the policy fills no HF tensor into {unfilled[:8]}")
    leftovers = [k for k in hf_state_dict if k not in consumed
                 and not k.endswith("rotary_emb.inv_freq")]
    if leftovers:
        logger.warning(f"unconverted HF tensors: {leftovers[:8]}"
                       f"{'...' if len(leftovers) > 8 else ''}")
    return cfg, model
