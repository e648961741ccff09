"""ZeRO-3 live-parameter governor (port of
``deepspeed_tpu/runtime/zero_governor.py``).

Reference: ``runtime/zero/config.py:205-228`` (``stage3_max_live_parameters``)
and ``partitioned_param_coordinator.py:262``. In the port the ceiling is
structural, as in JAX: stage 3 gathers one gather unit at a time
(``runtime/zero3.py``), a decoder layer, or with ``scan_layers`` a chunk
of ``scan_chunk_size`` layers, and ``chunk_size_for`` derives that chunk
from the budget. The engine logs the advisory (``max_live_advisory``)
when a stage-3 model exceeds the budget without scanned layers. The JAX
module's ``governed_layer_scan`` (a ``lax.scan`` utility) has no
counterpart: the model applies its layers chunk by chunk itself.
"""

from typing import Iterable, Optional

import torch


def per_layer_elements(layer_params: Iterable[torch.Tensor]) -> int:
    """Elements of one layer (its parameters; the JAX function takes the
    stacked ``[L, ...]`` leaves and drops the layer axis)."""
    return int(sum(p.numel() for p in layer_params))


def chunk_size_for(n_layers: int, per_layer_elems: int,
                   max_live_parameters: Optional[int]) -> int:
    """Largest divisor of n_layers whose chunk stays under the budget.

    A chunk's params are gathered while it computes and again during its
    backward recompute, so the budget covers one chunk (reference semantics:
    max_live_parameters bounds the coordinator's in-flight gather set).
    """
    if not max_live_parameters or per_layer_elems <= 0:
        return 1
    want = max(1, int(max_live_parameters // per_layer_elems))
    best = 1
    for c in range(1, min(want, n_layers) + 1):
        if n_layers % c == 0:
            best = c
    return best


def gather_bucket_mb(bucket_size_mb: float,
                     max_live_parameters: Optional[int] = None,
                     prefetch_bucket_size: Optional[int] = None,
                     itemsize: int = 4) -> float:
    """Effective bucket budget (MB) for a scheduled ZeRO-3 parameter store:
    at most half ``max_live_parameters`` (two bucket epochs in flight) and
    at most ``prefetch_bucket_size``, both element counts converted at
    ``itemsize``."""
    cap: Optional[int] = None
    if max_live_parameters and max_live_parameters > 0:
        cap = int(max_live_parameters) // 2
    if prefetch_bucket_size and prefetch_bucket_size > 0:
        cap = min(cap, int(prefetch_bucket_size)) if cap is not None \
            else int(prefetch_bucket_size)
    if cap is None:
        return bucket_size_mb
    cap_mb = max(cap * itemsize / 2**20, 1 / 2**20)
    return min(bucket_size_mb, cap_mb)


def max_live_advisory(n_elements: int, max_live_parameters: int,
                      scan_governed: bool) -> Optional[str]:
    """The JAX engine's warning (``runtime/engine.py:342-358``) when a
    stage-3 model's parameters exceed ``stage3_max_live_parameters`` and
    its layers are not scanned in chunks; None otherwise."""
    if n_elements <= max_live_parameters or scan_governed:
        return None
    return (f"ZeRO-3: model has {n_elements:.3g} elements > "
            f"stage3_max_live_parameters={max_live_parameters:.3g}. "
            "Gathering may exceed the budget on an unscanned model: use "
            "scan_layers with scan_chunk_size from zero_governor.chunk_size_for "
            "to make the ceiling structural.")
