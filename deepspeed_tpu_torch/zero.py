"""``deepspeed.zero`` API surface (port of ``deepspeed_tpu/zero.py``;
reference ``runtime/zero/partition_parameters.py``: ``Init :816``,
``GatheredParameters :2065``, ``register_external_parameter :128``).

- ``Init``: a context to build a model in. The port builds it on the CPU
  (the caller passes ``device="cpu"``); a stage-3 engine then moves only
  its own shards to the card (``runtime/engine.py``). It records the
  reference's keyword arguments, as the JAX shim does, so launch scripts
  port without edits.
- ``GatheredParameters(params, modifier_rank=None)``: within the block the
  stage-3 parameters among ``params`` are whole (their units gathered and
  pinned, ``runtime/zero3.py``); with ``modifier_rank`` (an index along the
  data-parallel axes) that rank's values are broadcast when the block
  closes and written into every rank's masters and compute shards. At
  stages 0-2 the parameters are whole already, and ``modifier_rank`` still
  writes the edit into the masters.
- ``register_external_parameter`` / ``unregister_external_parameter``: a
  parameter used outside its owning module. The port gathers the rest of
  the model (embedding, norm, head) around the whole forward, so a tied
  embedding is whole at every use and there is nothing to register: they
  do nothing, as in JAX.
"""

import contextlib
import weakref
from typing import Any, Optional

import torch

_OWNERS = weakref.WeakValueDictionary()  # id(parameter) -> engine


def register(engine, params) -> None:
    """``engine`` trains ``params`` (its ``GatheredParameters`` routing)."""
    for p in params:
        _OWNERS[id(p)] = engine


def _owner(p):
    eng = _OWNERS.get(id(p))
    return eng if eng is not None and id(p) in eng._index and \
        eng._params[eng._index[id(p)]] is p else None


class Init(contextlib.AbstractContextManager):
    """Context manager for sharded model construction (reference
    ``Init``): build the model on the CPU inside it and hand it to
    ``initialize`` with ZeRO stage 3."""

    def __init__(self, module=None, data_parallel_group=None, mem_efficient_linear=True,
                 remote_device=None, pin_memory=False, config_dict_or_path=None,
                 config=None, enabled=True, dtype=None, mpu=None,
                 sequence_data_parallel_group=None, param_swapper=None):
        self.enabled = enabled
        self.remote_device = remote_device
        self.config = config_dict_or_path if config_dict_or_path is not None else config
        self.dtype = dtype

    def __exit__(self, *exc):
        return False


@contextlib.contextmanager
def GatheredParameters(params: Any, modifier_rank: Optional[int] = None,
                       fwd_module=None, enabled: bool = True):
    """Whole stage-3 parameters for the block; with ``modifier_rank``
    that rank's edits reach every rank's shards when it closes (a
    collective: every rank enters the block)."""
    plist = [params] if isinstance(params, torch.Tensor) else list(params or [])
    groups = {}
    for p in plist:
        eng = _owner(p)
        if eng is not None:
            groups.setdefault(id(eng), (eng, []))[1].append(p)
    if not enabled or not groups:
        yield params
        return
    pinned = [(eng, ps, eng._user_gather(ps)) for eng, ps in groups.values()]
    try:
        yield params
    finally:
        for eng, ps, ks in pinned:
            eng._user_release(ps, ks, modifier_rank)


def register_external_parameter(module, parameter) -> None:
    """Reference ``partition_parameters.py:128``."""
    return None


def unregister_external_parameter(module, parameter) -> None:
    return None
