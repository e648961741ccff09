"""PyTorch/CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's layout so each module's counterpart
is easy to find (``deepspeed_tpu_torch/inference/v2/model.py`` ports
``deepspeed_tpu/inference/v2/model.py``). It imports ``torch``, ``numpy``
and the standard library only — never ``jax`` and never ``deepspeed_tpu``.

Ported so far: the ragged Llama serving path (``inference/v2``) with its
hand-written CUDA kernels, paged attention and RMSNorm, and its int8
options (weight-only int8 through the blockwise quantizer and an int8 KV
cache, ``linear/``); and Llama
training (``initialize`` -> ``engine.forward/backward/step``,
``fused_train_step(s)``, ``train_batch``, ``eval_batch``) in bf16, fp16
(dynamic loss scaling) or fp32, with remat and its policies, a
key-padding mask and a data loader, carried by the flash-attention
forward and backward kernels and the fused optimizer kernel over flat
fp32 state, which reads its per-step scalars from device memory
(``ops/``, ``csrc/``); with ZeRO stages 0-3 over the named mesh's
``data`` and ``fsdp`` axes (``runtime/zero_sharding.py``,
``runtime/zero3.py``, ``zero``), on the collectives of ``comm`` over
``torch.distributed`` (NCCL on cards, gloo on the CPU); the bucketed
gradient wire and, at stage 3 under it, the scheduled ZeRO-3 store
(``runtime/grad_comm.py``, ``runtime/zero3_schedule.py``); checkpoints
that load across worlds and stages, the universal layout shared with the
JAX package, and the resilience lifecycle (``checkpoint/``,
``runtime/sentry.py``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from . import comm  # noqa: F401
from . import zero  # noqa: F401
from .comm.comm import init_distributed  # noqa: F401



def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, distributed_port=29500,
               dist_init_required=None, collate_fn=None, config=None, mesh_param=None,
               config_params=None, device=None):
    """Build a training engine (port of ``deepspeed_tpu/__init__.py:23
    initialize``). ``model`` is a ``torch.nn.Module`` whose forward returns
    the loss (``models.llama.LlamaForCausalLM``); ``model_parameters`` the
    parameters to train (default: every parameter that takes a gradient);
    ``training_data`` a map-style dataset, batched by
    ``runtime.dataloader.DeepSpeedDataLoader`` at the micro batch size with
    ``collate_fn``; ``config`` a dict or the path of a JSON file
    (``config/config.py``). When ZeRO (stage > 0), a ``mesh`` section or
    ``mesh_param`` (``(dp, sp)``) asks for the mesh and none exists, the
    engine calls ``comm.init_distributed`` (``distributed_port``,
    ``dist_init_required``). Returns ``(engine, optimizer,
    training_dataloader, lr_scheduler)``. A client optimizer is not ported
    yet and raises."""
    from .runtime.engine import DeepSpeedTorchEngine
    if optimizer is not None:
        raise NotImplementedError("initialize: a client optimizer is not ported yet")
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    engine = DeepSpeedTorchEngine(model, model_parameters=model_parameters,
                                  config=config, lr_scheduler=lr_scheduler,
                                  device=device, training_data=training_data,
                                  collate_fn=collate_fn, mesh_param=mesh_param,
                                  distributed_port=distributed_port,
                                  dist_init_required=dist_init_required)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
