"""The 1-bit optimizers' compressed wire step (port of
``deepspeed_tpu/runtime/onebit_wire.py``; reference
``runtime/comm/nccl.py:16 compressed_allreduce`` driving
``runtime/fp16/onebit/adam.py``).

After the warmup (``freeze_step`` steps of exact Adam on the fp32
all-reduced gradients, the engine's default step), ``onebitadam`` and
``onebitlamb`` with ``comm_backend_name`` set take this step instead:

1. each rank's LOCAL gradients (the loss of its rows alone, no gradient
   all-reduce);
2. the optimizer's momentum update on them, the momentum of each
   parameter exchanged through ``comm/compressed.py``'s compressed
   allreduce (packed sign bits and one fp32 scale a rank on the wire,
   ~1/32 of fp32), with this rank's residual as error feedback;
3. every rank applies the same averaged update (the variance is frozen
   after the warmup, so no unreduced statistic can part the replicas).

The loss reported is the mean of the ranks' losses, and the norm the mean
of their local gradient norms (a diagnostic; the global norm would need
the fp32 reduce the wire avoids). The engine dispatches on the host by the
step number (``engine.py:888-915``). ``wire_supported`` is JAX's
predicate: gas 1, ZeRO stage 0, no fp16, no gradient clipping and a pure
data-parallel mesh with a split axis. The residuals are per rank by
design.
"""

from functools import partial

import torch

from ..comm import comm
from ..comm.compressed import reciprocal, exchange_signs
from .grad_comm import NON_DP_AXES, _dp_axes


def wire_supported(engine) -> bool:
    cfg, ctx = engine._config, engine.mesh_ctx
    if ctx is None:
        return False
    return (cfg.gradient_accumulation_steps == 1 and cfg.zero_config.stage == 0
            and not cfg.fp16_enabled and not cfg.gradient_clipping
            and len(_dp_axes(ctx)) >= 1 and all(ctx.axis_size(a) == 1 for a in NON_DP_AXES))


@torch.no_grad()
def _local_norm(engine, grads):
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(engine._views(grads))))


def wire_step(engine, args, kwargs) -> torch.Tensor:
    """One post-warmup step of ``engine`` on the global batch ``args`` /
    ``kwargs``; returns the ranks' mean loss as a device scalar."""
    eng = engine
    eng._training = True
    group = eng.zero_plan.dp_axes
    inv = reciprocal(eng.dp_world_size, eng.device)[0]  # pmean: psum times 1/w
    loss = eng._local_loss(*args, **kwargs)
    loss.float().backward()
    eng._accumulate_grads()
    acc = eng._flat_grad
    grads = acc if acc.dtype == torch.float32 else acc.float()
    with torch.no_grad():
        gnorm = comm.all_reduce(_local_norm(eng, grads), group=group).mul_(inv)
        opt = eng.optimizer
        opt.exchange = partial(exchange_signs, group=group)
        try:
            opt.step(grads)
        finally:
            opt.exchange = None
        eng._refresh_compute()
        acc.zero_()
        mean = comm.all_reduce(loss.detach().float().clone(), group=group).mul_(inv)
    eng._last_grad_norm = gnorm
    eng.losses = mean
    eng.micro_steps += 1
    eng._settle([False])
    return mean
