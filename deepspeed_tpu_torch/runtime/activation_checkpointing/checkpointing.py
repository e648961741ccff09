"""Activation checkpointing (port of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``:
``configure :48``, ``_resolve_policy :75``, ``checkpoint :113``,
``checkpoint_wrapper :128``, ``RNGStatesTracker :139``).

Recompute is ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``,
where the JAX module calls ``jax.checkpoint``. A policy names what the
forward keeps, by the JAX package's names (``jax.checkpoint_policies``
that take no arguments), as a selective-checkpoint context
(``create_selective_checkpoint_contexts``) that saves the outputs of the
listed ATen ops and recomputes the rest:

- ``nothing_saveable`` (and no policy): recompute everything;
- ``everything_saveable``: keep everything, so no recompute at all;
- ``dots_saveable``, ``checkpoint_dots``: keep the products (``mm``,
  ``addmm``, ``bmm``);
- ``dots_with_no_batch_dims_saveable``,
  ``checkpoint_dots_with_no_batch_dims``: keep ``mm`` and ``addmm``.

A hand-written kernel is no ATen op, so its output is recomputed under
every policy but ``everything_saveable`` (the flash forward is launched
again in the backward). The offload policies and ``cpu_checkpointing``
need host offload, and ``partition_activations`` the ``model`` axis: they
raise ``NotImplementedError``. Any other name is a ``ValueError``. The
other keys of the config section are accepted, as in JAX, and change
nothing.

A parameter store that hands the forward its weights through a
``TorchFunctionMode`` (the scheduled ZeRO-3 store) is gone by the time the
backward recomputes a region. ``recompute_under(factory)`` records a
context factory: every region checkpointed inside the block runs its
recompute under ``factory()`` (a mode that gathers the weights again), and
regions checkpointed inside that recompute take the same factory.

The RNG tracker keeps named generator states (the reference's
``CudaRNGStatesTracker``): ``fork(name)`` runs its block on the named
stream of the default generator and advances it. ``checkpoint`` hands the
recompute the tracker's states as the forward saw them, as
``torch.utils.checkpoint`` does for the default generator.
"""

import contextlib
import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint as torch_checkpoint,
                                    create_selective_checkpoint_contexts)

_CONFIG = {
    "partition_activations": False,
    "cpu_checkpointing": False,
    "contiguous_memory_optimization": False,
    "number_checkpoints": None,
    "synchronize_checkpoint_boundary": False,
    "profile": False,
    "policy": None,  # a jax.checkpoint_policies name, e.g. "dots_saveable"
}

_MODEL_PARALLEL_RNG_KEY = "model-parallel-rng"

_aten = torch.ops.aten
_DOTS = (_aten.mm, _aten.addmm, _aten.bmm)
# policy name -> the ATen ops whose outputs the forward keeps; None keeps
# nothing, "all" everything
POLICIES = {
    "nothing_saveable": None,
    "everything_saveable": "all",
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS[:2],
    "checkpoint_dots_with_no_batch_dims": _DOTS[:2],
}
OFFLOAD_POLICIES = ("offload_dot_with_no_batch_dims", "save_and_offload_only_these_names")


def _refuse_unported(partition_activations, cpu_checkpointing) -> None:
    if partition_activations:
        raise NotImplementedError("activation_checkpointing.partition_activations is not "
                                  "ported yet: it shards saved activations over the "
                                  "model axis")
    if cpu_checkpointing:
        raise NotImplementedError("activation_checkpointing.cpu_checkpointing is not "
                                  "ported yet: it needs host offload")


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Store the knobs (``configure :48``): the config's
    ``activation_checkpointing`` section, then the keyword overrides."""
    if deepspeed_config is not None:
        ac = getattr(deepspeed_config, "activation_checkpointing_config", None)
        if ac is not None:
            _CONFIG["partition_activations"] = ac.partition_activations
            _CONFIG["cpu_checkpointing"] = ac.cpu_checkpointing
            _CONFIG["contiguous_memory_optimization"] = ac.contiguous_memory_optimization
            _CONFIG["number_checkpoints"] = ac.number_checkpoints
            _CONFIG["policy"] = ac.remat_policy
    for key, val in (("partition_activations", partition_activations),
                     ("contiguous_memory_optimization", contiguous_checkpointing),
                     ("number_checkpoints", num_checkpoints),
                     ("cpu_checkpointing", checkpoint_in_cpu),
                     ("synchronize_checkpoint_boundary", synchronize),
                     ("profile", profile)):
        if val is not None:
            _CONFIG[key] = val
    _refuse_unported(_CONFIG["partition_activations"], _CONFIG["cpu_checkpointing"])


def is_configured() -> bool:
    return True


def resolve_policy(name: Optional[str]):
    """The ops the policy ``name`` keeps (``POLICIES``)."""
    if not name:
        return None
    if name in OFFLOAD_POLICIES:
        raise NotImplementedError(f"remat_policy {name!r} is not ported yet: it needs host "
                                  "offload")
    if name not in POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; the port takes "
                         f"{sorted(POLICIES)}")
    return POLICIES[name]


def _resolve_policy():
    """The configured policy's ops (``_resolve_policy :75``)."""
    _refuse_unported(_CONFIG["partition_activations"], _CONFIG["cpu_checkpointing"])
    return resolve_policy(_CONFIG["policy"])


def _keep_ops(ops, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _selective_contexts(ops):
    return create_selective_checkpoint_contexts(functools.partial(_keep_ops, ops))


# context factories of the enclosing ``recompute_under`` blocks, innermost last
_RECOMPUTE = []


@contextlib.contextmanager
def recompute_under(factory: Callable):
    """Regions checkpointed inside the block recompute under ``factory()``."""
    _RECOMPUTE.append(factory)
    try:
        yield
    finally:
        _RECOMPUTE.pop()


def checkpoint_with(policy: Optional[str], function: Callable, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward under the policy named ``policy`` (None: recompute all).
    Without autograd it is a plain call."""
    ops = resolve_policy(policy)
    if ops == "all" or not torch.is_grad_enabled():
        return function(*args, **kwargs)
    states = _RNG_TRACKER.get_states()
    factory = _RECOMPUTE[-1] if _RECOMPUTE else None
    calls = [0]

    def run(*a, **kw):
        calls[0] += 1
        if calls[0] == 1:
            return function(*a, **kw)
        with contextlib.ExitStack() as stack:  # the recompute
            stack.enter_context(_RNG_TRACKER.states_as(states))
            if factory is not None:
                stack.enter_context(recompute_under(factory))
                stack.enter_context(factory())
            return function(*a, **kw)

    extra = {} if ops is None else {"context_fn": functools.partial(_selective_contexts, ops)}
    return torch_checkpoint(run, *args, use_reentrant=False, **extra, **kwargs)


def checkpoint(function: Callable, *args, **kwargs):
    """``checkpoint :113``: run ``function`` with recompute under the
    configured policy."""
    _resolve_policy()
    return checkpoint_with(_CONFIG["policy"], function, *args, **kwargs)


def checkpoint_wrapper(function: Callable) -> Callable:
    """Decorator form (``checkpoint_wrapper :128``)."""

    def wrapped(*args, **kwargs):
        return checkpoint(function, *args, **kwargs)

    return wrapped


# ----------------------------------------------------------- RNG tracking

def _rng_state(device):
    return (torch.cuda.get_rng_state(device) if device.type == "cuda"
            else torch.get_rng_state())


def _set_rng_state(state, device):
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


class RNGStatesTracker:
    """Named RNG streams (``RNGStatesTracker :139``, the reference's
    ``CudaRNGStatesTracker``): each name holds a state of the default
    generator of one device."""

    def __init__(self):
        self._states = {}

    def reset(self):
        self._states.clear()

    def get_states(self):
        # a state is never written in place: each read makes a new tensor
        return dict(self._states)

    def set_states(self, states):
        self._states = dict(states)

    def add(self, name: str, seed: int, device=None):
        """A new stream ``name`` seeded with ``seed`` on ``device`` (the
        current CUDA device when there is one, else the CPU)."""
        if name in self._states:
            raise Exception(f"RNG state {name} already exists")
        device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        self._states[name] = (device, gen.get_state())

    @contextlib.contextmanager
    def fork(self, name: str = _MODEL_PARALLEL_RNG_KEY):
        """Run the block on stream ``name`` (its device's default
        generator), then keep the advanced stream and restore the default."""
        if name not in self._states:
            raise Exception(f"RNG state {name} not added")
        device, state = self._states[name]
        saved = _rng_state(device)
        _set_rng_state(state, device)
        try:
            yield
        finally:
            self._states[name] = (device, _rng_state(device))
            _set_rng_state(saved, device)

    @contextlib.contextmanager
    def states_as(self, states):
        """Run the block with the streams at ``states``, then put back the
        streams as they were."""
        current = self.get_states()
        self.set_states(states)
        try:
            yield
        finally:
            self.set_states(current)


_RNG_TRACKER = RNGStatesTracker()


def get_cuda_rng_tracker() -> RNGStatesTracker:  # the reference's name
    return _RNG_TRACKER
