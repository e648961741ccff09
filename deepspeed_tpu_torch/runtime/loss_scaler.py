"""Loss scaling for fp16 training (port of
``deepspeed_tpu/runtime/loss_scaler.py``).

The state and the update rule are the JAX package's (``LossScaleState
:22``, ``make_static_state``/``make_dynamic_state :30-42``,
``update_scale :54``). ``initial_state`` and ``next_state`` read the
config's ``fp16`` section (``config.FP16Config``) as the JAX
``LossScalerConfig`` (``:86-104``) does: ``loss_scale`` 0 is dynamic, any
other value a static scale that never moves.

Two forms of the state. ``LossScaleState`` holds plain host numbers:
``cur_scale`` rounded to fp32 as the JAX state holds it, the counters
Python ints; ``update_scale``/``next_state`` step it, and the tests hold
the device form to it. ``DeviceLossScaleState`` holds the same four
values as 0-d tensors on the engine's device (fp32 scale, int64
counters), and ``update_scale_device``/``next_device_state`` step it
with ``torch.where`` from a 0-d bool overflow flag, so the engine's step
reads nothing on the host (the JAX state rides the program's carry the
same way). The engine takes the overflow flag from its global gradient
norm (``engine.py``), so there is no separate pass over the gradients
for it.
"""

from typing import NamedTuple

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


class LossScaleState(NamedTuple):
    """Dynamic loss-scale state."""
    cur_scale: float  # an fp32 value
    cur_hysteresis: int
    last_overflow_iter: int
    iter: int


def make_static_state(scale: float) -> LossScaleState:
    return LossScaleState(_f32(scale), 1, -1, 0)


def make_dynamic_state(init_scale_power: int = 16, delayed_shift: int = 2) -> LossScaleState:
    return LossScaleState(_f32(2.0 ** init_scale_power), int(delayed_shift), -1, 0)


def update_scale(state: LossScaleState, overflow: bool, scale_factor: float = 2.0,
                 scale_window: int = 1000, min_scale: float = 1.0,
                 max_scale: float = 2.0 ** 32, delayed_shift: int = 2,
                 consecutive_hysteresis: bool = False) -> LossScaleState:
    """``DynamicLossScaler.update_scale``: on overflow, burn the hysteresis
    first, then halve the scale down to ``min_scale``; on a clean step,
    double it (up to ``max_scale``) when ``(iter - last_overflow_iter) %
    scale_window == 0`` (the first growth lands on iter ``window - 1``)."""
    if overflow:
        if state.cur_hysteresis > 1:
            scale, hyst = state.cur_scale, state.cur_hysteresis - 1
        else:
            scale = max(_f32(state.cur_scale / scale_factor), _f32(min_scale))
            hyst = state.cur_hysteresis
        return LossScaleState(scale, hyst, state.iter, state.iter + 1)
    scale = state.cur_scale
    if (state.iter - state.last_overflow_iter) % scale_window == 0:
        scale = min(_f32(state.cur_scale * scale_factor), _f32(max_scale))
    hyst = int(delayed_shift) if consecutive_hysteresis else state.cur_hysteresis
    return LossScaleState(scale, hyst, state.last_overflow_iter, state.iter + 1)


def initial_state(fp16) -> LossScaleState:
    """The state before the first step for the ``fp16`` section."""
    if fp16.loss_scale == 0:
        return make_dynamic_state(fp16.initial_scale_power, fp16.hysteresis)
    return make_static_state(fp16.loss_scale)


def next_state(fp16, state: LossScaleState, overflow: bool) -> LossScaleState:
    """The state after a step whose gradients did (``overflow``) or did
    not hold a non-finite value."""
    if fp16.loss_scale != 0:
        return state._replace(iter=state.iter + 1)
    return update_scale(state, overflow, scale_window=fp16.loss_scale_window,
                        min_scale=fp16.min_loss_scale, delayed_shift=fp16.hysteresis,
                        consecutive_hysteresis=fp16.consecutive_hysteresis)


class DeviceLossScaleState(NamedTuple):
    """``LossScaleState`` as 0-d tensors on one device."""
    cur_scale: torch.Tensor  # fp32
    cur_hysteresis: torch.Tensor  # int64
    last_overflow_iter: torch.Tensor  # int64
    iter: torch.Tensor  # int64


def to_device(state: LossScaleState, device) -> DeviceLossScaleState:
    """The host state on ``device`` (each value written by a fill)."""
    return DeviceLossScaleState(
        torch.full((), state.cur_scale, dtype=torch.float32, device=device),
        *(torch.full((), int(x), dtype=torch.int64, device=device)
          for x in state[1:]))


def to_host(state: DeviceLossScaleState) -> LossScaleState:
    """The device state read back (a synchronising read)."""
    return LossScaleState(float(state.cur_scale), *(int(x) for x in state[1:]))


def update_scale_device(state: DeviceLossScaleState, overflow: torch.Tensor,
                        scale_factor: float = 2.0, scale_window: int = 1000,
                        min_scale: float = 1.0, max_scale: float = 2.0 ** 32,
                        delayed_shift: int = 2,
                        consecutive_hysteresis: bool = False) -> DeviceLossScaleState:
    """``update_scale`` on the device, both branches computed and one
    taken by ``overflow`` (a 0-d bool tensor); fp32 quotient and product,
    each clamped at the fp32 bound, as the host rule rounds them."""
    scale, hyst = state.cur_scale, state.cur_hysteresis
    overflow = overflow.reshape(())
    burn = hyst > 1
    down = (scale / torch.full_like(scale, scale_factor)).clamp_min(_f32(min_scale))
    up = (scale * torch.full_like(scale, scale_factor)).clamp_max(_f32(max_scale))
    grow = torch.remainder(state.iter - state.last_overflow_iter, scale_window) == 0
    clean_hyst = torch.full_like(hyst, int(delayed_shift)) if consecutive_hysteresis else hyst
    return DeviceLossScaleState(
        torch.where(overflow, torch.where(burn, scale, down), torch.where(grow, up, scale)),
        torch.where(overflow, torch.where(burn, hyst - 1, hyst), clean_hyst),
        torch.where(overflow, state.iter, state.last_overflow_iter),
        state.iter + 1)


def next_device_state(fp16, state: DeviceLossScaleState,
                      overflow: torch.Tensor) -> DeviceLossScaleState:
    """``next_state`` on the device."""
    if fp16.loss_scale != 0:
        return state._replace(iter=state.iter + 1)
    return update_scale_device(state, overflow, scale_window=fp16.loss_scale_window,
                               min_scale=fp16.min_loss_scale,
                               delayed_shift=fp16.hysteresis,
                               consecutive_hysteresis=fp16.consecutive_hysteresis)
