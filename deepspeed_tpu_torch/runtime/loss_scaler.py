"""Loss scaling for fp16 training (port of
``deepspeed_tpu/runtime/loss_scaler.py``).

The state and the update rule are the JAX package's (``LossScaleState
:22``, ``make_static_state``/``make_dynamic_state :30-42``,
``update_scale :54``). ``initial_state`` and ``next_state`` read the
config's ``fp16`` section (``config.FP16Config``) as the JAX
``LossScalerConfig`` (``:86-104``) does: ``loss_scale`` 0 is dynamic, any
other value a static scale that never moves. The JAX engine reads the
overflow flag on the host after every step (``engine.py:1409``), so here
the state is plain host numbers: ``cur_scale`` rounded to fp32 as the JAX
state holds it, the counters Python ints. The engine takes the overflow
flag from its global gradient norm (``engine.py``), so there is no
separate pass over the gradients for it.
"""

from typing import NamedTuple

import numpy as np


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
