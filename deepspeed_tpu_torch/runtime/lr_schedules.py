"""LR schedules (port of ``deepspeed_tpu/runtime/lr_schedules.py``:
``LRRangeTest :67``, ``OneCycle :93``, ``WarmupLR :155``, ``WarmupDecayLR
:190``, ``WarmupCosineLR :218`` and ``get_lr_schedule :261``), with the
reference's JSON param keys and its ``step()``/``get_last_lr()``.
``OneCycle.get_mom`` reports the cycled momentum; as in the JAX engine,
nothing feeds it into the optimizer.

``lr_at(step)`` is the learning rate of optimizer update ``step + 1``: the
optimizer evaluates the schedule at its update count before that count
increments (optax's ``scale_by_schedule``), so update 1 uses ``lr_at(0)``;
under log ``WarmupLR`` that is ``warmup_min_lr``.
"""

import math
from typing import Optional

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"


class _LRScheduleBase:
    """Host-side schedule; subclasses define ``_lr(step)``."""

    def __init__(self, last_batch_iteration: int = -1):
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = None

    def _lr(self, step: float) -> float:
        raise NotImplementedError

    def lr_at(self, step) -> float:
        return self._lr(float(step))

    def get_last_lr(self):
        if self._last_lr is None:  # before the first step()
            return [self._lr(max(self.last_batch_iteration, 0))]
        return self._last_lr

    def step(self, last_batch_iteration: Optional[int] = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = [self._lr(self.last_batch_iteration)]

    def state_dict(self):
        """The schedule's position, for a checkpoint (``lr_schedules.py:60``)."""
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
        self._last_lr = (None if self.last_batch_iteration < 0
                         else [self._lr(self.last_batch_iteration)])


class LRRangeTest(_LRScheduleBase):
    """LR range test: ``min_lr * (1 + count * step_rate)`` with ``count =
    step / step_size``, floored when ``staircase``."""

    def __init__(self, lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1):
        super().__init__(last_batch_iteration)
        if lr_range_test_min_lr <= 0:
            raise ValueError(f"LR range test minimum lr={lr_range_test_min_lr}, must be > 0")
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def _lr(self, step):
        count = step / self.step_size
        if self.staircase:
            count = math.floor(count)
        return self.min_lr * (1 + count * self.step_rate)


class OneCycle(_LRScheduleBase):
    """1-cycle policy: up from ``cycle_min_lr`` to ``cycle_max_lr`` over
    the first step size, back down over the second, then decay
    ``cycle_min_lr / (1 + count * decay_lr_rate)`` (count floored to
    ``decay_step_size`` steps when that is > 0). The stair counts are
    accepted and unused, as in the JAX schedule."""

    def __init__(self, cycle_min_lr: float = 1e-4, cycle_max_lr: float = 1e-3,
                 decay_lr_rate: float = 0.0, cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0,
                 cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0, cycle_momentum: bool = True,
                 cycle_min_mom: float = 0.8, cycle_max_mom: float = 0.9,
                 decay_mom_rate: float = 0.0, last_batch_iteration: int = -1):
        super().__init__(last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_step_size = cycle_first_step_size
        self.second_step_size = cycle_second_step_size or cycle_first_step_size
        self.decay_step_size = decay_step_size
        self.total_cycle_size = self.first_step_size + self.second_step_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate

    def _lr(self, step):
        span = self.cycle_max_lr - self.cycle_min_lr
        if step < self.first_step_size:
            frac = min(max(step / max(self.first_step_size, 1), 0.0), 1.0)
            return self.cycle_min_lr + span * frac
        if step < self.total_cycle_size:
            frac = min(max((step - self.first_step_size) / max(self.second_step_size, 1),
                           0.0), 1.0)
            return self.cycle_max_lr - span * frac
        decay = max(step - self.total_cycle_size, 0.0)
        if self.decay_step_size > 0:
            decay = math.floor(decay / self.decay_step_size)
        return self.cycle_min_lr / (1.0 + decay * self.decay_lr_rate)

    def get_mom(self):
        """The cycled momentum at the current iteration (a report only)."""
        if not self.cycle_momentum:
            return None
        step = max(self.last_batch_iteration, 0)
        span = self.cycle_max_mom - self.cycle_min_mom
        if step < self.first_step_size:
            return self.cycle_max_mom - span * (step / max(self.first_step_size, 1))
        if step < self.total_cycle_size:
            return self.cycle_min_mom + span * ((step - self.first_step_size)
                                                / max(self.second_step_size, 1))
        return self.cycle_max_mom


class WarmupLR(_LRScheduleBase):
    """Warmup then hold. ``warmup_type``: log | linear."""

    def __init__(self, warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000, warmup_type: str = "log",
                 last_batch_iteration: int = -1):
        super().__init__(last_batch_iteration)
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        if warmup_type not in ("log", "linear"):
            warmup_type = "log"  # the reference's default for unknown types
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _gamma(self, step):
        if self.warmup_type == "log":
            g = self.inverse_log_warm_up * math.log(max(step, 1.0))
        else:
            g = step / self.warmup_num_steps
        return min(max(g, 0.0), 1.0)

    def _lr(self, step):
        return self.min_lr + (self.max_lr - self.min_lr) * self._gamma(step)


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to zero over ``total_num_steps``."""

    def __init__(self, total_num_steps: int = 10000, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = "log", last_batch_iteration: int = -1):
        self.total_num_steps = total_num_steps
        super().__init__(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)

    def _gamma(self, step):
        if step < self.warmup_num_steps:
            return super()._gamma(step)
        return max(0.0, (self.total_num_steps - step)
                   / max(self.total_num_steps - self.warmup_num_steps, 1))


class WarmupCosineLR(_LRScheduleBase):
    """Warmup then cosine decay, as ratios of ``base_lr``."""

    def __init__(self, total_num_steps: int = 10000, warmup_min_ratio: float = 0.0,
                 warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                 last_batch_iteration: int = -1, base_lr: float = 1.0):
        super().__init__(last_batch_iteration)
        self.total_num_steps = total_num_steps
        self.warmup_min_ratio = warmup_min_ratio
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.cos_min_ratio = cos_min_ratio
        self.base_lr = base_lr

    def _lr(self, step):
        if step < self.warmup_num_steps:
            ratio = self.warmup_min_ratio + (1.0 - self.warmup_min_ratio) * min(
                max(step / self.warmup_num_steps, 0.0), 1.0)
        else:
            frac = min(max((step - self.warmup_num_steps)
                           / max(self.total_num_steps - self.warmup_num_steps, 1),
                           0.0), 1.0)
            ratio = self.cos_min_ratio + (1.0 - self.cos_min_ratio) * 0.5 * (
                1.0 + math.cos(math.pi * frac))
        return self.base_lr * ratio


SCHEDULE_CLASSES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
    WARMUP_COSINE_LR: WarmupCosineLR,
}


def get_lr_schedule(name: str, params: dict, base_lr: Optional[float] = None):
    """The schedule named by the config's ``scheduler.type``."""
    if name not in SCHEDULE_CLASSES:
        raise NotImplementedError(
            f"LR schedule {name!r} is not ported; the port has "
            f"{sorted(SCHEDULE_CLASSES)}")
    kwargs = dict(params)
    if name == WARMUP_COSINE_LR and base_lr is not None:
        kwargs.setdefault("base_lr", base_lr)
    return SCHEDULE_CLASSES[name](**kwargs)
