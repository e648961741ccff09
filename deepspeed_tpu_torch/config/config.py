"""The training config (port of the subset of
``deepspeed_tpu/config/config.py`` that the stage-0 engine runs).

Keys, as in the JAX package's JSON config: the batch triangle
(``train_batch_size``, ``train_micro_batch_size_per_gpu``,
``gradient_accumulation_steps``, resolved as ``config.py:236
_configure_train_batch_size`` does for a world of one device),
``optimizer`` (``type``, ``params``), ``scheduler`` (``type``,
``params``), ``bf16`` (``enabled``), ``fp16`` (``feature_configs.py:137
FP16Config``: dynamic or static loss scaling), ``gradient_clipping``,
``zero_optimization`` with ``stage`` 0, ``data_types``
(``grad_accum_dtype``, ``feature_configs.py:154``) and
``activation_checkpointing`` (``:161``; ``remat_policy`` wraps the
model's whole forward, ``runtime/activation_checkpointing/``). Any other
key (``mesh``, ``async_pipeline``, ...), or one of these set to what the
port does not run yet (ZeRO stage > 0, ``partition_activations``,
``cpu_checkpointing``), raises: nothing is ignored silently. fp16's
``auto_cast`` and ``fp16_master_weights_and_grads`` are accepted and
change nothing, as in the JAX engine, which reads neither.
"""

import json
import os
from typing import Any, Dict

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

_KEYS = {TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU,
         GRADIENT_ACCUMULATION_STEPS, "optimizer", "scheduler", "bf16", "fp16",
         "gradient_clipping", "zero_optimization", "data_types",
         "activation_checkpointing"}


class DeepSpeedConfigError(Exception):
    pass


def _section(pd: Dict[str, Any], key: str, allowed) -> Dict[str, Any]:
    sec = pd.get(key) or {}
    if not isinstance(sec, dict):
        raise DeepSpeedConfigError(f"{key} must be a dict, got {type(sec)}")
    extra = sorted(set(sec) - set(allowed))
    if extra:
        raise NotImplementedError(f"config {key}: keys {extra} are not ported yet")
    return sec


class FP16Config:
    """The ``fp16`` section with the JAX package's defaults and bounds
    (``feature_configs.py:137``). ``loss_scale`` 0 means dynamic scaling
    from ``2**initial_scale_power``. ``auto_cast`` and
    ``fp16_master_weights_and_grads`` are kept and read by nothing (the
    masters stay fp32, the compute dtype comes from ``enabled``), as in the
    JAX engine."""

    _DEFAULTS = {"enabled": False, "auto_cast": False, "loss_scale": 0.0,
                 "initial_scale_power": 16, "loss_scale_window": 1000,
                 "hysteresis": 2, "consecutive_hysteresis": False,
                 "min_loss_scale": 1.0, "fp16_master_weights_and_grads": False}

    def __init__(self, section: Dict[str, Any]):
        for key, default in self._DEFAULTS.items():
            setattr(self, key, type(default)(section.get(key, default)))
        for key in ("loss_scale", "initial_scale_power", "loss_scale_window",
                    "hysteresis", "min_loss_scale"):
            if getattr(self, key) < 0:
                raise DeepSpeedConfigError(f"fp16.{key} must be >= 0")


class ActivationCheckpointingConfig:
    """The ``activation_checkpointing`` section (``feature_configs.py:161``)
    with its defaults."""

    _DEFAULTS = {"partition_activations": False, "cpu_checkpointing": False,
                 "contiguous_memory_optimization": False, "number_checkpoints": None,
                 "synchronize_checkpoint_boundary": False, "profile": False,
                 "remat_policy": None}

    def __init__(self, section: Dict[str, Any]):
        for key, default in self._DEFAULTS.items():
            setattr(self, key, section.get(key, default))
        if self.partition_activations:
            raise NotImplementedError("config activation_checkpointing.partition_activations "
                                      "is not ported yet: it needs the model axis")
        if self.cpu_checkpointing:
            raise NotImplementedError("config activation_checkpointing.cpu_checkpointing "
                                      "is not ported yet: it needs host offload")


class DeepSpeedTorchConfig:
    """The validated config the engine reads."""

    def __init__(self, config: Any):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(f"config file not found: {config}")
            with open(config) as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise DeepSpeedConfigError(
                f"expected a dict or a path to a json file, got {type(config)}")
        self._param_dict = dict(config)
        pd = self._param_dict
        extra = sorted(set(pd) - _KEYS)
        if extra:
            raise NotImplementedError(f"config keys {extra} are not ported yet")

        self.train_batch_size = pd.get(TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = pd.get(TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = pd.get(GRADIENT_ACCUMULATION_STEPS)
        self.gradient_clipping = float(pd.get("gradient_clipping") or 0.0)

        opt = _section(pd, "optimizer", ("type", "params"))
        self.optimizer_name = opt.get("type", "").lower() or None
        self.optimizer_params = dict(opt.get("params") or {})
        sched = _section(pd, "scheduler", ("type", "params"))
        self.scheduler_name = sched.get("type")
        self.scheduler_params = dict(sched.get("params") or {})

        self.bf16_enabled = bool(_section(pd, "bf16", ("enabled", )).get("enabled", False))
        self.fp16_config = FP16Config(_section(pd, "fp16", FP16Config._DEFAULTS))
        self.fp16_enabled = self.fp16_config.enabled
        if self.fp16_enabled and self.bf16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 modes cannot both be enabled")
        self.data_types_config = _section(pd, "data_types", ("grad_accum_dtype", ))
        self.activation_checkpointing_config = ActivationCheckpointingConfig(
            _section(pd, "activation_checkpointing",
                     ActivationCheckpointingConfig._DEFAULTS))
        zero = _section(pd, "zero_optimization", ("stage", ))
        if int(zero.get("stage", 0)) != 0:
            raise NotImplementedError(
                f"zero_optimization.stage {zero['stage']} is not ported yet; "
                "the port runs stage 0 on one device")
        self._configure_train_batch_size()

    def _configure_train_batch_size(self):
        """Resolve the batch triangle ``train = micro * gas`` (one device)."""
        train, micro, gas = (self.train_batch_size,
                             self.train_micro_batch_size_per_gpu,
                             self.gradient_accumulation_steps)
        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // micro
        elif train is not None and gas is not None:
            micro = train // gas
        elif micro is not None and gas is not None:
            train = micro * gas
        elif train is not None:
            gas, micro = 1, train
        elif micro is not None:
            train, gas = micro, 1
        else:
            raise DeepSpeedConfigError("Either train_batch_size or "
                                       "train_micro_batch_size_per_gpu needs to be provided")
        if not (train > 0 and micro > 0 and gas > 0 and train == micro * gas):
            raise DeepSpeedConfigError(
                "Check batch related parameters: train_batch_size is not equal to "
                f"micro_batch_per_gpu * gradient_acc_step: {train} != {micro} * {gas}")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas
