"""The training config (port of the subset of
``deepspeed_tpu/config/config.py`` that the engine runs).

Keys, as in the JAX package's JSON config: the batch triangle
(``train_batch_size``, ``train_micro_batch_size_per_gpu``,
``gradient_accumulation_steps``, resolved as ``config.py:236
_configure_train_batch_size`` does: ``train = micro * gas * dp`` over the
data-parallel world ``dp``, re-resolved by ``reresolve`` once the engine
knows the mesh), ``optimizer`` (``type``, ``params``), ``scheduler``
(``type``, ``params``), ``bf16`` (``enabled``), ``fp16``
(``feature_configs.py:137 FP16Config``: dynamic or static loss scaling),
``gradient_clipping``, ``zero_optimization`` (``feature_configs.py:52
ZeroConfig``: every key with its defaults and ``stage3_*`` aliases, stages
0-3), ``mesh`` (``:483 MeshConfig``), ``comms_logger``, ``data_types``
(``grad_accum_dtype``, ``feature_configs.py:154``) and
``activation_checkpointing`` (``:161``; ``remat_policy`` wraps the
model's whole forward, ``runtime/activation_checkpointing/``) and
``gradient_comm`` (``:188 GradientCommConfig``, the bucketed gradient
wire, ``runtime/grad_comm.py``), ``checkpoint`` (``:331
CheckpointConfig``) and ``resilience`` (``:441 ResilienceConfig``, with
its ``fault_injection``). Any other key (``async_pipeline``,
...), or one of these set to
what the port does not run yet (ZeRO offload, ZeRO++'s hpZ and
nontrainable-weight quantization, MiCS, ``partition_activations``,
``cpu_checkpointing``), raises: nothing is ignored silently. ZeRO++'s
``zero_quantized_weights`` and ``zero_quantized_gradients`` run only as
the scheduled ZeRO-3 store's int8 tiers (stage 3 with ``gradient_comm``,
``runtime/zero3_schedule.py``) and raise elsewhere. fp16's
``auto_cast`` and ``fp16_master_weights_and_grads`` are accepted and
change nothing, as in the JAX engine, which reads neither; so are the
ZeRO keys the JAX docstring marks inert (bucket sizes, ``overlap_comm``,
prefetch and reuse thresholds, ...).
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
         "activation_checkpointing", "mesh", "comms_logger", "gradient_comm", "checkpoint",
         "resilience"}
WIRE_TIERS = ("fp32", "int8", "onebit")


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


class ZeroConfig:
    """The ``zero_optimization`` section (``feature_configs.py:52``): every
    key of the JAX ``ZeroConfig`` with its default, read under its name or
    its ``stage3_*`` alias. ``stage`` 0-3 runs (``runtime/zero_sharding.py``);
    ``param_persistence_threshold`` keeps parameters of at most that many
    elements replicated at stage 3, and ``max_live_parameters`` feeds the
    governor's advisory (``runtime/zero_governor.py``). The keys that tune
    the reference's hook machinery are accepted and inert, as in JAX.
    Offload, ZeRO++'s hpZ and nontrainable-weight quantization, and MiCS
    raise ``NotImplementedError`` naming the key; ``zero_quantized_weights``
    and ``zero_quantized_gradients`` raise unless the scheduled ZeRO-3
    store can engage (stage 3 with ``gradient_comm``: checked by
    ``DeepSpeedTorchConfig``, then by the engine). The resilience keys
    (anomaly rollback, save retries, fault injection) are accepted and
    inert here, as in JAX, whose ``ZeroConfig`` ignores them: the
    ``resilience`` section holds the ones that act."""

    _DEFAULTS = {
        "stage": 0, "contiguous_gradients": True, "reduce_scatter": True,
        "reduce_bucket_size": int(5e8), "use_multi_rank_bucket_allreduce": True,
        "allgather_partitions": True, "allgather_bucket_size": int(5e8), "overlap_comm": None,
        "load_from_fp32_weights": True, "elastic_checkpoint": False, "offload_param": None,
        "offload_optimizer": None, "sub_group_size": int(1e9), "cpu_offload_param": None,
        "cpu_offload_use_pin_memory": None, "cpu_offload": None,
        "prefetch_bucket_size": int(5e7), "param_persistence_threshold": int(1e5),
        "model_persistence_threshold": int(1e9), "max_live_parameters": int(1e9),
        "max_reuse_distance": int(1e9), "gather_16bit_weights_on_model_save": False,
        "module_granularity_threshold": 0, "use_all_reduce_for_fetch_params": False,
        "ignore_unused_parameters": True, "legacy_stage1": False,
        "round_robin_gradients": False, "zero_hpz_partition_size": 1,
        "zero_quantized_weights": False, "zero_quantized_nontrainable_weights": False,
        "zero_quantized_gradients": False, "mics_shard_size": -1,
        "mics_hierarchical_params_gather": False, "memory_efficient_linear": True,
        "pipeline_loading_checkpoint": False, "max_consecutive_anomalies": 3,
        "loss_spike_window": 20, "loss_spike_factor": 3.0, "loss_spike_min_history": 5,
        "rollback": True, "save_retries": 3, "retry_backoff_secs": 0.05,
        "fault_injection": {}}
    ALIASES = {
        "stage3_prefetch_bucket_size": "prefetch_bucket_size",
        "stage3_param_persistence_threshold": "param_persistence_threshold",
        "stage3_model_persistence_threshold": "model_persistence_threshold",
        "stage3_max_live_parameters": "max_live_parameters",
        "stage3_max_reuse_distance": "max_reuse_distance",
        "stage3_gather_16bit_weights_on_model_save": "gather_16bit_weights_on_model_save",
        "stage3_module_granularity_threshold": "module_granularity_threshold",
        "stage3_use_all_reduce_for_fetch_params": "use_all_reduce_for_fetch_params"}
    _NON_NEGATIVE = ("reduce_bucket_size", "allgather_bucket_size", "sub_group_size",
                     "prefetch_bucket_size", "param_persistence_threshold",
                     "model_persistence_threshold", "max_live_parameters",
                     "max_reuse_distance", "zero_hpz_partition_size", "retry_backoff_secs")

    def __init__(self, section: Dict[str, Any]):
        given = {self.ALIASES.get(k, k): v for k, v in section.items() if v != "auto"}
        for key, default in self._DEFAULTS.items():
            setattr(self, key, given.get(key, default))
        self.stage = int(self.stage)
        if not 0 <= self.stage <= 3:
            raise DeepSpeedConfigError(f"zero_optimization.stage must be 0-3, got {self.stage}")
        for key in self._NON_NEGATIVE:
            if getattr(self, key) < 0:
                raise DeepSpeedConfigError(f"zero_optimization.{key} must be >= 0")
        for key in ("offload_param", "offload_optimizer"):
            sec = getattr(self, key) or {}
            if str(sec.get("device", "none")) != "none":
                raise NotImplementedError(f"zero_optimization.{key} is not ported yet: it "
                                          "needs host offload")
        for key in ("cpu_offload", "cpu_offload_param"):
            if getattr(self, key):
                raise NotImplementedError(f"zero_optimization.{key} is not ported yet: it "
                                          "needs host offload")
        for key in ("zero_quantized_nontrainable_weights", ):
            if getattr(self, key):
                raise NotImplementedError(f"zero_optimization.{key} (ZeRO++) is not ported "
                                          "yet")
        if self.zero_hpz_partition_size > 1:
            raise NotImplementedError("zero_optimization.zero_hpz_partition_size > 1 (ZeRO++ "
                                      "hpZ) is not ported yet")
        if self.mics_shard_size > 1:
            raise NotImplementedError("zero_optimization.mics_shard_size (MiCS) is not "
                                      "ported yet")


class GradientCommConfig:
    """The ``gradient_comm`` section (``feature_configs.py:188``): the
    bucketed gradient wire. ``bucket_size_mb`` (> 0) is each flat bucket's
    budget, ``comm_quantization`` the wire tier (``fp32``, ``int8`` or
    ``onebit``), ``quantization_block_size`` (> 0) the int8 tier's block,
    ``error_feedback`` carries a quantized tier's residual into the next
    micro-step, ``overlap_comm`` reduce-scatters each micro-step's buckets
    as soon as its backward ends, and ``comm_quantization_per_dtype`` maps
    a dtype's name (``"float32"``, ``"bfloat16"``) to its bucket's tier.
    ``active``: the wire is asked for (``enabled``, overlap, a quantized
    tier or an override)."""

    _DEFAULTS = {"enabled": False, "bucket_size_mb": 25.0, "comm_quantization": "fp32",
                 "quantization_block_size": 256, "error_feedback": True,
                 "overlap_comm": False, "comm_quantization_per_dtype": {}}

    def __init__(self, section: Dict[str, Any]):
        for key, default in self._DEFAULTS.items():
            setattr(self, key, section.get(key, default))
        self.enabled, self.error_feedback, self.overlap_comm = (
            bool(self.enabled), bool(self.error_feedback), bool(self.overlap_comm))
        self.bucket_size_mb = float(self.bucket_size_mb)
        self.quantization_block_size = int(self.quantization_block_size)
        for key in ("bucket_size_mb", "quantization_block_size"):
            if not getattr(self, key) > 0:
                raise DeepSpeedConfigError(f"gradient_comm.{key} must be > 0")
        self.comm_quantization = self._tier(self.comm_quantization, "comm_quantization")
        if not isinstance(self.comm_quantization_per_dtype, dict):
            raise DeepSpeedConfigError("gradient_comm.comm_quantization_per_dtype must be a dict")
        self.comm_quantization_per_dtype = {
            str(k): self._tier(v, f"comm_quantization_per_dtype[{k!r}]")
            for k, v in self.comm_quantization_per_dtype.items()}

    @staticmethod
    def _tier(value, key) -> str:
        value = str(getattr(value, "value", value))
        if value not in WIRE_TIERS:
            raise DeepSpeedConfigError(f"gradient_comm.{key} must be one of {WIRE_TIERS}, "
                                       f"got {value!r}")
        return value

    @property
    def active(self) -> bool:
        return (self.enabled or self.overlap_comm or self.comm_quantization != "fp32"
                or bool(self.comm_quantization_per_dtype))

    def tier_for_dtype(self, dtype) -> str:
        """The tier of a bucket of ``dtype`` (a torch dtype or its name)."""
        key = str(dtype).replace("torch.", "")
        return self.comm_quantization_per_dtype.get(key, self.comm_quantization)


class CheckpointConfig:
    """The ``checkpoint`` section (``feature_configs.py:331``):
    ``tag_validation`` (``Warn``, ``Ignore`` or ``Fail``: every rank must
    save under the same tag); ``load_universal``,
    ``use_node_local_storage`` and ``parallel_write`` are accepted and
    inert, as in JAX (``engine.load_universal_checkpoint`` reads a
    universal directory)."""

    _DEFAULTS = {"tag_validation": "WARN", "load_universal": False,
                 "use_node_local_storage": False, "parallel_write": {}}
    MODES = ("WARN", "IGNORE", "FAIL")

    def __init__(self, section: Dict[str, Any]):
        for key, default in self._DEFAULTS.items():
            setattr(self, key, section.get(key, default))
        self.tag_validation = str(getattr(self.tag_validation, "value",
                                          self.tag_validation)).upper()
        if self.tag_validation not in self.MODES:
            raise DeepSpeedConfigError(f"checkpoint.tag_validation must be one of {self.MODES}, "
                                       f"got {self.tag_validation!r}")
        self.load_universal = bool(self.load_universal)


class FaultInjectionConfig:
    """``resilience.fault_injection`` (``feature_configs.py:430``): a
    deterministic fault plan, ``faults`` a list of ``{"site", "nth",
    "times", "args"}`` (``utils/fault_injection.py``); inert unless
    ``enabled``."""

    _DEFAULTS = {"enabled": False, "seed": 0, "faults": []}

    def __init__(self, section: Dict[str, Any]):
        for key, default in self._DEFAULTS.items():
            setattr(self, key, section.get(key, default))
        self.enabled, self.seed = bool(self.enabled), int(self.seed)
        self.faults = list(self.faults)


class ResilienceConfig:
    """The ``resilience`` section (``feature_configs.py:441``): preemption
    autosave and ``auto_resume`` from ``save_dir``, the interval autosave,
    ``keep_last_n`` retention, the anomaly sentry and its rollback; all
    off unless ``enabled``. ``save_retries`` and ``retry_backoff_secs``
    are accepted and inert, as in JAX."""

    _DEFAULTS = {"enabled": False, "save_dir": None, "autosave_interval_steps": 0,
                 "keep_last_n": 3, "auto_resume": False, "preempt_save": True,
                 "preempt_signals": ["SIGTERM", "SIGINT"], "max_consecutive_anomalies": 3,
                 "loss_spike_window": 20, "loss_spike_factor": 3.0,
                 "loss_spike_min_history": 5, "rollback": True, "save_retries": 3,
                 "retry_backoff_secs": 0.05, "fault_injection": {}}
    _BOUNDS = {"autosave_interval_steps": 0, "keep_last_n": 0, "max_consecutive_anomalies": 1,
               "loss_spike_window": 2, "loss_spike_min_history": 1, "save_retries": 1,
               "retry_backoff_secs": 0}

    def __init__(self, section: Dict[str, Any]):
        for key, default in self._DEFAULTS.items():
            setattr(self, key, section.get(key, default))
        for key, low in self._BOUNDS.items():
            if getattr(self, key) < low:
                raise DeepSpeedConfigError(f"resilience.{key} must be >= {low}")
        if not self.loss_spike_factor > 1.0:
            raise DeepSpeedConfigError("resilience.loss_spike_factor must be > 1")
        self.fault_injection = FaultInjectionConfig(
            _section(section, "fault_injection", FaultInjectionConfig._DEFAULTS))


class MeshConfig:
    """The ``mesh`` section (``feature_configs.py:483``): each axis's size,
    -1 filling it with the remaining devices, and ``axis_order``."""

    AXES = ("pipe", "data", "fsdp", "seq", "expert", "model")
    _DEFAULTS = {"pipe": 1, "data": -1, "fsdp": 1, "seq": 1, "expert": 1, "model": 1,
                 "axis_order": list(AXES)}

    def __init__(self, section: Dict[str, Any]):
        for key, default in self._DEFAULTS.items():
            setattr(self, key, section.get(key, default))
        for axis in self.AXES:
            size = getattr(self, axis)
            if not isinstance(size, int) or (size < 1 and size != -1):
                raise DeepSpeedConfigError(f"mesh.{axis} must be a positive int or -1")

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in self.axis_order}


class DeepSpeedTorchConfig:
    """The validated config the engine reads. ``world_size`` is the
    data-parallel world the batch triangle divides by (1 until the engine
    knows the mesh, ``reresolve``)."""

    def __init__(self, config: Any, world_size: int = 1):
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
        self.zero_config = ZeroConfig(_section(pd, "zero_optimization",
                                               set(ZeroConfig._DEFAULTS) | set(ZeroConfig.ALIASES)))
        self.mesh_config = MeshConfig(_section(pd, "mesh", MeshConfig._DEFAULTS))
        self.gradient_comm_config = GradientCommConfig(
            _section(pd, "gradient_comm", GradientCommConfig._DEFAULTS))
        from ..comm.comms_logging import CommsLoggerConfig
        self.comms_config = CommsLoggerConfig(_section(pd, "comms_logger",
                                                       CommsLoggerConfig._DEFAULTS))
        self.checkpoint_config = CheckpointConfig(_section(pd, "checkpoint",
                                                           CheckpointConfig._DEFAULTS))
        self.resilience_config = ResilienceConfig(_section(pd, "resilience",
                                                           ResilienceConfig._DEFAULTS))
        zc = self.zero_config
        for key in ("zero_quantized_weights", "zero_quantized_gradients"):
            if getattr(zc, key) and not (zc.stage == 3 and self.gradient_comm_config.active):
                raise NotImplementedError(
                    f"zero_optimization.{key} (ZeRO++) is ported only as the scheduled ZeRO-3 "
                    "store's int8 tier: stage 3 with gradient_comm")
        self.world_size = max(int(world_size), 1)
        self._configure_train_batch_size()

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage

    def reresolve(self, world_size: int):
        """Resolve the batch triangle again over the data-parallel world
        ``world_size`` (``config.py:111``)."""
        if world_size == self.world_size:
            return
        self.world_size = max(int(world_size), 1)
        pd = self._param_dict
        self.train_batch_size = pd.get(TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = pd.get(TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = pd.get(GRADIENT_ACCUMULATION_STEPS)
        self._configure_train_batch_size()

    def _configure_train_batch_size(self):
        """Resolve the batch triangle ``train = micro * gas * dp``."""
        train, micro, gas = (self.train_batch_size,
                             self.train_micro_batch_size_per_gpu,
                             self.gradient_accumulation_steps)
        dp = self.world_size
        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // micro // dp
        elif train is not None and gas is not None:
            micro = train // dp // gas
        elif micro is not None and gas is not None:
            train = micro * gas * dp
        elif train is not None:
            gas, micro = 1, train // dp
        elif micro is not None:
            train, gas = micro * dp, 1
        else:
            raise DeepSpeedConfigError("Either train_batch_size or "
                                       "train_micro_batch_size_per_gpu needs to be provided")
        if not (train > 0 and micro > 0 and gas > 0 and train == micro * gas * dp):
            world = f" * {dp}" if dp > 1 else ""
            raise DeepSpeedConfigError(
                "Check batch related parameters: train_batch_size is not equal to "
                f"micro_batch_per_gpu * gradient_acc_step{' * world_size' if dp > 1 else ''}: "
                f"{train} != {micro} * {gas}{world}")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas
