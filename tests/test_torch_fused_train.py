"""The training engine's fused paths against the JAX engine's, on the same
seeded inputs and weights, on the CPU: ``fused_train_step`` and
``fused_train_steps`` (K steps, one fetch), the WarmupLR schedule inside a
window, the fp16 overflow bookkeeping, the gas > 1 ``train_batch`` and
``data_types.grad_accum_dtype``, with the guards (the cases of
``tests/unit/runtime/test_fused_step.py``). Within the port, a window
equals its steps run one by one bit for bit. Then the pieces the window
stands on: the device form of the loss-scale rule against the host rule,
and K7's skip flag and the optimizer's device count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import init_llama as jax_init_llama
from deepspeed_tpu_torch.models.convert import lookup, params_from_jax
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.ops import fused_optimizer as fo
from deepspeed_tpu_torch.runtime import loss_scaler as ls
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer

# fp32 on both sides, as tests/test_torch_training.py: the port's plain
# attention against the Pallas kernels in interpret mode, sums in another
# order
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
# an element whose gradient cancels to fp32 noise takes another share of
# Adam's step on each side (test_torch_training.py
# test_adam_outlier_is_a_cancelling_gradient): at most MAX_FLIPPED outside
# 1e-5, none beyond the whole path of the updates on both sides
MAX_FLIPPED = 4
SCHED = {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": LR,
                                        "warmup_num_steps": 3, "warmup_type": "linear"}}


def _models(seed=0, dtype="fp32"):
    jdt = {"fp32": jnp.float32, "fp16": jnp.float16}[dtype]
    jcfg = JaxLlamaConfig.tiny(dtype=jdt, attn_impl="flash", num_key_value_heads=2)
    jmodel, params = jax_init_llama(jcfg, seed=seed)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    tmodel = params_from_jax(params, LlamaConfig.tiny(dtype=torch.float32,
                                                      num_key_value_heads=2),
                             dtype=torch.float32, device="cpu", training=True)
    return jmodel, params, tmodel


def _config(gas=1, micro=1, **extra):
    cfg = {"train_batch_size": micro * gas, "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
           "scheduler": SCHED, "gradient_clipping": 1.0}
    cfg.update(extra)
    return cfg


def _engines(gas=1, dtype="fp32", **extra):
    """The JAX engine (micro 1 a device) and the port's (one device, the
    JAX global micro-batch) on the same weights."""
    jmodel, params, tmodel = _models(dtype=dtype)
    n_dev = jax.device_count()
    jcfg = _config(gas, 1, **extra)
    jcfg["train_batch_size"] = gas * n_dev
    jeng, *_ = deepspeed_tpu.initialize(model=jmodel, model_parameters=params, config=jcfg)
    teng, *_ = deepspeed_tpu_torch.initialize(model=tmodel, config=_config(gas, n_dev, **extra),
                                              device="cpu")
    return jeng, teng, n_dev


def _port_engine(gas=1, micro=2, seed=0, **extra):
    _, _, tmodel = _models(seed=seed)
    return deepspeed_tpu_torch.initialize(model=tmodel, config=_config(gas, micro, **extra),
                                          device="cpu")[0]


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


def _assert_masters_match(teng, jeng, path):
    jparams = jax.tree_util.tree_map(np.asarray, jeng.params)
    n_off = 0
    for name, master in teng.master_params().items():
        got, ref = master.numpy(), np.asarray(lookup(jparams, name))
        diff = np.abs(got - ref)
        n_off += int((diff > 1e-5 + 1e-5 * np.abs(ref)).sum())
        assert diff.max() <= 2 * path, name
    assert n_off <= MAX_FLIPPED, f"{n_off} elements off"


def _flat_state(engine):
    opt = engine.optimizer
    return [opt.params.clone()] + [t.clone() for t in opt.state.values()]


def _equal_states(a, b):
    return all(torch.equal(x, y) for x, y in zip(_flat_state(a), _flat_state(b)))


# LR path of 4 updates under the linear warmup (1e-4, 4e-4, 7e-4, 1e-3)
PATH4 = 1e-4 + 4e-4 + 7e-4 + 1e-3


@pytest.mark.parametrize("form", ["fused_train_step", "fused_train_steps"])
def test_fused_steps_match_jax_engine(form):
    """4 steps: each JAX engine call against the port's same call; the
    losses at every step, the LR after them and the final masters."""
    jeng, teng, n_dev = _engines()
    data = [_ids(20 + i, (n_dev, 16)) for i in range(4)]
    if form == "fused_train_step":
        ref = [float(jeng.fused_train_step(jnp.asarray(x), labels=jnp.asarray(x)))
               for x in data]
        got = []
        for x in data:
            loss = teng.fused_train_step(torch.from_numpy(x).long(),
                                         labels=torch.from_numpy(x).long())
            assert loss.dim() == 0
            got.append(loss.item())
    else:
        xs = np.stack(data)
        ref = np.asarray(jeng.fused_train_steps(jnp.asarray(xs), labels=jnp.asarray(xs)))
        t = torch.from_numpy(xs).long()
        got = teng.fused_train_steps(t, labels=t)
        assert got.shape == (4, ) and got.device.type == "cpu"
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **LOSS_TOL)
    assert teng.global_steps == jeng.global_steps == 4
    assert teng.micro_steps == jeng.micro_steps == 4
    assert teng.global_samples == jeng.global_samples
    np.testing.assert_allclose(teng.get_lr()[0], float(jeng.get_lr()[0]), rtol=1e-6)
    np.testing.assert_allclose(teng.get_global_grad_norm(), jeng.get_global_grad_norm(),
                               rtol=1e-5)
    _assert_masters_match(teng, jeng, PATH4)


def test_window_equals_its_steps_one_by_one():
    """Within the port: ``fused_train_steps`` over K stacked batches, K
    ``fused_train_step`` calls and K forward/backward/step give the same
    losses, masters, moments and LR bit for bit; the schedule advances
    once per step inside the window, from the device count."""
    data = torch.from_numpy(np.stack([_ids(40 + i, (2, 16)) for i in range(5)])).long()
    engines = [_port_engine() for _ in range(3)]
    window = engines[0].fused_train_steps(data, labels=data)
    single = torch.stack([engines[1].fused_train_step(x, labels=x) for x in data])
    split = []
    for x in data:
        loss = engines[2].forward(x, labels=x)
        engines[2].backward(loss)
        engines[2].step()
        split.append(loss.detach())
    assert torch.equal(window, single) and torch.equal(window, torch.stack(split))
    for e in engines[1:]:
        assert _equal_states(engines[0], e)
        assert e.get_lr() == engines[0].get_lr()
        assert e.global_steps == 5 and e.optimizer.count == 5
    assert engines[0].get_lr()[0] == pytest.approx(LR)
    assert int(engines[0].optimizer._count) == 5


def test_warmup_lr_inside_a_window_matches_single_steps():
    """JAX's check (``test_multi_step_fused_runs_lr_schedule_in_program``):
    after one window of 5 the LR equals 5 single steps', in the port and
    against the JAX engine's window."""
    sched = {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-2,
                                            "warmup_num_steps": 10}}
    jeng, teng, n_dev = _engines(scheduler=sched)
    xs = np.stack([_ids(60 + i, (n_dev, 16)) for i in range(5)])
    jeng.fused_train_steps(jnp.asarray(xs), labels=jnp.asarray(xs))
    t = torch.from_numpy(xs).long()
    teng.fused_train_steps(t, labels=t)
    single = _port_engine(micro=n_dev, scheduler=sched)
    for x in t:
        single.fused_train_step(x, labels=x)
    assert teng.get_lr() == single.get_lr()
    assert teng.get_lr()[0] == pytest.approx(float(jeng.get_lr()[0]), rel=1e-6)
    assert _equal_states(teng, single)


def test_fp16_overflow_bookkeeping_matches_jax():
    """fp16 with a scale that overflows the first steps (2^16, hysteresis
    1): a window of 6 against the JAX engine's window and against the
    port's own steps one by one; skipped steps, the scale, the update
    count and the LR exactly, the masters of the port's two runs bit for
    bit."""
    fp16 = {"enabled": True, "initial_scale_power": 16, "hysteresis": 1}
    jeng, teng, n_dev = _engines(dtype="fp16", fp16=fp16)
    xs = np.stack([_ids(80 + i, (n_dev, 16)) for i in range(6)])
    jl = np.asarray(jeng.fused_train_steps(jnp.asarray(xs), labels=jnp.asarray(xs)))
    t = torch.from_numpy(xs).long()
    tl = teng.fused_train_steps(t, labels=t)
    _, _, tmodel = _models(dtype="fp16")
    seq, *_ = deepspeed_tpu_torch.initialize(model=tmodel, config=_config(1, n_dev, fp16=fp16),
                                             device="cpu")
    for x in t:
        seq.backward(seq.forward(x, labels=x))
        seq.step()
    assert 0 < teng.skipped_steps < 6
    assert teng.skipped_steps == jeng.skipped_steps == seq.skipped_steps
    assert teng.cur_scale == float(jeng.scale_state.cur_scale) == seq.cur_scale
    assert ls.to_host(teng.scale_state) == ls.to_host(seq.scale_state)
    assert teng.optimizer.count == seq.optimizer.count == 6 - teng.skipped_steps
    assert teng.get_lr() == seq.get_lr()
    np.testing.assert_allclose(teng.get_lr()[0], float(jeng.get_lr()[0]), rtol=1e-6)
    assert _equal_states(teng, seq)
    # the losses of fp16 forwards, rounded at other points than JAX's
    np.testing.assert_allclose(tl.numpy(), jl, rtol=2.0 ** -10)


def test_gas2_train_batch_matches_jax_fused_batch():
    """gas 2: ``train_batch`` (2 micro-batches and the apply step, one
    fetch) against the JAX engine's one-program batch over 3 steps, and
    bit for bit against the port's micro loop."""
    jeng, teng, n_dev = _engines(gas=2)
    assert jeng._train_batch_fused is not None
    loop = _port_engine(gas=2, micro=n_dev)
    micros = [_ids(100 + i, (n_dev, 16)) for i in range(6)]
    for step in range(3):
        mb = micros[2 * step:2 * step + 2]
        ref = jeng.train_batch(iter([(jnp.asarray(x), jnp.asarray(x)) for x in mb]))
        tm = [torch.from_numpy(x).long() for x in mb]
        got = teng.train_batch(iter([(x, x) for x in tm]))
        assert isinstance(got, float)
        np.testing.assert_allclose(got, ref, **LOSS_TOL)
        losses = []
        for x in tm:
            loss = loop.forward(x, x)
            loop.backward(loss)
            loop.step()
            losses.append(loss.detach().float())
        assert got == float((torch.zeros(()) + losses[0] + losses[1]) / 2)
    assert teng.global_steps == jeng.global_steps == 3
    assert teng.micro_steps == jeng.micro_steps == 6
    assert _equal_states(teng, loop)
    _assert_masters_match(teng, jeng, 1e-4 + 4e-4 + 7e-4)


def test_grad_accum_dtype_bf16_halves_the_buffer():
    """``data_types.grad_accum_dtype`` bf16 at gas 2 (JAX's
    ``test_grad_accum_dtype_knob``): the buffer is bf16 and half the fp32
    one's bytes, and 3 batches' losses stay within 5e-3 relative of fp32
    accumulation, in the port and in the JAX engine alike."""
    runs = {}
    for gad in (None, "bf16"):
        extra = {"data_types": {"grad_accum_dtype": gad}} if gad else {}
        jeng, teng, n_dev = _engines(gas=2, **extra)
        data = [_ids(120 + i, (n_dev, 16)) for i in range(6)]
        jl = [jeng.train_batch(iter([(jnp.asarray(x), jnp.asarray(x))
                                     for x in data[2 * i:2 * i + 2]])) for i in range(3)]
        tl = [teng.train_batch(iter([(torch.from_numpy(x).long(), ) * 2
                                     for x in data[2 * i:2 * i + 2]])) for i in range(3)]
        runs[gad] = (teng, jl, tl)
        want = torch.bfloat16 if gad else torch.float32
        assert teng._flat_grad.dtype == teng.grad_accum_dtype == want
        assert all(g.dtype == want for g in teng._grad_acc)
        assert all(leaf.dtype == (jnp.bfloat16 if gad else jnp.float32)
                   for leaf in jax.tree_util.tree_leaves(jeng.grad_acc))
    (f32, jf, tf), (b16, jb, tb) = runs[None], runs["bf16"]
    assert 2 * b16._flat_grad.nbytes == f32._flat_grad.nbytes
    np.testing.assert_allclose(tb, tf, rtol=5e-3)
    np.testing.assert_allclose(jb, jf, rtol=5e-3)
    np.testing.assert_allclose(tb, jb, rtol=5e-3)


@pytest.mark.parametrize("gad,match", [("int8", "grad_accum_dtype"), ("fp16", "fp16"),
                                       ("float64", "grad_accum_dtype")])
def test_grad_accum_dtype_refusals_match_jax(gad, match):
    """int8 and unknown names are not accumulation types; fp16 needs fp16
    training's overflow skip. Both packages raise the same ValueError."""
    extra = {"data_types": {"grad_accum_dtype": gad}}
    jmodel, params, tmodel = _models()
    with pytest.raises(ValueError, match=match):
        deepspeed_tpu.initialize(model=jmodel, model_parameters=params,
                                 config=_config(**extra))
    with pytest.raises(ValueError, match=match):
        deepspeed_tpu_torch.initialize(model=tmodel, config=_config(**extra), device="cpu")


def test_grad_accum_dtype_fp16_under_fp16_training():
    engine = _port_engine(fp16={"enabled": True}, data_types={"grad_accum_dtype": "fp16"})
    assert engine._flat_grad.dtype == torch.float16
    x = torch.from_numpy(_ids(7, (2, 16))).long()
    assert np.isfinite(engine.train_batch(iter([(x, x)])))


def test_fused_guards():
    """JAX's guards that apply on one device: the fused paths need gas 1
    (an AssertionError naming it, as ``test_gas_gt_1_has_no_fused_path``),
    and a window needs one leading step axis."""
    engine = _port_engine(gas=2)
    x = torch.from_numpy(_ids(3, (1, 2, 16))).long()
    with pytest.raises(AssertionError, match="gradient_accumulation"):
        engine.fused_train_step(x[0], labels=x[0])
    with pytest.raises(AssertionError, match="gradient_accumulation"):
        engine.fused_train_steps(x, labels=x)
    engine = _port_engine()
    with pytest.raises(ValueError, match="leading step axis"):
        engine.fused_train_steps(x, labels=torch.cat([x, x]))
    assert engine.global_steps == 0


@pytest.mark.parametrize("window,hysteresis,consecutive,static", [
    (1000, 2, False, False), (2, 1, False, False), (3, 3, True, False), (1, 2, False, True)])
def test_device_loss_scale_rule_equals_host_rule(window, hysteresis, consecutive, static):
    """``next_device_state`` (0-d tensors, ``torch.where``) against
    ``next_state``, the host rule the JAX tests hold, step for step over a
    seeded pattern of overflows."""
    from deepspeed_tpu_torch.config.config import FP16Config
    fp16 = FP16Config({"enabled": True, "initial_scale_power": 6,
                       "loss_scale_window": window, "hysteresis": hysteresis,
                       "consecutive_hysteresis": consecutive, "min_loss_scale": 4.0,
                       "loss_scale": 128.0 if static else 0.0})
    host = ls.initial_state(fp16)
    dev = ls.to_device(host, "cpu")
    for ov in np.random.default_rng(window).random(60) < 0.35:
        host = ls.next_state(fp16, host, bool(ov))
        dev = ls.next_device_state(fp16, dev, torch.tensor(bool(ov)))
        assert ls.to_host(dev) == host


def _k7_state(seed, n=1031):
    rng = np.random.default_rng(seed)
    p, g, m = (torch.from_numpy(rng.normal(size=n).astype(np.float32)) for _ in range(3))
    v = torch.from_numpy(rng.random(n).astype(np.float32))
    g[7] = float("inf")  # an overflowed step's gradient
    return p, g, m, v


@pytest.mark.parametrize("body", ["adam", "lion", "lamb"])
def test_k7_skip_flag_leaves_the_buffers(body):
    """A set skip flag writes nothing: every buffer keeps its bits (a zero
    learning rate would not: 0 * inf is NaN); a clear one is the plain
    step."""
    p, g, m, v = _k7_state(5)
    s = {k: fo.device_scalar(x, "cpu") for k, x in (("lr", 1e-3), ("step", 3))}
    for flag in (True, False):
        skip = torch.tensor([flag])
        bufs = [t.clone() for t in (p, m, v)]
        u = g.clone()
        if body == "adam":
            fo.adam_step_(bufs[0], g, bufs[1], bufs[2], s["lr"], s["step"],
                          weight_decay=0.1, skip=skip)
        elif body == "lion":
            fo.lion_step_(bufs[0], g, bufs[1], s["lr"], weight_decay=0.1, skip=skip)
        else:
            fo.lamb_update_(u, bufs[1], bufs[2], s["step"], out=u, skip=skip)
            fo.lamb_apply_trust_(bufs[0], u, s["lr"], 0.1, [(0, 500), (500, 1031)], skip)
        kept = [torch.equal(a, b) for a, b in zip(bufs, (p, m, v))]
        if flag:
            assert all(kept)
        else:
            assert not any(kept[:2 if body == "lion" else 3])


@pytest.mark.parametrize("name,extra", [("adamw", {}), ("lamb", {}), ("lion", {}),
                                        ("sgd", {"momentum": 0.9}), ("adagrad", {})])
def test_optimizer_skips_keep_count_state_and_lr(name, extra):
    """The optimizer's device count moves only on applied steps, each
    step's learning rate is the schedule's at that count (read from the
    window's table), and a skipped step moves no state: against the same
    optimizer stepped only on the applied steps."""
    rng = np.random.default_rng(9)
    p0 = rng.normal(size=300).astype(np.float32)
    grads = [torch.from_numpy(rng.normal(size=300).astype(np.float32)) for _ in range(6)]
    flags = [False, True, False, True, True, False]
    sched = get_lr_schedule("WarmupLR", {"warmup_min_lr": 1e-3, "warmup_max_lr": 1e-2,
                                         "warmup_num_steps": 4, "warmup_type": "linear"})
    params = {"lr": 1e-2, **extra}
    a = build_optimizer(name, torch.from_numpy(p0.copy()), params, sched.lr_at,
                        bounds=[(0, 100), (100, 300)])
    b = build_optimizer(name, torch.from_numpy(p0.copy()), params, sched.lr_at,
                        bounds=[(0, 100), (100, 300)])
    a.begin_window(len(grads))
    for g, flag in zip(grads, flags):
        bad = g.clone()
        if flag:
            bad[11] = float("nan")
        a.step(bad, skip=torch.tensor(flag))
        if not flag:
            b.step(g.clone())
    assert int(a._count) == b.count == 3
    a.settle(3)
    assert a.count == 3 and a._unsettled == 0
    assert torch.equal(a.params, b.params)
    assert all(torch.equal(a.state[k], b.state[k]) for k in a.state)
