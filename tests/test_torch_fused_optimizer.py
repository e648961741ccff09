"""K7 (``deepspeed_tpu_torch/ops/fused_optimizer.py``) against the JAX
package's ``fused_adam_step`` / ``fused_lion_step`` / ``fused_lamb_step``,
both the Pallas kernel in interpret mode and the jnp branch, on the same
seeded numpy inputs, on the CPU (the port's plain versions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops
import deepspeed_tpu_torch.ops
from deepspeed_tpu.ops import fused_optimizer as jax_fo
from deepspeed_tpu_torch.ops import fused_optimizer as fo

IMPLS = {"interpret": dict(interpret=True, force_pallas=True),
         "jnp": dict(force_pallas=False)}
LR = 1e-3

# fp32 outputs. The moments are the same elementwise formula, rounded at
# other points (XLA contracts b*m + c into one fma): an ulp of the larger
# term, ~1e-8 for the terms of order 0.1 here, which is a large relative
# error where the two terms cancel: 1e-6 relative, 1e-7 absolute. The
# parameters: the bias corrections are 1 - exp(t log b) in the port and
# the Pallas body (1 - b**t in the jnp branch); one ulp of exp(t log b) ~
# b**t is up to 6e-5 of 1 - b**t at t = 1, b = 0.999, which moves the
# update by ~3e-5 and the parameter by ~3e-5 * lr: atol 1e-4 * lr.
M_TOL = dict(rtol=1e-6, atol=1e-7)
P_TOL = dict(rtol=1e-6, atol=1e-4 * LR)
# bf16 parameters: the same fp32 value rounded once to bf16 on both sides;
# where the fp32 values straddle a rounding boundary, one bf16 ulp (2^-8)
BF16_TOL = dict(rtol=2.0 ** -8, atol=1e-4 * LR)


def _inputs(seed, n, zero_tail=0):
    """p ~ N(0, 1), g ~ N(0, 1), m ~ 0.1 N(0, 1), v ~ 0.01 U(0, 1); the
    last ``zero_tail`` elements have g = m = v = 0."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=n).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    m = (0.1 * rng.normal(size=n)).astype(np.float32)
    v = (0.01 * rng.random(size=n)).astype(np.float32)
    if zero_tail:
        for a in (g, m, v):
            a[-zero_tail:] = 0
    return p, g, m, v


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(a).to(dtype)
    return jnp.asarray(t.float().numpy()).astype(
        {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]), t


def _s(x):
    """The in-place forms take the per-step scalars as one-element tensors."""
    return fo.device_scalar(x, "cpu")


def _check(got, ref, dtype=torch.float32, tol=P_TOL, name=""):
    assert got.dtype == dtype, name
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref).astype(np.float32),
                               err_msg=name, **tol)


# (n, step, weight_decay, params dtype, grads dtype)
ADAM_CASES = {
    "ragged_step1": (5003, 1, 0.0, torch.float32, torch.float32),
    "ragged_step3_wd": (5003, 3, 0.01, torch.float32, torch.float32),
    "aligned_step2_wd": (4096, 2, 0.1, torch.float32, torch.float32),
    "bf16_params": (3001, 2, 0.01, torch.bfloat16, torch.float32),
    "bf16_grads": (3001, 5, 0.0, torch.float32, torch.bfloat16),
}


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_fused_adam_step_matches_jax(case, impl):
    n, step, wd, p_dt, g_dt = ADAM_CASES[case]
    p, g, m, v = _inputs(sorted(ADAM_CASES).index(case), n, zero_tail=7)
    (jp, tp), (jg, tg) = _pair(p, p_dt), _pair(g, g_dt)
    ref = jax_fo.fused_adam_step(jp, jg, jnp.asarray(m), jnp.asarray(v), LR, step,
                                 weight_decay=wd, **IMPLS[impl])
    got = fo.fused_adam_step(tp, tg, torch.from_numpy(m), torch.from_numpy(v), LR, step,
                             weight_decay=wd)
    _check(got[0], ref[0], p_dt, BF16_TOL if p_dt == torch.bfloat16 else P_TOL, "p")
    _check(got[1], ref[1], tol=M_TOL, name="m")
    _check(got[2], ref[2], tol=M_TOL, name="v")


def test_adam_l2_mode_is_weight_decay_into_the_gradient():
    """``adam_step_(l2=True)``: the engine's adam with weight decay, one
    pass; against the JAX fused step on ``g + wd * p`` without decay."""
    p, g, m, v = _inputs(9, 2051)
    wd = 0.05
    ref = jax_fo.fused_adam_step(jnp.asarray(p), jnp.asarray(g + np.float32(wd) * p),
                                 jnp.asarray(m), jnp.asarray(v), LR, 2, interpret=True,
                                 force_pallas=True)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    fo.adam_step_(tp, torch.from_numpy(g), tm, tv, _s(LR), _s(2), weight_decay=wd,
                  l2=True)
    for name, got, r in zip("pmv", (tp, tm, tv), ref):
        _check(got, r, tol=P_TOL if name == "p" else M_TOL, name=name)


# (n, weight_decay, params dtype, grads dtype)
LION_CASES = {
    "ragged": (5003, 0.0, torch.float32, torch.float32),
    "ragged_wd": (5003, 0.05, torch.float32, torch.float32),
    "bf16_params_wd": (1027, 0.01, torch.bfloat16, torch.float32),
    "bf16_grads": (1027, 0.0, torch.float32, torch.bfloat16),
}


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("case", sorted(LION_CASES))
def test_fused_lion_step_matches_jax(case, impl):
    n, wd, p_dt, g_dt = LION_CASES[case]
    # the zero tail: sign(0) = 0, the parameter moves by lr * wd * p only
    p, g, m, _ = _inputs(10 + sorted(LION_CASES).index(case), n, zero_tail=5)
    (jp, tp), (jg, tg) = _pair(p, p_dt), _pair(g, g_dt)
    ref = jax_fo.fused_lion_step(jp, jg, jnp.asarray(m), LR, weight_decay=wd, **IMPLS[impl])
    got = fo.fused_lion_step(tp, tg, torch.from_numpy(m), LR, weight_decay=wd)
    _check(got[0], ref[0], p_dt, BF16_TOL if p_dt == torch.bfloat16 else P_TOL, "p")
    _check(got[1], ref[1], tol=M_TOL, name="m")


# (n, step, weight_decay, segments, params dtype, zeroed): ``zeroed`` makes
# one segment's parameters zero ("p") or its gradient and moments zero
# ("u", no update): either takes trust 1
LAMB_CASES = {
    "one_segment": (5003, 1, 0.0, None, torch.float32, None),
    "one_segment_wd": (5003, 2, 0.01, (0, 5003), torch.float32, None),
    "segments_wd": (5003, 3, 0.01, (0, 1000, 3000, 5003), torch.float32, None),
    "segments": (4096, 1, 0.0, (0, 64, 2048, 4096), torch.float32, None),
    "zero_norm_params": (3000, 2, 0.01, (0, 1000, 2000, 3000), torch.float32, "p"),
    "zero_update": (3000, 2, 0.0, (0, 1000, 2000, 3000), torch.float32, "u"),
    "bf16_params": (3001, 2, 0.01, (0, 1500, 3001), torch.bfloat16, None),
}


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("case", sorted(LAMB_CASES))
def test_fused_lamb_step_matches_jax(case, impl):
    n, step, wd, segments, p_dt, zeroed = LAMB_CASES[case]
    p, g, m, v = _inputs(20 + sorted(LAMB_CASES).index(case), n)
    if zeroed == "p":
        p[1000:2000] = 0
    elif zeroed == "u":
        g[1000:2000] = m[1000:2000] = v[1000:2000] = 0
    (jp, tp) = _pair(p, p_dt)
    ref = jax_fo.fused_lamb_step(jp, jnp.asarray(g), jnp.asarray(m), jnp.asarray(v), LR,
                                 step, weight_decay=wd, segments=segments, **IMPLS[impl])
    got = fo.fused_lamb_step(tp, torch.from_numpy(g), torch.from_numpy(m),
                             torch.from_numpy(v), LR, step, weight_decay=wd,
                             segments=segments)
    _check(got[0], ref[0], p_dt, BF16_TOL if p_dt == torch.bfloat16 else P_TOL, "p")
    _check(got[1], ref[1], tol=M_TOL, name="m")
    _check(got[2], ref[2], tol=M_TOL, name="v")
    if zeroed == "u" and not wd:
        assert torch.equal(got[0][1000:2000], tp[1000:2000])


def test_lamb_segments_matter():
    """Per-segment trust ratios differ from one over the whole buffer (the
    JAX test's check, on the port)."""
    p, g, m, v = _inputs(30, 3000)
    args = [torch.from_numpy(a) for a in (p, g, m, v)]
    per_seg = fo.fused_lamb_step(*args, LR, 1, weight_decay=0.01, segments=(0, 1000, 3000))
    whole = fo.fused_lamb_step(*args, LR, 1, weight_decay=0.01)
    assert not torch.allclose(per_seg[0], whole[0])


def test_in_place_forms_equal_the_functional_ones():
    """What the engine calls (in place, LAMB's update over the gradient
    buffer) gives what the functional forms return, bit for bit."""
    p, g, m, v = _inputs(31, 1500)
    t = {k: torch.from_numpy(a.copy()) for k, a in zip("pgmv", (p, g, m, v))}
    ref = fo.fused_adam_step(t["p"], t["g"], t["m"], t["v"], LR, 4, weight_decay=0.01)
    fo.adam_step_(t["p"], t["g"], t["m"], t["v"], _s(LR), _s(4), weight_decay=0.01)
    assert all(torch.equal(a, b) for a, b in zip((t["p"], t["m"], t["v"]), ref))
    t = {k: torch.from_numpy(a.copy()) for k, a in zip("pgmv", (p, g, m, v))}
    ref = fo.fused_lamb_step(t["p"], t["g"], t["m"], t["v"], LR, 2, eps=1e-8,
                             weight_decay=0.01, segments=(0, 700, 1500))
    u = fo.lamb_update_(t["g"], t["m"], t["v"], _s(2), eps=1e-8, out=t["g"])
    assert u is t["g"]
    fo.lamb_apply_trust_(t["p"], u, _s(LR), 0.01, [(0, 700), (700, 1500)])
    assert all(torch.equal(a, b) for a, b in zip((t["p"], t["m"], t["v"]), ref))


def test_entry_points_keep_the_jax_signatures():
    """``deepspeed_tpu_torch.ops.fused_*_step`` as ``deepspeed_tpu.ops``
    exports them: the same parameter names, order and defaults, less the
    JAX dispatch knobs (``block``, ``force_pallas``, ``interpret``)."""
    import inspect
    for name in ("fused_adam_step", "fused_lion_step", "fused_lamb_step"):
        ref = inspect.signature(getattr(deepspeed_tpu.ops, name)).parameters
        got = inspect.signature(getattr(deepspeed_tpu_torch.ops, name)).parameters
        ref = [(p.name, p.default) for p in ref.values()
               if p.name not in ("block", "force_pallas", "interpret")]
        assert [(p.name, p.default) for p in got.values()] == ref, name


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    """A CPU tensor runs the plain version and counts no launch; a tensor
    on another device is refused rather than computed some other way."""
    p, g, m, v = (torch.from_numpy(a) for a in _inputs(32, 64))
    before = (fo.adam_step_.launches, fo.lion_step_.launches, fo.lamb_update_.launches)
    fo.fused_adam_step(p, g, m, v, LR, 1)
    fo.fused_lion_step(p, g, m, LR)
    fo.fused_lamb_step(p, g, m, v, LR, 1)
    assert (fo.adam_step_.launches, fo.lion_step_.launches,
            fo.lamb_update_.launches) == before
    meta = [t.to("meta") for t in (p, g, m, v)]
    with pytest.raises(ValueError, match="device"):
        fo.adam_step_(*meta, LR, 1)
