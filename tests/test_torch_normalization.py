"""deepspeed_tpu_torch RMSNorm and LayerNorm against the JAX package's
kernels.

Same numpy inputs through ``deepspeed_tpu.ops.normalization.rms_norm`` and
``layer_norm`` (the Pallas kernels in interpret mode, and for LayerNorm also
its jnp branch, which the JAX serving forward computes) and the port's
``rms_norm`` and ``layer_norm`` (the plain PyTorch versions on CPU
tensors)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops.normalization import layer_norm as jax_layer_norm
from deepspeed_tpu.ops.normalization import rms_norm as jax_rms_norm
from deepspeed_tpu_torch.ops.normalization import layer_norm, rms_norm

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: reduction order only. bf16: both compute in fp32 and round once to
# bf16, so a result may sit one bf16 ulp (2^-7 relative) apart.
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    jd, td = DTYPES[dtype]
    return ((jnp.asarray(x, jd), jnp.asarray(w, jd)),
            (torch.from_numpy(x).to(td), torch.from_numpy(w).to(td)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(8, 64), (37, 100), (2, 5, 256), (1, 4096), (8, 4096)])
def test_matches_jax_kernel(dtype, shape):
    (xj, wj), (xt, wt) = _inputs(0, shape, dtype)
    out_j = jax_rms_norm(xj, wj, 1e-5, interpret=True)
    out_t = rms_norm(xt, wt, 1e-5)
    assert out_t.dtype == xt.dtype and out_t.shape == xt.shape
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), **TOL[dtype])


def test_fp32_weight_on_bf16_rows():
    """The weight is cast to fp32 and the output keeps x's dtype."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.normal(size=(64, )).astype(np.float32)
    out_j = jax_rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), 1e-5,
                         interpret=True)
    out_t = rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), 1e-5)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), **TOL["bfloat16"])


@pytest.mark.parametrize("shape", [(8, 3584), (3, 7), (768, 3584)])
def test_plus_one_scale_on_bf16_rows(shape):
    """Gemma's serving norm: a bf16 x and the fp32 scale 1 + w, w ~1e-3
    (deltas a bf16 scale would round away), against the JAX kernel."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    w = (1.0 + 1e-3 * rng.normal(size=shape[-1:])).astype(np.float32)
    out_j = jax_rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), 1e-6,
                         interpret=True)
    out_t = rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), 1e-6)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), **TOL["bfloat16"])


def _ln_inputs(seed, shape, dtype, shift):
    """Rows of N(0, 1) plus ``shift`` on the first row: a large mean that
    E[x^2] - E[x]^2 would cancel, the centred variance keeps."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1, shape[-1])[0] += shift
    w = (1.0 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    b = (0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in (x, w, b)],
            [torch.from_numpy(a).to(td) for a in (x, w, b)])


@pytest.mark.parametrize("branch", ["kernel", "jnp"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape, shift", [((8, 96), 0.0), ((37, 100), 300.0),
                                          ((2, 5, 256), 0.0), ((3, 4608), 1000.0),
                                          ((8, 4608), 0.0)])
def test_layer_norm_matches_jax(shape, shift, dtype, branch):
    """Against the Pallas kernel (interpret mode) and the jnp branch. The
    tolerances of RMSNorm: fp32 summation order; bf16 one ulp of the
    output. The mean of a shifted row is a sum of values near ``shift`` in
    fp32, in another order on each side: a few ulps of ``shift`` (2^-23
    relative each) move every centred value of that row, so fp32 allows
    2^-21 * shift more. A row of mean 1000 and spread 1 still normalizes
    to spread 1."""
    jargs, targs = _ln_inputs(2, shape, dtype, shift)
    out_j = jax_layer_norm(*jargs, 1e-5, force_pallas=False,
                           interpret=branch == "kernel")
    out_t = layer_norm(*targs, 1e-5)
    assert out_t.dtype == targs[0].dtype and out_t.shape == targs[0].shape
    tol = dict(TOL[dtype])
    if dtype == "float32":
        tol["atol"] += 2.0 ** -21 * shift
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), **tol)
    if dtype == "float32":
        row = out_t.reshape(-1, shape[-1])[0]
        assert abs(row.std(unbiased=False).item() - 1.0) < 0.15

