"""deepspeed_tpu_torch flash attention (K1/K2 plain versions and the
autograd.Function) against the JAX package's Pallas flash kernels in
interpret mode, on the same seeded numpy inputs, in fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import _flash_fwd
from deepspeed_tpu.ops.attention import flash_attention as jax_flash_attention
from deepspeed_tpu_torch.ops.attention import (
    flash_attention, flash_attention_bwd_dkdv,
    flash_attention_bwd_dq, flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_fwd_reference)

# (B, S, H, KV, D, causal): G = H / KV of 1, 2 and 4; S of 100 and 80 are
# not multiples of the CUDA kernels' 64-row tiles (the JAX kernel runs them
# as one block)
CASES = {
    "g1_causal": (1, 64, 2, 2, 16, True),
    "g2_causal_s100": (2, 100, 4, 2, 32, True),
    "g4_causal_s80": (1, 80, 8, 2, 16, True),
    "g4_full_s100": (1, 100, 4, 1, 16, False),
}
# fp32 on both sides; the two differ in summation order only (softmax over
# at most 100 keys, |o| < 3, grads < 10)
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(case):
    B, S, H, KV, D, causal = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in (
        (B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    return (q, k, v, do), causal


def _jax_lse_natural(lse, B, S, H, KV):
    """[B*KV, G, S, 1] (the Pallas kernel's layout) -> [B, S, H]."""
    G = H // KV
    return np.asarray(lse).reshape(B, KV, G, S).transpose(0, 3, 1, 2).reshape(B, S, H)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_pallas_kernels(case):
    (q, k, v, do), causal = _inputs(case)
    B, S, H, D = q.shape
    KV = k.shape[2]
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o_ref, lse_ref = _flash_fwd(jq, jk, jv, scale, causal, S, S, interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(
        a, b, c, causal=causal, interpret=True, impl_fwd="pallas",
        impl_bwd="pallas"), jq, jk, jv)
    grads_ref = vjp(jnp.asarray(do))

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_fwd_reference(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse_natural(lse_ref, B, S, H, KV),
                               **TOL)
    grads = flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, causal)
    for name, g, g_ref in zip("qkv", grads, grads_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), err_msg=f"d{name}",
                                   **TOL)


@pytest.mark.parametrize("case", ["g2_causal_s100", "g4_full_s100"])
def test_autograd_function_runs_the_kernel_functions_on_cpu(case):
    (q, k, v, do), causal = _inputs(case)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    counts = [f.launches for f in (flash_attention_fwd, flash_attention_bwd_dq,
                                   flash_attention_bwd_dkdv)]
    out = flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(do))
    o, lse = flash_attention_fwd_reference(tq.detach(), tk.detach(), tv.detach(),
                                           causal)
    torch.testing.assert_close(out.detach(), o, atol=0, rtol=0)
    grads = flash_attention_bwd_reference(tq.detach(), tk.detach(), tv.detach(),
                                          o, lse, torch.from_numpy(do), causal)
    for t, g in zip((tq, tk, tv), grads):
        torch.testing.assert_close(t.grad, g, atol=0, rtol=0)
    # the CPU path runs the plain versions: no kernel launch is counted
    assert counts == [f.launches for f in (flash_attention_fwd, flash_attention_bwd_dq,
                                           flash_attention_bwd_dkdv)]


def test_window_and_softcap_raise():
    (q, k, v, _), _ = _inputs("g1_causal")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(NotImplementedError, match="window"):
        flash_attention(tq, tk, tv, causal=True, window=8)
    with pytest.raises(NotImplementedError, match="softcap"):
        flash_attention(tq, tk, tv, causal=True, softcap=30.0)
