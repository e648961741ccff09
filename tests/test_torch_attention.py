"""deepspeed_tpu_torch flash attention (K1/K2 plain versions and the
autograd.Function) against the JAX package's Pallas flash kernels in
interpret mode, on the same seeded numpy inputs, in fp32 on the CPU:
causal or not, GQA, and the window and softcap options."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import _flash_fwd
from deepspeed_tpu.ops.attention import flash_attention as jax_flash_attention
from deepspeed_tpu_torch.ops.attention import (
    attention_delta, attention_reference, flash_attention, flash_attention_bwd_dkdv,
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
    """Both options are taken (the cases above); what no kernel takes, a
    window shorter than one key or a softcap not above 0, raises."""
    (q, k, v, _), _ = _inputs("g1_causal")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="window"):
        flash_attention(tq, tk, tv, causal=True, window=0)
    with pytest.raises(ValueError, match="window"):
        flash_attention(tq, tk, tv, causal=True, window=2.5)
    with pytest.raises(ValueError, match="softcap"):
        flash_attention(tq, tk, tv, causal=True, softcap=0.0)
    with pytest.raises(ValueError, match="softcap"):
        flash_attention_fwd(tq, tk, tv, True, None, 8, -30.0)


# (B, S, H, KV, D, causal, window, softcap): a window smaller than the CUDA
# kernels' 64-key tile, one that is not a multiple of it (100), one that
# covers the sequence, the softcap alone and with a window, and a window
# without the causal mask (future keys visible, old ones dropped); the JAX
# kernels run 64 x 64 blocks, so each case spans several blocks per axis
OPTION_CASES = {
    "w16_s128": (1, 128, 4, 2, 32, True, 16, None),
    "w100_s192": (2, 192, 8, 2, 16, True, 100, None),
    "w200_s128": (1, 128, 4, 4, 32, True, 200, None),
    "softcap_s128": (1, 128, 4, 1, 32, True, None, 30.0),
    "w64_softcap_s192": (1, 192, 8, 4, 16, True, 64, 20.0),
    "w70_softcap_full": (1, 128, 4, 2, 32, False, 70, 20.0),
    # head_dim 256 (Gemma-2, G 2) with the window and a softcap that bites
    # on N(0, 1) scores
    "d256_w64_softcap_s128": (1, 128, 4, 2, 256, True, 64, 2.0),
}
OPTION_BLOCK = 64


def _option_inputs(case):
    B, S, H, KV, D, causal, window, softcap = OPTION_CASES[case]
    rng = np.random.default_rng(100 + sorted(OPTION_CASES).index(case))
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in (
        (B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    return (q, k, v, do), dict(causal=causal, window=window, softcap=softcap)


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_plain_flash_with_window_and_softcap_matches_pallas_kernels(case):
    """K1's and K2's plain versions against ``_flash_fwd`` and the Pallas
    backward (``_dq_kernel``/``_dkdv_kernel`` with the window's block skip
    and softcap's 1 - t^2) on the same inputs; tolerance TOL, as above."""
    (q, k, v, do), opts = _option_inputs(case)
    B, S, H, D = q.shape
    KV = k.shape[2]
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o_ref, lse_ref = _flash_fwd(jq, jk, jv, scale, opts["causal"], OPTION_BLOCK,
                                OPTION_BLOCK, True, opts["window"], opts["softcap"])
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(
        a, b, c, interpret=True, block_q=OPTION_BLOCK, block_k=OPTION_BLOCK,
        impl_fwd="pallas", impl_bwd="pallas", **opts), jq, jk, jv)
    grads_ref = vjp(jnp.asarray(do))

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_fwd(tq, tk, tv, opts["causal"], None, opts["window"],
                                 opts["softcap"])
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse_natural(lse_ref, B, S, H, KV),
                               **TOL)
    grads = flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, **opts)
    for name, g, g_ref in zip("qkv", grads, grads_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), err_msg=f"d{name}",
                                   **TOL)
    # the wrappers' CPU path is the plain version itself
    delta = attention_delta(o, tdo)
    args = (tq, tk, tv, tdo, lse, delta, opts["causal"], None, opts["window"],
            opts["softcap"])
    torch.testing.assert_close(flash_attention_bwd_dq(*args), grads[0], atol=0, rtol=0)


def test_window_skips_what_it_hides():
    """A window of w equals the plain attention over explicitly masked
    scores, and a window covering the sequence equals none."""
    (q, k, v, _), _ = _option_inputs("w100_s192")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    S = tq.shape[1]
    full, _ = flash_attention_fwd(tq, tk, tv, True)
    wide, _ = flash_attention_fwd(tq, tk, tv, True, None, S)
    torch.testing.assert_close(wide, full, atol=0, rtol=0)
    narrow, _ = flash_attention_fwd(tq, tk, tv, True, None, 1)
    # a window of 1 keeps only the query's own key: o is v of that key
    G = tq.shape[2] // tk.shape[2]
    torch.testing.assert_close(narrow, tv.repeat_interleave(G, dim=2), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_plain_backward_is_the_gradient_in_fp64(case):
    """In fp64 the plain K1/K2 versions (P rebuilt from lse, dS with the
    softcap's 1 - t^2, the window's mask) equal autograd through the plain
    attention to fp64 rounding (1e-12 of values below 10): the exact value
    chip_smoke.py holds the kernels against."""
    (q, k, v, do), opts = _option_inputs(case)
    tq, tk, tv, tdo = (torch.from_numpy(x).double() for x in (q, k, v, do))
    o, lse = flash_attention_fwd_reference(tq, tk, tv, **opts)
    assert o.dtype == lse.dtype == torch.float64
    grads = flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, **opts)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = attention_reference(*leaves, **opts)
    out.backward(tdo)
    torch.testing.assert_close(out.detach(), o, atol=1e-12, rtol=1e-12)
    for name, t, g in zip("qkv", leaves, grads):
        torch.testing.assert_close(g, t.grad, atol=1e-12, rtol=1e-12, msg=f"d{name}")
