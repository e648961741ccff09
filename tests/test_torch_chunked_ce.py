"""deepspeed_tpu_torch chunked unembed + CE against the JAX package's
``ops/chunked_ce.py`` (its ``custom_vjp`` forward and backward sweeps), on
the same seeded numpy inputs, in fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import chunked_ce as jax_ce
from deepspeed_tpu_torch.ops.chunked_ce import (chunked_cross_entropy_loss,
                                                chunked_unembed_ce)

# (T, H, V, chunk): V = 250 is not a multiple of 64, so the last chunk is
# ragged; V = 256 splits into whole chunks; one chunk wider than V
CASES = {
    "plain": (24, 16, 250, 64),
    "whole_chunks": (24, 16, 256, 64),
    "one_chunk": (10, 8, 250, 512),
}
# fp32 on both sides: the sums over the 250-column vocab and 24 tokens run
# in another order
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(case):
    T, H, V, chunk = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    x = rng.normal(size=(T, H)).astype(np.float32)
    w = (0.5 * rng.normal(size=(H, V))).astype(np.float32)
    tg = rng.integers(0, V, size=(T, )).astype(np.int32)
    g = rng.normal(size=(T, )).astype(np.float32)
    return x, w, tg, g, chunk


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_unembed_ce_matches_jax(case):
    x, w, tg, g, chunk = _inputs(case)
    nll_ref, vjp = jax.vjp(
        lambda a, b: jax_ce.chunked_unembed_ce(a, b, None, jnp.asarray(tg), chunk,
                                               compute_dtype=jnp.float32),
        jnp.asarray(x), jnp.asarray(w))
    grads_ref = vjp(jnp.asarray(g))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w)]
    nll = chunked_unembed_ce(*leaves, torch.from_numpy(tg), chunk, torch.float32)
    nll.backward(torch.from_numpy(g))
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(nll_ref), **TOL)
    for name, t, gr in zip(("dx", "dw"), leaves, grads_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gr), err_msg=name, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_unembed_ce_softcap_matches_jax(case):
    """Gemma-2's final logit softcap in both sweeps: nll, dx and dw against
    the JAX op with ``softcap``; the cap of 3 bites on these logits (|l|
    up to ~10), so without it the nll moves."""
    x, w, tg, g, chunk = _inputs(case)
    nll_ref, vjp = jax.vjp(
        lambda a, b: jax_ce.chunked_unembed_ce(a, b, None, jnp.asarray(tg), chunk,
                                               softcap=3.0, compute_dtype=jnp.float32),
        jnp.asarray(x), jnp.asarray(w))
    grads_ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w)]
    nll = chunked_unembed_ce(*leaves, torch.from_numpy(tg), chunk, torch.float32,
                             softcap=3.0)
    nll.backward(torch.from_numpy(g))
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(nll_ref), **TOL)
    for name, t, gr in zip(("dx", "dw"), leaves, grads_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gr), err_msg=name, **TOL)
    plain = chunked_unembed_ce(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(tg), chunk, torch.float32)
    assert (plain - nll.detach()).abs().max().item() > 0.1
    with pytest.raises(ValueError, match="softcap"):
        chunked_unembed_ce(*leaves, torch.from_numpy(tg), chunk, torch.float32, softcap=0.0)


def test_chunked_loss_shifts_and_ignores_like_jax():
    rng = np.random.default_rng(5)
    B, S, H, V = 2, 9, 8, 70
    x = rng.normal(size=(B, S, H)).astype(np.float32)
    w = rng.normal(size=(H, V)).astype(np.float32)
    labels = rng.integers(0, V, size=(B, S)).astype(np.int32)
    labels[0, 3] = labels[1, 7] = -100
    ref, (gx_ref, gw_ref) = jax.value_and_grad(
        lambda a, b: jax_ce.chunked_cross_entropy_loss(
            a, b, None, jnp.asarray(labels), 32, compute_dtype=jnp.float32),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = chunked_cross_entropy_loss(tx, tw, torch.from_numpy(labels).long(), 32,
                                      compute_dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_ref), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw_ref), **TOL)
