"""deepspeed_tpu_torch K3 (the folded flash layout) and the attention
route against the JAX package, on the same seeded numpy inputs, in fp32
on the CPU: K3's plain versions against ``flash_fwd_folded`` /
``flash_bwd_folded`` in interpret mode (the masks of
``tests/unit/ops/test_flash_folded.py``), and every (forward, backward)
pin of {xla, pallas, folded} through ``flash_attention`` against the JAX
route with the same pins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import attention_folded as jax_folded
from deepspeed_tpu.ops.attention import flash_attention as jax_flash_attention
from deepspeed_tpu_torch.ops import attention as fa
from deepspeed_tpu_torch.ops import attention_folded as ff

# (B, S, H, KV, D, causal, window, softcap): causal GQA, MHA, no causal
# mask, a window smaller than a 64-row block and not a multiple of it, a
# softcap, both; the JAX kernels run 64 x 64 blocks, so every case has
# several blocks on each axis
CASES = {
    "causal_gqa": (2, 128, 8, 2, 32, True, None, None),
    "mha": (1, 128, 4, 4, 64, True, None, None),
    "noncausal": (2, 128, 4, 2, 32, False, None, None),
    "window_48": (1, 192, 4, 2, 32, True, 48, None),
    "softcap": (1, 128, 4, 1, 32, True, None, 20.0),
    "window_softcap": (2, 128, 8, 4, 16, True, 64, 50.0),
    "noncausal_window_softcap": (1, 192, 4, 2, 32, False, 100, 20.0),
}
BLOCK = 64
# fp32 on both sides; they differ in summation order only (online softmax
# over 64-key blocks against one softmax over the row): softmax-weighted
# means of N(0, 1) values (|o| < 3), gradients of an N(0, 1) cotangent
# (|g| < 10), lse of ~5
O_TOL = dict(atol=2e-5, rtol=2e-5)
LSE_TOL = dict(atol=2e-5, rtol=2e-6)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)


def _inputs(case):
    B, S, H, KV, D, causal, window, softcap = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in (
        (B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    return (q, k, v, do), dict(causal=causal, window=window, softcap=softcap)


def _rows_that_see_a_key(S, causal, window):
    """[S] bool: query rows with at least one visible key. The reference's
    two flash layouts mark the others differently (``attention.py:42``
    +1e30, ``attention_folded.py:41`` -1e30); the port writes +1e30 from
    both kernels, so lse is held only on rows that see a key."""
    pos = np.arange(S)
    visible = np.ones((S, S), bool)
    if causal:
        visible &= pos[None, :] <= pos[:, None]
    if window is not None:
        visible &= pos[:, None] - pos[None, :] < window
    return visible.any(1)


def test_marker_of_rows_that_see_no_key():
    assert fa.LSE_MASKED == 1e30 and jax_folded.LSE_MASKED == -1e30


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_folded_matches_pallas_folded(case):
    (q, k, v, do), opts = _inputs(case)
    B, S, H, D = q.shape
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o_ref, lse_ref = jax_folded.flash_fwd_folded(
        jq, jk, jv, scale, opts["causal"], BLOCK, BLOCK, True, opts["window"],
        opts["softcap"])
    grads_ref = jax_folded.flash_bwd_folded(
        jq, jk, jv, lse_ref, o_ref, jdo, scale, opts["causal"], BLOCK, BLOCK, True,
        opts["window"], opts["softcap"])

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ff.flash_fwd_folded(tq, tk, tv, scale, opts["causal"], BLOCK, BLOCK,
                                 opts["window"], opts["softcap"])
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **O_TOL)
    rows = _rows_that_see_a_key(S, opts["causal"], opts["window"])
    np.testing.assert_allclose(lse.numpy()[:, rows],
                               np.asarray(lse_ref)[..., 0][:, rows], **LSE_TOL)
    grads = ff.flash_bwd_folded(tq, tk, tv, lse, o, tdo, scale, opts["causal"],
                                BLOCK, BLOCK, opts["window"], opts["softcap"])
    for name, g, g_ref in zip("qkv", grads, grads_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), err_msg=f"d{name}",
                                   **GRAD_TOL)


IMPLS = ("xla", "pallas", "folded")
ROUTE_MASKS = {"causal": dict(causal=True, window=None, softcap=None),
               "window_softcap": dict(causal=True, window=48, softcap=20.0)}


@pytest.mark.parametrize("fwd", IMPLS)
@pytest.mark.parametrize("bwd", IMPLS)
@pytest.mark.parametrize("mask", sorted(ROUTE_MASKS))
def test_route_parity(fwd, bwd, mask):
    """Each pin of the two legs gives the JAX route's o and gradients: the
    mixed routes cross lse between K1 and K3 and the xla legs."""
    opts = ROUTE_MASKS[mask]
    rng = np.random.default_rng(IMPLS.index(fwd) * 3 + IMPLS.index(bwd))
    q, k, v, do = (rng.normal(size=(2, 128, n, 32)).astype(np.float32)
                   for n in (8, 2, 2, 8))

    def jax_route(a, b, c):
        return jax_flash_attention(a, b, c, interpret=True, block_q=BLOCK,
                                   block_k=BLOCK, impl_fwd=fwd, impl_bwd=bwd, **opts)

    o_ref, vjp = jax.vjp(jax_route, *map(jnp.asarray, (q, k, v)))
    grads_ref = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, impl_fwd=fwd, impl_bwd=bwd, **opts)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o_ref), **O_TOL)
    for name, t, g_ref in zip("qkv", leaves, grads_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_ref),
                                   err_msg=f"d{name}", **GRAD_TOL)


def test_route_runs_the_legs_it_resolved(monkeypatch):
    """On a CPU tensor the kernel legs run their plain versions and count
    no launch; the env pins pick which."""
    monkeypatch.setenv("DS_TPU_ATTN_FWD", "folded")
    monkeypatch.setenv("DS_TPU_ATTN_BWD", "pallas")
    calls = []
    for mod, name in ((ff, "folded_attention_fwd_reference"),
                      (fa, "flash_attention_bwd_dq_reference"),
                      (fa, "flash_attention_bwd_dkdv_reference"),
                      (fa, "attention_reference")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.append(_n), _fn(*a, **kw))[1])
    (q, k, v, do), opts = _inputs("causal_gqa")
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    launches = [f.launches for f in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                                     fa.flash_attention_bwd_dkdv, ff.folded_attention_fwd,
                                     ff.folded_attention_bwd_dq,
                                     ff.folded_attention_bwd_dkdv)]
    fa.flash_attention(*leaves, **opts).backward(torch.from_numpy(do))
    assert calls == ["folded_attention_fwd_reference", "flash_attention_bwd_dq_reference",
                     "flash_attention_bwd_dkdv_reference"]
    assert launches == [f.launches for f in (
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv,
        ff.folded_attention_fwd, ff.folded_attention_bwd_dq, ff.folded_attention_bwd_dkdv)]


def test_force_pallas_false_runs_the_plain_attention():
    (q, k, v, _), opts = _inputs("window_48")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    torch.testing.assert_close(
        fa.flash_attention(tq, tk, tv, force_pallas=False, **opts),
        fa.attention_reference(tq, tk, tv, **opts), atol=0, rtol=0)
