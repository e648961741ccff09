"""deepspeed_tpu_torch block-sparse attention against the JAX package.

The same seeded numpy inputs go through ``deepspeed_tpu.ops.sparse_attention``
and the port's ``deepspeed_tpu_torch.ops.sparse_attention``: the five
sparsity configs' layouts (element for element), ``build_block_table`` on a
layout and on its transpose, the dense masked path with both padding-mask
modes, and the splash path. On the CPU the port's splash path runs K8's
plain versions; the JAX side runs the Pallas kernels in interpret mode, as
``tests/unit/ops/test_splash_fuzz.py`` does, at that file's cases and
tolerances (fp32: 3e-5 for the forward, 2e-4 for the gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu.ops.sparse_attention import build_block_table as jax_table
from deepspeed_tpu.ops.sparse_attention import sparse_attention as jax_sparse
from deepspeed_tpu.ops.sparse_attention import splash_flops as jax_flops
from deepspeed_tpu.ops.sparse_attention import splash_sparse_attention as jax_splash
from deepspeed_tpu.ops.sparse_attention.sparse_self_attention import \
    SparseSelfAttention as JSparseSelfAttention
from deepspeed_tpu_torch.ops.sparse_attention import (SparseSelfAttention,
                                                      build_block_table,
                                                      sparse_attention, splash_flops,
                                                      splash_sparse_attention)
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc
from deepspeed_tpu_torch.ops.sparse_attention.splash import (
    LSE_EMPTY, SplashTables, splash_attention_fwd)

# (config class name, kwargs): every config, with the options that change
# the layout (per-head layouts, unidirectional, horizontal global, random
# blocks, global spans)
LAYOUT_CASES = [
    ("DenseSparsityConfig", dict(num_heads=2, block=16)),
    ("FixedSparsityConfig", dict(num_heads=4, block=16)),
    ("FixedSparsityConfig", dict(num_heads=4, block=16, num_local_blocks=3,
                                 num_global_blocks=1, attention="unidirectional")),
    ("FixedSparsityConfig", dict(num_heads=4, block=16, different_layout_per_head=True,
                                 num_local_blocks=4, num_global_blocks=2,
                                 num_different_global_patterns=2)),
    ("FixedSparsityConfig", dict(num_heads=3, block=32, horizontal_global_attention=True,
                                 num_local_blocks=2, different_layout_per_head=True,
                                 num_different_global_patterns=2)),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=16)),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=16, different_layout_per_head=True,
                                   num_random_blocks=2, seed=7)),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=16, num_sliding_window_blocks=5,
                                   num_global_blocks=2, attention="unidirectional",
                                   seed=3)),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16)),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16,
                                        global_block_indices=[0, 5],
                                        global_block_end_indices=[2, 7])),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16, num_sliding_window_blocks=5,
                                        global_block_indices=[3],
                                        attention="unidirectional")),
    ("VariableSparsityConfig", dict(num_heads=2, block=16)),
    ("VariableSparsityConfig", dict(num_heads=3, block=16, num_random_blocks=2,
                                    local_window_blocks=[1, 2, 3],
                                    global_block_indices=[0, 4],
                                    global_block_end_indices=[1, 6], seed=5)),
    ("VariableSparsityConfig", dict(num_heads=3, block=16, num_random_blocks=1,
                                    different_layout_per_head=True,
                                    attention="unidirectional", seed=11)),
]


@pytest.mark.parametrize("seq", [128, 256])
@pytest.mark.parametrize("case", LAYOUT_CASES, ids=lambda c: c[0] + "-" + "-".join(
    f"{k}={v}" for k, v in c[1].items() if k not in ("block", )))
def test_layouts_match_jax(case, seq):
    name, kw = case
    got = getattr(tsc, name)(**kw).make_layout(seq)
    want = getattr(jsc, name)(**kw).make_layout(seq)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_layout_refuses_ragged_seq():
    with pytest.raises(ValueError):
        tsc.FixedSparsityConfig(num_heads=2, block=16).make_layout(100)


@pytest.mark.parametrize("case", LAYOUT_CASES[1:8:2], ids=lambda c: c[0])
def test_block_table_matches_jax(case):
    """The table and counts of the layout and of its transpose."""
    name, kw = case
    layout = getattr(tsc, name)(**kw).make_layout(256)
    for lay in (layout, layout.transpose(0, 2, 1)):
        (t, c), (jt, jc) = build_block_table(lay), jax_table(lay)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(c, jc)
        assert t.dtype == np.int32 and c.dtype == np.int32


def _qkv(seed, B, H, S, D, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(n)]


def _pad_masks(B, S, seed):
    """Padding masks of both modes: keep-masks (bool, and float 0/1) with a
    fully padded sequence, and an additive float mask (0 or -1e4, with
    moderate biases that bias rather than hide)."""
    rng = np.random.default_rng(seed)
    keep = rng.random((B, S)) > 0.3
    keep[1] = False  # every key of the second sequence padded: zero rows
    add = np.where(keep, 0.0, -1e4).astype(np.float32)
    add[0, :4] = -1.5
    return {"mul_bool": (keep, "mul"), "mul_float": (keep.astype(np.float32), "mul"),
            "add_float": (add, "add"), "add_bool": (keep, "add")}


@pytest.mark.parametrize("mask", [None, "mul_bool", "mul_float", "add_float", "add_bool"])
def test_dense_path_matches_jax(mask):
    B, H, S, D = 2, 2, 64, 16
    cfg = tsc.BigBirdSparsityConfig(num_heads=H, block=16, num_random_blocks=1)
    layout = cfg.make_layout(S)
    q, k, v = _qkv(0, B, H, S, D)
    kpm, mode = _pad_masks(B, S, 1)[mask] if mask else (None, "mul")
    got = sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)), layout, 16,
                           None if kpm is None else torch.from_numpy(kpm),
                           key_padding_mask_mode=mode)
    want = jax_sparse(*(jnp.asarray(x) for x in (q, k, v)), layout, 16,
                      None if kpm is None else jnp.asarray(kpm),
                      key_padding_mask_mode=mode, use_kernel=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    if mode == "mul" and mask:
        assert not got[1].any()  # fully padded: rows that see no key are 0


def test_sparse_self_attention_matches_jax():
    """The wrapper's default mode is the additive padding mask."""
    B, H, S, D = 2, 4, 64, 16
    kw = dict(num_heads=H, block=16, num_local_blocks=2)
    q, k, v = _qkv(2, B, H, S, D)
    kpm = _pad_masks(B, S, 3)["add_float"][0]
    got = SparseSelfAttention(tsc.FixedSparsityConfig(**kw))(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(kpm))
    want = JSparseSelfAttention(jsc.FixedSparsityConfig(**kw))(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(kpm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_dispatch_rule():
    """On the CPU the default is the dense path; use_kernel=True runs K8's
    plain versions (the same function); the kernel refuses a padding
    mask."""
    B, H, S, D = 1, 2, 64, 16
    layout = tsc.BSLongformerSparsityConfig(num_heads=H, block=16).make_layout(S)
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, B, H, S, D))
    dense = sparse_attention(q, k, v, layout, 16)
    kernel = sparse_attention(q, k, v, layout, 16, use_kernel=True)
    torch.testing.assert_close(kernel, dense, atol=3e-5, rtol=3e-5)
    with pytest.raises(ValueError, match="key_padding_mask"):
        sparse_attention(q, k, v, layout, 16, torch.ones(B, S), use_kernel=True)
    with pytest.raises(ValueError, match="not divisible"):
        splash_sparse_attention(q[:, :, :40], k[:, :, :40], v[:, :, :40], layout, 16)


# test_splash_fuzz.py's cases: every family x random geometry
CASES = []
_rng = np.random.default_rng(123)
for fam in ("fixed", "bigbird", "longformer", "variable"):
    for _ in range(3):
        CASES.append(dict(fam=fam, heads=int(_rng.choice([2, 4])),
                          block=int(_rng.choice([64, 128])),
                          blocks=int(_rng.choice([4, 6])),
                          seed=int(_rng.integers(0, 1000))))
GRAD_CASES = [c for i, c in enumerate(CASES) if i % 3 == 0]


def _config(mod, case):
    h, blk = case["heads"], case["block"]
    if case["fam"] == "fixed":
        return mod.FixedSparsityConfig(num_heads=h, block=blk, num_local_blocks=2,
                                       num_global_blocks=1)
    if case["fam"] == "bigbird":
        return mod.BigBirdSparsityConfig(num_heads=h, block=blk, num_random_blocks=1,
                                         num_sliding_window_blocks=3, num_global_blocks=1)
    if case["fam"] == "longformer":
        return mod.BSLongformerSparsityConfig(num_heads=h, block=blk,
                                              num_sliding_window_blocks=3,
                                              global_block_indices=[0])
    return mod.VariableSparsityConfig(num_heads=h, block=blk, num_random_blocks=1,
                                      local_window_blocks=[1, 2], global_block_indices=[0])


def _case_id(c):
    return f"{c['fam']}h{c['heads']}b{c['block']}n{c['blocks']}s{c['seed']}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_splash_forward_matches_jax_kernel(case):
    cfg = _config(tsc, case)
    S = case["block"] * case["blocks"]
    layout = cfg.make_layout(S)
    np.testing.assert_array_equal(layout, _config(jsc, case).make_layout(S))
    rng = np.random.default_rng(case["seed"])
    q, k, v = (rng.normal(size=(1, case["heads"], S, 32)).astype(np.float32)
               for _ in range(3))
    got = splash_sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)), layout,
                                  cfg.block)
    want = jax_splash(*(jnp.asarray(x) for x in (q, k, v)), layout, cfg.block,
                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("case", GRAD_CASES, ids=_case_id)
def test_splash_vjp_matches_jax_kernel(case):
    """The port's autograd (the dq and dk/dv passes' plain versions) against
    the JAX custom_vjp (the Pallas dq and dk/dv kernels)."""
    cfg = _config(tsc, case)
    S = case["block"] * case["blocks"]
    layout = cfg.make_layout(S)
    rng = np.random.default_rng(case["seed"] + 1)
    q, k, v = (rng.normal(size=(1, case["heads"], S, 16)).astype(np.float32)
               for _ in range(3))
    g = rng.normal(size=q.shape).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = splash_sparse_attention(*leaves, layout, cfg.block)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda q, k, v: jax_splash(q, k, v, layout, cfg.block,
                                                interpret=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, rtol=2e-4,
                                   err_msg=name)


def test_splash_empty_rows():
    """test_splash_backward_empty_rows_zero_grads's layout: q-block 0 sees
    nothing, k-blocks 2 and 3 are seen by nobody. o = 0 and lse = +1e30
    there, and the gradients are exactly 0, not NaN."""
    block, nb, H = 64, 4, 2
    S = block * nb
    layout = np.zeros((H, nb, nb), np.bool_)
    layout[:, 1:, :2] = True
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, H, S, 16)).astype(np.float32))
               for _ in range(3))
    o, lse = splash_attention_fwd(q, k, v, SplashTables.build(layout, block, "cpu"))
    assert not o[:, :, :block].any()
    assert (lse[:, :, :block] == LSE_EMPTY).all()
    assert torch.isfinite(lse[:, :, block:]).all() and (lse[:, :, block:] < 100).all()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = splash_sparse_attention(*leaves, layout, block)
    dq, dk, dv = torch.autograd.grad(out, leaves, torch.ones_like(q))
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all()
    assert not dq[:, :, :block].any()
    assert not dk[:, :, 2 * block:].any() and not dv[:, :, 2 * block:].any()
    _, vjp = jax.vjp(lambda q, k, v: jax_splash(q, k, v, layout, block, interpret=True),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    for a, b in zip((dq, dk, dv), vjp(jnp.ones(q.shape, jnp.float32))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, rtol=2e-4)


def test_splash_broadcast_layout_and_bf16():
    """A one-head layout over 4 heads and bf16 inputs, against the dense
    path (P rounds to bf16 in both): within a few bf16 roundings."""
    B, H, S, D = 2, 4, 128, 32
    layout = tsc.FixedSparsityConfig(num_heads=1, block=16).make_layout(S)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(5, B, H, S, D))
    got = splash_sparse_attention(q, k, v, layout, 16)
    want = sparse_attention(q, k, v, layout, 16, use_kernel=False)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("fam", ["fixed", "bigbird", "longformer"])
def test_splash_flops_matches_jax(fam):
    case = dict(fam=fam, heads=4, block=16, blocks=16, seed=0)
    layout = _config(tsc, case).make_layout(256)
    assert splash_flops(layout, 16, 64, batch=4) == jax_flops(layout, 16, 64, batch=4)
