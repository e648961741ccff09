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
from deepspeed_tpu_torch.ops.sparse_attention import splash as sp
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


# ---- the plan of K8's grouped forward and dk/dv sweeps ----

def _smoke_layouts():
    """chip_smoke.py's geometry (S 4096, block 16, H 16) under each family's
    default config, layouts only."""
    configs = {"fixed": tsc.FixedSparsityConfig, "bigbird": tsc.BigBirdSparsityConfig,
               "longformer": tsc.BSLongformerSparsityConfig,
               "variable": tsc.VariableSparsityConfig}
    return {fam: cfg(num_heads=16, block=16).make_layout(4096) for fam, cfg in configs.items()}


def _coverage(plan, block, nb):
    """How often the plan sweeps each (layout head, 16-row slice of a block
    row, block) of its layout: [heads, nb * block / 16, nb]."""
    warp_rows, members = sp.WARP_ROWS, max(1, sp.GROUP_ROWS // block)
    warps = sp.GROUP_ROWS // warp_rows
    seen = np.zeros((plan.heads, nb * block // warp_rows, nb), np.int64)
    for h, e0, e1, _, *wrows in plan.items:
        ent = plan.entries[e0:e1]
        blocks, masks = ent & ((1 << sp.MASK_SHIFT) - 1), ent >> sp.MASK_SHIFT
        for w, row in enumerate(wrows):
            if row < 0:
                continue
            held = blocks[(masks >> (w * members // warps)) & 1 == 1]
            np.add.at(seen[h, row // warp_rows], held, 1)
    return seen


def _check_plan(layout, block, limit=None):
    """The forward's and dk/dv's plans of ``layout``, each checked."""
    lay = np.asarray(layout).astype(bool)
    nb = lay.shape[1]
    plans = []
    for sweep in (lay, lay.transpose(0, 2, 1)):
        plan = sp.plan_splash(sweep, block, limit)
        want = sweep[:plan.heads].repeat(block // sp.WARP_ROWS, axis=1)
        if plan.heads == 1:
            assert all((sweep[h] == sweep[0]).all() for h in range(len(sweep)))
        # every active (row, block) pair exactly once, nothing else
        np.testing.assert_array_equal(_coverage(plan, block, nb), want)
        lengths = plan.items[:, 2] - plan.items[:, 1]
        assert lengths.max() <= plan.limit
        cost = sp.sweep_stages(lengths, block)
        assert (np.diff(cost) <= 0).all(), "the longest items come first"
        # the segments of each split group: consecutive slots that tile its union
        for h, p0, nseg, _, *wrows in plan.merges:
            segs = plan.items[(plan.items[:, 3] >= p0) & (plan.items[:, 3] < p0 + nseg)]
            segs = segs[np.argsort(segs[:, 3])]
            assert len(segs) == nseg >= 2 and (segs[:, 0] == h).all()
            assert (segs[:, 4:] == wrows).all()
            assert (segs[1:, 1] == segs[:-1, 2]).all()
        assert plan.n_parts == int(plan.merges[:, 2].sum())
        assert plan.stats["segments"] == plan.n_parts
        plans.append(plan)
    return plans


@pytest.mark.parametrize("fam", ["fixed", "bigbird", "longformer", "variable"])
def test_plan_covers_the_smoke_layouts(fam):
    """At chip_smoke.py's geometry each active (row, block) pair of each
    pass is swept exactly once, no segment passes the limit, and the
    longest work items come first."""
    _check_plan(_smoke_layouts()[fam], 16)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plan_covers_the_fuzz_layouts(case):
    layout = _config(tsc, case).make_layout(case["block"] * case["blocks"])
    _check_plan(layout, case["block"])
    _check_plan(layout, case["block"], limit=1)  # every union cut to single blocks


def test_plan_groups_share_blocks():
    """Fixed's forward groups are its local windows (four identical rows:
    union/sum 0.25); its transposed global columns nest, and grouping them
    widest first sweeps fewer stages than grouping neighbours; BigBird's and
    Longformer's global rows are split over several thread blocks."""
    lay = _smoke_layouts()
    fwd = sp.plan_splash(lay["fixed"], 16)
    assert fwd.stats["union_share"] == 0.25 and fwd.heads == 1
    t = sp.plan_splash(lay["fixed"].transpose(0, 2, 1), 16)
    neighbours = np.asarray(lay["fixed"][0].T, bool).reshape(-1, 4, 256).any(1).sum(1)
    assert t.stats["stages"] < sp.sweep_stages(neighbours, 16).sum()
    assert t.stats["union_share"] < 0.3
    for fam in ("bigbird", "longformer"):
        plan = sp.plan_splash(lay[fam], 16)
        assert plan.stats["split_groups"] == 1 and plan.stats["segments"] >= 2
        assert plan.stats["widest_segment"] < 256


def _emulate_fwd(q, k, v, layout, block, plan, scale):
    """The planned forward sweep as the kernel runs it: each item's warps
    step through its stages of 64 keys, a running max, sum and accumulator
    updated once a stage over the 16-key chunks its member holds; a split
    group's segments merged in segment order. q, k, v: [BH, S, D] fp32."""
    BH, S, D = q.shape
    reps, (eps, spe) = BH // plan.heads, (sp.entries_per_stage(block),
                                          sp.stages_per_entry(block))
    members, mask = max(1, sp.GROUP_ROWS // block), (1 << sp.MASK_SHIFT) - 1
    rows_, warps = sp.GROUP_ROWS, sp.GROUP_ROWS // sp.WARP_ROWS
    o, lse = torch.full_like(q, float("nan")), torch.full((BH, S), float("nan"))
    parts = {}
    for h, e0, e1, part, *wrows in plan.items:
        for rep in range(reps):
            bh = rep * plan.heads + h
            m = torch.full((rows_, ), -float("inf"))
            l, acc = torch.zeros(rows_), torch.zeros(rows_, D)
            for t in range(int(sp.sweep_stages(e1 - e0, block))):
                for w, row in enumerate(wrows):
                    keys = []
                    for c in range(4):
                        e = e0 + t * eps + c * 16 // block if block <= 64 else e0 + t // spe
                        off = c * 16 % block if block <= 64 else t % spe * 64 + c * 16
                        if row >= 0 and e < e1 and (plan.entries[e] >> sp.MASK_SHIFT
                                                    >> (w * members // warps)) & 1:
                            keys.append((plan.entries[e] & mask) * block + off
                                        + torch.arange(16))
                    if not keys:
                        continue
                    r = slice(16 * w, 16 * w + 16)
                    s = q[bh, row:row + 16] @ k[bh, torch.cat(keys)].T * scale
                    m_new = torch.maximum(m[r], s.amax(1))
                    p, corr = torch.exp(s - m_new[:, None]), torch.exp(m[r] - m_new)
                    l[r] = l[r] * corr + p.sum(1)
                    acc[r] = acc[r] * corr[:, None] + p @ v[bh, torch.cat(keys)]
                    m[r] = m_new
            if part >= 0:
                parts[rep, part] = (m, l, acc)
                continue
            for w, row in enumerate(wrows):
                if row >= 0:
                    r = slice(16 * w, 16 * w + 16)
                    o[bh, row:row + 16] = torch.where(l[r, None] > 0, acc[r] / l[r, None], 0.0)
                    lse[bh, row:row + 16] = torch.where(l[r] > 0, m[r] + torch.log(l[r]),
                                                        sp.LSE_EMPTY)
    for h, p0, nseg, _, *wrows in plan.merges:
        for rep in range(reps):
            bh = rep * plan.heads + h
            ms, ls, accs = (torch.stack(x) for x in zip(*(parts[rep, p0 + i]
                                                          for i in range(nseg))))
            top = torch.where(ls > 0, ms, -float("inf")).amax(0)
            f = torch.where(ls > 0, torch.exp(ms - top), 0.0)
            L, acc = (ls * f).sum(0), (accs * f[..., None]).sum(0)
            for w, row in enumerate(wrows):
                if row >= 0:
                    r = slice(16 * w, 16 * w + 16)
                    o[bh, row:row + 16] = torch.where(L[r, None] > 0, acc[r] / L[r, None], 0.0)
                    lse[bh, row:row + 16] = torch.where(L[r] > 0, top[r] + torch.log(L[r]),
                                                        sp.LSE_EMPTY)
    return o, lse, _stack(parts, reps, plan.n_parts)


def _stack(parts, reps, n_parts):
    """The emulation's partials as the kernels' workspace tensors
    ``[replicas, slots, 64, ...]``, one for each partial of a slot."""
    return [torch.stack([torch.stack([parts[rep, p][i].reshape(sp.GROUP_ROWS, -1)
                                      for p in range(n_parts)])
                         for rep in range(reps)]) for i in range(len(parts[0, 0]))]


def _emulate_dkdv(q, k, v, do, lse, delta, block, plan, scale):
    """The planned dk/dv sweep over the transposed layout: each warp's 16
    keys accumulate dv += P^T dO and dk += dS^T q over the 16-row chunks of
    query rows its member holds; a split group's fp32 partials summed in
    segment order."""
    BH, S, D = q.shape
    reps, (eps, spe) = BH // plan.heads, (sp.entries_per_stage(block),
                                          sp.stages_per_entry(block))
    members, mask = max(1, sp.GROUP_ROWS // block), (1 << sp.MASK_SHIFT) - 1
    rows_, warps = sp.GROUP_ROWS, sp.GROUP_ROWS // sp.WARP_ROWS
    dk, dv = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    parts = {}
    for h, e0, e1, part, *wrows in plan.items:
        for rep in range(reps):
            bh = rep * plan.heads + h
            gk, gv = torch.zeros(rows_, D), torch.zeros(rows_, D)
            for t in range(int(sp.sweep_stages(e1 - e0, block))):
                for w, row in enumerate(wrows):
                    for c in range(4):
                        e = e0 + t * eps + c * 16 // block if block <= 64 else e0 + t // spe
                        off = c * 16 % block if block <= 64 else t % spe * 64 + c * 16
                        if row < 0 or e >= e1 or not (plan.entries[e] >> sp.MASK_SHIFT
                                                      >> (w * members // warps)) & 1:
                            continue
                        rows = (plan.entries[e] & mask) * block + off + torch.arange(16)
                        kr, r = slice(row, row + 16), slice(16 * w, 16 * w + 16)
                        pt = torch.exp(k[bh, kr] @ q[bh, rows].T * scale - lse[bh, rows])
                        gv[r] += pt @ do[bh, rows]
                        dst = pt * (v[bh, kr] @ do[bh, rows].T - delta[bh, rows]) * scale
                        gk[r] += dst @ q[bh, rows]
            if part >= 0:
                parts[rep, part] = (gk, gv)
                continue
            for w, row in enumerate(wrows):
                if row >= 0:
                    dk[bh, row:row + 16] = gk[16 * w:16 * w + 16]
                    dv[bh, row:row + 16] = gv[16 * w:16 * w + 16]
    for h, p0, nseg, _, *wrows in plan.merges:
        for rep in range(reps):
            bh = rep * plan.heads + h
            gk, gv = torch.zeros(rows_, D), torch.zeros(rows_, D)
            for i in range(nseg):  # in segment order
                gk, gv = gk + parts[rep, p0 + i][0], gv + parts[rep, p0 + i][1]
            for w, row in enumerate(wrows):
                if row >= 0:
                    dk[bh, row:row + 16] = gk[16 * w:16 * w + 16]
                    dv[bh, row:row + 16] = gv[16 * w:16 * w + 16]
    return dk, dv, _stack(parts, reps, plan.n_parts)


def _emulate_dq(q, k, v, do, lse, delta, block, plan, scale):
    """The planned dq sweep over the forward's plan: each warp's 16 query
    rows accumulate dq += dS k over the 16-key chunks its member holds, P
    rebuilt from lse; a split group's fp32 partials summed in segment
    order."""
    BH, S, D = q.shape
    reps, (eps, spe) = BH // plan.heads, (sp.entries_per_stage(block),
                                          sp.stages_per_entry(block))
    members, mask = max(1, sp.GROUP_ROWS // block), (1 << sp.MASK_SHIFT) - 1
    rows_, warps = sp.GROUP_ROWS, sp.GROUP_ROWS // sp.WARP_ROWS
    dq = torch.full_like(q, float("nan"))
    parts = {}
    for h, e0, e1, part, *wrows in plan.items:
        for rep in range(reps):
            bh = rep * plan.heads + h
            gq = torch.zeros(rows_, D)
            for t in range(int(sp.sweep_stages(e1 - e0, block))):
                for w, row in enumerate(wrows):
                    for c in range(4):
                        e = e0 + t * eps + c * 16 // block if block <= 64 else e0 + t // spe
                        off = c * 16 % block if block <= 64 else t % spe * 64 + c * 16
                        if row < 0 or e >= e1 or not (plan.entries[e] >> sp.MASK_SHIFT
                                                      >> (w * members // warps)) & 1:
                            continue
                        keys = (plan.entries[e] & mask) * block + off + torch.arange(16)
                        qr, r = slice(row, row + 16), slice(16 * w, 16 * w + 16)
                        p = torch.exp(q[bh, qr] @ k[bh, keys].T * scale - lse[bh, qr, None])
                        ds = p * (do[bh, qr] @ v[bh, keys].T - delta[bh, qr, None]) * scale
                        gq[r] += ds @ k[bh, keys]
            if part >= 0:
                parts[rep, part] = (gq, )
                continue
            for w, row in enumerate(wrows):
                if row >= 0:
                    dq[bh, row:row + 16] = gq[16 * w:16 * w + 16]
    for h, p0, nseg, _, *wrows in plan.merges:
        for rep in range(reps):
            bh = rep * plan.heads + h
            gq = torch.zeros(rows_, D)
            for i in range(nseg):  # in segment order
                gq = gq + parts[rep, p0 + i][0]
            for w, row in enumerate(wrows):
                if row >= 0:
                    dq[bh, row:row + 16] = gq[16 * w:16 * w + 16]
    return dq, _stack(parts, reps, plan.n_parts)


@pytest.mark.parametrize("block,per_head", [(16, False), (16, True), (32, True), (64, False),
                                            (128, False)])
def test_planned_sweep_matches_plain(block, per_head):
    """The CPU emulation of the planned forward, dq and dk/dv sweeps, with
    a limit that splits rows over several segments, a q-block that sees
    nothing and a k-block that no q-block sees, equals K8's dense plain
    versions within 2e-5 (fp32: only the order of the sums differs)."""
    B, H, D = 2, 2, 16
    nb = 10 if block <= 32 else 4
    S = nb * block
    rng = np.random.default_rng(block)
    layout = rng.random((H if per_head else 1, nb, nb)) < 0.45
    layout[:, 0, :] = True  # a global row: split by the limit
    layout[:, :, 1] = True  # a global column: split in dk/dv
    layout[:, 2, :] = False  # sees nothing
    layout[:, :, 3] = False  # seen by nobody
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(block, B, H, S, D, n=4))
    scale = 0.3
    o_ref, lse_ref = sp.splash_attention_fwd_reference(q, k, v, layout, block, scale)
    delta = (do * o_ref).sum(-1)
    dq_ref = sp.splash_attention_bwd_dq_reference(q, k, v, do, lse_ref, delta, layout, block,
                                                  scale)
    dk_ref, dv_ref = sp.splash_attention_bwd_dkdv_reference(q, k, v, do, lse_ref, delta,
                                                            layout, block, scale)
    plan, plan_t = _check_plan(layout, block, limit=2 if block <= 32 else 1)
    assert plan.n_parts and plan_t.n_parts
    flat = [x.reshape(B * H, S, D) for x in (q, k, v, do)]
    stats = (lse_ref.reshape(B * H, S), delta.reshape(B * H, S))
    o, lse, (m, l, acc) = _emulate_fwd(*flat[:3], layout, block, plan, scale)
    dq, (pq, ) = _emulate_dq(*flat, *stats, block, plan, scale)
    dk, dv, (pk, pv) = _emulate_dkdv(*flat, *stats, block, plan_t, scale)
    for got, want in ((o, o_ref), (lse, lse_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        torch.testing.assert_close(got.reshape(want.shape), want, atol=2e-5, rtol=2e-5)
    # the second passes' plain versions over the same partials write the
    # split rows as the emulation merged or summed them
    o2, lse2 = torch.full((B, H, S, D), float("nan")), torch.full((B, H, S), float("nan"))
    sp.splash_fwd_merge(o2, lse2, plan, acc, torch.stack([m, l], -1)[..., 0, :])
    split = ~torch.isnan(lse2)
    assert split.any()
    torch.testing.assert_close(o2[split], o.reshape(B, H, S, D)[split], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse2[split], lse.reshape(B, H, S)[split], atol=1e-6, rtol=1e-6)
    dq2 = torch.full((B, H, S, D), float("nan"))
    sp.splash_dq_sum(dq2, plan, pq)
    split = ~torch.isnan(dq2)
    assert split.any()
    torch.testing.assert_close(dq2[split], dq.reshape(B, H, S, D)[split], atol=0, rtol=0)
    dk2, dv2 = torch.full((B, H, S, D), float("nan")), torch.full((B, H, S, D), float("nan"))
    sp.splash_dkdv_sum(dk2, dv2, plan_t, pk, pv)
    split = ~torch.isnan(dk2)
    assert split.any()
    torch.testing.assert_close(dk2[split], dk.reshape(B, H, S, D)[split], atol=0, rtol=0)
    torch.testing.assert_close(dv2[split], dv.reshape(B, H, S, D)[split], atol=0, rtol=0)
    assert not o.reshape(B, H, S, D)[:, :, 2 * block:3 * block].any()
    assert (lse.reshape(B, H, S)[:, :, 2 * block:3 * block] == sp.LSE_EMPTY).all()
    assert not dq.reshape(B, H, S, D)[:, :, 2 * block:3 * block].any()
    assert not dk.reshape(B, H, S, D)[:, :, 3 * block:4 * block].any()
