"""Splash block-sparse attention, forward and backward (port of
``deepspeed_tpu/ops/sparse_attention/splash.py``: ``build_block_table`` :44,
the forward ``_splash_kernel`` :63 driven by ``_splash_fwd`` :117, the
backward ``_splash_dq_kernel`` :165 and ``_splash_dkv_kernel`` :201 driven
by ``_splash_bwd`` :242, ``_cached_splash_fn`` :318,
``splash_sparse_attention`` :346 and ``splash_flops`` :368).

q, k and v are ``[B, H, S, D]`` (head-major); the static layout is
``[H or 1, nb, nb]`` with ``nb = S // block``, and row ``bh = b * H + h``
reads layout head ``bh % layout_heads`` (the JAX kernel's
``jax.lax.rem(bh, nheads_layout)``). ``build_block_table`` compacts the
layout into the indices of each row's active k-blocks and their count (the
JAX package's dq table, kept as its port).

The kernels sweep a host plan instead (``plan_splash``, built once per
layout with the tables): the block rows of the forward's layout (q-blocks,
for the forward and dq) or of its transpose (k-blocks, for dk/dv) are cut
into groups of 64 rows (4 blocks of 16, 2 of 32, 1 of 64; a 128 block is
two groups that read one row), rows that share blocks together: the block
rows in order or sorted widest first, whichever needs fewer stages. A
group sweeps the sorted union of its members' blocks, 64 keys (forward,
dq) or query rows (dk/dv) a stage, each staged once for the group; a mask
per entry says which members hold it, and a warp skips the 16-row chunks
its member lacks. A union longer than the plan's limit is cut into
segments, each a thread block of its own that writes fp32 partials; a
second pass merges the forward's partials (max, sum, accumulator) or sums
dq's or dk/dv's in segment order, so the outputs are deterministic. Work
items run longest first.

Kernels (bodies in ``csrc/splash_grouped.cuh``, the note on the function
in ``csrc/splash_attention.cuh``; built from
``splash_attention{,_f16,_f32}.cu``, ``splash_attention_bwd_dq{,_f16,_f32}.cu``
and ``splash_attention_bwd_dkdv{,_f16,_f32}.cu`` in parallel), each with its
plain version here and a launch count:

- ``splash_attention_fwd`` (K8 forward): ``o`` in q's dtype and ``lse``
  ``[B, H, S]`` fp32; a row with no active block gets o = 0 and lse =
  ``LSE_EMPTY`` (+1e30), so the backward's ``exp(s - lse)`` is exactly 0;
  ``splash_fwd_merge`` merges the rows of split groups;
- ``splash_attention_bwd_dq``: dq over the forward's plan, P rebuilt from
  lse, dS rounded to k's dtype before ``dS k``; ``splash_dq_sum`` sums the
  partials of split groups and rounds them once;
- ``splash_attention_bwd_dkdv``: dk and dv over the transposed layout's
  plan, P rounded to dO's dtype and dS to q's dtype; ``splash_dkdv_sum``
  sums the partials of split groups and rounds them once.

Each wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA tensor or raises. ``delta = rowsum(dO * O)`` stays
PyTorch, as it is an XLA pass outside the Pallas kernels in the JAX
package. The plain versions compute the same function densely under the
layout's mask, in fp32 (fp64 for fp64 inputs: the exact value), in chunks
of ``(batch, head)`` rows.

``splash_sparse_attention`` is one ``torch.autograd.Function`` over the
three; its plans live on the device in a cache keyed like
``_cached_splash_fn`` (layout bytes, shape, block, scale, device), so a
call never rebuilds them in a host loop.
"""

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..attention import _wide, attention_delta

NEG_INF = -1e30
LSE_EMPTY = -NEG_INF  # lse of a row with no active block: exp(s - lse) == 0

# block sizes the kernels are built for (the JAX package's tests use all four;
# 16 is the reference's default)
KERNEL_BLOCKS = (16, 32, 64, 128)

# the plain versions score at most this many (row, query, key) triples at a
# time: 1 GiB of fp32 per score-shaped temporary
CHUNK_PAIRS = 1 << 28


def build_block_table(layout: np.ndarray):
    """[H, nb, nb] 0/1 layout -> (table [H, nb, A] int32, counts [H, nb]
    int32).

    A = widest active row; padding entries point at block 0 and are skipped
    via the counts. The JAX package's dq table (``splash.py:44``); the
    port's kernels sweep ``plan_splash``'s plans instead.
    """
    layout = np.asarray(layout).astype(bool)
    H, nb, nb2 = layout.shape
    assert nb == nb2, layout.shape
    counts = layout.sum(-1).astype(np.int32)
    A = max(int(counts.max()), 1)
    table = np.zeros((H, nb, A), dtype=np.int32)
    for h in range(H):
        for qb in range(nb):
            idx = np.nonzero(layout[h, qb])[0]
            table[h, qb, :len(idx)] = idx
    return table, counts


# The sweep of the kernels (csrc/splash_grouped.cuh): a work item is 64 rows
# (queries, or keys for dk/dv), a warp's 16 each, and a stage of its sweep
# is 64 keys (or query rows) of its union's blocks
WARP_ROWS = 16
GROUP_ROWS = 64
STAGE_ROWS = 64
# an item or merge row: head, first entry or slot, end or count, slot, and
# each warp's first row
ITEM_INTS = 4 + GROUP_ROWS // WARP_ROWS
MASK_SHIFT = 23  # an entry: block index | members' mask << MASK_SHIFT
# the default segment limit: a segment takes at most 1 / SEGMENT_SHARE of
# the plan's stages, and at least MIN_SEGMENT_STAGES stages are never cut
SEGMENT_SHARE = 8
MIN_SEGMENT_STAGES = 8
# the most entries a segment holds whatever the limit: the kernels stage an
# item's entries in shared memory (splash_grouped.cuh kMaxItemEntries)
MAX_SEGMENT_ENTRIES = 4096


def entries_per_stage(block: int) -> int:
    return max(1, STAGE_ROWS // block)


def stages_per_entry(block: int) -> int:
    return max(1, block // STAGE_ROWS)


def sweep_stages(n_entries, block: int):
    """Stages of a sweep over ``n_entries`` blocks (an int or an array)."""
    eps = entries_per_stage(block)
    return -(-np.asarray(n_entries) // eps) * stages_per_entry(block)


@dataclasses.dataclass(frozen=True)
class SplashPlan:
    """The work items of one sweep (the forward's layout for the forward and
    dq, or its transpose for dk/dv), as numpy arrays from ``plan_splash``
    or as int32 tensors on a device (``to``):

    - ``items`` ``[n_items, ITEM_INTS]``: layout head, first and end entry,
      partial slot (-1: the item writes the outputs), and each warp's first
      row (-1: no rows), longest first;
    - ``entries``: each group's union, ``block | mask << MASK_SHIFT``, bit m
      of the mask set where member m holds the block;
    - ``merges`` ``[n_merges, ITEM_INTS]``: a split group's layout head,
      first slot, segment count, 0, and its warps' rows;
    - ``heads``: the layout heads planned (1 where every head's layout is
      the same); ``n_parts`` partial slots; ``limit`` the most entries a
      segment holds; ``stats`` for the records."""
    items: object
    entries: object
    merges: object
    heads: int
    n_parts: int
    limit: int
    stats: dict

    def to(self, device) -> "SplashPlan":
        def put(a):
            a = a if len(a) else np.zeros((1, ) + a.shape[1:], np.int32)
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

        return dataclasses.replace(self, items=put(self.items), entries=put(self.entries),
                                   merges=put(self.merges))

    @property
    def n_items(self) -> int:
        return int(self.stats["items"])

    @property
    def n_merges(self) -> int:
        return int(self.stats["split_groups"])

    @property
    def cap(self) -> int:
        """The most entries one item sweeps (the kernels stage them in
        shared memory)."""
        return int(self.stats["widest_segment"])


def _group_order(lay: np.ndarray, members: int, block: int) -> np.ndarray:
    """The order in which one head's block rows are cut into groups of
    ``members``: as they lie (neighbours share windows: fixed's local
    windows, the sliding windows) or widest first, then by first entry
    (nested rows: fixed's transposed global columns), whichever sweeps
    fewer stages."""
    nb = lay.shape[0]
    counts = lay.sum(1)
    first = np.where(counts > 0, lay.argmax(1), nb)
    best = None
    for order in (np.arange(nb), np.lexsort((np.arange(nb), first, -counts))):
        pad = np.concatenate([lay[order], np.zeros((-nb % members, nb), bool)])
        unions = pad.reshape(-1, members, nb).any(1).sum(1)
        cost = int(sweep_stages(unions, block).sum())
        if best is None or cost < best[0]:
            best = (cost, order)
    return best[1]


def plan_splash(layout: np.ndarray, block: int, limit: Optional[int] = None) -> SplashPlan:
    """Plan the sweep over ``layout`` ``[Lh, nb, nb]`` (the forward's, which
    dq sweeps too; pass its transpose for dk/dv): groups of ``GROUP_ROWS //
    block`` block rows (one for block 64, and two 64-row halves of one row
    for block 128), the sorted union of each group's blocks with each
    entry's members, each union longer than ``limit`` entries cut into
    near-equal segments (aligned to whole stages where that stays within
    the limit), and the items ordered longest first. ``limit=None`` takes the default: a
    segment holds at most 1 / SEGMENT_SHARE of the plan's stages and no
    fewer than MIN_SEGMENT_STAGES."""
    lay = np.asarray(layout).astype(bool)
    if all((lay[h] == lay[0]).all() for h in range(1, lay.shape[0])):
        lay = lay[:1]  # one plan serves every head
    Lh, nb, _ = lay.shape
    members = max(1, GROUP_ROWS // block)
    halves = max(1, block // GROUP_ROWS)
    eps, spe = entries_per_stage(block), stages_per_entry(block)
    warps = GROUP_ROWS // WARP_ROWS
    per_member = warps // members  # warps a member's rows take

    groups, unions, entries = [], [], []  # (head, warp rows, first entry, n)
    held = off = 0
    for h in range(Lh):
        order = _group_order(lay[h], members, block)
        for g0 in range(0, nb, members):
            rows = order[g0:g0 + members]
            sub = lay[h, rows]
            union = np.flatnonzero(sub.any(0))
            masks = (sub[:, union].astype(np.int64) << np.arange(len(rows))[:, None]).sum(0)
            entries.append(union.astype(np.int64) | (masks << MASK_SHIFT))
            unions.append(len(union))
            held += int(sub.sum())
            for half in range(halves):
                wrows = [int(rows[w // per_member]) * block + half * GROUP_ROWS
                         + (w % per_member) * WARP_ROWS if w // per_member < len(rows) else -1
                         for w in range(warps)]
                groups.append((h, wrows, off, len(union)))
            off += len(union)
    stages = sweep_stages([n for *_, n in groups], block)
    if limit is None:
        seg_stages = max(MIN_SEGMENT_STAGES, -(-int(stages.sum()) // SEGMENT_SHARE))
        limit = max(1, seg_stages * eps // spe)
    if limit < 1:
        raise ValueError(f"plan_splash: limit must be at least 1, got {limit}")
    limit = min(limit, MAX_SEGMENT_ENTRIES)

    items, merges, parts = [], [], 0
    for h, wrows, e0, n in groups:
        if n <= limit:
            items.append([h, e0, e0 + n, -1, *wrows])
            continue
        seg = -(-n // -(-n // limit))
        if -(-seg // eps) * eps <= limit:
            seg = -(-seg // eps) * eps
        nseg = -(-n // seg)
        for k in range(nseg):
            items.append([h, e0 + k * seg, e0 + min(n, (k + 1) * seg), parts + k, *wrows])
        merges.append([h, parts, nseg, 0, *wrows])
        parts += nseg
    items = np.asarray(items, np.int32).reshape(-1, ITEM_INTS)
    cost = sweep_stages(items[:, 2] - items[:, 1], block)
    items = items[np.argsort(-cost, kind="stable")]
    split = items[:, 3] >= 0
    stats = {"items": len(items), "groups": len(groups), "split_groups": len(merges),
             "segments": int(split.sum()),
             "widest_segment": int((items[:, 2] - items[:, 1]).max()),
             "stages": int(cost.sum()), "longest_item_stages": int(cost.max()),
             "union_share": float(sum(unions)) / max(1, held), "limit": int(limit)}
    return SplashPlan(items, np.concatenate(entries).astype(np.int32) if entries else
                      np.zeros(0, np.int32),
                      np.asarray(merges, np.int32).reshape(-1, ITEM_INTS), Lh, parts,
                      int(limit), stats)


@dataclasses.dataclass(frozen=True)
class SplashTables:
    """One layout on one device: the layout itself (bool ``[Lh, nb, nb]``,
    for the plain versions), the block size, and the device plans of the
    forward and dq (``plan``) and of the dk/dv pass (``plan_t``, over the
    transposed layout; both None for a block the kernels do not take)."""
    layout: torch.Tensor
    block: int
    plan: Optional[SplashPlan]
    plan_t: Optional[SplashPlan]

    @staticmethod
    def build(layout: np.ndarray, block: int, device,
              limit: Optional[int] = None) -> "SplashTables":
        lay = np.ascontiguousarray(np.asarray(layout).astype(bool))
        dev = torch.device(device)
        plans = [plan_splash(x, block, limit).to(dev) if block in KERNEL_BLOCKS else None
                 for x in (lay, lay.transpose(0, 2, 1))]
        return SplashTables(torch.from_numpy(lay).to(dev), int(block), *plans)


def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / float(np.sqrt(q.shape[-1]))


def _layout_tensor(layout, device):
    """The bool layout on ``device``, from an array or a ``SplashTables``."""
    if isinstance(layout, SplashTables):
        return layout.layout.to(device)
    return torch.from_numpy(np.asarray(layout).astype(bool)).to(device)


def _row_chunks(q):
    """``(batch*head)`` row ranges whose dense scores fit ``CHUNK_PAIRS``."""
    B, H, S, _ = q.shape
    step = max(1, CHUNK_PAIRS // (S * S))
    for r0 in range(0, B * H, step):
        yield r0, min(B * H, r0 + step)


def _visible(layout, block, r0, r1):
    """The dense mask ``[r1 - r0, S, S]`` of rows r0:r1: row bh reads
    layout head ``bh % layout_heads``."""
    heads = torch.arange(r0, r1, device=layout.device) % layout.shape[0]
    m = layout[heads]
    return m.repeat_interleave(block, 1).repeat_interleave(block, 2)


def _flat(x):
    B, H, S, D = x.shape
    return x.reshape(B * H, S, D)


def splash_attention_fwd_reference(q, k, v, layout, block: int,
                                   scale: Optional[float] = None):
    """Plain forward of K8: fp32 scores of the active blocks (the others
    masked), the softmax, P cast to v's dtype for the PV product. Returns
    ``(o [B, H, S, D] in q's dtype, lse [B, H, S] fp32)``; a row with no
    active block gives 0 and ``LSE_EMPTY``."""
    B, H, S, D = q.shape
    lay = _layout_tensor(layout, q.device)
    scale = _scale(q, scale)
    qf, kf, vf = _flat(q), _flat(k), _flat(v)
    o = torch.empty_like(qf)
    lse = torch.empty(B * H, S, dtype=_wide(q[:0]).dtype, device=q.device)
    for r0, r1 in _row_chunks(q):
        vis = _visible(lay, block, r0, r1)
        s = torch.einsum("rqd,rkd->rqk", _wide(qf[r0:r1]), _wide(kf[r0:r1])) * scale
        s = s.masked_fill(~vis, float("-inf"))
        m = s.amax(-1, keepdim=True)
        m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(s - m_safe)
        l = p.sum(-1, keepdim=True)
        safe_l = torch.where(l == 0, torch.ones_like(l), l)
        oc = torch.einsum("rqk,rkd->rqd", _wide((p / safe_l).to(v.dtype)),
                          _wide(vf[r0:r1]))
        o[r0:r1] = oc.to(q.dtype)
        lse[r0:r1] = torch.where(l == 0, torch.full_like(l, LSE_EMPTY),
                                 m_safe + torch.log(safe_l))[..., 0]
    return o.reshape(B, H, S, D), lse.reshape(B, H, S)


def _dscores(qf, kf, vf, dof, lse, delta, lay, block, scale, r0, r1):
    """P = exp(s - lse) (0 outside the active blocks) and dS = P * (dP -
    delta) * scale of rows r0:r1, ``[rows, S, S]`` fp32."""
    vis = _visible(lay, block, r0, r1)
    s = torch.einsum("rqd,rkd->rqk", _wide(qf[r0:r1]), _wide(kf[r0:r1])) * scale
    p = torch.exp(s - _wide(lse[r0:r1])[..., None]).masked_fill(~vis, 0.0)
    dp = torch.einsum("rqd,rkd->rqk", _wide(dof[r0:r1]), _wide(vf[r0:r1]))
    return p, p * (dp - _wide(delta[r0:r1])[..., None]) * scale


def splash_attention_bwd_dq_reference(q, k, v, do, lse, delta, layout,
                                      block: int, scale: Optional[float] = None):
    """Plain dq pass of K8: dS rounded to k's dtype for the dS k product
    (``_splash_dq_kernel``)."""
    B, H, S, D = q.shape
    lay = _layout_tensor(layout, q.device)
    scale = _scale(q, scale)
    qf, kf, vf, dof = _flat(q), _flat(k), _flat(v), _flat(do)
    lse, delta = lse.reshape(B * H, S), delta.reshape(B * H, S)
    dq = torch.empty_like(qf)
    for r0, r1 in _row_chunks(q):
        _, ds = _dscores(qf, kf, vf, dof, lse, delta, lay, block, scale, r0, r1)
        dq[r0:r1] = torch.einsum("rqk,rkd->rqd", _wide(ds.to(k.dtype)),
                                 _wide(kf[r0:r1])).to(q.dtype)
    return dq.reshape(B, H, S, D)


def splash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta, layout,
                                        block: int, scale: Optional[float] = None):
    """Plain dk/dv pass of K8: dv = P^T dO (P rounded to dO's dtype), dk =
    dS^T q (dS rounded to q's dtype) (``_splash_dkv_kernel``)."""
    B, H, S, D = q.shape
    lay = _layout_tensor(layout, q.device)
    scale = _scale(q, scale)
    qf, kf, vf, dof = _flat(q), _flat(k), _flat(v), _flat(do)
    lse, delta = lse.reshape(B * H, S), delta.reshape(B * H, S)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for r0, r1 in _row_chunks(q):
        p, ds = _dscores(qf, kf, vf, dof, lse, delta, lay, block, scale, r0, r1)
        dv[r0:r1] = torch.einsum("rqk,rqd->rkd", _wide(p.to(do.dtype)),
                                 _wide(dof[r0:r1])).to(v.dtype)
        dk[r0:r1] = torch.einsum("rqk,rqd->rkd", _wide(ds.to(q.dtype)),
                                 _wide(qf[r0:r1])).to(k.dtype)
    return dk.reshape(B, H, S, D), dv.reshape(B, H, S, D)


def _check_cuda(name, q, tables, tensors):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, H, S, D = q.shape
    Lh, nb, _ = tables.layout.shape
    if tables.block not in KERNEL_BLOCKS:
        raise ValueError(f"{name}: the kernel takes block in {KERNEL_BLOCKS}, "
                         f"got {tables.block}")
    if nb * tables.block != S or H % Lh:
        raise ValueError(f"{name}: layout {tuple(tables.layout.shape)} at block "
                         f"{tables.block} does not cover q {tuple(q.shape)}")
    if D > 128 or D % 8:
        raise ValueError(f"{name}: the kernel takes head_dim <= 128 and a "
                         f"multiple of 8, got {D}")
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"{name}: the kernel takes float32, bfloat16 or float16, "
                        f"got {q.dtype}")
    for t in tensors:
        if t.device != q.device or tables.layout.device != q.device:
            raise ValueError(f"{name}: all inputs and the tables must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    for t in tensors[:4]:
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k, v (and dO) must share one shape "
                             "and dtype")
    for t in tensors[4:]:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, S):
            raise ValueError(f"{name}: lse and delta must be float32 {(B, H, S)}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _partials(q, plan, per_row):
    """fp32 partials of a plan's split groups, ``[replicas, slots, 64,
    per_row]`` (``B * H / heads`` replicas of the plan's heads); None
    without a split."""
    if not plan.n_parts:
        return None
    B, H = q.shape[:2]
    return torch.empty(B * H // plan.heads, plan.n_parts, GROUP_ROWS, per_row,
                       dtype=torch.float32, device=q.device)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def splash_fwd_sweep(q, k, v, tables: SplashTables, scale: Optional[float] = None):
    """K8 forward's grouped sweep alone (kernel ``dstt_splash_fwd`` over
    ``tables.plan``): ``(o, lse, acc, ml)``, where the rows of split groups
    are left to ``splash_fwd_merge`` and their segments' partials are in
    ``acc`` ``[replicas, slots, 64, D]`` and ``ml`` (max, sum) ``[...,
    2]`` (both None without a split). Counts in
    ``splash_attention_fwd.launches``."""
    _check_cuda("splash_attention_fwd", q, tables, (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    plan, (B, H, S, D) = tables.plan, q.shape
    acc, ml = _partials(q, plan, D), _partials(q, plan, 2)
    with torch.cuda.device(q.device):
        err = _build.lib().dstt_splash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            plan.items.data_ptr(), plan.entries.data_ptr(), plan.n_items, plan.cap, B * H, S,
            D, plan.heads, tables.block, _scale(q, scale), _build.dtype_code(q.dtype), _ptr(acc),
            _ptr(ml), plan.n_parts, _stream(q))
    _build.check(err, "splash_attention_fwd")
    splash_attention_fwd.launches += 1
    return o, lse, acc, ml


def splash_attention_fwd(q, k, v, tables: SplashTables,
                         scale: Optional[float] = None):
    """K8 forward (``splash_fwd_sweep``, then ``splash_fwd_merge`` where
    the plan splits a group): ``(o, lse)``."""
    if q.device.type == "cpu":
        return splash_attention_fwd_reference(q, k, v, tables, tables.block, scale)
    o, lse, acc, ml = splash_fwd_sweep(q, k, v, tables, scale)
    if tables.plan.n_merges:
        splash_fwd_merge(o, lse, tables.plan, acc, ml)
    return o, lse


def split_groups(plan, shape, device):
    """Each split group of ``plan`` in each replica, over outputs of
    ``shape`` ``[B, H, S, ...]``: (replica, the group's 64 rows in the
    flattened ``[B * H * S]`` rows, -1 where a warp has none, its partial
    slots in segment order)."""
    B, H, S = shape[:3]
    for h, p0, nseg, _, *wrows in plan.merges[:plan.n_merges].tolist():
        for rep in range(B * H // plan.heads):
            base = (rep * plan.heads + h) * S
            rows = [base + w + i if w >= 0 else -1 for w in wrows for i in range(WARP_ROWS)]
            yield rep, torch.tensor(rows, device=device), list(range(p0, p0 + nseg))


def splash_fwd_merge_reference(o, lse, plan: SplashPlan, acc, ml):
    """Plain merge of the split rows, in place: the segments' (max, sum,
    accumulator) rescaled to their largest max in fp32; o = 0 and
    ``LSE_EMPTY`` where no segment saw a key."""
    of, lf = o.view(-1, o.shape[-1]), lse.view(-1)
    for rep, rows, slots in split_groups(plan, o.shape, o.device):
        l = ml[rep, slots, :, 1]
        m = torch.where(l > 0, ml[rep, slots, :, 0], -float("inf"))
        top = m.amax(0)
        f = torch.where(l > 0, torch.exp(m - top), 0.0)
        L = (l * f).sum(0)
        total = (acc[rep, slots] * f[..., None]).sum(0)
        keep = rows >= 0
        of[rows[keep]] = torch.where(L[:, None] > 0, total / L[:, None], 0.0)[keep].to(o.dtype)
        lf[rows[keep]] = torch.where(L > 0, top + torch.log(L), LSE_EMPTY)[keep]


def splash_fwd_merge(o, lse, plan: SplashPlan, acc, ml):
    """The forward's second pass (kernel ``dstt_splash_fwd_merge``): each
    split group's rows from their segments' partials, in segment order, as
    K4's decode merges its page splits; o rounded once, lse = max +
    log(sum), and ``LSE_EMPTY`` with o = 0 where no segment saw a key."""
    if o.device.type == "cpu":
        return splash_fwd_merge_reference(o, lse, plan, acc, ml)
    B, H, S, D = o.shape
    with torch.cuda.device(o.device):
        err = _build.lib().dstt_splash_fwd_merge(
            o.data_ptr(), lse.data_ptr(), plan.merges.data_ptr(), plan.n_merges, B * H, S, D,
            plan.heads, _build.dtype_code(o.dtype), acc.data_ptr(), ml.data_ptr(),
            plan.n_parts, _stream(o))
    _build.check(err, "splash_fwd_merge")
    splash_fwd_merge.launches += 1


def splash_dq_sweep(q, k, v, do, lse, delta, tables: SplashTables,
                    scale: Optional[float] = None):
    """K8 dq's grouped sweep alone (kernel ``dstt_splash_bwd_dq`` over
    ``tables.plan``, the forward's): ``(dq, pq)``, where the rows of split
    groups are left to ``splash_dq_sum`` and their segments' fp32 partials
    are in ``pq`` ``[replicas, slots, 64, D]`` (None without a split).
    Counts in ``splash_attention_bwd_dq.launches``."""
    _check_cuda("splash_attention_bwd_dq", q, tables, (q, k, v, do, lse, delta))
    dq = torch.empty_like(q)
    plan, (B, H, S, D) = tables.plan, q.shape
    pq = _partials(q, plan, D)
    with torch.cuda.device(q.device):
        err = _build.lib().dstt_splash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), plan.items.data_ptr(), plan.entries.data_ptr(),
            plan.n_items, plan.cap, B * H, S, D, plan.heads, tables.block, _scale(q, scale),
            _build.dtype_code(q.dtype), _ptr(pq), plan.n_parts, _stream(q))
    _build.check(err, "splash_attention_bwd_dq")
    splash_attention_bwd_dq.launches += 1
    return dq, pq


def splash_attention_bwd_dq(q, k, v, do, lse, delta, tables: SplashTables,
                            scale: Optional[float] = None):
    """K8 dq pass over the forward's plan (``splash_dq_sweep``, then
    ``splash_dq_sum`` where the plan splits a group)."""
    if q.device.type == "cpu":
        return splash_attention_bwd_dq_reference(q, k, v, do, lse, delta, tables,
                                                 tables.block, scale)
    dq, pq = splash_dq_sweep(q, k, v, do, lse, delta, tables, scale)
    if tables.plan.n_merges:
        splash_dq_sum(dq, tables.plan, pq)
    return dq


def splash_dq_sum_reference(dq, plan: SplashPlan, pq):
    """Plain sum of the split rows of dq (or of dk or dv over the transposed
    plan), in place: each one's fp32 partials added in segment order,
    rounded once."""
    flat = dq.view(-1, dq.shape[-1])
    for rep, rows, slots in split_groups(plan, dq.shape, dq.device):
        total = torch.zeros_like(pq[rep, 0])
        for slot in slots:
            total += pq[rep, slot]
        keep = rows >= 0
        flat[rows[keep]] = total[keep].to(dq.dtype)


def splash_dq_sum(dq, plan: SplashPlan, pq):
    """dq's second pass (kernel ``dstt_splash_dq_sum``): each split group's
    fp32 partials summed in segment order and rounded once to q's dtype."""
    if dq.device.type == "cpu":
        return splash_dq_sum_reference(dq, plan, pq)
    B, H, S, D = dq.shape
    with torch.cuda.device(dq.device):
        err = _build.lib().dstt_splash_dq_sum(
            dq.data_ptr(), plan.merges.data_ptr(), plan.n_merges, B * H, S, D, plan.heads,
            _build.dtype_code(dq.dtype), pq.data_ptr(), plan.n_parts, _stream(dq))
    _build.check(err, "splash_dq_sum")
    splash_dq_sum.launches += 1


def splash_dkdv_sweep(q, k, v, do, lse, delta, tables: SplashTables,
                      scale: Optional[float] = None):
    """K8 dk/dv's grouped sweep alone (kernel ``dstt_splash_bwd_dkdv`` over
    ``tables.plan_t``): ``(dk, dv, pk, pv)``, where the keys of split groups
    are left to ``splash_dkdv_sum`` and their segments' fp32 partials are
    in ``pk`` and ``pv`` ``[replicas, slots, 64, D]`` (None without a
    split). Counts in ``splash_attention_bwd_dkdv.launches``."""
    _check_cuda("splash_attention_bwd_dkdv", q, tables, (q, k, v, do, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    plan, (B, H, S, D) = tables.plan_t, q.shape
    pk, pv = _partials(q, plan, D), _partials(q, plan, D)
    with torch.cuda.device(q.device):
        err = _build.lib().dstt_splash_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), plan.items.data_ptr(),
            plan.entries.data_ptr(), plan.n_items, plan.cap, B * H, S, D, plan.heads,
            tables.block,
            _scale(q, scale), _build.dtype_code(q.dtype), _ptr(pk), _ptr(pv), plan.n_parts,
            _stream(q))
    _build.check(err, "splash_attention_bwd_dkdv")
    splash_attention_bwd_dkdv.launches += 1
    return dk, dv, pk, pv


def splash_attention_bwd_dkdv(q, k, v, do, lse, delta, tables: SplashTables,
                              scale: Optional[float] = None):
    """K8 dk/dv pass over the transposed layout's plan
    (``splash_dkdv_sweep``, then ``splash_dkdv_sum`` where the plan splits
    a group): ``(dk, dv)``."""
    if q.device.type == "cpu":
        return splash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta, tables,
                                                   tables.block, scale)
    dk, dv, pk, pv = splash_dkdv_sweep(q, k, v, do, lse, delta, tables, scale)
    if tables.plan_t.n_merges:
        splash_dkdv_sum(dk, dv, tables.plan_t, pk, pv)
    return dk, dv


def splash_dkdv_sum_reference(dk, dv, plan: SplashPlan, pk, pv):
    """Plain sum of the split keys of dk and dv, in place
    (``splash_dq_sum_reference`` on each)."""
    splash_dq_sum_reference(dk, plan, pk)
    splash_dq_sum_reference(dv, plan, pv)


def splash_dkdv_sum(dk, dv, plan: SplashPlan, pk, pv):
    """The dk/dv pass's second pass (kernel ``dstt_splash_dkdv_sum``):
    each split group's fp32 partials summed in segment order and rounded
    once to k's dtype."""
    if dk.device.type == "cpu":
        return splash_dkdv_sum_reference(dk, dv, plan, pk, pv)
    B, H, S, D = dk.shape
    with torch.cuda.device(dk.device):
        err = _build.lib().dstt_splash_dkdv_sum(
            dk.data_ptr(), dv.data_ptr(), plan.merges.data_ptr(), plan.n_merges, B * H, S, D,
            plan.heads, _build.dtype_code(dk.dtype), pk.data_ptr(), pv.data_ptr(),
            plan.n_parts, _stream(dk))
    _build.check(err, "splash_dkdv_sum")
    splash_dkdv_sum.launches += 1


# every K8 kernel's launch counter, by wrapper
KERNEL_COUNTERS = (splash_attention_fwd, splash_fwd_merge, splash_attention_bwd_dq,
                   splash_dq_sum, splash_attention_bwd_dkdv, splash_dkdv_sum)
for _fn in KERNEL_COUNTERS:
    _fn.launches = 0


class _Splash(torch.autograd.Function):
    """The JAX ``custom_vjp``: K8's forward saves ``(q, k, v, o, lse)``;
    the backward computes delta, then runs the dq and the dk/dv kernel."""

    @staticmethod
    def forward(ctx, q, k, v, tables, scale):
        o, lse = splash_attention_fwd(q, k, v, tables, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tables, ctx.scale = tables, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        delta = attention_delta(o, g)  # rowsum(dO * O), [B, H, S]
        dq = splash_attention_bwd_dq(q, k, v, g, lse, delta, ctx.tables, ctx.scale)
        dk, dv = splash_attention_bwd_dkdv(q, k, v, g, lse, delta, ctx.tables, ctx.scale)
        return dq, dk, dv, None, None


@functools.lru_cache(maxsize=64)
def _cached_splash_fn(layout_bytes: bytes, layout_shape, block: int,
                      scale: float, device: str):
    """The plans (host loops, then one copy to ``device``)
    and the differentiable function over them, cached per (layout, block,
    scale, device): eager loops must not rebuild them every call."""
    layout = np.frombuffer(layout_bytes, dtype=np.bool_).reshape(layout_shape)
    tables = SplashTables.build(layout, block, device)

    def f(q, k, v):
        return _Splash.apply(q, k, v, tables, scale)

    f.tables = tables
    return f


def splash_function(layout: np.ndarray, block: int, scale: float, device):
    """The cached differentiable K8 function of ``layout`` on ``device``
    (``_cached_splash_fn``): a caller that holds it skips the cache key,
    a copy and hash of the layout's bytes."""
    lay = np.ascontiguousarray(np.asarray(layout).astype(bool))
    return _cached_splash_fn(lay.tobytes(), lay.shape, int(block), float(scale),
                             str(device))


def splash_sparse_attention(q, k, v, layout: np.ndarray, block: int,
                            scale: Optional[float] = None):
    """Block-sparse attention through K8, differentiable through the
    sparse backward kernels (dq over the forward's plan, dk/dv over the
    transposed layout's).

    q,k,v: [batch, heads, seq, head_dim]; layout: [heads or 1, nb, nb]
    static (a 1-head layout broadcasts over heads, dense-path parity).
    """
    B, H, S, D = q.shape
    layout_heads = np.shape(layout)[0]
    if S % block != 0:
        raise ValueError(f"seq {S} not divisible by block {block}")
    if H % layout_heads != 0:
        raise ValueError(f"q heads {H} not a multiple of layout heads {layout_heads}")
    scale = scale if scale is not None else 1.0 / float(np.sqrt(D))
    return splash_function(layout, block, scale, q.device)(q, k, v)


def splash_flops(layout: np.ndarray, block: int, head_dim: int,
                 batch: int = 1) -> dict:
    """Analytic fwd FLOP accounting: the kernel's work is structurally
    proportional to ACTIVE blocks (grid x per-tile matmuls), vs nb^2 for
    the dense-mask path — the reduction the reference's Triton SDD/DSD
    delivers."""
    layout = np.asarray(layout).astype(bool)
    H, nb, _ = layout.shape
    active = int(layout.sum())
    per_block = 4 * block * block * head_dim  # QK^T + PV
    return {
        "active_blocks": active,
        "total_blocks": H * nb * nb,
        "sparse_flops": batch * active * per_block,
        "dense_flops": batch * H * nb * nb * per_block,
        "reduction": 1.0 - active / (H * nb * nb),
    }
