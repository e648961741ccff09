"""The gradient wire's buckets and their collectives (port of
``deepspeed_tpu/comm/bucketing.py``; reference ``stage_1_and_2.py``'s
``reduce_bucket_size`` and ``coalesced_collectives.py``): a few large flat
buckets on the wire instead of one collective per parameter.

1. **Buckets.** ``plan_buckets`` packs a list of leaves (tensors, or
   anything with ``shape`` and ``dtype``), in the order given, into flat
   buckets of one dtype each: greedy up to ``bucket_size_mb``, a leaf never
   split (a leaf over the budget gets a bucket of its own), leaves end to
   end, each bucket padded to ``pad_multiple``. The engine gives its
   parameters in the JAX tree's ``tree_flatten`` order (sorted key paths,
   ``jax_leaf_order``), so a bucket holds the same values at the same
   offsets as JAX's, and every quantization block the same elements.
2. **The int8 tier.** ``quantize_block_int8`` is affine per block of
   ``block_size``: the block's ``[min, max]`` in 255 steps, a scale and a
   zero point (it is not K6, which is symmetric). On the wire: the int8
   codes and 8 bytes of scale and zero point a block, ~0.26x the fp32
   bytes at block 256.
3. **The collectives**, each through the ``fp32``, ``int8`` or ``onebit``
   tier over the ranks of ``group`` (mesh axes, as ``comm/comm.py``):
   ``reduce_scatter_bucket`` (fp32: ``reduce_scatter``; int8 and onebit:
   one ``all_to_all_single`` of each rank's codes or packed signs with
   their scales, the sum taken in fp32 after the dequantize),
   ``all_gather_bucket`` and ``allreduce_bucket``. The quantized tiers
   return this rank's residual beside the result, for error feedback.
   ``async_op=True`` returns a ``comm.CommHandle`` whose ``wait()``
   finishes the sum.

The arithmetic is JAX's as XLA compiles it (``jit``, as the JAX engine
runs it): a division by a constant is a multiplication by the constant's
fp32 reciprocal (the scale ``(max - min) * (1/255)``, a mean over the
ranks), a division by a tensor divides (the codes ``(x - min) / scale``),
the dequantize's multiply-add rounds once (computed in fp64, where the
product of a code and a scale is exact), and ``torch.round`` rounds half
to even as ``jnp.round`` does. So on the same input the codes, scales and
dequantized values are the JAX engine's bits.

4. **The store's gather**, ``param_gather_bucket``: the all-gather of a
   parameter bucket whose backward reduce-scatters the bucket's gradient,
   for the scheduled ZeRO-3 store (``runtime/zero3_schedule.py``).

The gradient wire's program is ``runtime/grad_comm.py``.
"""

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import comm
from .compressed import CHUNK_ELEMENTS, reciprocal, pack_signs, unpack_signs

WIRE_TIERS = ("fp32", "int8", "onebit")
DEFAULT_BLOCK_SIZE = 256


@dataclass(frozen=True)
class BucketSlot:
    """One leaf's place in a flat bucket."""
    leaf_index: int  # its position in the leaves given to plan_buckets
    offset: int  # its first element in the bucket
    size: int
    shape: Tuple[int, ...]


@dataclass(frozen=True)
class Bucket:
    dtype: Any  # the torch dtype of every slot
    size: int  # elements before the padding
    padded_size: int
    slots: Tuple[BucketSlot, ...] = ()


@dataclass(frozen=True)
class BucketLayout:
    buckets: Tuple[Bucket, ...]
    n_leaves: int


def jax_leaf_order(names: Sequence[str]) -> List[int]:
    """The indices of the port's parameter ``names`` in the JAX tree's
    ``tree_flatten`` order: sorted by their JAX key paths."""
    from ..models.convert import jax_key_path
    return sorted(range(len(names)), key=lambda i: jax_key_path(names[i]))


def _pad_to(n: int, multiple: int) -> int:
    return n if multiple <= 1 else n + (-n) % multiple


def plan_buckets(leaves, bucket_size_mb: float = 25.0, pad_multiple: int = 1) -> BucketLayout:
    """The buckets of ``leaves`` (see the module's docstring), ordered by
    their first leaf."""
    leaves = list(leaves)
    budget = int(bucket_size_mb * 1024 * 1024)
    if budget <= 0:
        raise ValueError(f"bucket_size_mb must be positive, got {bucket_size_mb}")
    open_buckets: Dict[Any, Tuple[list, int]] = {}
    done: List[Bucket] = []

    def close(dt):
        slots, fill = open_buckets.pop(dt)
        done.append(Bucket(dt, fill, _pad_to(fill, pad_multiple), tuple(slots)))

    for i, leaf in enumerate(leaves):
        shape = tuple(leaf.shape)
        dt = leaf.dtype
        itemsize = torch.empty((), dtype=dt).element_size()
        size = 1
        for d in shape:
            size *= int(d)
        if dt in open_buckets and (open_buckets[dt][1] + size) * itemsize > budget \
                and open_buckets[dt][1] > 0:
            close(dt)
        slots, fill = open_buckets.setdefault(dt, ([], 0))
        slots.append(BucketSlot(i, fill, size, shape))
        open_buckets[dt] = (slots, fill + size)
        if (fill + size) * itemsize >= budget:
            close(dt)
    for dt in list(open_buckets):
        close(dt)
    done.sort(key=lambda b: b.slots[0].leaf_index)
    return BucketLayout(tuple(done), len(leaves))


def flatten_buckets(leaves, layout: BucketLayout) -> List[torch.Tensor]:
    """The leaves as flat buckets, each padded with zeros."""
    leaves = list(leaves)
    if len(leaves) != layout.n_leaves:
        raise ValueError(f"{len(leaves)} leaves but the bucket layout was planned for "
                         f"{layout.n_leaves}; plan again with plan_buckets")
    out = []
    for b in layout.buckets:
        flat = torch.cat([leaves[s.leaf_index].reshape(-1).to(b.dtype) for s in b.slots])
        out.append(F.pad(flat, (0, b.padded_size - b.size)))
    return out


def unflatten_buckets(buckets: Sequence[torch.Tensor], layout: BucketLayout,
                      example=None) -> List[torch.Tensor]:
    """The leaves from the buckets (views, in the buckets' dtype, or in
    each ``example`` leaf's dtype)."""
    if len(buckets) != len(layout.buckets):
        raise ValueError(f"expected {len(layout.buckets)} buckets, got {len(buckets)}")
    leaves: List[Optional[torch.Tensor]] = [None] * layout.n_leaves
    for arr, b in zip(buckets, layout.buckets):
        for s in b.slots:
            leaf = arr[s.offset:s.offset + s.size].view(s.shape)
            dtype = example[s.leaf_index].dtype if example is not None else b.dtype
            leaves[s.leaf_index] = leaf.to(dtype)
    return leaves


# ---------------------------------------------------------------- the int8 tier


def _block_steps(n_blocks: int, block_size: int):
    """Slices of at most ``CHUNK_ELEMENTS`` elements' worth of blocks."""
    step = max(1, CHUNK_ELEMENTS // block_size)
    return [slice(a, min(a + step, n_blocks)) for a in range(0, n_blocks, step)]


def quantize_block_int8(x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE):
    """Flat ``[N]`` float -> (codes int8 ``[ceil(N/B), B]``, scale fp32
    ``[nb]``, zero fp32 ``[nb]``), ``x ~ (codes + 128) * scale + zero``
    with the codes spanning ``[-128, 127]`` over each block's range (the
    last block padded with zeros)."""
    n = x.shape[0]
    nb = -(-n // block_size)
    codes = torch.empty(nb, block_size, dtype=torch.int8, device=x.device)
    scale = torch.empty(nb, dtype=torch.float32, device=x.device)
    zero = torch.empty_like(scale)
    inv = reciprocal(255, x.device)
    for sl in _block_steps(nb, block_size):
        part = x[sl.start * block_size:sl.stop * block_size].float()
        xb = F.pad(part, (0, (-part.shape[0]) % block_size)).view(-1, block_size)
        lo = xb.amin(dim=1, keepdim=True)
        s = (xb.amax(dim=1, keepdim=True) - lo) * inv
        safe = torch.where(s > 0, s, torch.ones_like(s))
        codes[sl] = torch.clamp(torch.round((xb - lo) / safe), 0, 255) - 128
        scale[sl], zero[sl] = s[:, 0], lo[:, 0]
    return codes, scale, zero


def dequantize_block_int8(codes, scale, zero, n: Optional[int] = None) -> torch.Tensor:
    """The inverse of ``quantize_block_int8`` (any leading axes), trimmed
    to ``n`` elements."""
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    for sl in _block_steps(codes.shape[-2], codes.shape[-1]):
        # one rounding of the multiply-add, as XLA fuses it: the product of
        # an 8-bit code and an fp32 scale is exact in fp64
        out[..., sl, :] = ((codes[..., sl, :].to(torch.float64) + 128.0)
                           * scale[..., sl].to(torch.float64).unsqueeze(-1)
                           + zero[..., sl].to(torch.float64).unsqueeze(-1))
    flat = out.reshape(*codes.shape[:-2], -1)
    return flat if n is None else flat[..., :n]


# ------------------------------------------------------- one buffer on the wire


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as uint8 along its last axis."""
    return t.contiguous().view(torch.uint8)


def _pack_int8(x: torch.Tensor, w: int, block: int):
    """``x``'s codes, scales and zero points as ``[w, nb/w, block + 8]``
    bytes (a block's codes, then its scale and zero point), and the
    quantization's parts."""
    codes, scale, zero = quantize_block_int8(x, block)
    nb = codes.shape[0]
    if nb % w:
        raise ValueError(f"{nb} quantization blocks must divide the world {w}; pad buckets "
                         "to world x block")
    wire = torch.cat([_bytes(codes), _bytes(torch.stack([scale, zero], dim=1))], dim=1)
    return wire.view(w, nb // w, block + 8), (codes, scale, zero)


def _dequantize_rows(wire: torch.Tensor, block: int, n: Optional[int] = None):
    """Each rank's row of ``[w, nb, block + 8]`` bytes dequantized, one row
    at a time."""
    for row in wire.unbind(0):
        sz = row[:, block:].contiguous().view(torch.float32)
        yield dequantize_block_int8(row[:, :block].contiguous().view(torch.int8), sz[:, 0],
                                    sz[:, 1], n)


def _pack_onebit(chunks: torch.Tensor):
    """Each row of ``[w, chunk]``: its packed signs then its scale's 4
    bytes, as ``[w, chunk/8 + 4]``; and the packed signs and scales."""
    packs, scales = zip(*[pack_signs(c) for c in chunks.unbind(0)])
    packed, scale = torch.stack(packs), torch.stack(scales)
    return torch.cat([packed, _bytes(scale.view(-1, 1))], dim=1), (packed, scale)


def _signed_rows(wire: torch.Tensor, n: int):
    """Each rank's row of ``[w, n/8 + 4]`` bytes as its signs times its
    scale, one row at a time."""
    for row in wire.unbind(0):
        yield unpack_signs(row[:-4], n).mul_(row[-4:].contiguous().view(torch.float32))


def _sum(rows) -> torch.Tensor:
    """The sum of the rows (fresh tensors) in rank order."""
    rows = iter(rows)
    total = next(rows)
    for r in rows:
        total.add_(r)
    return total


def _check_tier(tier):
    if tier not in WIRE_TIERS:
        raise ValueError(f"unknown wire tier {tier!r}; expected one of {WIRE_TIERS}")


def _finish(handle, finish, async_op):
    if async_op:
        return comm.CommHandle(None, handle, lambda: finish(handle.value))
    return finish(handle)


def reduce_scatter_bucket(x: torch.Tensor, group=None, tier: str = "fp32",
                          block_size: int = DEFAULT_BLOCK_SIZE, async_op: bool = False):
    """Reduce-scatter the flat bucket ``x``: rank ``k`` of the group gets
    the SUM of every rank's ``k``-th chunk. Returns ``(shard [N/W],
    residual [N])``, the shard as a handle with ``async_op``; the residual
    is this rank's quantization error (None for fp32). The quantized
    tiers are done with ``x`` when this returns."""
    _check_tier(tier)
    w = comm.get_world_size(group)
    n = x.shape[0]
    if n % w:
        raise ValueError(f"bucket length {n} must divide the dp world {w}; "
                         "plan_buckets(pad_multiple=world*block) pads for this")
    if tier == "fp32":
        return comm.reduce_scatter(x, group=group, async_op=async_op), None
    if tier == "int8":
        wire, (codes, scale, zero) = _pack_int8(x, w, block_size)
        got = comm.all_to_all_single(wire, group=group, async_op=async_op)
        mine = dequantize_block_int8(codes, scale, zero, n)
        return (_finish(got, lambda r: _sum(_dequantize_rows(r, block_size)), async_op),
                mine.neg_().add_(x))
    chunk = n // w
    wire, (packed, scale) = _pack_onebit(x.view(w, chunk))
    got = comm.all_to_all_single(wire, group=group, async_op=async_op)
    mine = unpack_signs(packed, chunk).mul_(scale[:, None]).reshape(-1)
    return _finish(got, lambda r: _sum(_signed_rows(r, chunk)), async_op), mine.neg_().add_(x)


def all_gather_bucket(shard: torch.Tensor, group=None, tier: str = "fp32",
                      block_size: int = DEFAULT_BLOCK_SIZE, out: Optional[torch.Tensor] = None,
                      async_op: bool = False):
    """The ranks' shards gathered back into the whole flat bucket (into
    ``out`` where given). The quantized tiers send each shard quantized and
    every rank dequantizes the same bytes, so all end with the same
    values. ``async_op=True`` returns a ``comm.CommHandle`` whose
    ``wait()`` returns the bucket."""
    _check_tier(tier)
    if tier == "fp32":
        return comm.all_gather_into_tensor(out, shard, group=group, async_op=async_op)
    n = shard.shape[0]
    if tier == "int8":
        wire, _ = _pack_int8(shard, 1, block_size)

        def rows(got):
            return _dequantize_rows(got, block_size, n)
    else:
        wire, _ = _pack_onebit(shard.view(1, n))

        def rows(got):
            return _signed_rows(got, n)

    def finish(got):
        if out is None:
            return torch.cat(list(rows(got)))
        for i, row in enumerate(rows(got)):
            out[i * n:(i + 1) * n].copy_(row)
        return out

    got = comm.all_gather(wire[0], group=group, tiled=False, async_op=async_op)
    return _finish(got, finish, async_op)


class _ParamGatherBucket(torch.autograd.Function):
    """The differentiable bucket gather of the scheduled ZeRO-3 store (see
    ``param_gather_bucket``)."""

    @staticmethod
    def forward(ctx, shard, group, fwd_tier, bwd_tier, block_size, handle):
        ctx.opts = (group, bwd_tier, block_size)
        if handle is not None:  # issued ahead (async_op): lands here
            return handle.wait()
        return all_gather_bucket(shard, group, fwd_tier, block_size)

    @staticmethod
    def backward(ctx, g):
        group, bwd_tier, block_size = ctx.opts
        shard, _residual = reduce_scatter_bucket(g.contiguous(), group, bwd_tier, block_size)
        return shard, None, None, None, None, None


class PendingGather:
    """A ``param_gather_bucket`` issued ahead of its use: ``wait()`` waits
    for the collective and returns the gathered bucket, differentiable in
    the shard."""

    def __init__(self, shard, group, fwd_tier, bwd_tier, block_size):
        self.args = (shard, group, fwd_tier, bwd_tier, block_size)
        self.handle = all_gather_bucket(shard.detach(), group, fwd_tier, block_size,
                                        async_op=True)

    def wait(self) -> torch.Tensor:
        return _ParamGatherBucket.apply(*self.args, self.handle)


def param_gather_bucket(shard: torch.Tensor, group=None, fwd_tier: str = "fp32",
                        bwd_tier: str = "fp32", block_size: int = DEFAULT_BLOCK_SIZE,
                        async_op: bool = False):
    """Differentiable bucket all-gather for the scheduled ZeRO-3 store
    (``deepspeed_tpu/comm/bucketing.py:351-378``, a ``jax.custom_vjp``
    there, a ``torch.autograd.Function`` here).

    Forward: ``all_gather_bucket(shard, fwd_tier)`` (int8 with
    ``zero_quantized_weights``). Backward: the cotangent of the whole
    bucket reduce-scattered back to the shard's shape through ``bwd_tier``
    (int8 with ``zero_quantized_gradients``): the SUM over the ranks, as
    XLA's transpose of a tiled all-gather is, so for fp32 over fp32 the
    store's gradient exchange is the stage-2 wire's reduce-scatter to the
    bit; the quantized tiers pass the gradient straight through their
    forward rounding. ``async_op=True`` issues the gather now and returns a
    ``PendingGather`` whose ``wait()`` gives the bucket where it lands."""
    _check_tier(fwd_tier)
    _check_tier(bwd_tier)
    if async_op:
        return PendingGather(shard, group, fwd_tier, bwd_tier, block_size)
    return _ParamGatherBucket.apply(shard, group, fwd_tier, bwd_tier, block_size, None)


def allreduce_bucket(x: torch.Tensor, group=None, tier: str = "fp32",
                     block_size: int = DEFAULT_BLOCK_SIZE, mean: bool = True):
    """The mean (or sum) of the flat bucket ``x`` over the group through
    the tier: ``(result [N], residual [N])``, zeros for fp32."""
    _check_tier(tier)
    w = comm.get_world_size(group)
    n = x.shape[0]
    if tier == "fp32":
        total = comm.all_reduce(x.clone(), group=group)
        return (total.mul_(reciprocal(w, x.device)) if mean else total), torch.zeros_like(x)
    if tier == "int8":
        wire, (codes, scale, zero) = _pack_int8(x, 1, block_size)
        agg = _sum(_dequantize_rows(comm.all_gather(wire[0], group=group, tiled=False),
                                    block_size, n))
        mine = dequantize_block_int8(codes, scale, zero, n)
    else:
        wire, (packed, scale) = _pack_onebit(x.view(1, n))
        agg = _sum(_signed_rows(comm.all_gather(wire[0], group=group, tiled=False), n))
        mine = unpack_signs(packed, n)[0] * scale[0]
    return (agg.mul_(reciprocal(w, x.device)) if mean else agg), mine.neg_().add_(x)


def bucketed_allreduce_tree(leaves, group=None, layout: Optional[BucketLayout] = None,
                            tier: str = "fp32", block_size: int = DEFAULT_BLOCK_SIZE,
                            bucket_size_mb: float = 25.0, error_buckets=None,
                            mean: bool = True):
    """The mean of each leaf over the group through flat buckets: a few
    large collectives instead of one a leaf. ``error_buckets``: the last
    residuals (``init_error_buckets``), added before the exchange. Returns
    ``(leaves, new error buckets)``."""
    leaves = list(leaves)
    if layout is None:
        layout = plan_buckets(leaves, bucket_size_mb, pad_multiple=block_size)
    buckets = flatten_buckets(leaves, layout)
    if error_buckets is not None:
        if len(error_buckets) != len(buckets):
            raise ValueError(f"error_buckets has {len(error_buckets)} entries for "
                             f"{len(buckets)} buckets; pass init_error_buckets(layout)")
        buckets = [b + e for b, e in zip(buckets, error_buckets)]
    outs, errs = [], []
    for b in buckets:
        avg, err = allreduce_bucket(b, group, tier, block_size, mean)
        outs.append(avg)
        errs.append(err)
    return unflatten_buckets(outs, layout, example=leaves), errs


def init_error_buckets(layout: BucketLayout, device=None) -> List[torch.Tensor]:
    """Zero residual buffers of the layout (fp32, padded lengths)."""
    return [torch.zeros(b.padded_size, dtype=torch.float32, device=device)
            for b in layout.buckets]


def bucket_wire_bytes(layout: BucketLayout, world: int, tier: str = "fp32",
                      block_size: int = DEFAULT_BLOCK_SIZE) -> dict:
    """Each rank's received bytes for one allreduce of the layout per tier
    (``compressed.wire_bytes`` over the padded elements), and the buckets'
    count per dtype."""
    from .compressed import wire_bytes
    total = sum(b.padded_size for b in layout.buckets)
    per_tier = wire_bytes(total, world, block_size=block_size)
    counts: Dict[str, int] = {}
    for b in layout.buckets:
        key = str(b.dtype).replace("torch.", "")
        counts[key] = counts.get(key, 0) + 1
    return {"n_buckets": len(layout.buckets), "collectives_per_dtype": counts,
            "elements": total, "fp32_bytes": per_tier["fp32_bytes"],
            "int8_bytes": per_tier["int8_bytes"], "onebit_bytes": per_tier["compressed_bytes"],
            "wire_bytes": per_tier[{"fp32": "fp32_bytes", "int8": "int8_bytes",
                                    "onebit": "compressed_bytes"}[tier]]}


def record_bucket_traffic(layout: BucketLayout, world: int, tier: str,
                          block_size: int = DEFAULT_BLOCK_SIZE, duration: float = 0.0,
                          op: str = "all_reduce", record_name: str = "bucketed_grad_comm"):
    """Bank one step's bucketed wire bytes with the comms logger (while it
    is enabled) at the caller's measured ``duration``; returns the
    ``bucket_wire_bytes`` stats, or None when the logger is off."""
    from .comms_logging import get_comms_logger
    cl = get_comms_logger()
    if not cl.enabled:
        return None
    stats = bucket_wire_bytes(layout, world, tier, block_size)
    cl.append(op, f"{record_name}[{tier}]", duration, stats["wire_bytes"], n_participants=world)
    return stats
