"""Error-compensated 1-bit compressed allreduce, the wire of the 1-bit
optimizers (port of ``deepspeed_tpu/comm/compressed.py``; reference
``runtime/comm/nccl.py:16 compressed_allreduce``).

Each rank packs the signs of its error-corrected tensor into bytes (8
signs a byte), the ranks all-gather the packed bytes and one fp32 scale
each, and every rank decompresses and averages them itself::

    rank i:  c_i = x_i + e_i;  s_i = mean|c_i|;  wire_i = signbits(c_i)
    result = mean_i(sign(wire_i) * s_i);  e_i' = c_i - sign(c_i) * s_i

The sign rule and bit order are JAX's: bit ``k`` of byte ``i`` is element
``8 i + k``, a set bit means ``>= 0`` (one bit has no zero), the padding
of the last byte reads as set. The scale is ``mean |x|`` in fp32, the sum
times the fp32 reciprocal of the count as XLA compiles a mean; it sums in
another order than XLA, so the scales agree with JAX's to ulps, not to
bits. The tree form takes lists of tensors (the leaves) and sends every
leaf's bytes and scales in one all-gather each.
"""

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import comm

CHUNK_ELEMENTS = 1 << 24  # elements a pass (a multiple of 8): temporaries stay ~100 MB
_SHIFTS = {}


def spans(n: int, step: int = 0):
    """``(start, end)`` of each chunk of at most ``step`` (default
    ``CHUNK_ELEMENTS``) elements of ``n``."""
    step = step or CHUNK_ELEMENTS
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def _shifts(device) -> torch.Tensor:
    key = str(device)
    if key not in _SHIFTS:
        _SHIFTS[key] = torch.arange(8, dtype=torch.uint8, device=device)
    return _SHIFTS[key]


def pack_signs(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` flat ``[N]`` float -> (packed uint8 ``[ceil(N/8)]``, the fp32
    scale ``mean |x|`` as a 0-d tensor), a chunk at a time."""
    n = x.shape[0]
    packed = torch.empty((n + 7) // 8, dtype=torch.uint8, device=x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a, b in spans(n):
        part = x[a:b]
        bits = F.pad(part.ge(0).to(torch.uint8), (0, (a - b) % 8), value=1).view(-1, 8)
        packed[a // 8:a // 8 + bits.shape[0]] = (bits << _shifts(x.device)).sum(
            dim=1, dtype=torch.uint8)
        total += part.float().abs().sum()
    return packed, total * reciprocal(n, x.device)[0]


def unpack_signs(packed: torch.Tensor, n: int) -> torch.Tensor:
    """packed uint8 ``[..., ceil(N/8)]`` -> signs +-1.0 fp32 ``[..., N]``."""
    bits = (packed.unsqueeze(-1) >> _shifts(packed.device)) & 1
    signs = bits.to(torch.float32).mul_(2.0).sub_(1.0)
    return signs.reshape(*packed.shape[:-1], -1)[..., :n]


def reciprocal(n: int, device) -> torch.Tensor:
    """``1 / n`` as a one-element fp32 tensor: XLA compiles a division by a
    constant into a multiplication by its fp32 reciprocal, and so do the
    port's means and averages (a fill, no copy from the host)."""
    return torch.full((1, ), 1.0 / n, dtype=torch.float32, device=device)


def rank_mean(packed_by_rank: torch.Tensor, scales: torch.Tensor, n: int) -> torch.Tensor:
    """``mean_i(unpack(packed[i]) * scales[i])`` over the leading rank
    axis, added in rank order (JAX's ``jnp.mean``), one rank's ``[n]`` at a
    time."""
    total = unpack_signs(packed_by_rank[0], n) * scales[0]
    for i in range(1, packed_by_rank.shape[0]):
        total.add_(unpack_signs(packed_by_rank[i], n) * scales[i])
    return total.mul_(reciprocal(packed_by_rank.shape[0], total.device))


class SignLeaf:
    """One leaf of an exchange: ``part(a, b)`` gives, for its elements
    ``[a, b)`` (``a`` a multiple of 8), the mean over the ranks and this
    rank's compressed values, so a caller can go a chunk at a time."""

    def __init__(self, rows, scales, packed, scale):
        self.rows, self.scales, self.packed, self.scale = rows, scales, packed, scale

    def part(self, a: int, b: int):
        sl = slice(a // 8, (b + 7) // 8)
        return (rank_mean(self.rows[:, sl], self.scales, b - a),
                unpack_signs(self.packed[sl], b - a) * self.scale)


def exchange_signs(corrected: Sequence[torch.Tensor], group=None) -> List[SignLeaf]:
    """The exchange of each flat fp32 leaf of ``corrected``: its packed
    signs and scale, all leaves' in one all-gather of bytes and one of
    scales (run now, by every rank); returns each leaf's ``SignLeaf``."""
    if not corrected:
        return []
    packs, scales = zip(*[pack_signs(c) for c in corrected])
    all_packed = comm.all_gather(torch.cat(packs), group=group, tiled=False)  # [W, sum]
    all_scales = comm.all_gather(torch.stack(scales), group=group, tiled=False)  # [W, L]
    leaves, start = [], 0
    for j, (packed, scale) in enumerate(zip(packs, scales)):
        size = packed.shape[0]
        leaves.append(SignLeaf(all_packed[:, start:start + size], all_scales[:, j], packed,
                               scale))
        start += size
    return leaves


def compressed_allreduce(x: torch.Tensor, error: torch.Tensor,
                         group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-compensated compressed allreduce of the flat ``x`` with
    this rank's residual ``error`` over ``group`` (mesh axes, as
    ``comm.all_gather``): ``(mean over the ranks [N], new error [N])``."""
    avg, err = compressed_allreduce_tree([x], [error], group)
    return avg[0], err[0]


def compressed_allreduce_tree(tensors: Sequence[torch.Tensor], errors: Sequence[torch.Tensor],
                              group=None) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The allreduce of each leaf of ``tensors`` (each raveled, its signs
    and scale its own) with its residual in ``errors``, through
    ``exchange_signs``. Returns the averages and the new residuals, each in
    its leaf's shape and dtype."""
    tensors, errors = list(tensors), list(errors)
    if len(tensors) != len(errors):
        raise ValueError(
            f"compressed_allreduce_tree: {len(errors)} error buffers for {len(tensors)} "
            "leaves; the error-feedback buffers must be built from the same leaves")
    for i, (x, e) in enumerate(zip(tensors, errors)):
        if tuple(x.shape) != tuple(e.shape):
            raise ValueError(
                f"compressed_allreduce_tree: leaf {i} has shape {tuple(x.shape)} but its "
                f"error buffer has shape {tuple(e.shape)}; error buffers must mirror the "
                "gradient leaves exactly")
    corrected = [x.reshape(-1).float() + e.reshape(-1).float() for x, e in zip(tensors, errors)]
    avgs, new_errors = [], []
    for x, e, c, leaf in zip(tensors, errors, corrected, exchange_signs(corrected, group)):
        avg, mine = leaf.part(0, c.shape[0])
        avgs.append(avg.reshape(x.shape).to(x.dtype))
        new_errors.append((c - mine).reshape(e.shape).to(e.dtype))
    return avgs, new_errors


def wire_bytes(n_elements: int, world: int, block_size: int = 256) -> dict:
    """Each rank's received bytes for one allreduce of ``n_elements`` per
    wire tier: fp32 (4 bytes an element), int8 (1 byte an element and 8
    bytes of scale and zero point a block) and the packed signs with one
    fp32 scale a rank (``compressed_bytes``, ~1/32 of fp32)."""
    packed = world * ((n_elements + 7) // 8 + 4)
    n_blocks = (n_elements + block_size - 1) // block_size
    int8 = world * (n_elements + 8 * n_blocks)
    fp32 = world * n_elements * 4
    return {"compressed_bytes": packed, "int8_bytes": int8, "fp32_bytes": fp32,
            "reduction": fp32 / packed, "int8_reduction": fp32 / int8}
