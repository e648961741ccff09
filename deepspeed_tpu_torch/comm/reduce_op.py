"""ReduceOp (port of ``deepspeed_tpu/comm/reduce_op.py``), with its map
onto ``torch.distributed.ReduceOp``."""

from enum import Enum


class ReduceOp(Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    BAND = 4
    BOR = 5
    BXOR = 6
    AVG = 7
    UNUSED = 8


def to_torch(op: ReduceOp):
    """The ``torch.distributed.ReduceOp`` of ``op``. AVG has none here: the
    collectives sum and divide by the group's size, as JAX's ``pmean``."""
    import torch.distributed as dist
    table = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
             ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.BAND: dist.ReduceOp.BAND, ReduceOp.BOR: dist.ReduceOp.BOR,
             ReduceOp.BXOR: dist.ReduceOp.BXOR}
    if op not in table:
        raise NotImplementedError(f"ReduceOp {op} has no torch.distributed counterpart")
    return table[op]
