"""Collectives over the named mesh (port of ``deepspeed_tpu/comm``):
``comm.py`` (the functional API over ``torch.distributed``), ``mesh.py``
(the named mesh and its axis groups), ``reduce_op.py`` and
``comms_logging.py``, and the gradient wire's buckets and tiers
(``bucketing.py``) and 1-bit compression (``compressed.py``).
``exchange_host_state`` is not ported yet."""

from .comm import *  # noqa: F401,F403
from .comm import (all_reduce, all_gather, all_gather_into_tensor, reduce_scatter,
                   reduce_scatter_tensor, all_to_all, all_to_all_single, broadcast, barrier,
                   init_distributed, is_initialized, get_world_size, get_rank, get_local_rank,
                   get_axis_index, ppermute, inference_all_reduce, initialize_mesh_device,
                   log_summary, configure, CommHandle, mpi_discovery, parse_slurm_nodelist)
from .mesh import (MeshContext, get_mesh_context, set_mesh_context, reset_mesh_context,
                   mesh_is_initialized, resolve_axis_sizes, MESH_AXES)
from .reduce_op import ReduceOp
