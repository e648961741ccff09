from .sparsity_config import (SparsityConfig, DenseSparsityConfig, FixedSparsityConfig,
                              BigBirdSparsityConfig, BSLongformerSparsityConfig,
                              VariableSparsityConfig)
from .sparse_self_attention import SparseSelfAttention, sparse_attention
from .splash import splash_sparse_attention, splash_flops, build_block_table
