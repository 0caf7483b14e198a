"""Layers (counterparts of paddle_tpu/nn and fleet/mp_layers)."""
from .layers import ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding
from .norm import RMSNorm
