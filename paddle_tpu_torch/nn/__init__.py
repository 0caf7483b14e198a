"""Layers (counterparts of paddle_tpu/nn and fleet/mp_layers)."""
from .clip import ClipGradByGlobalNorm
from .layers import (ColumnParallelLinear, Dropout, Embedding,
                     RowParallelLinear, VocabParallelEmbedding)
from .norm import LayerNorm, RMSNorm
