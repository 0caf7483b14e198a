"""Dtype names -> torch dtypes (counterpart of paddle_tpu/core/dtype.py)."""
from __future__ import annotations

import torch

_NAME_TO_DTYPE = {
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "fp32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "fp64": torch.float64, "double": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def convert_dtype(dtype) -> torch.dtype:
    """A dtype name or torch dtype as a torch.dtype; None means float32,
    the reference's default dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _NAME_TO_DTYPE[dtype]
    except KeyError:
        raise ValueError(f"Unknown dtype: {dtype!r}") from None
