"""Automatic mixed precision state, consulted by the port's ops (counterpart
of paddle_tpu/amp/state.py).

The reference casts at op dispatch: under `auto_cast`, an op on the white
list gets its float32 tensor inputs cast to the low-precision dtype, an op on
the black list gets its bfloat16/float16 inputs cast to float32, and every
other op runs on what it is given (type promotion then decides: bf16 + fp32
is fp32 in both frameworks). The port keeps the same thread-local state and
each op that the lists name calls `cast_inputs` with its own name.
`torch.autocast` is not used: its lists differ from the reference's (for
example for layer_norm's output and for gelu).

The lists are the reference's (paddle_tpu/ops/ops.yaml, the reduction,
linalg and nn_ops groups' amp_white / amp_black).

Level O2: the reference's rule casts every op that is not black to the
low-precision dtype (amp/state.py:65), but its dispatcher consults the rule
only for ops that have a category (ops/registry.py:290), so O2 casts
exactly the ops O1 casts; custom lists, likewise, re-file only ops that
have one. What O2 changes is the parameters: `amp.decorate` makes them
bf16, so the embeddings, the residual stream, GELU and dropout run in bf16
because their inputs are bf16, not because an op casts them.
"""
from __future__ import annotations

import threading

import torch

WHITE_LIST = frozenset({
    "matmul", "mm", "bmm", "addmm", "mv", "einsum",
    "linear", "conv2d", "conv1d", "conv2d_transpose",
    "scaled_dot_product_attention",
})
BLACK_LIST = frozenset({
    "logsumexp", "sum", "mean",
    "norm", "cholesky", "qr", "svd", "eig", "eigh", "inverse", "pinv", "det",
    "slogdet", "solve", "triangular_solve", "lstsq", "lu", "lu_unpack",
    "matrix_exp", "matrix_norm", "vector_norm", "householder_product",
    "ormqr",
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "layer_norm",
    "rms_norm", "batch_norm", "group_norm", "instance_norm", "mse_loss",
    "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "cosine_similarity",
    "sigmoid_focal_loss",
})
_LOW = (torch.bfloat16, torch.float16)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = frozenset()
        self.custom_black = frozenset()


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def category(op_name: str):
    """'white', 'black' or None for an op under the current lists (None for
    an op that neither list names, whatever the custom lists say)."""
    if op_name not in WHITE_LIST and op_name not in BLACK_LIST:
        return None
    if op_name in _state.custom_white:
        return "white"
    if op_name in _state.custom_black:
        return "black"
    if op_name in WHITE_LIST:
        return "white"
    if op_name in BLACK_LIST:
        return "black"
    return None


def cast_inputs(op_name: str, *tensors):
    """The op's tensor inputs as the reference's dispatch casts them (None
    and non-float entries pass through); unchanged when amp is off."""
    if not _state.enabled:
        return tensors
    cat = category(op_name)
    if cat == "white":      # O1 and O2 alike (see the module note)
        target, froms = _state.dtype, (torch.float32,)
    elif cat == "black":
        target, froms = torch.float32, _LOW
    else:
        return tensors
    return tuple(t.to(target) if torch.is_tensor(t) and t.dtype in froms
                 else t for t in tensors)
