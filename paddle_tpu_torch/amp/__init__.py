"""AMP: `auto_cast` (counterpart of paddle_tpu/amp/__init__.py).

Level O1 only: the ops on the white list run in the low-precision dtype
(bfloat16 by default), those on the black list in float32, parameters stay
float32. O2 (`decorate`, low-precision parameters with float32 master
weights in the optimizer) is a later slice (ROADMAP queue 1).
"""
from __future__ import annotations

import contextlib

from ..core.dtype import convert_dtype
from .state import BLACK_LIST, WHITE_LIST, amp_state, cast_inputs

__all__ = ["auto_cast", "amp_state", "cast_inputs", "WHITE_LIST",
           "BLACK_LIST"]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    if enable and level != "O1":
        raise NotImplementedError(
            f"auto_cast level {level!r}: the port has O1 only; O2 and "
            "decorate() are the ROADMAP item 'amp O2'")
    st = amp_state()
    prev = (st.enabled, st.dtype, st.custom_white, st.custom_black)
    st.enabled = bool(enable)
    st.dtype = convert_dtype(dtype)
    st.custom_white = frozenset(custom_white_list or ())
    st.custom_black = frozenset(custom_black_list or ())
    try:
        yield
    finally:
        st.enabled, st.dtype, st.custom_white, st.custom_black = prev
