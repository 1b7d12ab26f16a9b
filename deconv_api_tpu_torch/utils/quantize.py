"""The symmetric-int8 convention (a copy of ``deconv_api_tpu/utils/
quantize.py``): the widest value maps onto +-127 (never -128, which would
break w == -w symmetry), and an all-zero tensor keeps scale 1.0 (no
division by zero; it dequantizes back to exact zeros)."""

from __future__ import annotations

Q8_LEVELS = 127.0


def int8_scale(amax: float) -> float:
    """The symmetric-int8 scale for a tensor with max-abs ``amax``: the one
    place the amax -> scale rule lives."""
    return float(amax) / Q8_LEVELS if amax > 0 else 1.0
