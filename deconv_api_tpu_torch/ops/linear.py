"""Dense layers, their backward projection, and (un)flatten (counterpart of
``deconv_api_tpu/ops/linear.py``).  Flatten keeps the (H, W, C) order that
Keras dense weights assume, which holds because activations stay NHWC."""

from __future__ import annotations

import math
from typing import Sequence

import torch


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ W + b`` with W shaped (in, out)."""
    y = x @ w
    return y if b is None else y + b


def dense_q8_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``dense_q8``'s plain version: the product in float64 (exact for
    int8 operands at any real width), cast to int32."""
    return (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)


def dense_q8(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Int8 forward dense with int32 accumulation: int8 (B, in) by int8
    (in, out) to the raw int32 accumulator
    (``deconv_api_tpu/ops/linear.py:dense_q8``).  A CUDA tensor launches the
    int8 conv kernel as a 1x1 conv (``ops/cuda_q8.py``) or raises; a CPU
    tensor runs the plain version."""
    if x_q.is_cuda:
        from deconv_api_tpu_torch.ops import cuda_q8

        return cuda_q8.dense_q8(x_q.contiguous(), w_q.contiguous())
    return dense_q8_plain(x_q, w_q)


def dense_input_backward(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Deconvnet backward projection of a dense layer: ``y @ W.T``, no bias."""
    return y @ w.T


def flatten(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*W*C), channels-last row-major."""
    return x.reshape(x.shape[0], -1)


def unflatten(y: torch.Tensor, spatial_shape: Sequence[int]) -> torch.Tensor:
    spatial_shape = tuple(int(d) for d in spatial_shape)
    if math.prod(spatial_shape) != math.prod(y.shape[1:]):
        raise ValueError(f"cannot unflatten {tuple(y.shape)} into {spatial_shape}")
    return y.reshape((y.shape[0], *spatial_shape))
