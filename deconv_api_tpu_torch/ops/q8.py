"""The int8 layer step of the int8 execution tier (counterpart of the
JAX package's ``deconv_api_tpu/engine/deconv.py:_up_step_q8`` body).

For each batch row with input scale ``sx`` and the kernel's scale ``sw``:
``xq = clip(rint(x / sx), +-127)`` (a float32 division, not a multiply by
the reciprocal; round half to even), the contraction int8 x int8 -> int32,
``bq = clip(rint(b / scale), +-2^30)`` at ``scale = sx * sw``, ``acc +
bq``, relu on the int32 where the activation is relu, and ``float(acc) *
scale``; an activation that is not int8-safe applies after the dequantize.

The weight arrives quantized and K-major (``quantize_weight``): a conv
kernel as (Cout, KH, KW, Cin), a dense one as (Dout, Din), the layouts K5's
contraction reads.  A CUDA tensor runs K5 (``ops/cuda_q8.py``: the input
quantizer, then the contraction with the fold, relu and dequantize in its
epilogue) or raises; a CPU tensor runs the plain version, op by op, which
is also what the kernels are held against on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch

from deconv_api_tpu_torch.ops.activations import apply_activation, int8_safe_activation
from deconv_api_tpu_torch.ops.conv import conv2d_q8_plain
from deconv_api_tpu_torch.ops.linear import dense_q8_plain
from deconv_api_tpu_torch.utils.quantize import Q8_LEVELS

BIAS_CLIP = 2.0**30  # the folded bias's range: the int32 add cannot wrap


def q8_scale(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale ``amax / 127`` (1.0 where amax is 0), a
    float32 division by a tensor: PyTorch's CUDA division by a CPU scalar
    multiplies by its reciprocal instead, which can round differently."""
    levels = torch.full_like(amax, Q8_LEVELS)
    return torch.where(amax > 0, amax, levels) / levels


def row_amax(x: torch.Tensor) -> torch.Tensor:
    """Each batch row's max-abs as a (B,) tensor, in one reduction:
    ``max(-min, max)`` equals ``max|x|`` exactly."""
    lo, hi = torch.aminmax(x.reshape(x.shape[0], -1), dim=1)
    return torch.maximum(-lo, hi)


def _rows(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.reshape(-1, *[1] * (dim - 1))


def quantize_rows_plain(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` (B, ...) -> int8 at the (B,) scales ``sx``: the input
    quantizer's plain version."""
    return torch.clamp(torch.round(x / _rows(sx, x.dim())), -Q8_LEVELS, Q8_LEVELS).to(torch.int8)


def quantize_weight_plain(w: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """The weight quantizer's plain version: ``quantize_weight``'s int8
    K-major kernel at the scale ``sw``."""
    wq = torch.clamp(torch.round(w / sw), -Q8_LEVELS, Q8_LEVELS).to(torch.int8)
    return wq.permute(3, 0, 1, 2).contiguous() if w.dim() == 4 else wq.T.contiguous()


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A float32 HWIO conv kernel, or (Din, Dout) dense kernel -> (its int8
    K-major form, (Cout, KH, KW, Cin) or (Dout, Din); its 0-d scale ``sw =
    max|w| / 127``)."""
    sw = q8_scale(row_amax(w.reshape(1, -1))[0])
    if w.is_cuda:
        from deconv_api_tpu_torch.ops import cuda_q8

        return cuda_q8.quantize_weight(w.contiguous(), sw), sw
    return quantize_weight_plain(w, sw), sw


def finish_plain(acc: torch.Tensor, scale: torch.Tensor, b: torch.Tensor, activation: str) -> torch.Tensor:
    """The fused contraction's epilogue, op by op: the int32 accumulator
    ``acc`` (B, ..., Cout), each row's ``scale`` (B,) = sx * sw and the
    float32 bias -> float32."""
    scale = _rows(scale, acc.dim())
    bq = torch.clamp(torch.round(b / scale), -BIAS_CLIP, BIAS_CLIP).to(torch.int32)
    acc = acc + bq
    if int8_safe_activation(activation):
        if activation == "relu":
            acc = torch.clamp_min(acc, 0)
        return acc.float() * scale
    return apply_activation(acc.float() * scale, activation)


def conv2d_q8_step_plain(x, sx, wq, sw, b, activation, strides=(1, 1), padding="SAME"):
    acc = conv2d_q8_plain(quantize_rows_plain(x, sx), wq.permute(1, 2, 3, 0), strides=strides, padding=padding)
    return finish_plain(acc, sx * sw, b, activation)


def dense_q8_step_plain(x, sx, wq, sw, b, activation):
    return finish_plain(dense_q8_plain(quantize_rows_plain(x, sx), wq.T), sx * sw, b, activation)


def _after(y: torch.Tensor, activation: str) -> torch.Tensor:
    return y if int8_safe_activation(activation) else apply_activation(y, activation)


def conv2d_q8_step(
    x: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, b: torch.Tensor, activation: str,
    strides: Sequence[int] = (1, 1), padding="SAME",
) -> torch.Tensor:
    """One int8 conv layer: float32 NHWC ``x`` at the (B,) input scales
    ``sx``, the K-major int8 kernel ``wq`` (Cout, KH, KW, Cin) at ``sw``,
    the float32 bias ``b`` -> float32 NHWC, XLA's strides and padding."""
    if x.is_cuda:
        from deconv_api_tpu_torch.ops import cuda_q8

        x_q = cuda_q8.quantize_rows(x.contiguous(), sx.contiguous())
        y = cuda_q8.conv2d_q8_fused(x_q, wq, b.contiguous(), (sx * sw).contiguous(), relu=activation == "relu",
                                    strides=strides, padding=padding)
        return _after(y, activation)
    return conv2d_q8_step_plain(x, sx, wq, sw, b, activation, strides, padding)


def dense_q8_step(
    x: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, b: torch.Tensor, activation: str,
) -> torch.Tensor:
    """One int8 dense layer, as ``conv2d_q8_step``: float32 (B, Din), the
    K-major int8 kernel ``wq`` (Dout, Din) -> float32 (B, Dout)."""
    if x.is_cuda:
        from deconv_api_tpu_torch.ops import cuda_q8

        x_q = cuda_q8.quantize_rows(x.contiguous(), sx.contiguous())
        y = cuda_q8.dense_q8_fused(x_q, wq, b.contiguous(), (sx * sw).contiguous(), relu=activation == "relu")
        return _after(y, activation)
    return dense_q8_step_plain(x, sx, wq, sw, b, activation)
