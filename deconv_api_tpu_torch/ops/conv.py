"""2-D convolution and its deconvnet backward projection (NHWC / HWIO).

Counterpart of ``deconv_api_tpu/ops/conv.py``.  A contiguous NHWC tensor
permuted to (N, C, H, W) is an NCHW tensor in ``channels_last`` memory
format, so ``F.conv2d`` runs on it without a copy, returns ``channels_last``
too, and the output permutes back to contiguous NHWC without a copy either.
Padding follows XLA: ``"VALID"``, ``"SAME"`` for any stride (the odd cell of
an uneven total at the end), or explicit ``((lo, hi), (lo, hi))`` pairs;
uneven pads go through ``F.pad``, since ``F.conv2d`` pads both sides alike.
The grouped backward projection is the channel-packed ("kpack") tail's:
cuDNN runs it on the card, as XLA ran it outside any Pallas kernel in the
reference.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

Pads = tuple[tuple[int, int], tuple[int, int]]


def spatial_pads(
    in_hw: Sequence[int], kernel_hw: Sequence[int], strides: Sequence[int], padding
) -> Pads:
    """XLA's per-axis (lo, hi) padding of a window op: ``VALID`` none,
    ``SAME`` a total of ``max((ceil(n/s) - 1)*s + k - n, 0)`` with the odd
    cell at the end, explicit pairs as given."""
    if isinstance(padding, str):
        if padding == "VALID":
            return ((0, 0), (0, 0))
        if padding != "SAME":
            raise ValueError(f"unknown padding {padding!r}; expected 'SAME', 'VALID' or (lo, hi) pairs")
        pads = []
        for n, k, s in zip(in_hw, kernel_hw, strides):
            total = max((math.ceil(n / s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    (t, b), (l, r) = padding
    return ((int(t), int(b)), (int(l), int(r)))


def pad_nchw(x: torch.Tensor, pads: Pads, value: float = 0.0):
    """NCHW ``x`` and the (h, w) padding left for the op itself: symmetric
    pads stay with the op, uneven ones are applied here with ``F.pad``."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    strides: Sequence[int] = (1, 1),
    padding="SAME",
    groups: int = 1,
) -> torch.Tensor:
    """Forward convolution: NHWC input, HWIO kernel (input channels per
    group), optional bias.  ``groups`` is XLA's ``feature_group_count``: it
    splits the channels into contiguous blocks, so a depthwise kernel
    (kh, kw, 1, C) with ``groups=C`` is MobileNet's depthwise conv."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    xn, pad = pad_nchw(
        x.permute(0, 3, 1, 2), spatial_pads(x.shape[1:3], (kh, kw), strides, padding)
    )
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), b, stride=tuple(strides), padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_q8_plain(
    x_q: torch.Tensor, w_q: torch.Tensor, *, strides: Sequence[int] = (1, 1), padding="SAME",
    feature_group_count: int = 1,
) -> torch.Tensor:
    """``conv2d_q8``'s plain version: the contraction in float64, cast to
    int32.  Exact: every partial sum is an integer of at most 127^2 times
    the reduction depth, far below 2^53."""
    y = conv2d(x_q.to(torch.float64), w_q.to(torch.float64), strides=strides, padding=padding,
               groups=feature_group_count)
    return y.to(torch.int32)


def conv2d_q8(
    x_q: torch.Tensor, w_q: torch.Tensor, *, strides: Sequence[int] = (1, 1), padding="SAME",
    feature_group_count: int = 1,
) -> torch.Tensor:
    """Int8 forward convolution with int32 accumulation: int8 NHWC ``x_q``
    and HWIO ``w_q``, already quantized by the caller, to the raw int32
    accumulator (``deconv_api_tpu/ops/conv.py:conv2d_q8``).  The bias fold,
    the activation and the dequantisation are the caller's.  A CUDA tensor
    launches the hand-written kernel (``ops/cuda_q8.py``, no groups) or
    raises; a CPU tensor runs the plain version."""
    if x_q.is_cuda:
        from deconv_api_tpu_torch.ops import cuda_q8

        return cuda_q8.conv2d_q8(x_q.contiguous(), w_q.contiguous(), strides=strides, padding=padding,
                                 feature_group_count=feature_group_count)
    return conv2d_q8_plain(x_q, w_q, strides=strides, padding=padding, feature_group_count=feature_group_count)


def flip_kernel(w: torch.Tensor) -> torch.Tensor:
    """Swap an HWIO kernel's in/out channels and flip both spatial axes:
    the Zeiler–Fergus backward kernel ``W' = flip_hw(W^T)``."""
    return w.permute(0, 1, 3, 2).flip(0, 1)


def tile_kernel_groups(w: torch.Tensor, groups: int) -> torch.Tensor:
    """Tile an HWIO kernel ``groups`` times along its output channels: the
    kernel of a grouped conv in which every group applies the same
    weights (output block g reads input block g)."""
    if groups <= 1:
        return w
    return torch.cat([w] * groups, dim=3)


def conv2d_input_backward_grouped(
    y: torch.Tensor, w: torch.Tensor, groups: int
) -> torch.Tensor:
    """Deconvnet backward projection of ``groups`` signals packed
    group-major into the channels: ``y`` (B, H, W, groups*Cout), signal g
    at channels ``[g*Cout, (g+1)*Cout)``, ``w`` the unflipped forward HWIO
    kernel (kh, kw, Cin, Cout) that every group shares -> (B, H, W,
    groups*Cin).  Stride-1 SAME odd kernels only (the kpack
    certification)."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    assert kh % 2 == 1 and kw % 2 == 1, (
        "grouped backward projection is only defined for odd SAME "
        "stride-1 kernels (the kpack certification)"
    )
    return conv2d(y, tile_kernel_groups(flip_kernel(w), groups), groups=groups)


def conv2d_input_backward(
    y: torch.Tensor,
    w: torch.Tensor,
    *,
    strides: Sequence[int] = (1, 1),
    padding="SAME",
    input_hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Deconvnet backward projection of a conv layer, no bias: the
    flipped-kernel conv for a stride-1 SAME odd kernel, otherwise the
    exact linear transpose of ``conv2d`` (a transposed conv over the padded
    input, cropped back).  ``input_hw`` is the forward input's extent where
    the stride does not divide it; it defaults to ``(Ho * sh, Wo * sw)``."""
    sh, sw = (int(s) for s in strides)
    kh, kw = int(w.shape[0]), int(w.shape[1])
    if (sh, sw) == (1, 1) and padding == "SAME" and kh % 2 == 1 and kw % 2 == 1:
        if input_hw is not None and tuple(input_hw) != tuple(y.shape[1:3]):
            raise ValueError(f"a stride-1 SAME conv keeps its extent; got input_hw {input_hw} for {tuple(y.shape)}")
        return conv2d(y, flip_kernel(w))
    h, wd = input_hw if input_hw is not None else (y.shape[1] * sh, y.shape[2] * sw)
    (t, b), (l, r) = spatial_pads((h, wd), (kh, kw), (sh, sw), padding)
    full_h, full_w = h + t + b, wd + l + r
    # the forward over the padded input yields (full - k) // s + 1 rows; the
    # transposed conv gives back (ho - 1) * s + k of them, the rest is padding
    out_pad = (full_h - ((y.shape[1] - 1) * sh + kh), full_w - ((y.shape[2] - 1) * sw + kw))
    if (full_h - kh) // sh + 1 != y.shape[1] or (full_w - kw) // sw + 1 != y.shape[2]:
        raise ValueError(
            f"signal {tuple(y.shape)} is not the output of a {kh}x{kw} stride-{(sh, sw)} "
            f"conv over {(h, wd)} with padding {padding!r}"
        )
    xn = F.conv_transpose2d(
        y.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=(sh, sw), output_padding=out_pad
    )
    return xn[:, :, t : t + h, l : l + wd].permute(0, 2, 3, 1).contiguous()
