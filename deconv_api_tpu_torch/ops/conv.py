"""2-D convolution and its deconvnet backward projection (NHWC / HWIO).

Counterpart of ``deconv_api_tpu/ops/conv.py``.  A contiguous NHWC tensor
permuted to (N, C, H, W) is an NCHW tensor in ``channels_last`` memory
format, so ``F.conv2d`` runs on it without a copy and the output permutes
back to contiguous NHWC.  Only the stride-1 path exists in this slice;
strided convs arrive with the DAG models.  The grouped backward projection
is the channel-packed ("kpack") tail's: cuDNN runs it on the card, as XLA
ran it outside any Pallas kernel in the reference.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _padding(w: torch.Tensor, padding: str):
    kh, kw = int(w.shape[0]), int(w.shape[1])
    if padding == "VALID":
        return 0
    if padding == "SAME" and kh % 2 == 1 and kw % 2 == 1:
        return (kh // 2, kw // 2)
    raise NotImplementedError(
        f"padding {padding!r} with a {kh}x{kw} kernel is not ported "
        "(only SAME with odd kernels, or VALID)"
    )


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    strides: Sequence[int] = (1, 1),
    padding: str = "SAME",
    groups: int = 1,
) -> torch.Tensor:
    """Forward convolution: NHWC input, HWIO kernel (input channels per
    group), optional bias; ``groups`` splits the channels into contiguous
    blocks, as XLA's ``feature_group_count`` does."""
    if tuple(strides) != (1, 1):
        raise NotImplementedError(
            f"strided conv {tuple(strides)} is not ported yet"
        )
    y = F.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
        padding=_padding(w, padding), groups=groups,
    )
    return y.permute(0, 2, 3, 1).contiguous()


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
    padding: str = "SAME",
    input_hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Deconvnet backward projection of a stride-1 SAME odd-kernel conv:
    the flipped-kernel convolution, no bias.  ``input_hw`` must equal the
    signal's extent on this path (kept for the reference's signature)."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    if (
        tuple(strides) != (1, 1)
        or padding != "SAME"
        or kh % 2 == 0
        or kw % 2 == 0
        or (input_hw is not None and tuple(input_hw) != tuple(y.shape[1:3]))
    ):
        raise NotImplementedError(
            "only the stride-1 SAME odd-kernel backward projection is "
            "ported; strided transposes arrive with the DAG models"
        )
    return conv2d(y, flip_kernel(w))
