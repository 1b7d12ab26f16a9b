"""Max-pooling with int8 argmax switches, and switch-guided unpooling.

Counterpart of ``deconv_api_tpu/ops/pool.py``.  The public ops dispatch on
the tensor's device: a CUDA tensor launches the hand-written kernel
(``ops/cuda_pool.py``, ``csrc/pool_argmax.cu`` and ``csrc/unpool_argmax.cu``)
or raises; a CPU tensor runs the plain PyTorch version below, which is also
what the kernels are held against on the card.

Batches: the backward signal carries B·K rows, image-major (row ``b*K + k``),
while the switches keep the forward batch B, so signal row ``i`` reads
switch block ``i // rep`` with ``rep = K``.  Groups: in the channel-packed
("kpack") tail the signal carries ``groups`` projections group-major in its
channels (C_y = groups * C_idx) and every group reads the same switch
channel ``ch % C_idx``.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _pool_hw(pool_size: Sequence[int]) -> tuple[int, int]:
    return int(pool_size[0]), int(pool_size[1])


def switch_rep(y_batch: int, idx_batch: int) -> int:
    """Signal rows per switch block; raises unless the batches divide."""
    if idx_batch <= 0 or y_batch % idx_batch:
        raise ValueError(
            f"signal batch {y_batch} is not a multiple of switch batch {idx_batch}"
        )
    return y_batch // idx_batch


def check_groups(cy: int, ci: int, groups: int) -> None:
    """Raise unless the signal's ``cy`` channels are ``groups`` blocks of
    the switches' ``ci``."""
    if groups < 1 or cy != groups * ci:
        raise ValueError(
            f"packed unpool: {cy} signal channels are not {groups} groups "
            f"of the {ci}-channel switch index"
        )


def maxpool_argmax_plain(
    x: torch.Tensor, pool_size: Sequence[int] = (2, 2)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-overlapping max-pool -> (pooled, int8 row-major window argmax).

    Walks the window in row-major order with a strict ``>``, so the first
    maximum wins, exactly as the kernel does.  Odd trailing rows and cols
    are floor-dropped."""
    ph, pw = _pool_hw(pool_size)
    b, h, w, c = x.shape
    ho, wo = h // ph, w // pw
    win = x[:, : ho * ph, : wo * pw, :].reshape(b, ho, ph, wo, pw, c)
    best = win[:, :, 0, :, 0, :]
    idx = torch.zeros(best.shape, dtype=torch.int8, device=x.device)
    for di in range(ph):
        for dj in range(pw):
            if di == 0 and dj == 0:
                continue
            cand = win[:, :, di, :, dj, :]
            take = cand > best
            best = torch.where(take, cand, best)
            idx = torch.where(take, torch.full_like(idx, di * pw + dj), idx)
    return best.contiguous(), idx


def unpool_argmax_plain(
    y: torch.Tensor,
    idx: torch.Tensor,
    pool_size: Sequence[int] = (2, 2),
    out_hw: tuple[int, int] | None = None,
    fuse_relu: bool = False,
    groups: int = 1,
) -> torch.Tensor:
    """Scatter each pooled value to its window's argmax slot, zeros
    elsewhere; ``out_hw`` zero-pads back the floor-dropped rows/cols,
    ``fuse_relu`` applies the deconvnet backward ReLU first, and the
    switch mask broadcasts across ``groups`` packed signals."""
    ph, pw = _pool_hw(pool_size)
    b, ho, wo, c = y.shape
    rep = switch_rep(b, idx.shape[0])
    check_groups(c, idx.shape[-1], groups)
    if fuse_relu:
        y = torch.relu(y)
    if rep > 1:
        idx = idx.repeat_interleave(rep, dim=0)
    pos = (
        torch.arange(ph, device=y.device)[:, None] * pw
        + torch.arange(pw, device=y.device)[None, :]
    ).to(idx.dtype)
    # (B, Ho, ph, Wo, pw, 1, Ci): the group axis rides the broadcast
    mask = idx[:, :, None, :, None, None, :] == pos[None, None, :, None, :, None, None]
    yg = y.reshape(b, ho, wo, groups, c // groups)
    up = (yg[:, :, None, :, None] * mask.to(y.dtype)).reshape(
        b, ho * ph, wo * pw, c
    )
    if out_hw is not None and tuple(out_hw) != (ho * ph, wo * pw):
        up = torch.nn.functional.pad(
            up, (0, 0, 0, out_hw[1] - wo * pw, 0, out_hw[0] - ho * ph)
        )
    return up


def maxpool_with_argmax(
    x: torch.Tensor, pool_size: Sequence[int] = (2, 2)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pooled, int8 idx): the kernel on CUDA, the plain version on CPU."""
    if x.is_cuda:
        from deconv_api_tpu_torch.ops import cuda_pool

        return cuda_pool.pool_argmax(x.contiguous(), _pool_hw(pool_size))
    return maxpool_argmax_plain(x, pool_size)


def unpool_with_argmax(
    y: torch.Tensor,
    idx: torch.Tensor,
    pool_size: Sequence[int] = (2, 2),
    out_hw: tuple[int, int] | None = None,
    fuse_relu: bool = False,
    groups: int = 1,
) -> torch.Tensor:
    """Switch unpool: the kernel on CUDA, the plain version on CPU."""
    if y.is_cuda:
        from deconv_api_tpu_torch.ops import cuda_pool

        return cuda_pool.unpool_argmax(
            y.contiguous(), idx.contiguous(), _pool_hw(pool_size), out_hw,
            fuse_relu, groups,
        )
    return unpool_argmax_plain(y, idx, pool_size, out_hw, fuse_relu, groups)
