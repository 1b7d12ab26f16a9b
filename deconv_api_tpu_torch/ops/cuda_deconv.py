"""Fused switch-unpool + flipped-conv backward step (counterpart of
``deconv_api_tpu/ops/pallas_deconv.py``).

``fused_unpool_backward`` computes

    conv2d_input_backward(unpool_with_argmax(y, idx, pool, out_hw, fuse_relu), w)

On a certified site with the policy engaged, a CUDA tensor launches
``csrc/fused_unpool_conv.cu`` and a CPU tensor runs the plain version, which
is that pair.  Any other site runs the pair itself: on the card the unpool
is the ``unpool_argmax`` kernel and the conv is ``F.conv2d``, as XLA did
that conv outside any Pallas kernel in the reference.  The launch counters
show which branch ran.

Policy vocabulary (the reference's): ``off`` never fuses, ``auto`` fuses on
CUDA, ``forced`` fuses on every device.  TPU measurements set the
reference's default to off; they decide nothing here.  The port's default
is ``ServerConfig.fused_unpool`` (``FUSED_DEFAULT`` names it for the engine),
set by the measurement on the H100 that ``PERF.md`` records.

``groups > 1`` is the channel-packed ("kpack") form: ``y`` carries
``groups`` projections group-major in its channels, ``idx`` the switches of
one, and every group goes through the same flipped kernel.  Its launches
count under ``fused_unpool_conv_grouped``.

bf16 runs on the tensor cores with the launch plan of ``tile_plan``; fp32,
and a bf16 site too wide for that kernel's tiles, run on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Sequence

import torch

from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.ops import _build
from deconv_api_tpu_torch.ops.conv import (
    conv2d_input_backward,
    conv2d_input_backward_grouped,
    flip_kernel,
)
from deconv_api_tpu_torch.ops.cuda_pool import _stream, check_nhwc
from deconv_api_tpu_torch.ops.pool import (
    switch_rep,
    unpool_argmax_plain,
    unpool_with_argmax,
)

FUSED_MODES = ("off", "auto", "forced")
FUSED_DEFAULT = ServerConfig.fused_unpool  # the engine's and the service's fused_unpool
launches = {"fused_unpool_conv": 0, "fused_unpool_conv_grouped": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = [_P, _P, _P, _P] + [_I] * 12 + [_P]
_SIG_BF16 = _SIG + [_I] * 3  # + the launch plan: tile_r, tile_c, bn

# The bf16 tensor-core kernel's tiling (csrc/fused_unpool_conv.cu, namespace
# tcore): 256 GEMM rows per block in 8 x 8 pixel sub-patches, 64-wide Cout
# chunks of 8 k-planes, a B ring of TC_STAGES steps.
TC_ROWS, TC_BK, TC_STAGES, TC_SUB = 256, 64, 4, 8
TC_PATCHES = ((16, 16), (8, 32), (32, 8))  # (tile_r, tile_c)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on the H100


@dataclass(frozen=True)
class TilePlan:
    """A launch of the bf16 tensor-core kernel: a patch of ``tile_r`` x
    ``tile_c`` output pixels of one group by ``bn`` input channels per
    block."""

    tile_r: int
    tile_c: int
    bn: int
    blocks: int
    smem_bytes: int


def _smem_bytes(bn, hrows, pooled_px, halo_bufs) -> int:
    """csrc/fused_unpool_conv.cu:tcore::layout: the B ring, the halo tiles,
    the pooled rectangle (signal and switches) and the halo pixels'
    metadata, each tile as 8 k-planes padded by 16 bytes; or the epilogue's
    output tile if larger."""
    planes = TC_BK // 8
    b_ring = TC_STAGES * planes * (bn * 16 + 16)
    halo = halo_bufs * planes * (hrows * 16 + 16)
    pooled = planes * (pooled_px * 16 + 16) + planes * (-(-pooled_px * 8 // 16) * 16 + 16)
    meta = -(-hrows * 4 // 16) * 16
    return max(b_ring + halo + pooled + meta, TC_ROWS * bn * 2)


@functools.lru_cache(maxsize=256)
def tile_plan(n, h, w, groups, cin, cout, kh, kw, ph=2, pw=2) -> TilePlan | None:
    """The tensor-core kernel's tiling of an unpooled (n, h, w) extent with
    ``groups`` packed groups, ``cin`` output and ``cout`` signal channels
    (two halo tiles when ``cout`` spans more than one chunk), a kh x kw
    kernel and a ph x pw pool: BN 64 for ``cin <= 64`` else 128, and among
    the patches whose tiles fit in shared memory the one that wastes the
    fewest rows past the image edge, then the one with the smallest halo
    tile, then the widest.  None when none fits; the CUDA-core kernel then
    takes the site."""
    bn = 64 if cin <= 64 else 128
    best = None
    for tr, tc in TC_PATCHES:
        hrows = (tr + kh - 1) * (tc + kw - 1)
        pooled_px = ((tr + kh - 2 + ph - 1) // ph + 1) * ((tc + kw - 2 + pw - 1) // pw + 1)
        smem = _smem_bytes(bn, hrows, pooled_px, 2 if cout > TC_BK else 1)
        covered = -(-h // tr) * tr * -(-w // tc) * tc
        key = (covered, hrows, -tc)
        if smem <= SMEM_LIMIT and (best is None or key < best[0]):
            best = (key, tr, tc, smem)
    if best is None:
        return None
    _, tr, tc, smem = best
    blocks = n * groups * -(-h // tr) * -(-w // tc) * -(-cin // bn)
    return TilePlan(tr, tc, bn, blocks, smem)


def resolve_fused_unpool(policy) -> str:
    """Validate the off|auto|forced knob ('' / '0' / 'false' / 'no' mean off)."""
    if isinstance(policy, bool):
        raise ValueError(f"illegal fused_unpool policy {policy!r}")
    p = str(policy).strip().lower()
    if p in ("", "0", "off", "false", "no"):
        return "off"
    if p in ("auto", "forced"):
        return p
    raise ValueError(
        f"illegal fused_unpool policy {policy!r}; expected 'off', 'auto' or 'forced'"
    )


def fused_engaged(mode: str, device: torch.device) -> bool:
    """Whether a resolved policy fuses on ``device`` (shape certification
    still applies per site)."""
    return mode == "forced" or (mode == "auto" and device.type == "cuda")


def fused_supported(y_shape, idx_shape, w_shape, pool_size, out_hw, groups: int = 1) -> bool:
    """Static certification of a site for the fused kernel: 4-D NHWC, an
    odd kernel (the caller asserts stride 1 and SAME), switch batch
    dividing the signal batch, the packed channel contract ``Cy == groups
    * Ci`` with ``Ci == Cout`` of the kernel, an unpooled extent of exactly
    ``(ho*ph, wo*pw)``, and every tensor within 32-bit indexing."""
    if len(y_shape) != 4 or len(idx_shape) != 4 or len(w_shape) != 4:
        return False
    b, ho, wo, cy = y_shape
    bi, hi, wi, ci = idx_shape
    kh, kw, cin, cout = w_shape
    ph, pw = int(pool_size[0]), int(pool_size[1])
    if (hi, wi) != (ho, wo) or bi <= 0 or b % bi:
        return False
    if kh % 2 == 0 or kw % 2 == 0:
        return False
    if groups < 1 or cy != groups * ci or ci != cout:
        return False
    if out_hw is not None and tuple(out_hw) != (ho * ph, wo * pw):
        return False
    return max(b * ho * wo * cy, b * ho * ph * wo * pw * groups * cin) < 2**31


def _conv_back(up: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    if groups > 1:
        return conv2d_input_backward_grouped(up, w, groups)
    return conv2d_input_backward(up, w)


def fused_plain(
    y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
    pool_size: Sequence[int] = (2, 2), fuse_relu: bool = False, groups: int = 1,
) -> torch.Tensor:
    """The plain version of the fused kernel: the unfused pair (grouped
    for ``groups > 1``)."""
    return _conv_back(unpool_argmax_plain(y, idx, pool_size, None, fuse_relu, groups), w, groups)


def fused_unpool_conv(
    y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
    pool_size: tuple[int, int] = (2, 2), relu: bool = False, groups: int = 1,
) -> torch.Tensor:
    """The kernel on a certified site: ``y`` (N, ho, wo, groups*Cout),
    ``idx`` (N/rep, ho, wo, Cout) int8, ``w`` the UNFLIPPED forward HWIO
    kernel (kh, kw, Cin, Cout) in y's dtype -> (N, ho*ph, wo*pw,
    groups*Cin)."""
    check_nhwc(y, "fused_unpool_conv y")
    check_nhwc(idx, "fused_unpool_conv idx", (torch.int8,))
    if not w.is_cuda or w.dtype != y.dtype or w.dim() != 4:
        raise TypeError(f"fused_unpool_conv w: expected a 4-D CUDA {y.dtype} kernel")
    ph, pw = pool_size
    if not fused_supported(y.shape, idx.shape, w.shape, pool_size, None, groups):
        raise ValueError(
            f"fused_unpool_conv: uncertified site y={tuple(y.shape)} "
            f"idx={tuple(idx.shape)} w={tuple(w.shape)} groups={groups}"
        )
    n, ho, wo, _ = y.shape
    kh, kw, cin, cout = w.shape
    rep = switch_rep(n, idx.shape[0])
    out = torch.empty((n, ho * ph, wo * pw, groups * cin), dtype=y.dtype, device=y.device)
    if out.numel():
        lib = _build.load(
            "fused_unpool_conv",
            {"fused_unpool_conv_f32": _SIG, "fused_unpool_conv_bf16": _SIG_BF16},
        )
        plan = None
        if y.dtype == torch.bfloat16:
            plan = tile_plan(n, ho * ph, wo * pw, groups, cin, cout, kh, kw, ph, pw)
        # the CUDA-core kernel reads the flipped kernel (kh, kw, Cout, Cin),
        # the tensor-core kernel w itself (K-major, taps reversed)
        wk = (w if plan else flip_kernel(w)).contiguous()
        args = (
            y.data_ptr(), idx.data_ptr(), wk.data_ptr(), out.data_ptr(),
            n, ho, wo, cout, cin, ph, pw, kh, kw, rep, groups, int(relu), _stream(y),
        )
        if y.dtype == torch.bfloat16:
            tiles = (plan.tile_r, plan.tile_c, plan.bn) if plan else (0, 0, 0)
            rc = lib.fused_unpool_conv_bf16(*args, *tiles)
        else:
            rc = lib.fused_unpool_conv_f32(*args)
        _build.check(rc, "fused_unpool_conv")
        launches["fused_unpool_conv_grouped" if groups > 1 else "fused_unpool_conv"] += 1
    return out


def fused_unpool_backward(
    y: torch.Tensor,
    idx: torch.Tensor,
    w: torch.Tensor,
    pool_size: Sequence[int] = (2, 2),
    out_hw: tuple[int, int] | None = None,
    fuse_relu: bool = False,
    groups: int = 1,
    mode: str = "auto",
) -> torch.Tensor:
    """Switch-unpool ``y`` through ``idx`` and project it through the
    flipped conv of ``w`` (the unflipped forward HWIO kernel) as one op
    on certified sites; see the module docstring for the branches."""
    pool_size = (int(pool_size[0]), int(pool_size[1]))
    mode = resolve_fused_unpool(mode)
    if fused_engaged(mode, y.device) and fused_supported(
        y.shape, idx.shape, w.shape, pool_size, out_hw, groups
    ):
        if y.is_cuda:
            return fused_unpool_conv(
                y.contiguous(), idx.contiguous(), w, pool_size, fuse_relu, groups
            )
        return fused_plain(y, idx, w, pool_size, fuse_relu, groups)
    up = unpool_with_argmax(y, idx, pool_size, out_hw, fuse_relu, groups)
    return _conv_back(up, w, groups)
