"""Wrappers of K5, the int8 layer step (``csrc/conv_q8.cu``): the
counterpart of the JAX package's int8 tier (``deconv_api_tpu/engine/
deconv.py:_up_step_q8`` around XLA's ``conv2d_q8`` and ``dense_q8``,
``ops/conv.py``, ``ops/linear.py``), which no Pallas kernel computed.

Every wrapper takes contiguous CUDA tensors of the dtypes named below and
raises on anything the kernels do not take (groups, another dtype or
layout, a CPU tensor); ``ops/q8.py``, ``ops/conv.py:conv2d_q8`` and
``ops/linear.py:dense_q8`` route CPU tensors to their plain versions, which
are also what the kernels are held against on the card.

Launch counts, one per wrapper call that launches:
- ``conv_q8``: the contraction, as the raw int32 accumulator
  (``conv2d_q8``, ``dense_q8``) or as the fused step (``conv2d_q8_fused``,
  ``dense_q8_fused``: bias fold, relu, dequantize, float32 out).  A dense
  layer of at most ``GEMV_ROWS`` rows is the split-K GEMV and its fold (two
  grid launches, one count); one of more rows, or of a reduction not a
  multiple of 16, is the conv kernel on a 1x1 image.
- ``quantize_q8``: the input quantizer (``quantize_rows``).
- ``quantize_w_q8``: the weight quantizer (``quantize_weight``), which
  writes the K-major layout the contraction reads.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from deconv_api_tpu_torch.ops import _build
from deconv_api_tpu_torch.ops.conv import spatial_pads
from deconv_api_tpu_torch.ops.cuda_pool import _stream

launches = {"conv_q8": 0, "quantize_q8": 0, "quantize_w_q8": 0}

GEMV_ROWS = 64  # a dense layer of this many rows or fewer runs the GEMV
GEMV_STEP = 256  # reduction bytes per GEMV step: a split is a multiple
GEMV_BLOCKS = 264  # the GEMV grid aimed at: two blocks per SM of the H100

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGS = {
    "conv_q8": [_P] * 5 + [_I] * 14 + [_P],
    "dense_q8": [_P] * 6 + [_I] * 6 + [_P],
    "quantize_rows_q8": [_P] * 3 + [_L] * 2 + [_P],
    "quantize_t_q8": [_P] * 3 + [_I] * 2 + [_P],
}
RAW, LINEAR, RELU = 0, 1, 2

_lib = None


def _entries():
    global _lib
    if _lib is None:
        _lib = _build.load("conv_q8", _SIGS)
    return _lib


def _check(t: torch.Tensor, what: str, dim: int, dtype=torch.int8) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: the kernel takes {dtype}, got {t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dim}-D tensor, got {tuple(t.shape)}")


def _check_finish(b: torch.Tensor, scale: torch.Tensor, cout: int, rows: int, what: str) -> None:
    _check(b, f"{what} bias", 1, torch.float32)
    _check(scale, f"{what} scale", 1, torch.float32)
    if b.shape[0] != cout or scale.shape[0] != rows:
        raise ValueError(f"{what}: bias {tuple(b.shape)} and scale {tuple(scale.shape)} do not fit "
                         f"{cout} channels and {rows} rows")


def _geometry(x_q, w_ohwi, strides, padding):
    n, h, w, cin = x_q.shape
    cout, kh, kw, wcin = w_ohwi.shape
    if wcin != cin:
        raise ValueError(f"conv_q8: kernel (Cout, KH, KW, Cin) {tuple(w_ohwi.shape)} does not take {cin} "
                         "input channels")
    sh, sw = (int(s) for s in strides)
    (pt, pb), (pl, pr) = spatial_pads((h, w), (kh, kw), (sh, sw), padding)
    ho, wo = (h + pt + pb - kh) // sh + 1, (w + pl + pr - kw) // sw + 1
    return (n, max(ho, 0), max(wo, 0), cout), (n, h, w, cin, kh, kw, cout, ho, wo, sh, sw, pt, pl)


def _conv(x_q, w_ohwi, out, b, scale, geometry, mode) -> torch.Tensor:
    if out.numel():
        rc = _entries().conv_q8(x_q.data_ptr(), w_ohwi.data_ptr(), out.data_ptr(),
                                b.data_ptr() if b is not None else None,
                                scale.data_ptr() if scale is not None else None,
                                *geometry, mode, _stream(x_q))
        _build.check(rc, "conv_q8")
        launches["conv_q8"] += 1
    return out


def conv2d_q8_kmajor(
    x_q: torch.Tensor, w_ohwi: torch.Tensor, *, strides: Sequence[int] = (1, 1), padding="SAME",
) -> torch.Tensor:
    """int8 NHWC ``x_q`` (N, H, W, Cin) by the int8 K-major kernel
    ``w_ohwi`` (Cout, KH, KW, Cin) -> the raw int32 accumulator (N, Ho, Wo,
    Cout), with XLA's strides and padding."""
    _check(x_q, "conv_q8 x", 4)
    _check(w_ohwi, "conv_q8 w", 4)
    shape, geometry = _geometry(x_q, w_ohwi, strides, padding)
    out = torch.empty(shape, dtype=torch.int32, device=x_q.device)
    return _conv(x_q, w_ohwi, out, None, None, geometry, RAW)


def conv2d_q8(
    x_q: torch.Tensor, w_q: torch.Tensor, *, strides: Sequence[int] = (1, 1), padding="SAME",
    feature_group_count: int = 1,
) -> torch.Tensor:
    """int8 NHWC ``x_q`` by int8 HWIO ``w_q`` (KH, KW, Cin, Cout) -> the raw
    int32 accumulator: the kernel turned K-major, then
    ``conv2d_q8_kmajor``."""
    if feature_group_count != 1:
        raise ValueError(f"conv_q8 takes no groups, got feature_group_count={feature_group_count}")
    _check(x_q, "conv_q8 x", 4)
    _check(w_q, "conv_q8 w", 4)
    if w_q.shape[2] != x_q.shape[3]:
        raise ValueError(f"conv_q8: kernel {tuple(w_q.shape)} does not take {x_q.shape[3]} input channels")
    return conv2d_q8_kmajor(x_q, w_q.permute(3, 0, 1, 2).contiguous(), strides=strides, padding=padding)


def conv2d_q8_fused(
    x_q: torch.Tensor, w_ohwi: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, *, relu: bool,
    strides: Sequence[int] = (1, 1), padding="SAME",
) -> torch.Tensor:
    """The int8 conv step after the input quantize: int8 NHWC ``x_q`` by
    the int8 K-major ``w_ohwi``, the float32 bias ``b`` (Cout,) folded at
    each row's ``scale`` (N,) = sx * sw, relu on the int32 when ``relu``,
    dequantized -> float32 (N, Ho, Wo, Cout)."""
    _check(x_q, "conv_q8 x", 4)
    _check(w_ohwi, "conv_q8 w", 4)
    shape, geometry = _geometry(x_q, w_ohwi, strides, padding)
    _check_finish(b, scale, shape[3], shape[0], "conv_q8")
    out = torch.empty(shape, dtype=torch.float32, device=x_q.device)
    return _conv(x_q, w_ohwi, out, b, scale, geometry, RELU if relu else LINEAR)


def gemv_plan(rows: int, din: int, dout: int) -> tuple[int, int]:
    """(splits, reduction bytes per split) of the dense GEMV: enough splits
    that the grid reaches GEMV_BLOCKS, each a multiple of GEMV_STEP."""
    tiles = -(-dout // 64) * -(-rows // 8)
    steps = -(-din // GEMV_STEP)
    splits = max(1, min(steps, -(-GEMV_BLOCKS // tiles)))
    kper = -(-steps // splits) * GEMV_STEP
    return -(-din // kper), kper


def _dense(x_q, w_t, b, scale, mode) -> torch.Tensor:
    (rows, din), dout = x_q.shape, w_t.shape[0]
    dtype = torch.int32 if mode == RAW else torch.float32
    if rows > GEMV_ROWS or din % 16 or x_q.data_ptr() % 16 or w_t.data_ptr() % 16:
        out = torch.empty((rows, 1, 1, dout), dtype=dtype, device=x_q.device)
        geometry = (rows, 1, 1, din, 1, 1, dout, 1, 1, 1, 1, 0, 0)
        return _conv(x_q.view(rows, 1, 1, din), w_t.view(dout, 1, 1, din), out, b, scale, geometry,
                     mode).view(rows, dout)
    out = torch.empty((rows, dout), dtype=dtype, device=x_q.device)
    if out.numel():
        splits, kper = gemv_plan(rows, din, dout)
        ws = torch.empty((splits, rows, dout), dtype=torch.int32, device=x_q.device)
        rc = _entries().dense_q8(x_q.data_ptr(), w_t.data_ptr(), out.data_ptr(),
                                 b.data_ptr() if b is not None else None,
                                 scale.data_ptr() if scale is not None else None, ws.data_ptr(),
                                 rows, din, dout, splits, kper, mode, _stream(x_q))
        _build.check(rc, "dense_q8")
        launches["conv_q8"] += 1
    return out


def _check_dense(x_q, w_t) -> None:
    _check(x_q, "dense_q8 x", 2)
    _check(w_t, "dense_q8 w", 2)
    if w_t.shape[1] != x_q.shape[1]:
        raise ValueError(f"dense_q8: kernel (out, in) {tuple(w_t.shape)} does not take {x_q.shape[1]} inputs")


def dense_q8(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 (B, Din) by int8 (Din, Dout) -> the raw int32 accumulator (B,
    Dout): the kernel transposed K-major, then the GEMV (or the conv kernel
    on a 1x1 image)."""
    _check(x_q, "dense_q8 x", 2)
    _check(w_q, "dense_q8 w", 2)
    if w_q.shape[0] != x_q.shape[1]:
        raise ValueError(f"dense_q8: kernel {tuple(w_q.shape)} does not take {x_q.shape[1]} inputs")
    return dense_q8_kmajor(x_q, w_q.T.contiguous())


def dense_q8_kmajor(x_q: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """int8 (B, Din) by the int8 K-major kernel ``w_t`` (Dout, Din) -> the
    raw int32 accumulator (B, Dout)."""
    _check_dense(x_q, w_t)
    return _dense(x_q, w_t, None, None, RAW)


def dense_q8_fused(x_q: torch.Tensor, w_t: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, *,
                   relu: bool) -> torch.Tensor:
    """The int8 dense step after the input quantize, as ``conv2d_q8_fused``:
    ``w_t`` (Dout, Din) K-major -> float32 (B, Dout)."""
    _check_dense(x_q, w_t)
    _check_finish(b, scale, w_t.shape[0], x_q.shape[0], "dense_q8")
    return _dense(x_q, w_t, b, scale, RELU if relu else LINEAR)


def quantize_rows(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` (B, ...) -> int8 ``clip(rint(x / sx[b]), +-127)`` per
    batch row b, ``sx`` (B,) float32."""
    _check(x, "quantize_q8 x", x.dim(), torch.float32)
    _check(sx, "quantize_q8 scale", 1, torch.float32)
    if x.dim() < 1 or sx.shape[0] != x.shape[0]:
        raise ValueError(f"quantize_q8: {sx.shape[0]} scales for {tuple(x.shape)}")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if out.numel():
        rows = x.shape[0]
        rc = _entries().quantize_rows_q8(x.data_ptr(), sx.data_ptr(), out.data_ptr(), rows, x.numel() // rows,
                                         _stream(x))
        _build.check(rc, "quantize_rows_q8")
        launches["quantize_q8"] += 1
    return out


def quantize_weight(w: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """float32 HWIO conv kernel (KH, KW, Cin, Cout), or dense kernel (Din,
    Dout), -> its int8 ``clip(rint(w / sw), +-127)`` K-major: (Cout, KH,
    KW, Cin), or (Dout, Din).  ``sw`` a one-element float32 tensor."""
    if w.dim() not in (2, 4):
        raise ValueError(f"quantize_w_q8: expected a 2-D or 4-D kernel, got {tuple(w.shape)}")
    _check(w, "quantize_w_q8 w", w.dim(), torch.float32)
    _check(sw.reshape(-1), "quantize_w_q8 scale", 1, torch.float32)
    if sw.numel() != 1:
        raise ValueError(f"quantize_w_q8: one scale, got {tuple(sw.shape)}")
    cout = w.shape[-1]
    r = w.numel() // cout if cout else 0
    out = torch.empty((cout, *w.shape[:-1]), dtype=torch.int8, device=w.device)
    if out.numel():
        rc = _entries().quantize_t_q8(w.data_ptr(), sw.data_ptr(), out.data_ptr(), r, cout, _stream(w))
        _build.check(rc, "quantize_t_q8")
        launches["quantize_w_q8"] += 1
    return out
