"""Wrapper of the int8 convolution kernel, K5 (``csrc/conv_q8.cu``): the
counterpart of XLA's ``conv2d_q8`` and ``dense_q8`` in the JAX package
(``deconv_api_tpu/ops/conv.py``, ``ops/linear.py``), which no Pallas kernel
computed.

Both wrappers take contiguous int8 CUDA tensors only and return the raw
int32 accumulator; they raise on anything the kernel does not take (groups,
another dtype, a CPU tensor).  ``ops/conv.py:conv2d_q8`` and
``ops/linear.py:dense_q8`` route CPU tensors to their plain versions, which
are also what the kernel is held against on the card.  A dense layer is the
same kernel as a 1x1 conv over a 1x1 image; both count under ``conv_q8``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from deconv_api_tpu_torch.ops import _build
from deconv_api_tpu_torch.ops.conv import spatial_pads
from deconv_api_tpu_torch.ops.cuda_pool import _stream

launches = {"conv_q8": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = [_P, _P, _P] + [_I] * 13 + [_P]

_entry = None


def _conv_q8_entry():
    global _entry
    if _entry is None:
        _entry = _build.load("conv_q8", {"conv_q8": _SIG}).conv_q8
    return _entry


def _check(t: torch.Tensor, what: str, dim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int8:
        raise TypeError(f"{what}: the int8 kernel takes int8, got {t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dim}-D tensor, got {tuple(t.shape)}")


def _launch(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, geometry: Sequence[int]) -> None:
    if out.numel():
        rc = _conv_q8_entry()(x.data_ptr(), w.data_ptr(), out.data_ptr(), *geometry, _stream(x))
        _build.check(rc, "conv_q8")
        launches["conv_q8"] += 1


def conv2d_q8(
    x_q: torch.Tensor, w_q: torch.Tensor, *, strides: Sequence[int] = (1, 1), padding="SAME",
    feature_group_count: int = 1,
) -> torch.Tensor:
    """int8 NHWC ``x_q`` (N, H, W, Cin) by int8 HWIO ``w_q`` (KH, KW, Cin,
    Cout) -> the int32 accumulator (N, Ho, Wo, Cout), with XLA's strides
    and padding."""
    if feature_group_count != 1:
        raise ValueError(f"conv_q8 takes no groups, got feature_group_count={feature_group_count}")
    _check(x_q, "conv_q8 x", 4)
    _check(w_q, "conv_q8 w", 4)
    n, h, w, cin = x_q.shape
    kh, kw, wcin, cout = w_q.shape
    if wcin != cin:
        raise ValueError(f"conv_q8: kernel {tuple(w_q.shape)} does not take {cin} input channels")
    sh, sw = (int(s) for s in strides)
    (pt, pb), (pl, pr) = spatial_pads((h, w), (kh, kw), (sh, sw), padding)
    ho, wo = (h + pt + pb - kh) // sh + 1, (w + pl + pr - kw) // sw + 1
    out = torch.empty((n, max(ho, 0), max(wo, 0), cout), dtype=torch.int32, device=x_q.device)
    _launch(x_q, w_q, out, (n, h, w, cin, kh, kw, cout, ho, wo, sh, sw, pt, pl))
    return out


def dense_q8(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 (B, Din) by int8 (Din, Dout) -> the int32 accumulator (B,
    Dout): the conv kernel on a 1x1 image."""
    _check(x_q, "dense_q8 x", 2)
    _check(w_q, "dense_q8 w", 2)
    (b, din), (wdin, dout) = x_q.shape, w_q.shape
    if wdin != din:
        raise ValueError(f"dense_q8: kernel {tuple(w_q.shape)} does not take {din} inputs")
    out = torch.empty((b, dout), dtype=torch.int32, device=x_q.device)
    _launch(x_q, w_q, out, (b, 1, 1, din, 1, 1, dout, 1, 1, 1, 1, 0, 0))
    return out
