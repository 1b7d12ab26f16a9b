"""Wrappers of the pool/unpool CUDA kernels (counterparts of
``deconv_api_tpu/ops/pallas_pool.py``).

Each wrapper takes contiguous NHWC CUDA tensors only and raises on anything
its kernel does not take; ``ops/pool.py`` routes CPU tensors to the plain
versions.  ``launches`` counts kernel launches per wrapper, so a run can
show that its path went through the kernels; a grouped (channel-packed)
unpool counts under its own name.
"""

from __future__ import annotations

import ctypes

import torch

from deconv_api_tpu_torch.ops import _build
from deconv_api_tpu_torch.ops.pool import check_groups, switch_rep

launches = {"pool_argmax": 0, "unpool_argmax": 0, "unpool_argmax_grouped": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_POOL_SIG = [_P, _P, _P, _L, _I, _I, _I, _I, _I, _P]
_UNPOOL_SIG = [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_nhwc(t: torch.Tensor, what: str, dtypes=tuple(_SUFFIX)) -> None:
    """Raise unless ``t`` is a contiguous 4-D CUDA tensor of an accepted
    dtype whose element count fits the kernels' 32-bit indexing."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {list(dtypes)}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{what}: expected contiguous 4-D NHWC, got {tuple(t.shape)}")
    if t.numel() >= 2**31:
        raise ValueError(f"{what}: {t.numel()} elements exceed 32-bit indexing")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pool_argmax(
    x: torch.Tensor, pool_size: tuple[int, int] = (2, 2)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pooled, int8 idx) by ``csrc/pool_argmax.cu``."""
    check_nhwc(x, "pool_argmax x")
    ph, pw = pool_size
    b, h, w, c = x.shape
    pooled = torch.empty((b, h // ph, w // pw, c), dtype=x.dtype, device=x.device)
    idx = torch.empty(pooled.shape, dtype=torch.int8, device=x.device)
    if pooled.numel():
        lib = _build.load(
            "pool_argmax", {"pool_argmax_f32": _POOL_SIG, "pool_argmax_bf16": _POOL_SIG}
        )
        fn = getattr(lib, f"pool_argmax_{_SUFFIX[x.dtype]}")
        rc = fn(x.data_ptr(), pooled.data_ptr(), idx.data_ptr(), b, h, w, c, ph, pw, _stream(x))
        _build.check(rc, "pool_argmax")
        launches["pool_argmax"] += 1
    return pooled, idx


def unpool_argmax(
    y: torch.Tensor,
    idx: torch.Tensor,
    pool_size: tuple[int, int] = (2, 2),
    out_hw: tuple[int, int] | None = None,
    relu: bool = False,
    groups: int = 1,
) -> torch.Tensor:
    """Switch unpool by ``csrc/unpool_argmax.cu``; ``idx`` may carry a
    batch that divides y's (each switch block serves ``rep`` rows) and
    1/``groups`` of its channels (every packed group reads the same
    switches)."""
    check_nhwc(y, "unpool_argmax y")
    check_nhwc(idx, "unpool_argmax idx", (torch.int8,))
    ph, pw = pool_size
    n, ho, wo, c = y.shape
    if tuple(idx.shape[1:3]) != (ho, wo):
        raise ValueError(f"switches {tuple(idx.shape)} do not match signal {tuple(y.shape)}")
    check_groups(c, idx.shape[3], groups)
    rep = switch_rep(n, idx.shape[0])
    hout, wout = out_hw if out_hw is not None else (ho * ph, wo * pw)
    if not (ho * ph <= hout < (ho + 1) * ph and wo * pw <= wout < (wo + 1) * pw):
        raise ValueError(f"out_hw {out_hw} is not a floor-pooled extent of {(ho, wo)}")
    out = torch.empty((n, hout, wout, c), dtype=y.dtype, device=y.device)
    if out.numel():
        lib = _build.load(
            "unpool_argmax",
            {"unpool_argmax_f32": _UNPOOL_SIG, "unpool_argmax_bf16": _UNPOOL_SIG},
        )
        fn = getattr(lib, f"unpool_argmax_{_SUFFIX[y.dtype]}")
        rc = fn(
            y.data_ptr(), idx.data_ptr(), out.data_ptr(), n, ho, wo, c, hout, wout,
            ph, pw, rep, groups, int(relu), _stream(y),
        )
        _build.check(rc, "unpool_argmax")
        launches["unpool_argmax_grouped" if groups > 1 else "unpool_argmax"] += 1
    return out
