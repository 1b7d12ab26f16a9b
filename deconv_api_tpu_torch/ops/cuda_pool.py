"""Wrappers of the pool/unpool CUDA kernels (counterparts of
``deconv_api_tpu/ops/pallas_pool.py``).

Each wrapper takes contiguous NHWC CUDA tensors only and raises on anything
its kernel does not take; ``ops/pool.py`` routes CPU tensors to the plain
versions.  ``launches`` counts kernel launches per wrapper, so a run can
show that its path went through the kernels; a grouped (channel-packed)
unpool counts under its own name.

Both kernels take their launch geometry from a plan computed here
(``pool_plan``, ``unpool_plan``): one thread per pooled pixel and per
16-byte channel vector (the vector path), or per channel (the scalar path,
for ragged channels, misaligned pointers and windows other than 2x2); a
grid of (blocks over pooled columns x channel vectors, pooled rows, batch
rows).  The unpool's stores stream (``st.global.cs``, evict first).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from deconv_api_tpu_torch.ops import _build
from deconv_api_tpu_torch.ops.pool import check_groups, switch_rep

launches = {"pool_argmax": 0, "unpool_argmax": 0, "unpool_argmax_grouped": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# + the launch plan: lanes, threads, grid x, y, z
_POOL_SIG = [_P, _P, _P, _L, _I, _I, _I, _I, _I, _P] + [_I] * 5
_UNPOOL_SIG = [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P] + [_I] * 5
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

VECTOR_BYTES = 16  # one thread's channel vector on the vector path
MAX_THREADS = 256  # per block
GRID_YZ_MAX = 65535  # CUDA's limit on gridDim.y and gridDim.z
INDEX_LIMIT = 2**31  # the kernels index elements in 32 bits


@dataclass(frozen=True)
class PoolPlan:
    """A launch of the pool or unpool kernel: ``lanes`` channels per thread
    (16 bytes' worth on the vector path, 1 on the scalar path), ``threads``
    per block, ``grid`` = (blocks over pooled columns x channel vectors,
    pooled rows, batch rows)."""

    lanes: int
    threads: int
    grid: tuple[int, int, int]


def _vector_lanes(itemsize: int, pool_size, channels: int, value_ptrs, switch_ptrs) -> int:
    """Channels per thread: 16 bytes' worth when the window is 2x2, every
    vector lies inside ``channels`` (the switch channels: one group's), the
    value pointers are 16-byte aligned and the switch pointers aligned to
    the lane count; else 1.  A pointer may be given as its residue modulo
    VECTOR_BYTES."""
    lanes = VECTOR_BYTES // itemsize
    ok = (
        tuple(pool_size) == (2, 2)
        and channels % lanes == 0
        and all(p % VECTOR_BYTES == 0 for p in value_ptrs)
        and all(p % lanes == 0 for p in switch_ptrs)
    )
    return lanes if ok else 1


def _plan(rows: int, bands_h: int, bands_w: int, channels: int, lanes: int) -> PoolPlan:
    """Blocks of at most MAX_THREADS threads, a multiple of 32, spread
    evenly over one pooled row's bands_w x channels/lanes threads."""
    if rows > GRID_YZ_MAX or bands_h > GRID_YZ_MAX:
        raise ValueError(f"{rows} rows of {bands_h} pooled rows exceed the grid's y/z limit")
    row = bands_w * (channels // lanes)
    blocks = -(-row // MAX_THREADS)
    per_block = -(-row // max(blocks, 1))
    threads = max(32, -(-per_block // 32) * 32)
    return PoolPlan(lanes, threads, (blocks, bands_h, rows))


@functools.lru_cache(maxsize=256)
def pool_plan(x_shape, itemsize: int, pool_size, x_ptr: int) -> PoolPlan:
    """The pool kernel's launch for an NHWC input of ``x_shape``: one
    thread per pooled pixel (trailing rows and cols that fill no window
    have none) and channel vector.  The outputs are fresh allocations, so
    only the input's alignment matters; the wrapper passes its pointer
    modulo VECTOR_BYTES, so plans cache by shape.  Inside a CUDA graph the
    plan is taken once, at the capture: that is sound because a graph
    replays on the addresses it was captured with (``engine/capture.py``),
    so the alignment the plan read holds on every replay."""
    b, h, w, c = x_shape
    ph, pw = pool_size
    lanes = _vector_lanes(itemsize, pool_size, c, (x_ptr,), ())
    return _plan(b, h // ph, w // pw, c, lanes)


@functools.lru_cache(maxsize=256)
def unpool_plan(
    y_shape, switch_channels: int, itemsize: int, pool_size, out_hw, y_ptr: int, idx_ptr: int
) -> PoolPlan:
    """The unpool kernel's launch for an NHWC signal of ``y_shape`` whose
    switches carry ``switch_channels`` (one group's) and an output of
    ``out_hw``: one thread per pooled pixel and channel vector, plus one
    band of threads for a padded row and one for a padded column of
    ``out_hw``, which write its zeros.  Raises when the output has 2^31
    elements or more.  Pointers may be given modulo VECTOR_BYTES."""
    n, ho, wo, c = y_shape
    ph, pw = pool_size
    hout, wout = out_hw
    if n * hout * wout * c >= INDEX_LIMIT:
        raise ValueError(
            f"unpool_argmax out: {n * hout * wout * c} elements exceed 32-bit indexing"
        )
    lanes = _vector_lanes(itemsize, pool_size, switch_channels, (y_ptr,), (idx_ptr,))
    bands_h = ho + (hout > ho * ph)
    bands_w = wo + (wout > wo * pw)
    return _plan(n, bands_h, bands_w, c, lanes)


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
    """The current CUDA stream of ``t``'s device as a raw handle (what
    ``torch.cuda.current_stream(d).cuda_stream`` gives, without building a
    Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


_entries: dict = {}  # (kernel, dtype) -> its C entry


def _entry(kernel: str, signature: list, dtype: torch.dtype):
    """The C entry ``<kernel>_<f32|bf16>``, built and loaded at first use."""
    fn = _entries.get((kernel, dtype))
    if fn is None:
        lib = _build.load(kernel, {f"{kernel}_{sfx}": signature for sfx in _SUFFIX.values()})
        fn = _entries[(kernel, dtype)] = getattr(lib, f"{kernel}_{_SUFFIX[dtype]}")
    return fn


def pool_argmax(
    x: torch.Tensor, pool_size: tuple[int, int] = (2, 2)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pooled, int8 idx) by ``csrc/pool_argmax.cu``.  The batch is one
    grid dimension, so it takes at most 65535 rows (GRID_YZ_MAX), and as
    many pooled rows."""
    check_nhwc(x, "pool_argmax x")
    ph, pw = pool_size
    b, h, w, c = x.shape
    plan = pool_plan(x.shape, x.element_size(), (ph, pw), x.data_ptr() % VECTOR_BYTES)
    pooled = torch.empty((b, h // ph, w // pw, c), dtype=x.dtype, device=x.device)
    idx = torch.empty(pooled.shape, dtype=torch.int8, device=x.device)
    if pooled.numel():
        rc = _entry("pool_argmax", _POOL_SIG, x.dtype)(
            x.data_ptr(), pooled.data_ptr(), idx.data_ptr(), b, h, w, c, ph, pw, _stream(x),
            plan.lanes, plan.threads, *plan.grid,
        )
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
    switches).  y's batch rows (B*K on the main path) are one grid
    dimension, so it takes at most 65535 of them (GRID_YZ_MAX), and as
    many pooled rows."""
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
    plan = unpool_plan(
        y.shape, idx.shape[3], y.element_size(), (ph, pw), (hout, wout),
        y.data_ptr() % VECTOR_BYTES, idx.data_ptr() % VECTOR_BYTES,
    )
    out = torch.empty((n, hout, wout, c), dtype=y.dtype, device=y.device)
    if out.numel():
        rc = _entry("unpool_argmax", _UNPOOL_SIG, y.dtype)(
            y.data_ptr(), idx.data_ptr(), out.data_ptr(), n, ho, wo, c, hout, wout,
            ph, pw, rep, groups, int(relu), _stream(y),
            plan.lanes, plan.threads, *plan.grid,
        )
        _build.check(rc, "unpool_argmax")
        launches["unpool_argmax_grouped" if groups > 1 else "unpool_argmax"] += 1
    return out
