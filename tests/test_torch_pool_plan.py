"""Launch plans of the pool and unpool kernels (``ops/cuda_pool.py``), on
the CPU: vector width, the scalar path, the grid's coverage of every pooled
pixel, channel vector and output element, and the 32-bit limits.  Pure
Python at tiny sizes; the kernels themselves are tested on the card in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest

from deconv_api_tpu_torch.ops import cuda_pool
from deconv_api_tpu_torch.ops.cuda_pool import pool_plan, unpool_plan

F32, BF16 = 4, 2  # bytes per element


def _threads(plan, bands_w, channels):
    """(batch row, pooled row, pooled col, first channel) of every thread
    that does work, decoded from the grid as the kernels decode it."""
    cvecs = channels // plan.lanes
    gx, gy, gz = plan.grid
    t = np.arange(gx * plan.threads)
    t = t[t < bands_w * cvecs]
    pc, ch = t // cvecs, (t % cvecs) * plan.lanes
    return [(z, y, int(c), int(k)) for z in range(gz) for y in range(gy) for c, k in zip(pc, ch)]


@pytest.mark.parametrize("itemsize,lanes", [(F32, 4), (BF16, 8)])
def test_vector_width_by_dtype(itemsize, lanes):
    assert pool_plan((2, 8, 8, 64), itemsize, (2, 2), 0).lanes == lanes
    assert unpool_plan((8, 4, 4, 64), 64, itemsize, (2, 2), (8, 8), 256, 512).lanes == lanes
    assert unpool_plan((8, 4, 4, 512), 64, itemsize, (2, 2), (8, 8), 256, 512).lanes == lanes


@pytest.mark.parametrize(
    "what,itemsize,channels,switch_channels,pool_size,y_ptr,idx_ptr",
    [
        ("ragged C", BF16, 12, 12, (2, 2), 0, 0),
        ("ragged C", F32, 70, 70, (2, 2), 0, 0),
        ("ragged C", F32, 3, 3, (2, 2), 0, 0),
        ("ragged C/groups", BF16, 48, 6, (2, 2), 0, 0),
        ("ragged C/groups", F32, 24, 6, (2, 2), 0, 0),
        ("misaligned signal", BF16, 64, 64, (2, 2), 2, 0),
        ("misaligned signal", F32, 64, 64, (2, 2), 8, 0),
        ("misaligned switches", BF16, 64, 64, (2, 2), 0, 4),
        ("misaligned switches", F32, 64, 64, (2, 2), 0, 2),
        ("window 3x2", F32, 64, 64, (3, 2), 0, 0),
        ("window 1x2", BF16, 64, 64, (1, 2), 0, 0),
    ],
)
def test_scalar_path(what, itemsize, channels, switch_channels, pool_size, y_ptr, idx_ptr):
    ph, pw = pool_size
    plan = unpool_plan((2, 3, 4, channels), switch_channels, itemsize, pool_size, (3 * ph, 4 * pw), y_ptr, idx_ptr)
    assert plan.lanes == 1, what
    if switch_channels == channels and idx_ptr == 0:
        assert pool_plan((2, 3 * ph, 4 * pw, channels), itemsize, pool_size, y_ptr).lanes == 1, what


def test_aligned_switches_need_only_the_lane_count():
    """A switch vector is 8 bytes (bf16) or 4 (fp32): that alignment is enough."""
    assert unpool_plan((2, 3, 4, 64), 64, BF16, (2, 2), (6, 8), 0, 8).lanes == 8
    assert unpool_plan((2, 3, 4, 64), 64, F32, (2, 2), (6, 8), 0, 4).lanes == 4


@pytest.mark.parametrize(
    "shape,itemsize,pool_size",
    [((2, 9, 11, 16), F32, (2, 2)), ((1, 8, 6, 64), BF16, (2, 2)), ((2, 7, 5, 3), BF16, (3, 2)),
     ((1, 4, 40, 32), F32, (2, 2)), ((3, 2, 2, 1), F32, (1, 1))],
)
def test_pool_grid_covers_every_pooled_pixel_and_vector_once(shape, itemsize, pool_size):
    b, h, w, c = shape
    ho, wo = h // pool_size[0], w // pool_size[1]
    plan = pool_plan(shape, itemsize, pool_size, 0)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= cuda_pool.MAX_THREADS
    assert plan.grid[1:] == (ho, b)
    row = wo * c // plan.lanes
    assert (plan.grid[0] - 1) * plan.threads < row <= plan.grid[0] * plan.threads
    got = _threads(plan, wo, c)
    want = [(z, y, x, k) for z in range(b) for y in range(ho) for x in range(wo) for k in range(0, c, plan.lanes)]
    assert sorted(got) == want


@pytest.mark.parametrize(
    "y_shape,switch_channels,itemsize,pool_size,pad",
    [((2, 3, 5, 16), 16, F32, (2, 2), (0, 0)), ((2, 3, 5, 16), 16, BF16, (2, 2), (1, 1)),
     ((1, 4, 3, 24), 8, BF16, (2, 2), (1, 0)), ((2, 3, 2, 6), 3, F32, (3, 2), (2, 1)),
     ((1, 2, 3, 5), 5, BF16, (1, 2), (0, 1)), ((1, 2, 9, 64), 64, F32, (2, 2), (0, 1))],
)
def test_unpool_grid_covers_every_output_element_once(y_shape, switch_channels, itemsize, pool_size, pad):
    """Each thread writes its window's slots inside out_hw, one lane vector
    each; the threads past the pooled extent write out_hw's padding."""
    n, ho, wo, c = y_shape
    ph, pw = pool_size
    hout, wout = ho * ph + pad[0], wo * pw + pad[1]
    plan = unpool_plan(y_shape, switch_channels, itemsize, pool_size, (hout, wout), 0, 0)
    bands_w = wo + (pad[1] > 0)
    assert plan.grid[1:] == (ho + (pad[0] > 0), n)
    row = bands_w * c // plan.lanes
    assert (plan.grid[0] - 1) * plan.threads < row <= plan.grid[0] * plan.threads
    writes = np.zeros((n, hout, wout, c), np.int64)
    for z, pr, pc, ch in _threads(plan, bands_w, c):
        rows = slice(pr * ph, min((pr + 1) * ph, hout))
        cols = slice(pc * pw, min((pc + 1) * pw, wout))
        writes[z, rows, cols, ch : ch + plan.lanes] += 1
    assert (writes == 1).all()


def test_unpool_plan_refuses_outputs_past_32_bit_indexing():
    """The output is ph*pw times the signal: a signal of 2^29 elements
    unpools to 2^31, one past the kernels' 32-bit indexing."""
    with pytest.raises(ValueError, match="32-bit"):
        unpool_plan((1, 16384, 16384, 2), 2, BF16, (2, 2), (32768, 32768), 0, 0)
    with pytest.raises(ValueError, match="32-bit"):
        unpool_plan((1, 16384, 16384, 2), 2, BF16, (2, 2), (32769, 32768), 0, 0)
    plan = unpool_plan((1, 16383, 16384, 2), 2, BF16, (2, 2), (32766, 32768), 0, 0)
    assert plan.grid[1] == 16383


def test_plans_refuse_grids_past_the_y_and_z_limits():
    with pytest.raises(ValueError, match="grid"):
        pool_plan((cuda_pool.GRID_YZ_MAX + 1, 2, 2, 4), F32, (2, 2), 0)
    with pytest.raises(ValueError, match="grid"):
        unpool_plan((1, cuda_pool.GRID_YZ_MAX + 1, 1, 4), 4, F32, (2, 2), (2 * cuda_pool.GRID_YZ_MAX + 2, 2), 0, 0)
