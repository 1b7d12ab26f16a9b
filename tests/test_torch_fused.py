"""The fused unpool + flipped-conv step of the port
(deconv_api_tpu_torch/ops/cuda_deconv.py) against the JAX package's.

On the CPU the fused op runs its plain version (the unfused pair), held
against the JAX ``_mxu_kernel`` body in interpret mode and against the JAX
pair, in fp32 within 1e-5 of the largest reference magnitude (another
summation order over kh*kw*Cout terms).  Asymmetric random kernels keep a
wrong flip direction visible."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deconv_api_tpu.ops import pallas_deconv
from deconv_api_tpu.ops.conv import conv2d_input_backward as j_conv_back
from deconv_api_tpu.ops.pool import unpool_with_argmax as j_unpool
from deconv_api_tpu_torch.ops import cuda_deconv

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(bi, rep, ho, wo, cout, cin, k, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((bi * rep, ho, wo, cout)).astype(np.float32)
    idx = rng.integers(0, 4, (bi, ho, wo, cout)).astype(np.int8)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    return y, idx, w


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize(
    "rep,relu,k",
    [(4, True, 3), (3, False, 3), (2, True, 5)],
)
def test_fused_matches_jax_mxu_body_and_pair(rep, relu, k):
    y, idx, w = _inputs(2, rep, 4, 3, 6, 5, k, seed=rep * 10 + k + relu)
    got = cuda_deconv.fused_unpool_backward(
        torch.from_numpy(y), torch.from_numpy(idx), torch.from_numpy(w),
        (2, 2), fuse_relu=relu, mode="forced",
    ).numpy()
    jy, jidx, jw = jnp.asarray(y), jnp.asarray(idx), jnp.asarray(w)
    mxu = pallas_deconv.fused_pallas_call(
        jy, jidx, jw, (2, 2), relu=relu, impl="mxu", interpret=True
    )
    pair = j_conv_back(
        j_unpool(jy, jnp.repeat(jidx, rep, axis=0), (2, 2), fuse_relu=relu), jw
    )
    _close(got, mxu)
    _close(got, pair)


def test_uncertified_site_runs_the_pair():
    """An odd unpooled extent fails certification: the op computes the pair
    with the out_hw zero padding, on any policy."""
    y, idx, w = _inputs(1, 2, 3, 4, 4, 3, 3, seed=9)
    out_hw = (7, 9)
    args = (torch.from_numpy(y), torch.from_numpy(idx), torch.from_numpy(w), (2, 2), out_hw)
    assert not cuda_deconv.fused_supported(y.shape, idx.shape, w.shape, (2, 2), out_hw)
    got = cuda_deconv.fused_unpool_backward(*args, fuse_relu=True, mode="forced")
    pair = j_conv_back(
        j_unpool(jnp.asarray(y), jnp.repeat(jnp.asarray(idx), 2, axis=0), (2, 2), out_hw, fuse_relu=True),
        jnp.asarray(w),
    )
    _close(got.numpy(), pair)
    assert got.shape == (2, 7, 9, 3)


@pytest.mark.parametrize(
    "y_shape,idx_shape,w_shape,out_hw,ok",
    [
        ((8, 4, 4, 6), (2, 4, 4, 6), (3, 3, 5, 6), None, True),
        ((8, 4, 4, 6), (2, 4, 4, 6), (3, 3, 5, 6), (8, 8), True),
        ((8, 4, 4, 6), (3, 4, 4, 6), (3, 3, 5, 6), None, False),  # batch
        ((8, 4, 4, 6), (2, 4, 4, 6), (2, 2, 5, 6), None, False),  # even kernel
        ((8, 4, 4, 6), (2, 4, 4, 6), (3, 3, 5, 7), None, False),  # Cout
        ((8, 4, 4, 6), (2, 4, 4, 6), (3, 3, 5, 6), (9, 8), False),  # extent
    ],
)
def test_fused_supported(y_shape, idx_shape, w_shape, out_hw, ok):
    assert cuda_deconv.fused_supported(y_shape, idx_shape, w_shape, (2, 2), out_hw) is ok


def test_policy_vocabulary_and_engagement():
    resolve = cuda_deconv.resolve_fused_unpool
    assert [resolve(p) for p in ("off", "", "0", "no", "AUTO", "forced")] == [
        "off", "off", "off", "off", "auto", "forced",
    ]
    for bad in (True, "sometimes"):
        with pytest.raises(ValueError):
            resolve(bad)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert cuda_deconv.fused_engaged("auto", cuda) and not cuda_deconv.fused_engaged("auto", cpu)
    assert cuda_deconv.fused_engaged("forced", cpu)
    assert not cuda_deconv.fused_engaged("off", cuda)


def test_fused_kernel_wrapper_refuses_cpu_tensors():
    y, idx, w = _inputs(1, 1, 2, 2, 4, 3, 3, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_deconv.fused_unpool_conv(torch.from_numpy(y), torch.from_numpy(idx), torch.from_numpy(w))


def _main_path_sites():
    """The fused sites of chip_smoke.py: the four of a batch-8 top-4
    ``POST /`` and the two packed ones of ``/v1/deconv`` (top-8, 8 groups)."""
    import chip_smoke

    b, k, kg = chip_smoke.B, chip_smoke.K, chip_smoke.KG
    for ho, wo, cout, cin in chip_smoke.FUSED_SITES:
        yield f"POST / {ho}x{wo}", (b * k, ho, wo, cout), (b, ho, wo, cout), (3, 3, cin, cout), 1
    for name, (ho, wo, cout, cin) in chip_smoke.PACKED_SITES.items():
        yield name, (b, ho, wo, kg * cout), (b, ho, wo, cout), (3, 3, cin, cout), kg


@pytest.mark.parametrize("site", list(_main_path_sites()), ids=lambda s: s[0])
def test_main_path_sites_are_certified_and_tiled(site):
    """Every main-path site stays certified, and the tensor-core kernel's
    launch plan covers its GEMM (M rows, N = Cin) within shared memory."""
    _, y_shape, idx_shape, w_shape, groups = site
    assert cuda_deconv.fused_supported(y_shape, idx_shape, w_shape, (2, 2), None, groups)
    n, ho, wo, _ = y_shape
    kh, kw, cin, _ = w_shape
    h, w = 2 * ho, 2 * wo
    plan = cuda_deconv.tile_plan(n, h, w, groups, cin, w_shape[3], kh, kw)
    assert plan is not None
    assert plan.tile_r * plan.tile_c == cuda_deconv.TC_ROWS and plan.bn in (64, 128)
    assert plan.tile_r % cuda_deconv.TC_SUB == 0 and plan.tile_c % cuda_deconv.TC_SUB == 0
    tiles = (-(-h // plan.tile_r), -(-w // plan.tile_c), -(-cin // plan.bn))
    assert tiles[0] * plan.tile_r >= h and tiles[1] * plan.tile_c >= w and tiles[2] * plan.bn >= cin
    assert plan.blocks == n * groups * tiles[0] * tiles[1] * tiles[2] < 2**31
    assert plan.blocks * plan.tile_r * plan.tile_c * plan.bn >= n * h * w * groups * cin
    assert plan.smem_bytes <= 227 * 1024


def test_tile_plan_falls_back_when_the_halo_does_not_fit():
    """A kernel too wide for the halo tiles gets no tensor-core plan (the
    wrapper then launches the CUDA-core kernel); a 7-tap one still fits."""
    assert cuda_deconv.tile_plan(2, 28, 28, 1, 512, 512, 9, 9) is None
    assert cuda_deconv.tile_plan(1, 6, 6, 1, 8, 8, 19, 19) is None
    plan = cuda_deconv.tile_plan(2, 28, 28, 1, 512, 512, 7, 7)
    assert plan is not None and plan.smem_bytes <= cuda_deconv.SMEM_LIMIT


def test_tile_plan_prefers_the_patch_that_fits_the_extent():
    """Of the 256-row patches, the one that wastes the fewest rows past the
    edge (56 = 7 x 8 columns), then the one with the smallest halo."""

    def patch(*site):
        plan = cuda_deconv.tile_plan(*site)
        return plan.tile_r, plan.tile_c, plan.bn

    assert patch(8, 224, 224, 8, 64, 64, 3, 3) == (16, 16, 64)
    assert patch(32, 56, 56, 1, 256, 256, 3, 3) == (8, 32, 128)
    assert patch(32, 28, 28, 1, 512, 512, 3, 3) == (16, 16, 128)
