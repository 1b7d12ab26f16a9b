"""The port's batched visualizer (deconv_api_tpu_torch/engine/deconv.py)
against the JAX package's ``get_visualizer(..., batched=True)`` on vgg_tiny.

The same params (JAX init, carried across by ``params_from_jax``) and the
same numpy images go through both.  Bars: selected indices and validity
equal; fp32 projections within 1e-4 of the largest reference magnitude;
deprocessed 2x2 grids at >= 65 dB PSNR for an fp32 backward and >= 52 dB
for a bf16 backward, the JAX package's own bars
(tests/test_full_depth_parity.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deconv_api_tpu.engine.deconv import get_visualizer as j_get_visualizer
from deconv_api_tpu.models.tiny import vgg_tiny_init
from deconv_api_tpu.serving.codec import _stitch_grid_traced
from deconv_api_tpu_torch.engine.deconv import get_visualizer
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.weights import params_from_jax
from deconv_api_tpu_torch.serving.codec import stitch_grid

B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _params(dead: bool = False):
    spec, params = vgg_tiny_init(jax.random.key(0, impl="rbg"))
    if dead:  # kill all but 4 of block3_conv1's 64 channels
        b = np.asarray(params["block3_conv1"]["b"]).copy()
        b[4:] = -1e4
        params = {**params, "block3_conv1": {**params["block3_conv1"], "b": jnp.asarray(b)}}
    return spec, params


def _images():
    return (np.random.default_rng(0).standard_normal((B, 32, 32, 3)) * 50).astype(np.float32)


@functools.cache
def _jax_result(layer, k, bwd, bug_compat, mode="all", dead=False):
    spec, params = _params(dead)
    fn = j_get_visualizer(spec, layer, k, mode, bug_compat, batched=True, backward_dtype=bwd)
    r = fn(params, _images())[layer]
    grid = _stitch_grid_traced(r["images"], r["valid"])
    return {key: np.asarray(v) for key, v in r.items()} | {"grid": np.asarray(grid)}


def _port_result(layer, k, bwd, bug_compat, fused, mode="all", dead=False):
    _, params = _params(dead)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    fn = get_visualizer(VGG_TINY_SPEC, layer, k, mode, bug_compat, bwd, fused, device="cpu")
    r = fn(tp, torch.from_numpy(_images()))[layer]
    return r, stitch_grid(r["images"], r["valid"]).numpy()


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0**2 / mse)


CASES = [
    ("block3_conv1", 4, None, True),
    ("block3_conv1", 8, "bfloat16", True),
    ("block3_conv1", 4, "bfloat16", False),
    ("block3_conv1", 8, None, False),
]


@pytest.mark.parametrize("fused", ["forced", "off"])
@pytest.mark.parametrize("layer,k,bwd,bug_compat", CASES)
def test_visualizer_matches_jax(layer, k, bwd, bug_compat, fused):
    want = _jax_result(layer, k, bwd, bug_compat)
    got, grid = _port_result(layer, k, bwd, bug_compat, fused)
    np.testing.assert_array_equal(got["indices"].numpy(), want["indices"])
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    images = got["images"].numpy()
    assert images.shape == want["images"].shape == (B, k, 32, 32, 3)
    if bwd is None:
        scale = np.abs(want["images"]).max()
        assert np.abs(images - want["images"]).max() <= 1e-4 * scale
    assert grid.shape == (B, 64, 64, 3) and grid.dtype == np.uint8
    bar = 65.0 if bwd is None else 52.0
    assert min(_psnr(g, w) for g, w in zip(grid, want["grid"])) >= bar


@pytest.mark.parametrize(
    "layer,mode",
    [("fc1", "all"), ("block2_pool", "all"), ("block2_conv2", "max")],
)
def test_other_layer_kinds_match_jax(layer, mode):
    """A dense head (unflatten on the way down), a requested
    pool layer (the standalone unpool at the top) and ``mode="max"``."""
    want = _jax_result(layer, 4, None, True, mode)
    got, grid = _port_result(layer, 4, None, True, "forced", mode)
    np.testing.assert_array_equal(got["indices"].numpy(), want["indices"])
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    scale = np.abs(want["images"]).max()
    assert np.abs(got["images"].numpy() - want["images"]).max() <= 1e-4 * scale
    assert min(_psnr(g, w) for g, w in zip(grid, want["grid"])) >= 65.0


def test_dead_channels_keep_the_reference_order():
    """60 of 64 channels never fire: their sums tie at -inf and the lower
    channel index must come first, as lax.top_k orders them."""
    want = _jax_result("block3_conv1", 8, None, True, dead=True)
    got, _ = _port_result("block3_conv1", 8, None, True, "forced", dead=True)
    assert (~want["valid"]).sum(axis=1).min() >= 4
    np.testing.assert_array_equal(got["indices"].numpy(), want["indices"])
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])


def test_illegal_arguments_raise():
    with pytest.raises(ValueError, match="mode"):
        get_visualizer(VGG_TINY_SPEC, "fc1", mode="min", device="cpu")
    with pytest.raises(ValueError, match="backward_dtype"):
        get_visualizer(VGG_TINY_SPEC, "fc1", backward_dtype="float16", device="cpu")
    with pytest.raises(ValueError, match="input layer"):
        get_visualizer(VGG_TINY_SPEC, "input_1", device="cpu")
