"""The port's layer sweep and packed tail (deconv_api_tpu_torch/engine/deconv.py)
against the JAX package's ``get_visualizer(batched=True, sweep=..., kpack_chan=...)``
on vgg_tiny.

The same params (JAX init, carried across by ``params_from_jax``) and the
same numpy images go through both.  Bars: the same layers in the same
order (deepest first), selected indices and validity equal, fp32
projections within 1e-4 of the largest reference magnitude (the engine
bar), and the port's packed projections within 1e-5 of its own unpacked
ones."""

import functools

import jax
import numpy as np
import pytest
import torch

from deconv_api_tpu.engine.deconv import get_visualizer as j_get_visualizer
from deconv_api_tpu.models.tiny import vgg_tiny_init
from deconv_api_tpu.serving.models import spec_bundle as j_spec_bundle
from deconv_api_tpu_torch.engine.deconv import KPACK_FORCED_CHAN, get_visualizer
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.weights import params_from_jax

B, K = 2, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _params():
    return vgg_tiny_init(jax.random.key(3, impl="rbg"))


def _images():
    return (np.random.default_rng(1).standard_normal((B, 32, 32, 3)) * 50).astype(np.float32)


@functools.cache
def _jax_result(layer, sweep, kpack_chan):
    spec, params = _params()
    fn = j_get_visualizer(
        spec, layer, K, "all", True, sweep=sweep, batched=True, kpack_chan=kpack_chan,
        fused_unpool="off",
    )
    out = fn(params, _images())
    return {name: {k: np.asarray(v) for k, v in entry.items()} for name, entry in out.items()}


@functools.cache
def _port_result(layer, sweep, kpack_chan, fused):
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, _params()[1]))
    fn = get_visualizer(
        VGG_TINY_SPEC, layer, K, "all", True, None, fused, device="cpu",
        sweep=sweep, kpack_chan=kpack_chan,
    )
    return fn(tp, torch.from_numpy(_images()))


def _sweep_order(layer):
    spec, params = _params()
    return list(j_spec_bundle(spec, params).sweep_layers(layer))


@pytest.mark.parametrize("fused", ["forced", "off"])
@pytest.mark.parametrize("kpack_chan", [KPACK_FORCED_CHAN, 0])
@pytest.mark.parametrize("layer,sweep", [("block3_conv1", True), ("block2_pool", True), ("block3_conv1", False)])
def test_sweep_and_packed_tail_match_jax(layer, sweep, kpack_chan, fused):
    want = _jax_result(layer, sweep, kpack_chan)
    got = _port_result(layer, sweep, kpack_chan, fused)
    assert list(got) == (_sweep_order(layer) if sweep else [layer])
    assert set(got) == set(want)
    for name, entry in got.items():
        np.testing.assert_array_equal(entry["indices"].numpy(), want[name]["indices"])
        np.testing.assert_array_equal(entry["valid"].numpy(), want[name]["valid"])
        images, ref = entry["images"].numpy(), want[name]["images"]
        assert images.shape == ref.shape == (B, K, 32, 32, 3)
        assert np.abs(images - ref).max() <= 1e-4 * np.abs(ref).max(), name


@pytest.mark.parametrize("fused", ["forced", "off"])
@pytest.mark.parametrize("layer", ["block3_conv1", "block2_pool"])
def test_packed_tail_matches_the_unpacked_walk(layer, fused):
    packed = _port_result(layer, True, KPACK_FORCED_CHAN, fused)
    plain = _port_result(layer, True, 0, fused)
    for name in plain:
        assert torch.equal(packed[name]["indices"], plain[name]["indices"])
        a, b = packed[name]["images"], plain[name]["images"]
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name


def test_top_k_one_packs_a_single_group():
    """K = 1: the packed tail runs with one group, which is the plain walk."""
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, _params()[1]))
    x = torch.from_numpy(_images())
    packed = get_visualizer(VGG_TINY_SPEC, "block2_conv2", 1, device="cpu", kpack_chan=64)(tp, x)
    plain = get_visualizer(VGG_TINY_SPEC, "block2_conv2", 1, device="cpu")(tp, x)
    assert torch.equal(packed["block2_conv2"]["images"], plain["block2_conv2"]["images"])
