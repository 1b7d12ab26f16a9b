"""Weights across the two packages: ``params_from_jax`` and the slash-keyed
``.npz`` archive both packages read and write."""

import jax
import numpy as np
import pytest
import torch

from deconv_api_tpu.models import weights as j_weights
from deconv_api_tpu.models.tiny import vgg_tiny_init
from deconv_api_tpu_torch.models import VGG_TINY_SPEC, init_params
from deconv_api_tpu_torch.models import weights


@pytest.fixture(scope="module")
def jax_params():
    return vgg_tiny_init(jax.random.key(2, impl="rbg"))[1]


def _assert_same(port, jtree):
    assert set(port) == set(jtree)
    for layer, leaves in jtree.items():
        assert set(port[layer]) == set(leaves)
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(port[layer][leaf].numpy(), np.asarray(arr))


def test_params_from_jax_keeps_layouts(jax_params):
    port = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    _assert_same(port, jax_params)
    assert port["block1_conv1"]["w"].shape == (3, 3, 3, 16)  # HWIO
    assert port["fc1"]["w"].shape == (4 * 4 * 64, 256)  # (din, dout)


def test_npz_round_trips_with_the_jax_package(jax_params, tmp_path):
    j_weights.save_npz(jax_params, str(tmp_path / "jax.npz"))
    port = weights.load_npz(str(tmp_path / "jax.npz"))
    _assert_same(port, jax_params)

    weights.save_npz(port, str(tmp_path / "port.npz"))
    zeros = jax.tree_util.tree_map(np.zeros_like, jax_params)
    back = j_weights.load_npz_into(str(tmp_path / "port.npz"), zeros)
    _assert_same(port, back)


def test_init_params_is_seeded_he_normal(jax_params):
    a = init_params(VGG_TINY_SPEC, torch.Generator().manual_seed(0))
    b = init_params(VGG_TINY_SPEC, torch.Generator().manual_seed(0))
    ref = jax_params
    for layer, leaves in ref.items():
        for leaf, arr in leaves.items():
            assert a[layer][leaf].shape == arr.shape and a[layer][leaf].dtype == torch.float32
            assert torch.equal(a[layer][leaf], b[layer][leaf])
    w = a["block3_conv1"]["w"]  # fan_in 3*3*32: std sqrt(2/288)
    assert abs(float(w.std()) - (2 / 288) ** 0.5) < 0.01
    assert not a["fc1"]["b"].any()
