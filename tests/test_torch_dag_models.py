"""The port's DAG building blocks and model families against the JAX package
on the CPU: the deconvnet ReLU/ReLU6 Functions, strided / explicitly padded
/ depthwise convs and the strided backward projection, the overlapping
max-pool (forward and gradient, tied windows included), the average pool,
and each family's forward activations (ResNet50 at 64x64, InceptionV3 at
75x75, MobileNet v1/v2 at 64x64, 10 classes), plus VGG19's spec.

Params and inputs come from ``tests/torch_dag_families.py``.  Bar for the
forwards: equal activation names and shapes, fp32 within 1e-4 of the
largest reference magnitude."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deconv_api_tpu import ops as jops
from deconv_api_tpu.models import blocks as jblocks
from deconv_api_tpu.models import mobilenet_v1 as j_mnv1
from deconv_api_tpu.models import mobilenet_v2 as j_mnv2
from deconv_api_tpu.models import resnet50 as j_resnet
from deconv_api_tpu.models.vgg19 import VGG19_SPEC as J_VGG19_SPEC
from deconv_api_tpu_torch import ops as tops
from deconv_api_tpu_torch.models import blocks, mobilenet_v1, mobilenet_v2, resnet50
from deconv_api_tpu_torch.models.vgg19 import VGG19_SPEC
from deconv_api_tpu_torch.models.weights import params_from_jax
from deconv_api_tpu_torch.ops.activations import deconv_relu, deconv_relu6
from tests.torch_dag_families import FAMILIES, both_params, images, numpy_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------ activations


@pytest.mark.parametrize("name", ["relu", "relu6"])
def test_deconv_activation_gradients_match_jax(name):
    """Forward relu / relu6; backward relu / relu6 of the incoming
    gradient, the cap included, whatever the forward input's sign."""
    tfn, jfn = {"relu": (deconv_relu, jops.deconv_relu), "relu6": (deconv_relu6, jops.deconv_relu6)}[name]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 7)) * 8).astype(np.float32)
    g = (rng.standard_normal((3, 5, 7)) * 8).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    y = tfn(xt)
    (gx,) = torch.autograd.grad(y, xt, _t(g))
    jy, vjp = jax.vjp(jfn, jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    assert (gx.numpy() > 0).sum() > (x > 0).sum() // 2  # not masked by the forward sign
    if name == "relu6":
        assert gx.max() == 6.0
    np.testing.assert_array_equal(tops.apply_activation(_t(x), name).numpy(), np.asarray(jops.apply_activation(x, name)))


@pytest.mark.parametrize("fn", [deconv_relu, deconv_relu6], ids=["relu", "relu6"])
def test_deconv_functions_run_under_batched_grads(fn):
    """``is_grads_batched`` runs the Functions' backward on all rows at once
    and equals one backward per row."""
    x = torch.randn(2, 6, 6, 4, generator=torch.Generator().manual_seed(0)).requires_grad_(True)
    y = fn(x * 3) * 2
    gs = torch.randn(5, 2, 6, 6, 4, generator=torch.Generator().manual_seed(1)) * 4
    (batched,) = torch.autograd.grad(y, x, gs, is_grads_batched=True, retain_graph=True)
    rows = torch.stack([torch.autograd.grad(y, x, g, retain_graph=True)[0] for g in gs])
    torch.testing.assert_close(batched, rows, rtol=0, atol=0)


# ------------------------------------------------------------------ convs

# (input (B, H, W, C), kernel (kh, kw), Cout, strides, padding, depthwise)
CONV_CASES = [
    ((2, 9, 7, 3), (3, 3), 5, (2, 2), "SAME", False),  # odd extent: SAME pads (0, 1)
    ((2, 10, 10, 3), (3, 3), 4, (2, 2), "SAME", False),
    ((1, 13, 11, 3), (7, 7), 6, (2, 2), ((3, 3), (3, 3)), False),  # ResNet conv1
    ((2, 12, 12, 4), (3, 3), 5, (2, 2), ((0, 1), (0, 1)), False),  # MobileNet stride 2
    ((2, 11, 11, 6), (3, 3), 6, (2, 2), ((0, 1), (0, 1)), True),  # depthwise stride 2
    ((2, 8, 9, 6), (3, 3), 6, (1, 1), "SAME", True),  # depthwise
    ((2, 15, 15, 3), (3, 3), 4, (2, 2), "VALID", False),  # Inception stem
    ((2, 9, 9, 4), (1, 7), 3, (1, 1), "SAME", False),
    ((2, 9, 9, 4), (7, 1), 3, (1, 1), "SAME", False),
    ((2, 8, 8, 3), (2, 2), 4, (1, 1), "SAME", False),  # even kernel: pads (0, 1)
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"{c[0]}-{c[1]}-s{c[3][0]}-{c[4]}-dw{int(c[5])}".replace(" ", ""))
def test_conv2d_and_its_backward_projection_match_jax(case):
    shape, (kh, kw), cout, strides, padding, depthwise = case
    rng = np.random.default_rng(sum(shape) + kh)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((kh, kw, 1 if depthwise else c, c if depthwise else cout)).astype(np.float32)
    groups = c if depthwise else 1
    got = tops.conv2d(_t(x), _t(w), strides=strides, padding=padding, groups=groups)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), strides=strides, padding=padding, feature_group_count=groups)
    _close(got.numpy(), want)
    assert got.is_contiguous()
    if depthwise:
        return  # the reference's backward projection has no groups
    y = rng.standard_normal(got.shape).astype(np.float32)
    hw = shape[1:3]
    back = tops.conv2d_input_backward(_t(y), _t(w), strides=strides, padding=padding, input_hw=hw)
    jback = jops.conv2d_input_backward(jnp.asarray(y), jnp.asarray(w), strides=strides, padding=padding, input_hw=hw)
    _close(back.numpy(), jback)
    # the projection is the conv's exact linear transpose: its gradient
    xt = _t(x).requires_grad_(True)
    (grad,) = torch.autograd.grad(tops.conv2d(xt, _t(w), strides=strides, padding=padding), xt, _t(y))
    _close(back.numpy(), grad.numpy())


# ------------------------------------------------------------------ pools


@pytest.mark.parametrize("padding", [((1, 1), (1, 1)), "VALID", "SAME"])
def test_maxpool_forward_and_gradient_on_tied_windows_match_jax(padding):
    """Overlapping 3x3/2 windows over post-ReLU values with many ties (and
    all-zero windows): both send each window's cotangent to its first
    maximum in row-major order, and a cell sums the windows it wins."""
    rng = np.random.default_rng(3)
    x = rng.choice(np.array([0.0, 0.0, 0.0, 1.0, 2.0], np.float32), size=(2, 11, 10, 3))
    xt = _t(x).requires_grad_(True)
    y = blocks.maxpool(xt, 3, 2, padding)
    jy, vjp = jax.vjp(lambda a: jblocks.maxpool(a, 3, 2, padding), jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    g = rng.standard_normal(jy.shape).astype(np.float32)
    (gx,) = torch.autograd.grad(y, xt, _t(g))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(gx.numpy(), want, rtol=0, atol=1e-6)
    assert (want != 0).sum() < want.size // 4  # routed to window winners only


@pytest.mark.parametrize("window,stride,padding", [(3, 1, "SAME"), (3, 2, "SAME"), (2, 2, "VALID")])
def test_avgpool_divides_by_the_valid_cells_like_jax(window, stride, padding):
    x = np.random.default_rng(4).standard_normal((2, 8, 7, 5)).astype(np.float32)
    got = blocks.avgpool(_t(x), window, stride, padding).numpy()
    _close(got, jblocks.avgpool(jnp.asarray(x), window, stride, padding))


# ---------------------------------------------------------- model families


@functools.cache
def _jax_acts(family: str):
    jp, _ = both_params(family)
    fwd = FAMILIES[family][1]
    out, acts = jax.jit(lambda p, x: fwd(p, x, rules=jblocks.DECONV_RULES))(jp, images(family))
    return {k: np.asarray(v) for k, v in acts.items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_forward_matches_jax(family):
    _, tp = both_params(family)
    module, fwd = FAMILIES[family][2], FAMILIES[family][3]
    with torch.no_grad():
        _, acts = fwd(tp, _t(images(family)), rules=blocks.DECONV_RULES)
    want = _jax_acts(family)
    assert sorted(acts) == sorted(want)  # the same named activations
    assert set(module.DECONV_LAYERS) <= set(acts)
    for name in module.DECONV_LAYERS + ("predictions",):
        _close(acts[name].numpy(), want[name], rel=1e-4)


def test_resnet50_projectable_layers_keep_the_reference_order():
    assert resnet50.DECONV_LAYERS == j_resnet.DECONV_LAYERS
    assert resnet50.DECONV_LAYERS[-1] == "conv1_relu"  # not forward order
    assert mobilenet_v1.DECONV_LAYERS == j_mnv1.DECONV_LAYERS
    assert mobilenet_v2.DECONV_LAYERS == j_mnv2.DECONV_LAYERS


def test_port_init_is_seeded_he_normal_in_the_reference_layout():
    """The port's own init: the reference's tree and shapes, one seed one
    set of weights, He-normal kernels, identity BatchNorm."""
    made = {}
    for family in sorted(FAMILIES):
        init = getattr(FAMILIES[family][2], f"{family}_init")
        a = made[family] = init(torch.Generator().manual_seed(0), num_classes=10)
        b = init(torch.Generator().manual_seed(0), num_classes=10)
        shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), numpy_params(family))
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), a) == shapes
        assert all(torch.equal(u, v) for u, v in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))
    w = made["mobilenet_v2"]["block_13"]["project"]["w"]  # 1x1 from 576 channels
    assert abs(float(w.std()) / (2 / 576) ** 0.5 - 1) < 0.05
    assert torch.equal(made["mobilenet_v2"]["Conv1"]["var"], torch.ones(32))
    assert torch.equal(made["resnet50"]["conv2_block1"]["c1"]["beta"], torch.zeros(64))


def test_vgg19_spec_is_the_references():
    assert VGG19_SPEC.name == J_VGG19_SPEC.name and VGG19_SPEC.input_shape == J_VGG19_SPEC.input_shape
    assert [(l.name, l.kind, l.activation, l.filters) for l in VGG19_SPEC.layers] == [
        (l.name, l.kind, l.activation, l.filters) for l in J_VGG19_SPEC.layers
    ]


def test_nested_params_round_trip_through_npz_with_the_jax_package(tmp_path):
    """Three-level DAG trees (``params["conv2_block1"]["c1"]["w"]``) cross
    ``params_from_jax`` and both packages' ``a/b/leaf`` archives intact."""
    from deconv_api_tpu.models import weights as j_weights
    from deconv_api_tpu_torch.models import weights

    tree = numpy_params("resnet50")
    port = params_from_jax(tree)
    assert port["conv2_block1"]["c1"]["w"].shape == (1, 1, 64, 64)
    j_weights.save_npz(tree, str(tmp_path / "jax.npz"))
    loaded = weights.load_npz(str(tmp_path / "jax.npz"))
    weights.save_npz(loaded, str(tmp_path / "port.npz"))
    back = j_weights.load_npz_into(str(tmp_path / "port.npz"), jax.tree_util.tree_map(np.zeros_like, tree))
    for a, b, c in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b.numpy())
        np.testing.assert_array_equal(a, np.asarray(c))
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: t.numpy(), loaded))
