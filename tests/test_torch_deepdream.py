"""The port's DeepDream engine (deconv_api_tpu_torch/engine/deepdream.py)
against the JAX package's on the CPU: the octave ladder, the resize and the
pyramid step, the true-gradient ReLU and ReLU6 at their ties, the loss,
one octave, and the whole batched dream on the JAX tests' TINY spec and on
MobileNet v1 at 64x64; each row of a batch against its solo dream."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deconv_api_tpu.engine.deepdream  # noqa: F401  (the module, not the function)
import deconv_api_tpu_torch.engine.deepdream  # noqa: F401
from deconv_api_tpu import ops as j_ops
from deconv_api_tpu.models.apply import spec_forward as j_spec_forward
from deconv_api_tpu.models.spec import init_params as j_init_params
from deconv_api_tpu_torch.models.apply import spec_forward
from deconv_api_tpu_torch.models.blocks import INFERENCE_RULES
from deconv_api_tpu_torch.models.spec import Layer, ModelSpec
from deconv_api_tpu_torch.models.weights import params_from_jax
from tests.test_engine_parity import TINY
from tests.torch_dag_families import FAMILIES, both_params

J = sys.modules["deconv_api_tpu.engine.deepdream"]
T = sys.modules["deconv_api_tpu_torch.engine.deepdream"]

RESIZE_TOL = 1e-5  # of the resized input's largest magnitude
LOSS_RTOL = 1e-5
X_ATOL = 2e-5
# the JAX package's own batch-vs-solo bars (tests/test_deepdream.py)
DREAM_RTOL, DREAM_ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_spec(spec) -> ModelSpec:
    return ModelSpec(spec.name, spec.input_shape, tuple(Layer(**dataclasses.asdict(l)) for l in spec.layers))


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, port params, JAX forward, port forward) of TINY cut at
    b2c1, and three 16x16 images."""
    jp = j_init_params(TINY, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    spec = TINY.truncated("b2c1")
    imgs = np.random.default_rng(1).standard_normal((3, 16, 16, 3)).astype(np.float32)
    return jp, tp, j_spec_forward(spec), spec_forward(_port_spec(spec)), imgs


@pytest.fixture(scope="module")
def mobilenet():
    """MobileNet v1 at 64x64 (10 classes): JAX and port params and
    forwards, and two images."""
    jp, tp = both_params("mobilenet_v1")
    j_fwd, t_fwd = FAMILIES["mobilenet_v1"][1], FAMILIES["mobilenet_v1"][3]
    imgs = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    return jp, tp, j_fwd, t_fwd, imgs


MODELS = {"tiny": ("tiny", ("b2c1",), 8), "mobilenet_v1": ("mobilenet", ("conv_pw_7_relu", "conv_pw_11_relu"), 32)}


@pytest.mark.parametrize(
    "args",
    [(299, 299, 10, 1.4, 75), (224, 224, 10, 1.4, 16), (32, 32, 3, 1.3, 8), (120, 90, 4, 1.4, 40), (50, 50, 3, 1.4, 75)],
    ids=["inception_299", "vgg_224", "tiny_32", "non_square", "one_rung_fallback"],
)
def test_octave_shapes_match_jax(args):
    assert T.octave_shapes(*args) == J.octave_shapes(*args)


@pytest.mark.parametrize(
    "shape, hw",
    [((2, 299, 299, 3), (78, 78)), ((2, 299, 299, 3), (214, 214)), ((2, 153, 153, 3), (214, 214)),
     ((1, 120, 90, 5), (86, 64)), ((1, 86, 64, 5), (120, 90))],
    ids=["down_299_78", "down_299_214", "up_153_214", "down_non_square", "up_non_square"],
)
def test_resize_matches_jax(shape, hw):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = np.asarray(J._resize(jnp.asarray(x), hw))
    got = T._resize(torch.from_numpy(x), hw).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RESIZE_TOL * np.abs(x).max()


@pytest.mark.parametrize("prev_hw", [None, (46, 46)], ids=["first_octave", "detail_reinjected"])
def test_pyramid_step_matches_jax(prev_hw):
    rng = np.random.default_rng(4)
    base = rng.standard_normal((2, 90, 90, 3)).astype(np.float32)
    x = rng.standard_normal((2, *(prev_hw or (46, 46)), 3)).astype(np.float32)
    want = np.asarray(J._pyramid_step(jnp.asarray(x), jnp.asarray(base), (64, 64), prev_hw))
    got = T._pyramid_step(torch.from_numpy(x), torch.from_numpy(base), (64, 64), prev_hw).numpy()
    assert np.abs(got - want).max() <= RESIZE_TOL * max(np.abs(x).max(), np.abs(base).max())


@pytest.mark.parametrize("name", ["relu", "relu6"])
def test_inference_rules_split_ties_as_jax(name):
    """The gradient at the ties (0, and 6 for ReLU6) is 0.5, as
    ``jnp.maximum``/``jnp.minimum`` give it."""
    v = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    want = np.asarray(jax.grad(lambda x: getattr(j_ops, name)(x).sum())(jnp.asarray(v)))
    x = torch.from_numpy(v).requires_grad_(True)
    (got,) = torch.autograd.grad(getattr(INFERENCE_RULES, name)(x).sum(), x)
    np.testing.assert_array_equal(got.numpy(), want)
    expected = {"relu": [0, 0.5, 1, 1, 1], "relu6": [0, 0.5, 1, 0.5, 0]}[name]
    np.testing.assert_array_equal(got.numpy(), np.array(expected, np.float32))


@pytest.mark.parametrize("model", list(MODELS))
def test_activation_loss_and_one_octave_match_jax(model, request):
    fixture, layers, _ = MODELS[model]
    jp, tp, j_fwd, t_fwd, imgs = request.getfixturevalue(fixture)
    want_loss = np.asarray(J.activation_loss(j_fwd, jp, jnp.asarray(imgs), layers))
    got_loss = T.activation_loss(t_fwd, tp, torch.from_numpy(imgs), layers)
    np.testing.assert_allclose(got_loss.detach().numpy(), want_loss, rtol=LOSS_RTOL)

    # at the route's lr: a larger step can land a pre-activation within
    # fp32 rounding of a ReLU kink, where either side's gradient is right
    want_x, want_l = J.make_octave_runner(j_fwd, layers, steps=3, lr=0.01)(jp, jnp.asarray(imgs))
    got_x, got_l = T.make_octave_runner(t_fwd, layers, steps=3, lr=0.01)(tp, torch.from_numpy(imgs))
    assert not got_x.requires_grad
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=X_ATOL)


@pytest.mark.parametrize("model", list(MODELS))
def test_deepdream_batch_matches_jax_and_each_row_its_solo_dream(model, request):
    fixture, layers, min_size = MODELS[model]
    jp, tp, j_fwd, t_fwd, imgs = request.getfixturevalue(fixture)
    steps = 3 if model == "tiny" else 2
    kw = dict(layers=layers, steps_per_octave=steps, num_octaves=2, min_size=min_size)
    want_x, want_l = J.deepdream_batch(j_fwd, jp, jnp.asarray(imgs), **kw)
    got_x, got_l = T.deepdream_batch(t_fwd, tp, imgs, device="cpu", **kw)
    assert got_x.shape == imgs.shape and got_x.dtype == torch.float32
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=DREAM_RTOL, atol=DREAM_ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=DREAM_RTOL)
    assert not np.allclose(got_x.numpy(), imgs)
    for i in range(len(imgs)):
        solo_x, solo_l = T.deepdream(t_fwd, tp, imgs[i], device="cpu", **kw)
        np.testing.assert_allclose(got_x[i].numpy(), solo_x.numpy(), rtol=DREAM_RTOL, atol=DREAM_ATOL,
                                   err_msg=f"dream {i} diverged from its solo run")
        np.testing.assert_allclose(float(got_l[i]), float(solo_l), rtol=DREAM_RTOL)


def test_unknown_layer_raises(tiny):
    _, tp, _, t_fwd, imgs = tiny
    with pytest.raises(KeyError, match="no activation"):
        T.deepdream_batch(t_fwd, tp, imgs[:1], layers=("nope",), steps_per_octave=1, min_size=8, device="cpu")


@pytest.mark.slow
def test_inception_v3_dream_matches_jax_at_106():
    """InceptionV3's default dream layers at 106x106 (ladder (76, 106)),
    the smallest input with two rungs: JAX's gradient compile of the
    whole model is too heavy for the default run."""
    jp, tp = both_params("inception_v3")
    j_fwd, t_fwd = FAMILIES["inception_v3"][1], FAMILIES["inception_v3"][3]
    imgs = np.random.default_rng(5).standard_normal((1, 106, 106, 3)).astype(np.float32)
    kw = dict(layers=("mixed3", "mixed4", "mixed5"), steps_per_octave=2, num_octaves=2, min_size=75)
    assert T.octave_shapes(106, 106, 2, 1.4, 75) == ((76, 76), (106, 106))
    want_x, want_l = J.deepdream_batch(j_fwd, jp, jnp.asarray(imgs), **kw)
    got_x, got_l = T.deepdream_batch(t_fwd, tp, imgs, device="cpu", **kw)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=DREAM_RTOL, atol=DREAM_ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=DREAM_RTOL)
