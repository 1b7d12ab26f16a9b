"""Ops of the port (deconv_api_tpu_torch.ops) against the JAX package's.

The same numpy inputs go through both packages on the CPU.  Pool and unpool
are held bit-exact against the plain JAX ops and against the Pallas kernels
in interpret mode; conv and dense within fp32 reduction order (1e-5 of the
largest reference magnitude: another summation order over at most a few
hundred terms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deconv_api_tpu import ops as jops
from deconv_api_tpu.ops import pallas_pool
from deconv_api_tpu_torch import ops as tops
from deconv_api_tpu_torch.ops import cuda_pool, pool

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _j(a, dtype=None):
    return jnp.asarray(a, dtype=dtype)


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a).copy())
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale


def _pool_input(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":  # all-equal windows and +0 against -0
        return np.array([-0.0, 0.0, 1.0], np.float32)[rng.integers(0, 3, shape)]
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "dtype,kind,shape",
    [
        ("float32", "normal", (2, 8, 6, 5)),
        ("bfloat16", "normal", (2, 8, 6, 5)),
        ("float32", "ties", (2, 8, 6, 5)),
        ("bfloat16", "ties", (3, 4, 4, 7)),
    ],
)
def test_maxpool_matches_jax_and_pallas(dtype, kind, shape):
    x = _pool_input(shape, kind, seed=len(shape) + shape[0])
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got_p, got_i = tops.maxpool_with_argmax(_t(x, tdt), (2, 2))
    jx = _j(x, getattr(jnp, dtype))
    for want_p, want_i in (
        jops.maxpool_with_argmax(jx, (2, 2)),
        pallas_pool.maxpool_argmax_pallas(jx, (2, 2), True),
    ):
        assert got_i.dtype == torch.int8
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(_np(got_p), np.asarray(want_p, np.float32))


@pytest.mark.parametrize("shape,pool_size", [((2, 7, 9, 3), (2, 2)), ((1, 10, 11, 4), (3, 2))])
def test_maxpool_odd_extents_floor_dropped(shape, pool_size):
    x = _pool_input(shape, "normal", seed=5)
    got_p, got_i = tops.maxpool_with_argmax(_t(x), pool_size)
    want_p, want_i = jops.maxpool_with_argmax(_j(x), pool_size)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_maxpool_first_maximum_wins_in_row_major_order():
    x = np.zeros((1, 2, 2, 1), np.float32)
    x[0, 0, 1, 0] = x[0, 1, 0, 0] = 3.0  # two maxima: (0, 1) comes first
    _, idx = tops.maxpool_with_argmax(_t(x))
    assert int(idx[0, 0, 0, 0]) == 1


@pytest.mark.parametrize(
    "dtype,relu,rep,out_hw",
    [
        ("float32", False, 1, None),
        ("float32", True, 1, None),
        ("bfloat16", True, 3, None),
        ("float32", False, 2, (9, 11)),
        ("bfloat16", True, 1, (9, 11)),
    ],
)
def test_unpool_matches_jax_and_pallas(dtype, relu, rep, out_hw):
    rng = np.random.default_rng(rep + 7 * relu)
    bi, ho, wo, c = 2, 4, 5, 6
    y = rng.standard_normal((bi * rep, ho, wo, c)).astype(np.float32)
    idx = rng.integers(0, 4, (bi, ho, wo, c)).astype(np.int8)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = tops.unpool_with_argmax(_t(y, tdt), _t(idx), (2, 2), out_hw, fuse_relu=relu)
    jy = _j(y, getattr(jnp, dtype))
    # the JAX plain op takes the switches row-aligned: repeat each block
    want = jops.unpool_with_argmax(
        jy, _j(np.repeat(idx, rep, axis=0)), (2, 2), out_hw, fuse_relu=relu
    )
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    if out_hw is None:  # the Pallas kernel shares one switch block per rep rows
        want_k = pallas_pool.unpool_argmax_pallas(jy, _j(idx), (2, 2), True, relu)
        np.testing.assert_array_equal(_np(got), np.asarray(want_k, np.float32))


def test_unpool_rejects_switch_batch_that_does_not_divide():
    y = torch.zeros((5, 2, 2, 3))
    idx = torch.zeros((2, 2, 2, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple"):
        tops.unpool_with_argmax(y, idx)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch kernels only: a CPU tensor is an error there
    (ops/pool.py routes CPU tensors to the plain versions instead)."""
    x = torch.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_pool.pool_argmax(x)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_pool.unpool_argmax(x, torch.zeros((1, 4, 4, 2), dtype=torch.int8))
    assert pool.maxpool_argmax_plain(x)[0].shape == (1, 2, 2, 2)


@pytest.mark.parametrize("k,cin,cout", [(3, 3, 8), (5, 4, 6), (1, 5, 7)])
def test_conv2d_and_backward_match_jax(k, cin, cout):
    rng = np.random.default_rng(k * 10 + cin)
    x = rng.standard_normal((2, 9, 7, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)  # asymmetric
    b = rng.standard_normal((cout,)).astype(np.float32)
    y = rng.standard_normal((2, 9, 7, cout)).astype(np.float32)
    _close(tops.conv2d(_t(x), _t(w), _t(b)).numpy(), jops.conv2d(_j(x), _j(w), _j(b)))
    _close(
        tops.conv2d_input_backward(_t(y), _t(w)).numpy(),
        jops.conv2d_input_backward(_j(y), _j(w)),
    )
    np.testing.assert_array_equal(
        tops.flip_kernel(_t(w)).numpy(), np.asarray(jops.flip_kernel(_j(w)))
    )


def test_conv_refuses_strided_projection():
    """Strided convs and their projections are ported (the DAG models,
    tests/test_torch_dag_models.py); what is refused is a projection onto an
    input extent the signal cannot have come from, and a padding XLA does
    not name."""
    w = torch.zeros((3, 3, 2, 2))
    assert tops.conv2d(torch.zeros((1, 4, 4, 2)), w, strides=(2, 2)).shape == (1, 2, 2, 2)
    assert tops.conv2d_input_backward(torch.zeros((1, 4, 4, 2)), w, strides=(2, 2)).shape == (1, 8, 8, 2)
    with pytest.raises(ValueError, match="not the output"):
        tops.conv2d_input_backward(torch.zeros((1, 4, 4, 2)), w, strides=(2, 2), input_hw=(20, 20))
    with pytest.raises(ValueError, match="keeps its extent"):
        tops.conv2d_input_backward(torch.zeros((1, 4, 4, 2)), w, input_hw=(5, 5))
    with pytest.raises(ValueError, match="unknown padding"):
        tops.conv2d(torch.zeros((1, 4, 4, 2)), w, padding="FULL")


def test_dense_ops_and_flatten_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    w = rng.standard_normal((60, 7)).astype(np.float32)
    b = rng.standard_normal((7,)).astype(np.float32)
    y = rng.standard_normal((2, 7)).astype(np.float32)
    flat = tops.flatten(_t(x))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jops.flatten(_j(x))))
    _close(tops.dense(flat, _t(w), _t(b)).numpy(), jops.dense(jops.flatten(_j(x)), _j(w), _j(b)))
    back = tops.dense_input_backward(_t(y), _t(w))
    _close(back.numpy(), jops.dense_input_backward(_j(y), _j(w)))
    np.testing.assert_array_equal(
        tops.unflatten(back, (3, 4, 5)).numpy().shape, (2, 3, 4, 5)
    )


@pytest.mark.parametrize("name", ["relu", "linear", "softmax"])
def test_activations_match_jax(name):
    x = np.random.default_rng(1).standard_normal((3, 10)).astype(np.float32)
    _close(tops.apply_activation(_t(x), name).numpy(), jops.apply_activation(_j(x), name))


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        tops.apply_activation(torch.zeros(2), "gelu")
