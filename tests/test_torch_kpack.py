"""The channel-packed ("kpack") ops of the port against the JAX package's:
``pack_k``/``unpack_k``, the ``lowc_kpack`` vocabulary, the grouped
backward conv, the grouped switch unpool and the grouped fused unpool+conv
(its plain version on the CPU, held against the JAX ``_mxu_kernel`` body in
interpret mode and against the JAX grouped pair).

Bars: layout ops and the unpool exact; convolutions in fp32 within 1e-5 of
the largest reference magnitude (another summation order over kh*kw*Cout
terms).  Asymmetric random kernels keep a wrong flip or group order
visible."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deconv_api_tpu.engine.deconv import pack_k as j_pack_k
from deconv_api_tpu.engine.deconv import resolve_kpack_chan as j_resolve
from deconv_api_tpu.engine.deconv import unpack_k as j_unpack_k
from deconv_api_tpu.ops import pallas_deconv
from deconv_api_tpu.ops.conv import conv2d_input_backward_grouped as j_conv_grouped
from deconv_api_tpu.ops.pool import unpool_with_argmax as j_unpool
from deconv_api_tpu_torch.engine.deconv import pack_k, resolve_kpack_chan, unpack_k
from deconv_api_tpu_torch.ops import cuda_deconv, pool
from deconv_api_tpu_torch.ops.conv import conv2d_input_backward_grouped

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def test_pack_k_matches_jax_channel_order_and_round_trips():
    b, k, h, w, c = 2, 3, 4, 5, 6
    a = np.random.default_rng(0).standard_normal((b, k, h, w, c)).astype(np.float32)
    x = torch.from_numpy(a.reshape(b * k, h, w, c))  # image-major rows
    packed = pack_k(x, k)
    # the reference's (K, B, ...) layout of the same projections
    want = np.asarray(j_pack_k(jnp.asarray(a.transpose(1, 0, 2, 3, 4))))
    np.testing.assert_array_equal(packed.numpy(), want)
    assert torch.equal(unpack_k(packed, k), x)
    back = np.asarray(j_unpack_k(jnp.asarray(want), k)).transpose(1, 0, 2, 3, 4)
    np.testing.assert_array_equal(unpack_k(packed, k).numpy(), back.reshape(b * k, h, w, c))


@pytest.mark.parametrize(
    "policy", ["off", "", "0", "false", "no", "OFF", "auto", "forced", "96", 32, 0]
)
def test_resolve_kpack_chan_vocabulary_equals_jax(policy):
    assert resolve_kpack_chan(policy, top_k=8) == j_resolve(policy, top_k=8)
    assert resolve_kpack_chan(policy, top_k=1) == j_resolve(policy, top_k=1)


@pytest.mark.parametrize("policy", ["bogus", "-8", "3.5", True])
def test_resolve_kpack_chan_rejects_what_jax_rejects(policy):
    for resolve in (resolve_kpack_chan, j_resolve):
        with pytest.raises(ValueError, match="lowc_kpack"):
            resolve(policy, top_k=8)


@pytest.mark.parametrize("c", [3, 16, 64])
def test_grouped_backward_conv_matches_jax(c):
    rng = np.random.default_rng(c)
    groups, cout = 4, 8
    y = rng.standard_normal((2, 6, 5, groups * cout)).astype(np.float32)
    w = rng.standard_normal((3, 3, c, cout)).astype(np.float32)
    got = conv2d_input_backward_grouped(torch.from_numpy(y), torch.from_numpy(w), groups)
    assert got.shape == (2, 6, 5, groups * c)
    _close(got.numpy(), j_conv_grouped(jnp.asarray(y), jnp.asarray(w), groups))


@pytest.mark.parametrize(
    "groups,rep,out_hw,relu",
    [(2, 1, None, False), (4, 1, (9, 11), True), (3, 2, None, True)],
)
def test_grouped_unpool_matches_jax_exactly(groups, rep, out_hw, relu):
    rng = np.random.default_rng(groups * 10 + rep)
    c = 5
    y = rng.standard_normal((2 * rep, 4, 5, groups * c)).astype(np.float32)
    idx = rng.integers(0, 4, (2, 4, 5, c)).astype(np.int8)
    got = pool.unpool_with_argmax(
        torch.from_numpy(y), torch.from_numpy(idx), (2, 2), out_hw, relu, groups
    )
    want = j_unpool(
        jnp.asarray(y), jnp.repeat(jnp.asarray(idx), rep, axis=0), (2, 2), out_hw,
        fuse_relu=relu, groups=groups,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grouped_unpool_rejects_a_channel_mismatch():
    y, idx = torch.zeros((1, 2, 2, 10)), torch.zeros((1, 2, 2, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="groups"):
        pool.unpool_with_argmax(y, idx, (2, 2), None, False, 2)


@pytest.mark.parametrize("groups,rep,relu", [(2, 1, True), (4, 3, False)])
def test_grouped_fused_plain_matches_jax_mxu_body_and_pair(groups, rep, relu):
    rng = np.random.default_rng(groups + rep)
    cout, cin = 6, 5
    y = rng.standard_normal((2 * rep, 4, 3, groups * cout)).astype(np.float32)
    idx = rng.integers(0, 4, (2, 4, 3, cout)).astype(np.int8)
    w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    ty, tidx, tw = torch.from_numpy(y), torch.from_numpy(idx), torch.from_numpy(w)
    got = cuda_deconv.fused_plain(ty, tidx, tw, (2, 2), relu, groups)
    assert got.shape == (2 * rep, 8, 6, groups * cin)
    # the policy op on a certified CPU site runs the same plain version
    assert torch.equal(
        cuda_deconv.fused_unpool_backward(ty, tidx, tw, (2, 2), None, relu, groups, "forced"), got
    )
    jy, jidx, jw = jnp.asarray(y), jnp.asarray(idx), jnp.asarray(w)
    mxu = pallas_deconv.fused_pallas_call(
        jy, jidx, jw, (2, 2), relu=relu, groups=groups, impl="mxu", interpret=True
    )
    pair = j_conv_grouped(
        j_unpool(jy, jnp.repeat(jidx, rep, axis=0), (2, 2), fuse_relu=relu, groups=groups),
        jw, groups,
    )
    _close(got.numpy(), mxu)
    _close(got.numpy(), pair)


@pytest.mark.parametrize(
    "y_shape,idx_shape,w_shape,groups,ok",
    [
        ((2, 4, 4, 24), (2, 4, 4, 6), (3, 3, 5, 6), 4, True),
        ((8, 4, 4, 12), (2, 4, 4, 6), (3, 3, 5, 6), 2, True),
        ((2, 4, 4, 24), (2, 4, 4, 6), (3, 3, 5, 6), 3, False),  # Cy != groups * Ci
        ((2, 4, 4, 24), (2, 4, 4, 8), (3, 3, 5, 8), 4, False),  # Cy != groups * Ci
        ((2, 4, 4, 24), (2, 4, 4, 6), (3, 3, 5, 7), 4, False),  # Ci != Cout
        ((2, 4, 4, 24), (2, 4, 4, 6), (3, 3, 5, 6), 0, False),
    ],
)
def test_fused_supported_groups(y_shape, idx_shape, w_shape, groups, ok):
    assert cuda_deconv.fused_supported(y_shape, idx_shape, w_shape, (2, 2), None, groups) is ok
    args = (y_shape, idx_shape, w_shape, (2, 2), None, groups)
    assert pallas_deconv.fused_supported(*args) is ok
