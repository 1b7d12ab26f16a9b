"""The int8 execution tier of the port against the JAX package's, on the
CPU at vgg_tiny with the same params (``params_from_jax``) and the same
seeded numpy inputs.

Bars, each stated where it is checked:
- ``conv2d_q8`` and ``dense_q8`` (the plain versions, what a CPU tensor
  runs) bit for bit: the contraction is exact in both packages;
- ``_up_step_q8`` bit for bit on every relu/linear entry, fed the same
  input (a float32 division, round half to even, the int32 fold: the same
  arithmetic); the softmax head within 1e-6 of its largest value (the two
  softmax implementations differ in their last bits);
- the int8 visualizer, dynamic and calibrated: the same switches at every
  pool and the same top-k channels, and grids at ``GRID_PSNR_DB`` (the
  selection is fp32 in both; the bf16 backward rounds differently);
- the calibration artifacts: the same ranges give the same digest and the
  same file bytes in both packages, either package's file loads in the
  other, and a torn, mismatched or future-version file reads as absent.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deconv_api_tpu.engine import quant as j_quant
from deconv_api_tpu.engine.deconv import _forward_chain as j_forward_chain
from deconv_api_tpu.engine.deconv import _up_step as j_up_step
from deconv_api_tpu.engine.deconv import _up_step_q8 as j_up_step_q8
from deconv_api_tpu.engine.deconv import get_visualizer as j_get_visualizer
from deconv_api_tpu.models.spec import entry_chain as j_entry_chain
from deconv_api_tpu.models.tiny import vgg_tiny_init
from deconv_api_tpu.ops import activations as j_activations
from deconv_api_tpu.ops.conv import conv2d_q8 as j_conv2d_q8
from deconv_api_tpu.ops.linear import dense_q8 as j_dense_q8
from deconv_api_tpu.serving.codec import _stitch_grid_traced
from deconv_api_tpu.utils.quantize import int8_scale as j_int8_scale
from deconv_api_tpu_torch import ops
from deconv_api_tpu_torch.engine import quant
from deconv_api_tpu_torch.engine.deconv import _forward_chain, _up_step, _up_step_q8, get_visualizer
from deconv_api_tpu_torch.models.spec import entry_chain
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.weights import params_from_jax
from deconv_api_tpu_torch.ops import cuda_q8
from deconv_api_tpu_torch.serving.codec import stitch_grid
from deconv_api_tpu_torch.serving.models import ModelBundle

B = 3
# port against JAX, int8 grids: the forward, switches and selection agree;
# the bf16 backward and the deprocess round in other places
GRID_PSNR_DB = 52.0
SOFTMAX_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _params():
    spec, params = vgg_tiny_init(jax.random.key(0, impl="rbg"))
    return spec, params, params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _images(n=B, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, 32, 32, 3)) * 50).astype(np.float32)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _rand_q8(rng, shape, extreme=False):
    if extreme:  # every product at its largest magnitude: the widest sums
        return np.where(rng.random(shape) < 0.5, -127, 127).astype(np.int8)
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("cin", [3, 64])
@pytest.mark.parametrize("strides", [(1, 1), (2, 2)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv2d_q8_is_bit_exact_against_jax(padding, strides, cin):
    """Plain int8 conv against JAX's, bit for bit, on random and on
    extreme operands (|acc| up to 127^2 * 9 * cin)."""
    rng = np.random.default_rng(cin + 7 * strides[0])
    for extreme in (False, True):
        x, w = _rand_q8(rng, (2, 9, 11, cin), extreme), _rand_q8(rng, (3, 3, cin, 8), extreme)
        got = ops.conv2d_q8(torch.from_numpy(x), torch.from_numpy(w), strides=strides, padding=padding)
        want = np.asarray(j_conv2d_q8(jnp.asarray(x), jnp.asarray(w), strides=strides, padding=padding))
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 75, 6), (3, 1024, 40)])
def test_dense_q8_is_bit_exact_against_jax(shape):
    b, din, dout = shape
    rng = np.random.default_rng(din)
    for extreme in (False, True):
        x, w = _rand_q8(rng, (b, din), extreme), _rand_q8(rng, (din, dout), extreme)
        got = ops.dense_q8(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_dense_q8(jnp.asarray(x), jnp.asarray(w))))


def test_the_kernel_wrapper_raises_on_what_it_does_not_take():
    """No fallback: the K5 wrapper takes contiguous int8 CUDA tensors and no
    groups; the plain route (a CPU tensor) takes groups, as XLA does."""
    x, w = torch.zeros((1, 4, 4, 4), dtype=torch.int8), torch.zeros((3, 3, 2, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="groups"):
        cuda_q8.conv2d_q8(x, w, feature_group_count=2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_q8.conv2d_q8(x, torch.zeros((3, 3, 4, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_q8.dense_q8(x.reshape(1, -1), torch.zeros((64, 2), dtype=torch.int8))
    rng = np.random.default_rng(1)
    xg, wg = _rand_q8(rng, (1, 4, 4, 4)), _rand_q8(rng, (3, 3, 2, 4))
    got = ops.conv2d_q8(torch.from_numpy(xg), torch.from_numpy(wg), feature_group_count=2)
    want = j_conv2d_q8(jnp.asarray(xg), jnp.asarray(wg), feature_group_count=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.int8_safe_activation("relu") and not ops.int8_safe_activation("relu6")
    for name in ("linear", "relu", "relu6", "softmax"):
        assert ops.int8_safe_activation(name) == j_activations.int8_safe_activation(name)


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
def test_up_step_q8_matches_jax_on_every_entry(calibrated):
    """Each conv and dense entry of vgg_tiny, fed the float walk's input:
    relu/linear entries bit for bit, the softmax head within SOFTMAX_TOL.
    Dynamic ranges are per row (JAX: per example under vmap); a calibrated
    range is a constant (here 1.5x the row's own).  JAX's step runs op by
    op here: under ``jit`` XLA rounds the dequant product in another order
    (1 ulp on some values), which the visualizer tests below cover with
    their bars."""
    _, jparams, tparams = _params()
    x = torch.from_numpy(_images())
    switches = {}
    for e, je in zip(entry_chain(VGG_TINY_SPEC), j_entry_chain(_params()[0])):
        if not e.is_companion_act and e.layer.kind in ("conv", "dense"):
            amax = x.float().abs().amax(dim=tuple(range(1, x.dim())))
            if calibrated:
                amax = amax * 1.5
                got = torch.cat([_up_step_q8(e, tparams, x[i:i + 1], float(amax[i])) for i in range(B)])
            else:
                got = _up_step_q8(e, tparams, x, amax)
            # JAX's step per example (vmap), op by op: the dynamic range a
            # traced scalar, a calibrated one given as the same float32
            want = np.asarray(jax.vmap(lambda xi, a: j_up_step_q8(je, jparams, xi[None], a)[0])(
                jnp.asarray(x.numpy()), jnp.asarray(amax.numpy())))
            if e.layer.activation == "softmax":
                np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SOFTMAX_TOL * np.abs(want).max())
            else:
                np.testing.assert_array_equal(got.numpy(), want, err_msg=e.name)
        x = _up_step(e, tparams, x, switches)


def _op_by_op_up_step_q8(e, params, x, amax):
    """The int8 step written op by op on whole tensors, as a reference:
    ``ops.conv2d_q8_step`` / ``dense_q8_step`` (and K5 on the card) must
    give its bits."""
    levels = lambda a: torch.where(a > 0, a, torch.full_like(a, 127.0)) / torch.full_like(a, 127.0)
    l = e.layer
    w, b, x = params[l.name]["w"].float(), params[l.name]["b"].float(), x.float()
    if not isinstance(amax, torch.Tensor):
        amax = torch.full((x.shape[0],), amax, dtype=torch.float32)
    sx = levels(amax).reshape(-1, *[1] * (x.dim() - 1))
    sw = levels(w.abs().amax())
    xq = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    wq = torch.clamp(torch.round(w / sw), -127, 127).to(torch.int8)
    if l.kind == "conv":
        acc = ops.conv2d_q8(xq, wq, strides=l.strides, padding=l.padding)
    else:
        acc = ops.dense_q8(xq, wq)
    scale = sx * sw
    acc = acc + torch.clamp(torch.round(b / scale), -(2.0**30), 2.0**30).to(torch.int32)
    if l.activation == "relu":
        return torch.clamp_min(acc, 0).float() * scale
    y = acc.float() * scale
    return y if l.activation == "linear" else ops.apply_activation(y, l.activation)


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
def test_the_ops_step_equals_the_op_by_op_step_on_every_entry(calibrated):
    """``_up_step_q8`` (the ops step, plain on the CPU) against the op-by-op
    reference on every conv and dense entry of vgg_tiny, bit for bit
    (-0.0 included), with a zero image among the rows (amax 0, scale 1)."""
    _, _, tparams = _params()
    x = torch.from_numpy(_images(4, seed=2))
    x[1] = 0.0
    switches, checked = {}, 0
    for e in entry_chain(VGG_TINY_SPEC):
        if not e.is_companion_act and e.layer.kind in ("conv", "dense"):
            amax = ops.row_amax(x)
            assert torch.equal(amax, x.abs().amax(dim=tuple(range(1, x.dim()))))
            if calibrated:
                amax = float(amax.max()) * 1.5
            got = _up_step_q8(e, tparams, x, amax)
            assert torch.equal(_bits(got), _bits(_op_by_op_up_step_q8(e, tparams, x, amax))), e.name
            checked += 1
        x = _up_step(e, tparams, x, switches)
    assert checked == 7


@pytest.mark.parametrize("shape", [(3, 3, 3, 16), (3, 3, 16, 5), (1, 1, 8, 8), (40, 24)], ids=str)
def test_the_weight_quantizes_k_major(shape):
    """``quantize_weight_q8``: the int8 kernel at ``max|w| / 127``, as
    (Cout, KH, KW, Cin) or (Dout, Din); its scale JAX's."""
    w = torch.from_numpy(np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32))
    wq, sw = ops.quantize_weight_q8(w)
    want = torch.clamp(torch.round(w / (w.abs().amax() / 127)), -127, 127).to(torch.int8)
    assert torch.equal(wq, want.permute(3, 0, 1, 2) if w.dim() == 4 else want.T)
    assert wq.is_contiguous() and sw.dim() == 0
    assert float(sw) == float(np.float32(j_int8_scale(float(np.abs(w.numpy()).max()))))
    zero, s0 = ops.quantize_weight_q8(torch.zeros(shape))
    assert float(s0) == 1.0 and not zero.any()


@pytest.mark.parametrize("wrapper", ["quantize_rows", "quantize_weight", "conv2d_q8_fused", "dense_q8_fused",
                                     "conv2d_q8_kmajor", "dense_q8_kmajor"])
def test_the_step_wrappers_take_only_card_tensors(wrapper):
    """No fallback in the K5 wrappers: a CPU tensor raises before any
    kernel loads."""
    f32 = torch.zeros((2, 4, 4, 16))
    q = torch.zeros((2, 4, 4, 16), dtype=torch.int8)
    w = torch.zeros((8, 3, 3, 16), dtype=torch.int8)
    b, s = torch.zeros(8), torch.ones(2)
    calls = {
        "quantize_rows": lambda: cuda_q8.quantize_rows(f32, s),
        "quantize_weight": lambda: cuda_q8.quantize_weight(torch.zeros((3, 3, 16, 8)), torch.ones(())),
        "conv2d_q8_fused": lambda: cuda_q8.conv2d_q8_fused(q, w, b, s, relu=True),
        "dense_q8_fused": lambda: cuda_q8.dense_q8_fused(q.reshape(2, -1), torch.zeros((8, 256), dtype=torch.int8),
                                                         b, s, relu=False),
        "conv2d_q8_kmajor": lambda: cuda_q8.conv2d_q8_kmajor(q, w),
        "dense_q8_kmajor": lambda: cuda_q8.dense_q8_kmajor(q.reshape(2, -1), torch.zeros((8, 256), dtype=torch.int8)),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[wrapper]()


def _jax_switches_and_ups(quant_spec, layer, images):
    spec, jparams, _ = _params()
    entries = j_entry_chain(spec.truncated(layer))

    def one(image):
        switches = {}
        ups = j_forward_chain(entries, jparams, image, switches, False, 0, quant=quant_spec)
        return {k: v[0] for k, v in switches.items()}, ups[-1]

    sw, out = jax.jit(jax.vmap(one))(jnp.asarray(images))
    return {k: np.asarray(v)[:, 0] for k, v in sw.items()}, np.asarray(out)[:, 0]


def _calibrated_spec():
    spec, jparams, _ = _params()
    return j_quant.quant_spec(j_quant.collect_ranges(spec, jparams, list(_images(4, seed=5)), layer="fc1"))


@pytest.mark.parametrize("kind", ["dynamic", "calibrated"])
def test_int8_forward_switches_match_jax(kind):
    """The int8 walk to fc1: every pool's switches equal JAX's (dequantized
    activations tie far more often than fp32 ones: both take the first
    maximum), and the walk's output within 1e-5 of its largest value."""
    quant_spec = "dynamic" if kind == "dynamic" else _calibrated_spec()
    images = _images()
    want_sw, want_out = _jax_switches_and_ups(quant_spec, "fc1", images)
    _, _, tparams = _params()
    switches = {}
    ups = _forward_chain(entry_chain(VGG_TINY_SPEC.truncated("fc1")), tparams, torch.from_numpy(images),
                         switches, quant_spec)
    assert set(switches) == set(want_sw)
    for name, (idx, _) in switches.items():
        np.testing.assert_array_equal(idx.numpy(), want_sw[name], err_msg=name)
    out = ups[-1].numpy()
    np.testing.assert_allclose(out, want_out, rtol=0, atol=1e-5 * np.abs(want_out).max())


@pytest.mark.parametrize("layer", ["block3_conv1", "fc1"])
@pytest.mark.parametrize("kind", ["dynamic", "calibrated"])
def test_int8_visualizer_matches_jax(kind, layer):
    """``get_visualizer(quant=...)`` against JAX's, bf16 backward (the
    serving default): the same top-4 channels and validity, and 2x2 grids
    at GRID_PSNR_DB."""
    quant_spec = "dynamic" if kind == "dynamic" else _calibrated_spec()
    spec, jparams, tparams = _params()
    images = _images()
    r = j_get_visualizer(spec, layer, 4, "all", True, batched=True, backward_dtype="bfloat16",
                         quant=quant_spec)(jparams, images)[layer]
    want_grid = np.asarray(_stitch_grid_traced(r["images"], r["valid"]))
    p = get_visualizer(VGG_TINY_SPEC, layer, 4, "all", True, "bfloat16", device="cpu",
                       quant=quant_spec)(tparams, torch.from_numpy(images))[layer]
    np.testing.assert_array_equal(p["indices"].numpy(), np.asarray(r["indices"]))
    np.testing.assert_array_equal(p["valid"].numpy(), np.asarray(r["valid"]))
    got_grid = stitch_grid(p["images"], p["valid"]).numpy()
    for i in range(B):
        assert _psnr(got_grid[i], want_grid[i]) >= GRID_PSNR_DB, (kind, layer, i)


def test_a_rows_int8_forward_does_not_depend_on_its_batch():
    """Per-example ranges: an image's int8 walk (switches and output) is
    the same alone as beside other images, bit for bit on the CPU."""
    _, _, tparams = _params()
    images = torch.from_numpy(_images(4, seed=3))
    entries = entry_chain(VGG_TINY_SPEC.truncated("fc1"))
    together = {}
    ups = _forward_chain(entries, tparams, images, together, "dynamic")
    for i in range(4):
        alone = {}
        one = _forward_chain(entries, tparams, images[i:i + 1], alone, "dynamic")
        assert torch.equal(one[-1][0], ups[-1][i])
        for name in alone:
            assert torch.equal(alone[name][0][0], together[name][0][i])


def test_the_int8_walk_differs_from_the_float_one_and_rejects_bad_specs():
    _, _, tparams = _params()
    images = torch.from_numpy(_images())
    fl = get_visualizer(VGG_TINY_SPEC, "block3_conv1", device="cpu")(tparams, images)["block3_conv1"]
    q8 = get_visualizer(VGG_TINY_SPEC, "block3_conv1", device="cpu", quant="dynamic")(tparams, images)
    assert not torch.equal(fl["sums"], q8["block3_conv1"]["sums"])
    for bad in ("static", 3, ["a", 1.0]):
        with pytest.raises(ValueError, match="illegal quant spec"):
            get_visualizer(VGG_TINY_SPEC, "block3_conv1", device="cpu", quant=bad)
        with pytest.raises(ValueError, match="illegal quant spec"):
            j_get_visualizer(_params()[0], "block3_conv1", quant=bad)


def test_each_tier_captures_its_own_program():
    """The program key: full keeps the key without tiers; bf16 (the staged
    dtype), dynamic int8 and calibrated int8 each key a program of their
    own per bucket."""
    _, _, tparams = _params()
    bundle = ModelBundle(VGG_TINY_SPEC, tparams, torch.device("cpu"))
    calibrated = (("block1_conv1", 200.0),)
    programs = {
        "full": bundle.program("block3_conv1", "all", 4, 1, post="grid"),
        "bf16": bundle.program("block3_conv1", "all", 4, 1, post="grid", dtype=torch.bfloat16),
        "dynamic": bundle.program("block3_conv1", "all", 4, 1, post="grid", quant="dynamic"),
        "calibrated": bundle.program("block3_conv1", "all", 4, 1, post="grid", quant=calibrated),
    }
    assert len(set(map(id, programs.values()))) == 4 and len(bundle.programs) == 4
    full_key = ("deconv", "vgg_tiny", "block3_conv1", "all", 4, "grid", False, "off", 0, True, None, 1,
                (1, 32, 32, 3))
    assert full_key in bundle.programs.keys()
    assert programs["bf16"].static[0].dtype == torch.bfloat16
    x = _images(1)
    grids = {name: prog(torch.from_numpy(x))["block3_conv1"]["grid"].clone() for name, prog in programs.items()}
    assert not torch.equal(grids["full"], grids["dynamic"])


def test_calibration_artifacts_are_the_same_bytes_in_both_packages(tmp_path):
    """The same ranges: one digest, one file's bytes; either package's file
    loads in the other with the same ranges and quant spec."""
    ranges = {"block1_conv1": 162.37, "fc1": 3.25, "block2_conv1": np.float32(12.5), "block3_conv1": 0.0}
    assert quant.ranges_digest(ranges) == j_quant.ranges_digest(ranges)
    p_path, p_digest = quant.save_calibration(str(tmp_path / "p"), "vgg_tiny", ranges, image_size=32, n_images=4,
                                              source="test")
    j_path, j_digest = j_quant.save_calibration(str(tmp_path / "j"), "vgg_tiny", ranges, image_size=32, n_images=4,
                                                source="test")
    assert p_digest == j_digest
    assert open(p_path, "rb").read() == open(j_path, "rb").read()
    for reader in (quant.load_calibration, j_quant.load_calibration):
        for d in ("p", "j"):
            payload = reader(str(tmp_path / d), "vgg_tiny")
            assert payload["digest"] == p_digest
            assert quant.quant_spec(payload["ranges"]) == j_quant.quant_spec(payload["ranges"])
    assert quant.QUALITY_TIERS == j_quant.QUALITY_TIERS and quant.DYNAMIC == j_quant.DYNAMIC


@pytest.mark.parametrize("damage", ["torn", "digest", "future", "garbage", "missing"])
def test_a_damaged_artifact_reads_as_absent_in_both(tmp_path, damage):
    path, _ = quant.save_calibration(str(tmp_path), "vgg_tiny", {"block1_conv1": 10.0, "fc1": 2.0})
    raw = open(path, "rb").read()
    if damage == "torn":
        open(path, "wb").write(raw[: len(raw) // 2])
    elif damage == "digest":
        doc = json.loads(raw)
        doc["ranges"]["fc1"] = 3.0
        open(path, "w").write(json.dumps(doc))
    elif damage == "future":
        doc = json.loads(raw)
        doc["version"] = doc["v"] = 2
        open(path, "w").write(json.dumps(doc))
    elif damage == "garbage":
        open(path, "wb").write(b"\x00\xff[")
    else:
        os.remove(path)
    assert quant.load_calibration(str(tmp_path), "vgg_tiny") is None
    assert j_quant.load_calibration(str(tmp_path), "vgg_tiny") is None


def test_collect_ranges_matches_jax():
    """The same images through the float walk: the same entries, each range
    within 1e-5 relative of JAX's (the float convs sum in another order)."""
    spec, jparams, tparams = _params()
    images = list(_images(4, seed=5))
    want = j_quant.collect_ranges(spec, jparams, images, layer="fc1")
    got = quant.collect_ranges(VGG_TINY_SPEC, tparams, images, layer="fc1", batch=3)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-5), name
    assert got == quant.collect_ranges(VGG_TINY_SPEC, tparams, images[::-1], layer="fc1")  # order-free
