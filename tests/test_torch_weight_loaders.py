"""The port's weight loaders (``models/weights.py``, ``models/dag_weights.py``)
against the JAX package's, on the same files: synthetic Keras h5 files
written with h5py as ``tests/test_weights.py`` writes them (sequential with
both dataset naming schemes, ResNet50 with current and legacy names,
InceptionV3 numbered from 0 and from 1, MobileNet v1 and v2 with their
depthwise kernels), each read by both packages into trees that must be
equal leaf for leaf; the same messages for a shape mismatch, a missing
trunk layer and too few convs; npz round trips of the nested DAG trees
across the packages; and the committed golden fixture
(``tests/fixtures/golden/vgg16_block1.h5``, written by Keras): the port's
truncated VGG16 forward with its weights within 1e-4 of Keras's
activations, the random init not, and the port's committed npz of it
(``tests/fixtures/torch/vgg16_block1.npz``, what the card loads) equal to
what both packages read from the hash-pinned h5.

The trees are the families' JAX trees at 10 classes
(``tests/torch_dag_families.py``), as numpy for the JAX loaders and as
tensors for the port's."""

import dataclasses
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from deconv_api_tpu.models import dag_weights as j_dag
from deconv_api_tpu.models import weights as j_weights
from deconv_api_tpu.models.tiny import VGG_TINY_SPEC as J_TINY_SPEC
from deconv_api_tpu_torch.models import VGG16_SPEC, VGG_TINY_SPEC, init_params
from deconv_api_tpu_torch.models import dag_weights, weights
from deconv_api_tpu_torch.models.apply import spec_forward
from deconv_api_tpu_torch.models.weights import params_from_jax
from tests.torch_dag_families import numpy_params

h5py = pytest.importorskip("h5py")

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
PORT_NPZ = os.path.join(os.path.dirname(__file__), "fixtures", "torch", "vgg16_block1.npz")
# the JAX package's pin (tests/test_weights_golden.py) and the port's npz
H5_SHA256 = "b0969ec43c0949b7c3ec522f752b02eca6db29780831da73b89971656e4fd397"
NPZ_SHA256 = "9180ba4a4c5512a2f6369d67082033aed4d877cbf300b3cdc5c5b4e49c231f02"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_same_tree(port: dict, jtree: dict) -> None:
    """Equal keys, and every port leaf a float32 tensor equal to the JAX
    leaf."""
    p, j = _leaves(port), _leaves(jtree)
    assert sorted(p) == sorted(j)
    for key, leaf in p.items():
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32, key
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(j[key]), err_msg=key)


def _tiny_numpy(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {name: {leaf: rng.standard_normal(tuple(t.shape)).astype(np.float32) for leaf, t in layer.items()}
            for name, layer in init_params(VGG_TINY_SPEC, torch.Generator().manual_seed(0)).items()}


# ------------------------------------------------------------- sequential h5


def _fill_sequential_h5(path, params, scheme="keras2", wrap=False):
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights") if wrap else f
        for name, leaves in params.items():
            g = root.create_group(name)
            w, b = np.asarray(leaves["w"]), np.asarray(leaves["b"])
            if scheme == "keras2":
                gg = g.create_group(name)
                gg.create_dataset("kernel:0", data=w)
                gg.create_dataset("bias:0", data=b)
            else:  # keras1
                g.create_dataset(f"{name}_W:0", data=w)
                g.create_dataset(f"{name}_b:0", data=b)


@pytest.mark.parametrize("scheme,wrap", [("keras2", False), ("keras1", True)])
def test_sequential_h5_loads_as_the_jax_package(tmp_path, scheme, wrap):
    init, golden = _tiny_numpy(0), _tiny_numpy(1)
    path = str(tmp_path / "vgg_tiny.h5")
    _fill_sequential_h5(path, golden, scheme, wrap)
    port = weights.load_model_weights("vgg_tiny", VGG_TINY_SPEC, path, params_from_jax(init))
    jtree = j_weights.load_model_weights("vgg_tiny", J_TINY_SPEC, path, init)
    assert_same_tree(port, jtree)
    assert_same_tree(port, golden)


def _messages(port_call, jax_call) -> tuple[str, str]:
    with pytest.raises(ValueError) as pe:
        port_call()
    with pytest.raises(ValueError) as je:
        jax_call()
    return str(pe.value), str(je.value)


def test_sequential_shape_mismatch_raises_the_jax_message(tmp_path):
    init = _tiny_numpy(0)
    bad = {"block1_conv1": {"w": np.zeros((5, 5, 3, 16), np.float32), "b": np.zeros(16, np.float32)}}
    path = str(tmp_path / "bad.h5")
    _fill_sequential_h5(path, bad)
    port_msg, jax_msg = _messages(lambda: weights.load_weights(VGG_TINY_SPEC, path, params_from_jax(init)),
                                  lambda: j_weights.load_weights(J_TINY_SPEC, path, init))
    assert port_msg == jax_msg and "block1_conv1" in port_msg


def test_missing_layers_keep_their_init(tmp_path):
    init, golden = _tiny_numpy(0), _tiny_numpy(1)
    path = str(tmp_path / "partial.h5")
    _fill_sequential_h5(path, {"block1_conv1": golden["block1_conv1"]})
    port = weights.load_weights(VGG_TINY_SPEC, path, params_from_jax(init))
    np.testing.assert_array_equal(port["block1_conv1"]["w"].numpy(), golden["block1_conv1"]["w"])
    for name in init:
        if name != "block1_conv1":  # untouched layers keep their init values
            np.testing.assert_array_equal(port[name]["w"].numpy(), init[name]["w"])
    assert_same_tree(port, j_weights.load_weights(J_TINY_SPEC, path, init))


# ------------------------------------------------------------------- DAG h5


def _conv_bn(rng, like, bias=True, gamma=True):
    cout = like["w"].shape[-1]
    t = {
        "kernel": rng.standard_normal(like["w"].shape).astype(np.float32),
        "beta": rng.standard_normal(cout).astype(np.float32),
        "moving_mean": rng.standard_normal(cout).astype(np.float32),
        "moving_variance": rng.random(cout).astype(np.float32) + 0.5,
    }
    if gamma:
        t["gamma"] = rng.standard_normal(cout).astype(np.float32)
    if bias:
        t["bias"] = rng.standard_normal(cout).astype(np.float32)
    return t


def _write_conv_bn(root, conv_name, bn_name, t, kernel_key="kernel"):
    g = root.create_group(conv_name).create_group(conv_name)
    g.create_dataset(f"{kernel_key}:0", data=t["kernel"])
    if "bias" in t:
        g.create_dataset("bias:0", data=t["bias"])
    b = root.create_group(bn_name).create_group(bn_name)
    for key in ("gamma", "beta", "moving_mean", "moving_variance"):
        if key in t:
            b.create_dataset(f"{key}:0", data=t[key])


def _write_dense(root, name, w, b):
    g = root.create_group(name).create_group(name)
    g.create_dataset("kernel:0", data=w)
    g.create_dataset("bias:0", data=b)


def _resnet_h5(path, rng, init, legacy):
    with h5py.File(path, "w") as f:
        _write_conv_bn(f, *(("conv1", "bn_conv1") if legacy else ("conv1_conv", "conv1_bn")),
                       _conv_bn(rng, init["conv1"]))
        for stage, n_blocks in j_dag._RESNET_STAGES:
            for i in range(1, n_blocks + 1):
                bk = f"{stage}_block{i}"
                for ours, j, br in j_dag._RESNET_BRANCHES:
                    if ours not in init[bk]:
                        continue
                    if legacy:
                        blk = chr(ord("a") + i - 1)
                        names = (f"res{stage[-1]}{blk}_branch{br}", f"bn{stage[-1]}{blk}_branch{br}")
                    else:
                        names = (f"{bk}_{j}_conv", f"{bk}_{j}_bn")
                    _write_conv_bn(f, *names, _conv_bn(rng, init[bk][ours]))
        w = init["predictions"]["w"]
        _write_dense(f, "fc1000" if legacy else "predictions", rng.standard_normal(w.shape).astype(np.float32),
                     rng.standard_normal(w.shape[-1]).astype(np.float32))


def _inception_h5(path, rng, init, one_based):
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        for idx, p_path in enumerate(j_dag.INCEPTION_V3_CONV_ORDER):
            like = init[p_path[0]] if len(p_path) == 1 else init[p_path[0]][p_path[1]]
            k = idx + 1 if one_based else idx
            suffix = f"_{k}" if k else ""
            # keras inception: no conv bias, BN without scale
            _write_conv_bn(root, f"conv2d{suffix}", f"batch_normalization{suffix}",
                           _conv_bn(rng, like, bias=False, gamma=False))


def _depthwise(rng, like):
    """Keras's (kh, kw, C, 1) depthwise kernel for a (kh, kw, 1, C) leaf."""
    t = _conv_bn(rng, like, bias=False)
    t["kernel"] = np.ascontiguousarray(np.transpose(t["kernel"], (0, 1, 3, 2)))
    return t


def _mobilenet_v1_h5(path, rng, init):
    with h5py.File(path, "w") as f:
        _write_conv_bn(f, "conv1", "conv1_bn", _conv_bn(rng, init["conv1"], bias=False))
        for key in init:
            if key.startswith("conv_dw_"):  # keras 2 names the depthwise kernel
                _write_conv_bn(f, key, f"{key}_bn", _depthwise(rng, init[key]), kernel_key="depthwise_kernel")
            elif key.startswith("conv_pw_"):
                _write_conv_bn(f, key, f"{key}_bn", _conv_bn(rng, init[key], bias=False))
        w = init["predictions"]["w"]  # keras's 1x1 conv_preds
        _write_dense(f, "conv_preds", rng.standard_normal((1, 1, *w.shape)).astype(np.float32),
                     rng.standard_normal(w.shape[-1]).astype(np.float32))


def _mobilenet_v2_h5(path, rng, init):
    with h5py.File(path, "w") as f:
        _write_conv_bn(f, "Conv1", "bn_Conv1", _conv_bn(rng, init["Conv1"], bias=False))
        _write_conv_bn(f, "Conv_1", "Conv_1_bn", _conv_bn(rng, init["Conv_1"], bias=False))
        # keras 3 names the depthwise kernel plain "kernel"
        _write_conv_bn(f, "expanded_conv_depthwise", "expanded_conv_depthwise_BN",
                       _depthwise(rng, init["expanded_conv"]["depthwise"]))
        _write_conv_bn(f, "expanded_conv_project", "expanded_conv_project_BN",
                       _conv_bn(rng, init["expanded_conv"]["project"], bias=False))
        for key in init:
            if key.startswith("block_"):
                for part in ("expand", "depthwise", "project"):
                    t = (_depthwise if part == "depthwise" else _conv_bn)(rng, init[key][part])
                    t.pop("bias", None)
                    _write_conv_bn(f, f"{key}_{part}", f"{key}_{part}_BN", t)
        w = init["predictions"]["w"]
        _write_dense(f, "predictions", rng.standard_normal(w.shape).astype(np.float32),
                     rng.standard_normal(w.shape[-1]).astype(np.float32))


DAG_FILES = {
    "resnet50-current": ("resnet50", lambda p, r, i: _resnet_h5(p, r, i, legacy=False)),
    "resnet50-legacy": ("resnet50", lambda p, r, i: _resnet_h5(p, r, i, legacy=True)),
    "inception_v3-0based": ("inception_v3", lambda p, r, i: _inception_h5(p, r, i, one_based=False)),
    "inception_v3-1based": ("inception_v3", lambda p, r, i: _inception_h5(p, r, i, one_based=True)),
    "mobilenet_v1": ("mobilenet_v1", _mobilenet_v1_h5),
    "mobilenet_v2": ("mobilenet_v2", _mobilenet_v2_h5),
}


@pytest.mark.parametrize("case", sorted(DAG_FILES))
def test_dag_h5_loads_as_the_jax_package(tmp_path, case):
    family, write = DAG_FILES[case]
    init = numpy_params(family)
    path = str(tmp_path / f"{family}.h5")
    write(path, np.random.default_rng(3), init)
    port = weights.load_model_weights(family, None, path, params_from_jax(init))
    jtree = j_weights.load_model_weights(family, None, path, init)
    assert_same_tree(port, jtree)
    # every leaf left its init but a classifier the file lacks
    kept = {k for k, v in _leaves(port).items() if np.array_equal(v.numpy(), _leaves(init)[k])}
    assert kept == ({"predictions/w", "predictions/b"} if family == "inception_v3" else set())


def test_missing_trunk_layers_raise_the_jax_messages(tmp_path):
    rng = np.random.default_rng(0)
    for family, key, conv, bn in (("resnet50", "conv1", "conv1_conv", "conv1_bn"),
                                  ("mobilenet_v1", "conv1", "conv1", "conv1_bn"),
                                  ("mobilenet_v2", "Conv1", "Conv1", "bn_Conv1"),
                                  ("inception_v3", "stem1", "conv2d", "batch_normalization")):
        init = numpy_params(family)
        like = init[key]
        path = str(tmp_path / f"{family}_short.h5")
        with h5py.File(path, "w") as f:
            _write_conv_bn(f, conv, bn, _conv_bn(rng, like, bias=False))
        port_msg, jax_msg = _messages(lambda: weights.load_model_weights(family, None, path, params_from_jax(init)),
                                      lambda: j_weights.load_model_weights(family, None, path, init))
        assert port_msg == jax_msg, family
        assert ("expected 94" if family == "inception_v3" else "missing layer") in port_msg


def test_dag_kernel_shape_mismatch_raises_the_jax_message(tmp_path):
    init = numpy_params("mobilenet_v1")
    path = str(tmp_path / "bad.h5")
    t = _conv_bn(np.random.default_rng(0), {"w": np.zeros((5, 5, 3, 32), np.float32)}, bias=False)
    with h5py.File(path, "w") as f:
        _write_conv_bn(f, "conv1", "conv1_bn", t)
    port_msg, jax_msg = _messages(lambda: weights.load_model_weights("mobilenet_v1", None, path, params_from_jax(init)),
                                  lambda: j_weights.load_model_weights("mobilenet_v1", None, path, init))
    assert port_msg == jax_msg and "kernel shape" in port_msg


# ---------------------------------------------------------------------- npz


@pytest.mark.parametrize("family", ["resnet50", "mobilenet_v2"])
def test_npz_round_trips_nested_trees_across_the_packages(tmp_path, family):
    tree = numpy_params(family)
    port_zero = weights.tree_map(torch.zeros_like, params_from_jax(tree))
    # the JAX package's archive into the port, and the port's into JAX
    j_path, p_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j_weights.save_npz(tree, j_path)
    weights.save_npz(params_from_jax(tree), p_path)
    assert_same_tree(weights.load_model_weights(family, None, j_path, port_zero), tree)
    assert_same_tree(params_from_jax(j_weights.load_model_weights(family, None, p_path, tree)), tree)


def _save_flat(path, flat: dict) -> str:
    np.savez(str(path), **flat)
    return str(path)


def test_npz_shape_mismatch_and_unknown_keys(tmp_path):
    init = _tiny_numpy(0)
    path = _save_flat(tmp_path / "bad.npz", {"block1_conv1/w": np.zeros((1, 1, 3, 16), np.float32),
                                             "no_such_layer/w": np.zeros(3, np.float32)})
    port_msg, jax_msg = _messages(lambda: weights.load_npz_into(path, params_from_jax(init)),
                                  lambda: j_weights.load_npz_into(path, init))
    assert port_msg == jax_msg and "block1_conv1/w" in port_msg
    ok = _save_flat(tmp_path / "ok.npz", {"no_such_layer/w": np.zeros(3, np.float32)})
    assert_same_tree(weights.load_npz_into(ok, params_from_jax(init)), init)


def test_without_h5py_an_h5_file_says_to_use_npz(tmp_path, monkeypatch):
    path = str(tmp_path / "vgg_tiny.h5")
    _fill_sequential_h5(path, _tiny_numpy(1))
    monkeypatch.setitem(sys.modules, "h5py", None)
    for call in (lambda: weights.load_model_weights("vgg_tiny", VGG_TINY_SPEC, path, params_from_jax(_tiny_numpy(0))),
                 lambda: dag_weights.read_h5_layers(path)):
        with pytest.raises(ImportError, match="needs h5py.*npz"):
            call()


def test_a_checkpoint_directory_and_other_formats_are_refused(tmp_path):
    init = params_from_jax(_tiny_numpy(0))
    with pytest.raises(ValueError, match="orbax checkpoint"):
        weights.load_model_weights("vgg_tiny", VGG_TINY_SPEC, str(tmp_path), init)
    other = tmp_path / "w.pt"
    other.write_bytes(b"")
    with pytest.raises(ValueError, match="unsupported weights format"):
        weights.load_model_weights("vgg_tiny", VGG_TINY_SPEC, str(other), init)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        weights.load_model_weights("vgg_tiny", VGG_TINY_SPEC, str(tmp_path / "none.npz"), init)


# ------------------------------------------------------------------- golden


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _rel_err(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()), 1e-6)


def _golden_spec():
    return dataclasses.replace(VGG16_SPEC.truncated("block1_pool"), input_shape=(64, 64, 3))


def _golden_acts(params) -> dict:
    exp = np.load(os.path.join(GOLDEN, "vgg16_block1_expected.npz"))
    with torch.no_grad():
        _, acts = spec_forward(_golden_spec())(params, torch.from_numpy(exp["x"]))
    return {k: _rel_err(exp[k], acts[k].numpy()) for k in ("block1_conv1", "block1_pool")}


@pytest.mark.parametrize("source", ["h5", "npz"])
def test_golden_fixture_matches_keras_and_the_init_does_not(source):
    init = init_params(_golden_spec(), torch.Generator().manual_seed(0))
    path = os.path.join(GOLDEN, "vgg16_block1.h5") if source == "h5" else PORT_NPZ
    loaded = weights.load_model_weights("vgg16", _golden_spec(), path, init)
    errs = _golden_acts(loaded)
    assert max(errs.values()) < 1e-4, errs
    assert _golden_acts(init)["block1_conv1"] > 1e-2


def test_committed_npz_is_what_both_packages_read_from_the_pinned_h5():
    h5 = os.path.join(GOLDEN, "vgg16_block1.h5")
    assert _sha256(h5) == H5_SHA256
    assert _sha256(PORT_NPZ) == NPZ_SHA256
    spec = _golden_spec()
    init = {k: {leaf: t.numpy() for leaf, t in v.items()}
            for k, v in init_params(spec, torch.Generator().manual_seed(0)).items()}
    with np.load(PORT_NPZ) as archive:
        committed = {key: archive[key] for key in archive.files}
    port = _leaves(weights.load_weights(spec, h5, params_from_jax(init)))
    jtree = _leaves(j_weights.load_weights(spec, h5, init))
    assert sorted(committed) == sorted(port) == sorted(jtree)
    for key, value in committed.items():
        np.testing.assert_array_equal(port[key].numpy(), value, err_msg=key)
        np.testing.assert_array_equal(np.asarray(jtree[key]), value, err_msg=key)
