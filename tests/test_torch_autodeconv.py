"""The port's autodiff deconv engine (deconv_api_tpu_torch/engine/autodeconv.py)
and the DAG serving path on the CPU, against the JAX package.

The same params (the JAX init's tree filled from numpy, see
``tests/torch_dag_families.py``) and the same numpy images go through
``jax.vmap(autodeconv_visualizer(...))`` and the port's batched
``autodeconv_visualizer``.  Bars: indices and validity equal where the
reference's ranking separates the top K by more than fp32 error (each test
asserts that precondition, ``engine/crosscheck.py:ranking_separated``),
projections within 1e-4 of the largest reference magnitude, stitched 2x2 grids at >= 65 dB.  Also: the port's own
cross-check against the sequential engine in clean mode, the batched
backward against K separate backward passes (and free of the per-row
fallback), VGG19's sequential projection, and a DAG model served over
HTTP."""

import base64
import json
import threading
import urllib.error
import urllib.parse
import urllib.request
import warnings

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deconv_api_tpu.engine import autodeconv_visualizer as j_autodeconv
from deconv_api_tpu.engine.deconv import get_visualizer as j_get_visualizer
from deconv_api_tpu.models.spec import init_params as j_init_params
from deconv_api_tpu.models.vgg19 import VGG19_SPEC as J_VGG19_SPEC
from deconv_api_tpu.serving.codec import _stitch_grid_traced
from deconv_api_tpu_torch.engine.autodeconv import autodeconv_visualizer, project
from deconv_api_tpu_torch.engine.deconv import _seed_fmaps, get_visualizer
from deconv_api_tpu_torch.models.apply import spec_forward
from deconv_api_tpu_torch.models.blocks import DECONV_RULES
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.vgg19 import VGG19_SPEC
from deconv_api_tpu_torch.models.weights import params_from_jax
from deconv_api_tpu_torch.serving import codec
from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService, Program
from deconv_api_tpu_torch.serving.models import ModelBundle
from deconv_api_tpu_torch.engine.crosscheck import psnr_db, ranking_separated
from tests.torch_dag_families import FAMILIES, both_params, images

K = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_project(family, layer, mode="all", sweep=None):
    jp, _ = both_params(family)
    fn = jax.vmap(j_autodeconv(FAMILIES[family][1], layer, K, mode, sweep_layers=sweep), in_axes=(None, 0))
    out = fn(jp, images(family))
    return out if sweep else {layer: out}


def _port_project(family, layer, mode="all", sweep=None):
    _, tp = both_params(family)
    fn = autodeconv_visualizer(FAMILIES[family][3], layer, K, mode, sweep_layers=sweep, device="cpu")
    return fn(tp, torch.from_numpy(images(family)))


def _assert_matches(got: dict, want: dict, act: np.ndarray):
    # precondition: each image's top K+1 channel sums are apart by more
    # than fp32 error (or tie exactly, as ReLU6-saturated channels do)
    assert all(ranking_separated(torch.from_numpy(act), K))
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(want["indices"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    ref = np.asarray(want["images"])
    img = got["images"].numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert np.abs(img - ref).max() <= 1e-4 * np.abs(ref).max()
    grid = codec.stitch_grid(got["images"], got["valid"]).numpy()
    jgrid = np.asarray(_stitch_grid_traced(want["images"], want["valid"]))
    assert min(psnr_db(g, w) for g, w in zip(grid, jgrid)) >= 65.0


def _act(family, layer):
    _, tp = both_params(family)
    with torch.no_grad():
        _, acts = FAMILIES[family][3](tp, torch.from_numpy(images(family)), rules=DECONV_RULES)
    return acts[layer].numpy()


# one layer per family, deep enough to cross its strided / branching /
# depthwise / residual structure
LAYERS = [
    ("resnet50", "conv4_block2_out", "all"),
    ("resnet50", "conv3_block1_out", "max"),
    ("inception_v3", "mixed2", "all"),
    ("mobilenet_v1", "conv_pw_11_relu", "all"),
    ("mobilenet_v2", "block_6_expand_relu", "all"),
]


@pytest.mark.parametrize("family,layer,mode", LAYERS)
def test_autodeconv_matches_jax(family, layer, mode):
    got = _port_project(family, layer, mode)
    want = _jax_project(family, layer, mode)
    assert list(got) == [layer]
    _assert_matches(got[layer], want[layer], _act(family, layer))
    assert got[layer]["images"].shape == (2, K, *images(family).shape[1:])


SWEEPS = [
    ("resnet50", ("conv3_block1_out", "conv2_block3_out", "conv2_block2_out", "conv2_block1_out", "conv1_relu")),
    ("inception_v3", ("mixed1", "mixed0")),  # across a concat
]


@pytest.mark.parametrize("family,names", SWEEPS)
def test_autodeconv_sweep_matches_jax(family, names):
    """One forward, one retained graph, each swept layer seeded alone; the
    layer list is what the bundle's forward order gives."""
    _, tp = both_params(family)
    bundle = ModelBundle(
        None, tp, torch.device("cpu"), name=family, image_size=FAMILIES[family][4],
        layer_names=FAMILIES[family][2].DECONV_LAYERS, forward_fn=FAMILIES[family][3],
    )
    assert bundle.sweep_layers(names[0]) == names
    got = _port_project(family, names[0], sweep=names)
    want = _jax_project(family, names[0], sweep=names)
    assert list(got) == list(names)
    for name in names:
        _assert_matches(got[name], want[name], _act(family, name))


@pytest.mark.parametrize("layer,mode", [("block2_conv2", "all"), ("block3_conv1", "max"), ("fc1", "all")])
def test_autodeconv_matches_the_sequential_engine_in_clean_mode(layer, mode):
    """Two formulations of Zeiler–Fergus in the port: the gradient of
    ``spec_forward`` under the deconv rules, and the hand-built walk with
    ``bug_compat=False``."""
    from deconv_api_tpu.models.tiny import vgg_tiny_init

    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, vgg_tiny_init(jax.random.key(5, impl="rbg"))[1]))
    x = torch.from_numpy((np.random.default_rng(2).standard_normal((2, 32, 32, 3)) * 50).astype(np.float32))
    got = autodeconv_visualizer(spec_forward(VGG_TINY_SPEC), layer, 8, mode, device="cpu")(tp, x)[layer]
    want = get_visualizer(VGG_TINY_SPEC, layer, 8, mode, bug_compat=False, device="cpu")(tp, x)[layer]
    for key in ("indices", "valid"):
        assert torch.equal(got[key], want[key])
    scale = want["images"].abs().max()
    assert (got["images"] - want["images"]).abs().max() <= 1e-4 * scale


def test_batched_backward_equals_k_separate_passes():
    """The one batched backward (``is_grads_batched``) equals K retained
    backward passes, and no op on the path falls back to a per-row loop
    (the functorch fallback warning stays silent)."""
    _, tp = both_params("resnet50")
    x = torch.from_numpy(images("resnet50")).requires_grad_(True)
    _, acts = FAMILIES["resnet50"][3](tp, x, rules=DECONV_RULES)
    act = acts["conv3_block2_out"]
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = project(act, x, K, "all", retain_graph=True)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert not [w for w in seen if "batching rule" in str(w.message)], [str(w.message) for w in seen]
    seeds = _seed_fmaps(act.detach(), got["indices"], "all").reshape(2, K, *act.shape[1:])
    for k in range(K):
        (row,) = torch.autograd.grad(act, x, seeds[:, k], retain_graph=True)
        torch.testing.assert_close(got["images"][:, k], row, rtol=1e-5, atol=1e-6 * float(row.abs().max()))


@pytest.mark.parametrize("bwd", [None, "bfloat16"])
def test_vgg19_sequential_projection_matches_jax(bwd):
    """VGG19 through the sequential engine at block5_conv4 (32x32 input, the
    conv trunk only): the VGG bars, 65 dB for an fp32 backward, 52 dB for
    bf16."""
    spec = J_VGG19_SPEC.truncated("block5_conv4")
    jp = j_init_params(spec, jax.random.key(3, impl="rbg"))
    x = (np.random.default_rng(4).standard_normal((2, 32, 32, 3)) * 50).astype(np.float32)
    want = j_get_visualizer(spec, "block5_conv4", K, batched=True, backward_dtype=bwd)(jp, x)["block5_conv4"]
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    got = get_visualizer(VGG19_SPEC, "block5_conv4", K, backward_dtype=bwd, device="cpu")(tp, torch.from_numpy(x))
    got = got["block5_conv4"]
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(want["indices"]))
    ref = np.asarray(want["images"])
    if bwd is None:
        assert np.abs(got["images"].numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    grid = codec.stitch_grid(got["images"], got["valid"]).numpy()
    jgrid = np.asarray(_stitch_grid_traced(want["images"], want["valid"]))
    assert min(psnr_db(g, w) for g, w in zip(grid, jgrid)) >= (65.0 if bwd is None else 52.0)


def test_dag_bundle_validates_the_sequential_policies_and_leaves_them_inert():
    """``lowc_kpack`` and ``fused_unpool`` are checked, then change nothing
    on the gradient walk; the backward dtype stays fp32."""
    _, tp = both_params("resnet50")
    bundle = ModelBundle(None, tp, torch.device("cpu"), image_size=64,
                         layer_names=FAMILIES["resnet50"][2].DECONV_LAYERS, forward_fn=FAMILIES["resnet50"][3])
    x = torch.from_numpy(images("resnet50"))
    base = bundle.batched_visualizer("conv2_block1_out", "all", 4)(tp, x)["conv2_block1_out"]
    other = bundle.batched_visualizer("conv2_block1_out", "all", 4, backward_dtype="bfloat16",
                                      fused_unpool="forced", lowc_kpack="forced")(tp, x)["conv2_block1_out"]
    assert base["images"].dtype == torch.float32
    for key in ("images", "indices", "valid"):
        assert torch.equal(base[key], other[key])
    for bad in ({"lowc_kpack": "sometimes"}, {"fused_unpool": "maybe"}):
        with pytest.raises(ValueError, match="illegal"):
            bundle.batched_visualizer("conv2_block1_out", "all", 4, **bad)


def _png_uri(size: int, seed: int) -> str:
    img = np.random.default_rng(seed).integers(0, 256, (size, size + 3, 3)).astype(np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return "data:image/png;base64," + base64.b64encode(buf.tobytes()).decode()


def test_dag_service_answers_post_and_v1_deconv():
    """A DeconvService over a small-input ResNet50 bundle: ``POST /`` grid,
    ``/v1/deconv`` tiles and a sweep over HTTP, served filters equal to the
    engine's, and the tf preprocessing mode carried by the bundle."""
    _, tp = both_params("resnet50")
    bundle = ModelBundle(
        None, tp, torch.device("cpu"), name="resnet50", image_size=64,
        layer_names=FAMILIES["resnet50"][2].DECONV_LAYERS, forward_fn=FAMILIES["resnet50"][3],
    )
    service = DeconvService(bundle, max_batch=4)
    service.start()
    server = DeconvHTTPServer(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]

    def post(path, form):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", urllib.parse.urlencode(form).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        service.warmup()
        assert service.ready
        uri = _png_uri(48, 0)
        status, body = post("/", {"file": uri, "layer": "conv4_block2_out"})
        assert status == 200 and body.startswith("data:image/webp;base64,")
        raw = base64.b64decode(urllib.parse.unquote(body.split(",", 1)[1]))
        assert codec.jpeg_size(raw) == (128, 128)
        status, body = post("/v1/deconv", {"file": uri, "layer": "conv3_block1_out", "top_k": "3"})
        assert status == 200 and 1 <= len(body["filters"]) == len(body["images"]) <= 3
        x = service.decode_preprocess(uri)[None]
        engine = service.run_program(Program("conv3_block1_out", "all", 3, "tiles"), x)["conv3_block1_out"]
        n = int(engine["valid"][0].sum())
        assert body["filters"] == [int(i) for i in engine["indices"][0][:n]]
        status, body = post("/v1/deconv", {"file": uri, "layer": "conv2_block2_out", "sweep": "1", "top_k": "2"})
        assert status == 200 and list(body["layers"]) == ["conv2_block2_out", "conv2_block1_out", "conv1_relu"]
        status, body = post("/", {"file": uri, "layer": "block5_conv1"})
        assert status == 422 and body["error"] == "unknown_layer"
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(10)
    assert not thread.is_alive()
    tf = ModelBundle(None, tp, torch.device("cpu"), image_size=64, preprocess=codec.preprocess_tf,
                     layer_names=("conv1_relu",), forward_fn=FAMILIES["resnet50"][3])
    y = DeconvService(tf).decode_preprocess(_png_uri(64, 1))
    assert y.shape == (64, 64, 3) and -1.0 <= y.min() and y.max() <= 1.0


@pytest.mark.slow
@pytest.mark.parametrize("model", ["resnet50", "inception_v3", "mobilenet_v1", "mobilenet_v2", "vgg19"])
def test_serve_each_new_model_on_the_cpu_at_full_size(model):
    """``python -m deconv_api_tpu_torch serve --model <m> --device cpu`` at
    the model's own input size: warmup, ``POST /`` and ``/v1/deconv``."""
    from deconv_api_tpu_torch.__main__ import build_server

    server = build_server(["serve", "--model", model, "--device", "cpu", "--port", "0", "--max-batch", "2"])
    service = server.service
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        layer = service.bundle.deepest_layer()
        size = service.bundle.image_size
        form = urllib.parse.urlencode({"file": _png_uri(100, 2), "layer": layer}).encode()
        port = server.server_address[1]
        with urllib.request.urlopen(urllib.request.Request(f"http://127.0.0.1:{port}/", form), timeout=600) as r:
            body = json.loads(r.read())
        raw = base64.b64decode(urllib.parse.unquote(body.split(",", 1)[1]))
        assert codec.jpeg_size(raw) == (2 * size, 2 * size)
        with urllib.request.urlopen(urllib.request.Request(f"http://127.0.0.1:{port}/v1/deconv", form), timeout=600) as r:
            assert json.loads(r.read())["filters"]
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(10)
