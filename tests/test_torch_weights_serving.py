"""Pretrained weights on the served path, the offline commands and
``POST /v1/profile``, against the JAX package on the CPU.

A port server and a JAX server of vgg_tiny with the same ``weights_path``
(a file, then a directory of per-model files under a managed weight
manager that pages a model out and in) answer ``POST /`` and ``POST
/v1/deconv`` with grids and tiles within the served routes' bars (JPEG to
JPEG: 65 dB with a float32 backward, 52 dB otherwise, and at the int8
tier), and unlike the init's; the cache-key prefix carries
``weights_path``; ``GET /v1/config`` reports the paths as booleans;
``calibrate --weights`` writes the ranges of the loaded weights; the CLI's
``visualize``, ``dream`` and ``models`` give the JAX CLI's outputs and
``doctor --platform cpu`` its four checks; ``POST /v1/profile`` answers as
the JAX route does, and one armed batch writes one ``torch.profiler``
trace."""

import base64
import glob
import json
import urllib.parse

import cv2
import httpx
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from deconv_api_tpu.cli import main as jax_main
from deconv_api_tpu.config import ServerConfig as JServerConfig
from deconv_api_tpu.engine import quant as j_quant
from deconv_api_tpu.models.tiny import VGG_TINY_SPEC as J_TINY_SPEC, vgg_tiny_init
from deconv_api_tpu.models.weights import load_model_weights as j_load_model_weights
from deconv_api_tpu.serving.app import DeconvService as JDeconvService
from deconv_api_tpu.serving.models import spec_bundle as j_spec_bundle
from deconv_api_tpu_torch.__main__ import _synthetic_images, main
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.weights import params_from_jax, save_npz
from deconv_api_tpu_torch.serving import app as app_mod
from deconv_api_tpu_torch.serving.app import DeconvService
from deconv_api_tpu_torch.serving.models import ModelBundle
from deconv_api_tpu_torch.serving.weight_manager import tree_nbytes
from tests.test_serving import ServiceFixture
from tests.test_torch_pipeline_serving import _Port

LAYER = "block3_conv1"
DREAM_LAYERS = ("block2_conv2", "block3_conv1")
FP32_PSNR_DB = 65.0
PSNR_DB = 52.0
QUIET = {"cache_bytes": 0, "singleflight": False, "max_batch": 4, "batch_window_ms": 1.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def init_tree():
    """The init both packages' vgg_tiny bundles start from."""
    return jax.tree_util.tree_map(np.asarray, vgg_tiny_init(jax.random.key(2, impl="rbg"))[1])


def _trained(seed: int) -> dict:
    """A full vgg_tiny tree that is not the init: the file's weights."""
    rng = np.random.default_rng(seed)
    spec_shapes = jax.eval_shape(lambda: vgg_tiny_init(jax.random.key(0, impl="rbg"))[1])
    return jax.tree_util.tree_map(lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), spec_shapes)


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """``vgg_tiny.npz`` and ``tiny_b.npz`` (``tiny_c`` has no file)."""
    d = tmp_path_factory.mktemp("weights")
    save_npz(params_from_jax(_trained(11)), str(d / "vgg_tiny.npz"))
    save_npz(params_from_jax(_trained(12)), str(d / "tiny_b.npz"))
    return d


def _port_registry(tree, names):
    return {n: (lambda n=n: ModelBundle(VGG_TINY_SPEC, params_from_jax(tree), torch.device("cpu"), name=n,
                                        dream_layers=DREAM_LAYERS)) for n in names}


def _jax_registry(tree, names):
    return {n: (lambda: j_spec_bundle(J_TINY_SPEC, jax.tree_util.tree_map(np.asarray, tree),
                                      dream_layers=DREAM_LAYERS)) for n in names}


def _pair(tree, names=("vgg_tiny",), port_kw=None, **kw):
    """(port, JAX) servers of ``names`` (the first the default) from the
    same init ``tree`` with the same settings ``kw``."""
    port = _Port(DeconvService(cfg=ServerConfig(model=names[0], **QUIET, **kw, **(port_kw or {})),
                               registry=_port_registry(tree, names)))
    jcfg = JServerConfig(image_size=0, compilation_cache_dir="", model=names[0], serve_lanes="off",
                         warmup_all_buckets=False, **QUIET, **kw)
    return port, ServiceFixture(None, service=JDeconvService(jcfg, registry=_jax_registry(tree, names)))


def _uri(seed: int) -> str:
    img = np.random.default_rng(seed).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return "data:image/png;base64," + base64.b64encode(buf.tobytes()).decode()


def _post(served, path, form):
    r = httpx.post(served.base_url + path, data=form, timeout=120)
    return r.status_code, r.json()


def _jpeg(data_url: str) -> np.ndarray:
    raw = base64.b64decode(urllib.parse.unquote(data_url.split(",", 1)[1]))
    return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR).astype(np.float64)


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _images(served, form) -> list:
    """The decoded images of a ``POST /`` (one grid) or ``/v1/deconv``
    (its tiles) answer."""
    route = "/v1/deconv" if "top_k" in form else "/"
    status, body = _post(served, route, form)
    assert status == 200, body
    return [_jpeg(body)] if route == "/" else [_jpeg(u) for u in body["images"]]


def _agree(port, jx, forms, bar) -> list:
    """Each form answered by both at ``bar`` dB; the port's images."""
    out = []
    for form in forms:
        got, want = _images(port, form), _images(jx, form)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _psnr(g, w) >= bar, form.get("model")
        out.append(got)
    return out


def _differs(a: list, b: list) -> bool:
    return any(_psnr(x, y) < 40.0 for xs, ys in zip(a, b) for x, y in zip(xs, ys))


def test_a_weights_file_serves_the_loaded_model_as_the_reference(init_tree, weights_dir):
    path = str(weights_dir / "vgg_tiny.npz")
    forms = [{"file": _uri(1), "layer": LAYER}, {"file": _uri(2), "layer": LAYER, "top_k": "4"}]
    int8 = [{"file": _uri(3), "layer": LAYER, "quality": "int8"}]
    port, jx = _pair(init_tree, weights_path=path, backward_dtype="float32")
    try:
        with jx:
            loaded = _agree(port, jx, forms, FP32_PSNR_DB)
            loaded_int8 = _agree(port, jx, int8, PSNR_DB)
            config = httpx.get(port.base_url + "/v1/config", timeout=30).json()
            jconfig = httpx.get(jx.base_url + "/v1/config", timeout=30).json()
            assert (config["weights_path"], config["profile_dir"]) == (jconfig["weights_path"],
                                                                       jconfig["profile_dir"]) == (True, False)
    finally:
        port.close()
    init = _Port(DeconvService(cfg=ServerConfig(model="vgg_tiny", **QUIET, backward_dtype="float32"),
                               registry=_port_registry(init_tree, ["vgg_tiny"])))
    try:
        assert _differs(loaded, [_images(init, f) for f in forms])
        assert _differs(loaded_int8, [_images(init, f) for f in int8])
    finally:
        init.close()


def test_a_weights_directory_loads_each_served_model_across_a_page_out(init_tree, weights_dir, monkeypatch):
    """``vgg_tiny`` and ``tiny_b`` from their files, ``tiny_c`` (no file)
    at its init with one ``weights_missing`` event, under a port budget
    that holds the default and one more model, so ``tiny_b`` pages out
    for ``tiny_c`` and back in with the same grid."""
    events = []
    real_event = app_mod.slog.event
    monkeypatch.setattr(app_mod.slog, "event", lambda logger, name, **kw: (events.append((name, kw)),
                                                                              real_event(logger, name, **kw)))
    names = ("vgg_tiny", "tiny_b", "tiny_c")
    one = tree_nbytes(params_from_jax(init_tree))
    port, jx = _pair(init_tree, names, port_kw={"hbm_budget_bytes": 2 * one}, weights_path=str(weights_dir),
                     serve_models=",".join(names))
    form = lambda m, seed: {"file": _uri(seed), "layer": LAYER, "model": m}  # noqa: E731
    try:
        with jx:
            first = _agree(port, jx, [form(m, 5) for m in names], PSNR_DB)
            _agree(port, jx, [form("tiny_c", 6)], PSNR_DB)  # tiny_b pages out
            again = _agree(port, jx, [form("tiny_b", 5)], PSNR_DB)
        assert port.service.weights.page_outs >= 1 and port.service.weights.page_ins >= 3
        np.testing.assert_array_equal(again[0][0], first[1][0])  # the loaded tiny_b, paged back in
    finally:
        port.close()
    assert [kw["model"] for name, kw in events if name == "weights_missing"] == ["tiny_c"]
    assert _differs([first[0]], [first[1]])  # two files, two models
    init = _Port(DeconvService(cfg=ServerConfig(model="tiny_c", **QUIET), registry=_port_registry(init_tree,
                                                                                                 ["tiny_c"])))
    try:
        np.testing.assert_array_equal(_images(init, form("tiny_c", 5))[0], first[2][0])
        assert _differs([first[0]], [_images(init, form("tiny_c", 5))])
    finally:
        init.close()


def test_the_cache_prefix_carries_the_weights_path(init_tree, weights_dir):
    prefixes = {}
    for path in ("", str(weights_dir / "vgg_tiny.npz"), str(weights_dir)):
        port, jx = _pair(init_tree, weights_path=path)
        try:
            with jx:
                prefixes[path] = port.service._model_prefix("vgg_tiny")
                assert prefixes[path] == jx.service._model_prefix("vgg_tiny") + "|cpu"
        finally:
            port.close()
    assert len(set(prefixes.values())) == 3


def test_calibrate_reads_the_weights_the_server_runs(init_tree, weights_dir, tmp_path, capsys):
    path = str(weights_dir / "vgg_tiny.npz")
    docs = {}
    for name, extra in (("init", []), ("loaded", ["--weights", path])):
        out = tmp_path / name
        assert main(["calibrate", "--model", "vgg_tiny", "--n-images", "2", "--out", str(out), "--device", "cpu",
                     *extra]) == 0
        capsys.readouterr()
        docs[name] = json.loads(open(out / "vgg_tiny.calib.json", "rb").read())
    jbundle = j_spec_bundle(J_TINY_SPEC, init_tree)
    jparams = j_load_model_weights("vgg_tiny", J_TINY_SPEC, path, jbundle.params)
    want = j_quant.collect_ranges(J_TINY_SPEC, jparams, _synthetic_images(2, 32, jbundle.preprocess))
    assert list(docs["loaded"]["ranges"]) == list(want)
    for layer, r in want.items():
        assert docs["loaded"]["ranges"][layer] == pytest.approx(float(np.asarray(r)), rel=1e-5), layer
    assert docs["loaded"]["ranges"] != docs["init"]["ranges"]


# ------------------------------------------------------------------- the CLI


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path)).astype(np.float64)


def _run(fn, argv, capsys) -> tuple[int, dict]:
    rc = fn(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else {}


@pytest.fixture(scope="module")
def cli_image(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "in.png"
    Image.fromarray(np.random.default_rng(4).integers(0, 256, (40, 48, 3)).astype(np.uint8)).save(path)
    return str(path)


def _cli_pair(argv: list, out, capsys):
    port = _run(main, [*argv, "--output", str(out / "port.png")], capsys)
    jx = _run(jax_main, [*argv, "--output", str(out / "jax.png")], capsys)
    return port, jx


@pytest.mark.parametrize("sweep", [False, True])
def test_visualize_gives_the_jax_clis_grids(weights_dir, cli_image, tmp_path, capsys, sweep):
    argv = ["visualize", "--image", cli_image, "--layer", LAYER, "--model", "vgg_tiny", "--platform", "cpu",
            "--weights", str(weights_dir / "vgg_tiny.npz"), *(["--sweep"] if sweep else [])]
    (rc, line), (jrc, jline) = _cli_pair(argv, tmp_path, capsys)
    assert rc == jrc == 0
    if sweep:
        assert list(line["outputs"]) == list(jline["outputs"]) and len(line["outputs"]) > 1
        pairs = [(line["outputs"][k], jline["outputs"][k]) for k in line["outputs"]]
    else:
        assert (line["layer"], line["filters"]) == (jline["layer"], jline["filters"])
        pairs = [(line["output"], jline["output"])]
    for got, want in pairs:
        assert _psnr(_png(got), _png(want)) >= FP32_PSNR_DB, got
    assert main(["visualize", "--image", cli_image, "--layer", "fc9", "--model", "vgg_tiny",
                 "--platform", "cpu"]) == 2


def test_dream_gives_the_jax_clis_image(weights_dir, cli_image, tmp_path, capsys):
    argv = ["dream", "--image", cli_image, "--model", "vgg_tiny", "--platform", "cpu", "--steps", "2",
            "--octaves", "2", "--weights", str(weights_dir / "vgg_tiny.npz")]
    (rc, line), (jrc, jline) = _cli_pair(argv, tmp_path, capsys)
    assert rc == jrc == 0 and line["layers"] == jline["layers"] == list(DREAM_LAYERS)
    assert line["loss"] == pytest.approx(jline["loss"], rel=2e-4, abs=2e-5)
    # the float dream within rtol 2e-4 leaves the uint8 image within a level
    assert np.abs(_png(line["output"]) - _png(jline["output"])).max() <= 1.0


def test_models_prints_the_jax_clis_lines(capsys):
    assert main(["models"]) == 0
    port = capsys.readouterr().out
    assert jax_main(["models"]) == 0
    assert port == capsys.readouterr().out and len(port.splitlines()) == 7


def test_doctor_on_the_cpu_runs_its_four_checks(capsys):
    assert main(["doctor", "--platform", "cpu"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert [l["check"] for l in lines] == ["backend", "rtt", "build", "selftest", "overall"]
    assert all(l["ok"] for l in lines), lines
    assert lines[0]["platform"] == "cpu" and lines[3]["out_shape"] == [1, 2, 8, 8, 3]
    assert main(["doctor", "--checks", "backend,compile_cache"]) == 2


# ------------------------------------------------------------- POST /v1/profile


@pytest.mark.parametrize("with_dir,body,status", [
    (False, {"batches": "2"}, 400), (True, {"batches": "x"}, 400), (True, {"batches": "0"}, 400),
    (True, {"batches": "65"}, 400), (True, {"batches": "2"}, 200), (True, {}, 200),
])
def test_profile_route_answers_as_the_reference(init_tree, tmp_path, with_dir, body, status):
    kw = {"profile_dir": str(tmp_path / "prof")} if with_dir else {}
    port, jx = _pair(init_tree, **kw)
    try:
        with jx:
            got = httpx.post(port.base_url + "/v1/profile", data=body, timeout=30)
            want = httpx.post(jx.base_url + "/v1/profile", data=body, timeout=30)
    finally:
        port.close()
    assert got.status_code == want.status_code == status
    if status == 200:
        assert got.json() == want.json() == {"armed": int(body.get("batches", 4)), "profile_dir": kw["profile_dir"]}
    else:
        assert got.json()["error"] == want.json()["error"]
        assert got.json().get("code") == want.json().get("code")


def test_an_armed_batch_writes_one_trace(init_tree, tmp_path, monkeypatch):
    monkeypatch.setenv("DECONV_PROFILE_BATCHES", "0")  # nothing traced until armed
    prof = tmp_path / "prof"
    port = _Port(DeconvService(cfg=ServerConfig(model="vgg_tiny", profile_dir=str(prof), **QUIET),
                               registry=_port_registry(init_tree, ["vgg_tiny"])))
    try:
        assert _post(port, "/", {"file": _uri(7), "layer": LAYER})[0] == 200
        assert not glob.glob(str(prof / "*.json"))
        assert _post(port, "/v1/profile", {"batches": "1"}) == (200, {"armed": 1, "profile_dir": str(prof)})
        assert _post(port, "/", {"file": _uri(8), "layer": LAYER})[0] == 200
        assert _post(port, "/", {"file": _uri(9), "layer": LAYER})[0] == 200
    finally:
        port.close()
    traces = glob.glob(str(prof / "trace-*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
