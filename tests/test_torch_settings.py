"""The server settings the port used to hard-code, against the JAX package:
each at a value other than its default, a port and a JAX vgg_tiny server
(the same params) asked the same requests (equal statuses and error
codes; grids and tiles within the served routes' bars, JPEG to JPEG: 65 dB
with a float32 backward, 52 dB otherwise), each server's cache-key prefix
equal to the JAX one's up to the port's device suffix; ``warmup_programs``
equal to the JAX warmup's keys under the three warmup flags;
``ServerConfig.from_env`` equal to the JAX one's on the same ``DECONV_*``
variables; and the ``calibrate`` subcommand's artifact byte-equal to the
library's, which a ``--calibration-dir`` server then binds its int8 keys
to."""

import base64
import importlib.util
import json
import os
import urllib.parse

import cv2
import httpx
import jax
import numpy as np
import pytest
import torch

from deconv_api_tpu.config import ServerConfig as JServerConfig
from deconv_api_tpu.engine import quant as j_quant
from deconv_api_tpu.models.tiny import VGG_TINY_SPEC as J_TINY_SPEC, vgg_tiny_init
from deconv_api_tpu.serving.app import DeconvService as JDeconvService
from deconv_api_tpu.serving.models import spec_bundle as j_spec_bundle
from deconv_api_tpu_torch.__main__ import _calibration_images, main, server_config, _parser
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.engine import quant
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.weights import params_from_jax
from deconv_api_tpu_torch.serving.app import DeconvService, Dream, Program
from deconv_api_tpu_torch.serving.models import ModelBundle, build_bundle
from tests.test_serving import ServiceFixture
from tests.test_torch_pipeline_serving import _Port

LAYER = "block3_conv1"
DREAM_LAYERS = ("block2_conv2", "block3_conv1")
FP32_PSNR_DB = 65.0
PSNR_DB = 52.0
BLACK = np.zeros((40, 48, 3), np.uint8)  # 12 of block1_conv1's 16 filters fire


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jparams():
    return vgg_tiny_init(jax.random.key(2, impl="rbg"))[1]


def _bundle(jparams) -> ModelBundle:
    return ModelBundle(VGG_TINY_SPEC, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
                       torch.device("cpu"), dream_layers=DREAM_LAYERS)


def _jax_service(jparams, **kw) -> JDeconvService:
    settings = {"image_size": 0, "max_batch": 4, "warmup_all_buckets": False, **kw}
    jcfg = JServerConfig(batch_window_ms=1.0, compilation_cache_dir="", model="vgg_tiny", serve_lanes="off",
                         cache_bytes=0, **settings)
    return JDeconvService(jcfg, registry={"vgg_tiny": lambda: j_spec_bundle(J_TINY_SPEC, jparams,
                                                                             dream_layers=DREAM_LAYERS)})


def _uri(img) -> str:
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return "data:image/png;base64," + base64.b64encode(buf.tobytes()).decode()


def _noise(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (40, 48, 3), dtype=np.uint8)


def _jpeg(data_url: str) -> np.ndarray:
    raw = base64.b64decode(urllib.parse.unquote(data_url.split(",", 1)[1]))
    return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR).astype(np.float64)


def _psnr(a, b) -> float:
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _post(served, path, form, headers=None):
    r = httpx.post(served.base_url + path, data=form, headers=headers or {}, timeout=120)
    return r.status_code, r.json()


# setting -> (its value(s), the requests: (route, layer, image, extra form))
SETTINGS = {
    "visualize_mode_max": ({"visualize_mode": "max"}, [("/", LAYER, _noise(1), {}),
                                                       ("/v1/deconv", LAYER, _noise(1), {})]),
    "top_k_3": ({"top_k": 3}, [("/v1/deconv", LAYER, _noise(2), {})]),
    "stitch_k_2": ({"stitch_k": 2}, [("/", LAYER, _noise(3), {})]),
    "bug_compat_off": ({"bug_compat": False}, [("/", LAYER, _noise(4), {}), ("/v1/deconv", LAYER, _noise(4), {})]),
    "strict_compat": ({"strict_compat": True, "stitch_k": 16}, [("/", "block1_conv1", _noise(5), {}),
                                                                ("/", "block1_conv1", BLACK, {})]),
    "image_size_48": ({"image_size": 48}, [("/", LAYER, _noise(6), {}), ("/v1/deconv", LAYER, _noise(6), {}),
                                           ("/v1/dream", "", _noise(6), {"steps": "1", "octaves": "2"})]),
    "backward_float32": ({"backward_dtype": "float32"}, [("/", LAYER, _noise(7), {}),
                                                         ("/v1/deconv", LAYER, _noise(7), {})]),
    "backward_none": ({"backward_dtype": ""}, [("/", LAYER, _noise(8), {}), ("/v1/deconv", LAYER, _noise(8), {})]),
    "dtype_bfloat16": ({"dtype": "bfloat16"}, [("/", LAYER, _noise(9), {}),
                                               ("/", LAYER, _noise(9), {"quality": "bf16"})]),
    "fused_unpool_auto": ({"fused_unpool": "auto"}, [("/", LAYER, _noise(10), {}),
                                                     ("/v1/deconv", LAYER, _noise(10), {})]),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_each_setting_serves_as_the_reference(jparams, setting):
    values, requests = SETTINGS[setting]
    port = _Port(DeconvService(_bundle(jparams), ServerConfig(model="vgg_tiny", max_batch=4, batch_window_ms=1.0,
                                                              cache_bytes=0, **values)))
    try:
        jservice = _jax_service(jparams, **values)
        assert port.service._model_prefix("vgg_tiny") == jservice._model_prefix("vgg_tiny") + "|cpu"
        bar = FP32_PSNR_DB if values.get("backward_dtype", "bfloat16") != "bfloat16" else PSNR_DB
        with ServiceFixture(None, service=jservice) as jx:
            for route, layer, img, extra in requests:
                form = {"file": _uri(img), **({"layer": layer} if layer else {}), **extra}
                (got_status, got), (want_status, want) = _post(port, route, form), _post(jx, route, form)
                assert got_status == want_status, (route, got, want)
                if got_status >= 400:
                    assert got["error"] == want["error"]
                    continue
                if route == "/":
                    assert _jpeg(got).shape == _jpeg(want).shape
                    assert _psnr(_jpeg(got), _jpeg(want)) >= bar
                elif route == "/v1/deconv":
                    assert (got["layer"], got["mode"], got["filters"]) == (want["layer"], want["mode"], want["filters"])
                    for a, b in zip(got["images"], want["images"]):
                        assert _jpeg(a).shape == _jpeg(b).shape
                        assert _psnr(_jpeg(a), _jpeg(b)) >= bar
                else:
                    assert _jpeg(got["image"]).shape == _jpeg(want["image"]).shape
                    assert got["loss"] == pytest.approx(want["loss"], rel=2e-4)
    finally:
        port.close()


def test_strict_compat_answers_422_where_fewer_than_stitch_k_fired(jparams):
    port = _Port(DeconvService(_bundle(jparams), ServerConfig(model="vgg_tiny", max_batch=4, batch_window_ms=1.0,
                                                              cache_bytes=0, strict_compat=True, stitch_k=16)))
    try:
        ok = _post(port, "/", {"file": _uri(_noise(5)), "layer": "block1_conv1"})
        short = _post(port, "/", {"file": _uri(BLACK), "layer": "block1_conv1"})
    finally:
        port.close()
    assert ok[0] == 200
    assert short == (422, {**short[1], "error": "no_active_filters"}) and "need 16" in short[1]["detail"]


def test_a_bfloat16_server_serves_full_as_the_bf16_tier(jparams):
    """``dtype=bfloat16`` runs the bf16 tier's program at quality=full (and
    bf16 as full): its grid is a default server's ``quality=bf16`` grid."""
    form = {"file": _uri(_noise(11)), "layer": LAYER}
    grids = {}
    for name, dtype in (("bf16_server", "bfloat16"), ("default", "float32")):
        port = _Port(DeconvService(_bundle(jparams), ServerConfig(model="vgg_tiny", max_batch=4, batch_window_ms=1.0,
                                                                  cache_bytes=0, dtype=dtype)))
        try:
            grids[name] = {q: _post(port, "/", {**form, "quality": q})[1] for q in ("full", "bf16")}
            assert port.service._effective_quality("bf16", port.service.bundle) == (
                "full" if dtype == "bfloat16" else "bf16")
        finally:
            port.close()
    assert grids["bf16_server"]["full"] == grids["bf16_server"]["bf16"] == grids["default"]["bf16"]
    assert grids["default"]["full"] != grids["default"]["bf16"]


WARMUP_FLAGS = [
    {"warmup_all_buckets": True, "warmup_sweep": False, "warmup_dream": False},
    {"warmup_all_buckets": True, "warmup_sweep": True, "warmup_dream": True},
    {"warmup_all_buckets": False, "warmup_sweep": True, "warmup_dream": True},
    {"warmup_all_buckets": False, "warmup_sweep": False, "warmup_dream": False},
]


@pytest.mark.parametrize("flags", WARMUP_FLAGS, ids=lambda f: "-".join(k for k, v in f.items() if v) or "none")
def test_warmup_programs_are_the_jax_warmups_keys(jparams, flags):
    """The JAX warmup's (key, batch) calls, recorded, at the layer the port
    warms (its deepest conv; the JAX warmup takes it as ``layer_name``)."""
    settings = {"visualize_mode": "max", "top_k": 5, "stitch_k": 3, "max_batch": 8, **flags}
    service = DeconvService(_bundle(jparams), ServerConfig(model="vgg_tiny", **settings))
    jservice = _jax_service(jparams, **settings)
    calls = []
    jservice._run_batch = lambda key, images, lane=0: calls.append((key, len(images)))
    layer = service.bundle.deepest_layer()
    jservice.warmup(layer_name=layer)

    def jax_key(program):
        if isinstance(program, Dream):
            return ("__dream__", *program)
        key = (program.layer, program.mode, program.top_k, program.post)
        return (*key, True) if program.sweep else key

    assert [(jax_key(p), b) for p, b in service.warmup_programs()] == calls
    assert any(isinstance(p, Dream) for p, _ in service.warmup_programs()) is flags["warmup_dream"]


ENV = {"DECONV_TOP_K": "4", "DECONV_STITCH_K": "2", "DECONV_VISUALIZE_MODE": "max", "DECONV_BUG_COMPAT": "0",
       "DECONV_STRICT_COMPAT": "yes", "DECONV_IMAGE_SIZE": "48", "DECONV_DTYPE": "bfloat16",
       "DECONV_BACKWARD_DTYPE": "", "DECONV_FUSED_UNPOOL": "auto", "DECONV_WARMUP_DREAM": "on",
       "DECONV_WARMUP_ALL_BUCKETS": "false", "DECONV_JOBS_DIR": "/srv/jobs", "DECONV_JOBS_WORKERS": "3",
       "DECONV_JOBS_RETENTION_S": "60", "DECONV_DRAIN_GRACE_S": "2.5", "DECONV_MAX_BATCH": "4",
       "DECONV_CACHE_BYTES": "0", "DECONV_QOS": "1", "DECONV_MODEL": "vgg_tiny"}


def test_from_env_reads_the_jax_packages_variables(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    got, want = ServerConfig.from_env(top_k=6), JServerConfig.from_env(top_k=6)
    shared = [f for f in ServerConfig.__dataclass_fields__ if f in JServerConfig.__dataclass_fields__]
    assert {"top_k", "stitch_k", "bug_compat", "jobs_dir", "drain_grace_s", "fused_unpool", "dtype"} <= set(shared)
    assert {f: getattr(got, f) for f in shared} == {f: getattr(want, f) for f in shared}
    assert (got.top_k, got.bug_compat, got.strict_compat, got.backward_dtype, got.jobs_workers) == (6, False, True,
                                                                                                    "", 3)
    with pytest.raises(ValueError, match="unknown config field"):
        ServerConfig.from_env(no_such_field=1)
    # a flag given wins over its variable; the variables fill the rest
    cfg = server_config(_parser().parse_args(["serve", "--top-k", "7", "--bug-compat", "--jobs-dir", "/j"]))
    assert (cfg.top_k, cfg.bug_compat, cfg.jobs_dir, cfg.stitch_k, cfg.model) == (7, True, "/j", 2, "vgg_tiny")


def test_the_defaults_are_the_jax_packages_but_warmup_dream():
    shared = [f for f in ServerConfig.__dataclass_fields__ if f in JServerConfig.__dataclass_fields__]
    differ = {f for f in shared if getattr(ServerConfig(), f) != getattr(JServerConfig(), f)}
    assert differ == {"warmup_dream"}


@pytest.mark.parametrize("value", [{"fused_unpool": "sometimes"}, {"dtype": "float16"}, {"backward_dtype": "fp8"},
                                   {"visualize_mode": "min"}, {"top_k": 0}])
def test_a_setting_the_server_cannot_run_fails_the_boot(jparams, value):
    with pytest.raises(ValueError):
        DeconvService(_bundle(jparams), ServerConfig(model="vgg_tiny", **value))


def test_calibrate_writes_the_librarys_artifact_and_a_server_binds_to_it(tmp_path, capsys):
    images = tmp_path / "captures"
    images.mkdir()
    for i in range(3):
        cv2.imwrite(str(images / f"c{i}.png"), _noise(20 + i))
    (images / "notes.txt").write_text("not an image")
    out = tmp_path / "calib"
    assert main(["calibrate", "--model", "vgg_tiny", "--images", str(images), "--out", str(out),
                 "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["which"], line["model"], line["n_images"], line["layers"]) == ("calibrate", "vgg_tiny", 3, 7)
    artifact = open(out / "vgg_tiny.calib.json", "rb").read()

    bundle = build_bundle("vgg_tiny", "cpu")
    xs = _calibration_images(str(images), bundle.image_size, bundle.preprocess)
    lib = tmp_path / "lib"
    _, digest = quant.save_calibration(str(lib), "vgg_tiny", quant.collect_ranges(bundle.spec, bundle.params, xs),
                                       image_size=bundle.image_size, n_images=3,
                                       source=f"images:{os.path.abspath(images)}")
    assert artifact == open(lib / "vgg_tiny.calib.json", "rb").read() and digest == line["digest"]

    port = _Port(DeconvService(build_bundle("vgg_tiny", "cpu"), ServerConfig(model="vgg_tiny", calibration_dir=str(out),
                                                                             cache_bytes=0)))
    try:
        assert _post(port, "/", {"file": _uri(_noise(1)), "layer": LAYER, "quality": "int8"})[0] == 200
        assert httpx.get(port.base_url + "/readyz", timeout=30).json()["quality"]["calibrated"] == ["vgg_tiny"]
        config = httpx.get(port.base_url + "/v1/config", timeout=30).json()
        assert config["quality"]["calibration"] == {"vgg_tiny": digest}
    finally:
        port.close()
    assert main(["calibrate", "--model", "resnet50", "--out", str(out), "--device", "cpu"]) == 2
    assert main(["calibrate", "--model", "vgg_tiny", "--images", str(tmp_path / "lib"), "--out", str(out),
                 "--device", "cpu"]) == 2  # no image there


def _jax_calibrate_tool():
    """The JAX package's ``tools/calibrate.py``, loaded from its file."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "calibrate.py")
    spec = importlib.util.spec_from_file_location("jax_calibrate_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_calibrate_loads_captures_as_the_jax_tool_and_writes_its_artifact(jparams, tmp_path, capsys, monkeypatch):
    """The same captures (png, jpeg, grayscale, each resized) through the
    port's ``calibrate`` and through the JAX package's tool on the same
    params: pixel-equal inputs, and an artifact with the same fields and
    entries, each range within 1e-5 relative of JAX's (the float convs sum
    in another order)."""
    images = tmp_path / "captures"
    images.mkdir()
    cv2.imwrite(str(images / "a.png"), _noise(30))
    cv2.imwrite(str(images / "b.jpg"), _noise(31))
    cv2.imwrite(str(images / "c.png"), _noise(32)[..., 0])
    monkeypatch.setattr("deconv_api_tpu_torch.__main__.build_bundle", lambda model, device: _bundle(jparams))
    out = tmp_path / "port"
    assert main(["calibrate", "--model", "vgg_tiny", "--images", str(images), "--out", str(out),
                 "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port_doc = json.loads(open(out / "vgg_tiny.calib.json", "rb").read())

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)  # the tool sets a default at import
    tool, jbundle = _jax_calibrate_tool(), j_spec_bundle(J_TINY_SPEC, jparams)
    size = jbundle.image_size
    want_xs = tool._load_images(str(images), size, jbundle.preprocess)
    got_xs = _calibration_images(str(images), size, _bundle(jparams).preprocess)
    assert len(got_xs) == len(want_xs) == 3
    for got, want in zip(got_xs, want_xs):
        np.testing.assert_array_equal(got, np.asarray(want))
    ranges = j_quant.collect_ranges(J_TINY_SPEC, jparams, want_xs)
    j_quant.save_calibration(str(tmp_path / "jax"), "vgg_tiny", ranges, image_size=size, n_images=len(want_xs),
                             source=f"images:{os.path.abspath(images)}")
    jax_doc = json.loads(open(tmp_path / "jax" / "vgg_tiny.calib.json", "rb").read())
    assert {k: v for k, v in port_doc.items() if k not in ("ranges", "digest")} == \
        {k: v for k, v in jax_doc.items() if k not in ("ranges", "digest")}
    assert list(port_doc["ranges"]) == list(jax_doc["ranges"]) and line["layers"] == len(jax_doc["ranges"])
    for name, want in jax_doc["ranges"].items():
        assert port_doc["ranges"][name] == pytest.approx(want, rel=1e-5), name
