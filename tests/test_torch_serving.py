"""The port's service (deconv_api_tpu_torch/serving) in-process on the CPU
with vgg_tiny: the reference's routes and error codes, ``/v1/deconv`` with
the packed tail, batching, the grid and the tiles against the JAX package's
serving programs, and the host codec's numpy fallbacks against cv2."""

import base64
import http.client
import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deconv_api_tpu.models.tiny import VGG_TINY_SPEC as J_TINY_SPEC, vgg_tiny_init
from deconv_api_tpu.serving.models import spec_bundle as j_spec_bundle
from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.weights import params_from_jax
from deconv_api_tpu_torch.serving import codec
from deconv_api_tpu_torch.__main__ import build_server
from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService, Program
from deconv_api_tpu_torch.serving.models import ModelBundle

LAYER = "block3_conv1"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    return vgg_tiny_init(jax.random.key(1, impl="rbg"))[1]


def _bundle(jparams):
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return ModelBundle(VGG_TINY_SPEC, params, torch.device("cpu"))


class _Served:
    def __init__(self, service):
        self.service = service
        service.start()
        self.server = DeconvHTTPServer(service, "127.0.0.1", 0)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.service.close()
        self.thread.join(10)
        assert not self.thread.is_alive()

    def request(self, path, data=None, headers=None):
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}", data=data, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def post(self, form, path="/"):
        return self.request(path, urllib.parse.urlencode(form).encode())


@pytest.fixture(scope="module")
def served(jax_params):
    s = DeconvService(_bundle(jax_params), max_batch=8, batch_window_ms=3.0)
    s.warmup()
    srv = _Served(s)
    yield srv
    srv.close()


def _image_uri(seed, shape=(40, 48, 3)):
    img = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return "data:image/png;base64," + base64.b64encode(buf.tobytes()).decode()


def _decode_response(body):
    assert body.startswith("data:image/webp;base64,")
    raw = base64.b64decode(urllib.parse.unquote(body.split(",", 1)[1]))
    return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0**2 / mse)


def test_post_grid_matches_jax_serving_program(served, jax_params):
    uri = _image_uri(0)
    status, body = served.post({"file": uri, "layer": LAYER})
    assert status == 200
    served_grid = _decode_response(body)
    assert served_grid.shape == (64, 64, 3)

    x = served.service.decode_preprocess(uri)[None]
    port = served.service.visualize_batch(LAYER, x)
    jbundle = j_spec_bundle(J_TINY_SPEC, jax_params)
    fn = jbundle.batched_visualizer(LAYER, "all", 4, True, "bfloat16", post="grid")
    want = np.asarray(fn(jax_params, jnp.asarray(x))[LAYER]["grid"])
    assert _psnr(port["grid"][0], want[0]) >= 52.0
    assert body == codec.encode_data_url(port["grid"][0])  # the served bytes


def test_multipart_form_is_accepted(served):
    boundary = "xyzBOUNDARY"
    body = "".join(
        f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'
        for k, v in (("file", _image_uri(1)), ("layer", "fc1"))
    ) + f"--{boundary}--\r\n"
    status, payload = served.request(
        "/", body.encode(), {"content-type": f"multipart/form-data; boundary={boundary}"}
    )
    assert status == 200 and payload.startswith("data:image/webp;base64,")


def test_routes_and_error_codes(served):
    assert served.request("/health-check") == (200, {"healthy": "true"})
    assert served.request("/ready") == (200, {"ready": True})
    status, payload = served.post({"file": "data:image/png;base64,AAAA", "layer": LAYER})
    assert (status, payload["error"]) == (400, "invalid_image")
    status, payload = served.post({"file": _image_uri(2), "layer": "block9_conv9"})
    assert (status, payload["error"]) == (422, "unknown_layer")
    status, payload = served.post({"layer": LAYER})
    assert (status, payload["error"]) == (400, "bad_request")
    assert served.request("/nope")[0] == 404
    conn = http.client.HTTPConnection("127.0.0.1", served.port, timeout=30)
    conn.putrequest("POST", "/")
    conn.putheader("content-length", "not-a-number")
    conn.endheaders()
    resp = conn.getresponse()
    assert (resp.status, json.loads(resp.read())["error"]) == (400, "bad content-length")
    conn.close()


def test_concurrent_posts_coalesce_into_one_batch(jax_params):
    # at pipeline depth 1 the straggler window waits for the second request
    # (at depth 2 an idle device takes the first request at once)
    service = DeconvService(_bundle(jax_params), max_batch=2, batch_window_ms=5000.0, pipeline_depth=1)
    service.ready = True
    srv = _Served(service)
    try:
        results = []
        threads = [
            threading.Thread(target=lambda s=s: results.append(srv.post({"file": _image_uri(s), "layer": LAYER})))
            for s in (3, 4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert [r[0] for r in results] == [200, 200]
        assert list(service.batch_sizes) == [2]
    finally:
        srv.close()


def test_no_active_filters_and_not_ready(jax_params):
    dead = {**jax_params, LAYER: {**jax_params[LAYER], "b": jnp.full((64,), -1e4)}}
    service = DeconvService(_bundle(dead))
    form = {"file": _image_uri(5), "layer": LAYER}
    with pytest.raises(errors.ModelNotReady):
        service.compat(form)
    service.ready = True
    service.start()
    try:
        with pytest.raises(errors.NoActiveFilters):
            service.compat(form)
    finally:
        service.close()


# --- POST /v1/deconv, with the packed tail -----------------------------------------


@pytest.fixture(scope="module")
def served_kpack(jax_params):
    s = DeconvService(_bundle(jax_params), lowc_kpack="auto")
    s.warmup()
    srv = _Served(s)
    yield srv
    srv.close()


def test_v1_deconv_tiles_match_jax_serving_program(served_kpack, jax_params):
    uri = _image_uri(10)
    status, body = served_kpack.post({"file": uri, "layer": LAYER}, "/v1/deconv")
    assert status == 200
    assert (body["layer"], body["mode"]) == (LAYER, "all")
    x = served_kpack.service.decode_preprocess(uri)[None]
    port = served_kpack.service.run_program(Program(LAYER, "all", 8, "tiles"), x)[LAYER]
    jbundle = j_spec_bundle(J_TINY_SPEC, jax_params)
    fn = jbundle.batched_visualizer(LAYER, "all", 8, True, "bfloat16", post="tiles")
    want = {k: np.asarray(v) for k, v in fn(jax_params, jnp.asarray(x))[LAYER].items()}
    np.testing.assert_array_equal(port["indices"], want["indices"])
    np.testing.assert_array_equal(port["valid"], want["valid"])
    n_valid = int(want["valid"][0].sum())
    assert body["filters"] == [int(i) for i in want["indices"][0][:n_valid]]
    assert len(body["images"]) == n_valid > 0
    for k in range(n_valid):
        assert _psnr(port["tiles"][0, k], want["tiles"][0, k]) >= 52.0
        assert body["images"][k] == codec.encode_data_url(port["tiles"][0, k])  # the served bytes
        assert _decode_response(body["images"][k]).shape == (32, 32, 3)


def test_v1_deconv_sweep_response_shape(served_kpack):
    form = {"file": _image_uri(11), "layer": "block2_pool", "mode": "max", "top_k": "3", "sweep": "on"}
    status, body = served_kpack.post(form, "/v1/deconv")
    assert status == 200
    assert {k: body[k] for k in ("layer", "mode", "sweep")} == {"layer": "block2_pool", "mode": "max", "sweep": True}
    assert list(body["layers"]) == list(served_kpack.service.bundle.sweep_layers("block2_pool"))
    assert list(body["layers"])[0] == "block2_pool" and list(body["layers"])[-1] == "block1_conv1"
    for entry in body["layers"].values():
        assert set(entry) == {"filters", "images"}
        assert len(entry["filters"]) == len(entry["images"]) <= 3


def test_v1_deconv_error_codes(served_kpack):
    uri = _image_uri(12)
    for form, want in (
        ({"file": uri, "layer": LAYER, "mode": "bogus"}, (422, "illegal_visualize_mode")),
        ({"file": uri, "layer": LAYER, "top_k": "0"}, (400, "bad_request")),
        ({"file": uri, "layer": LAYER, "top_k": "65"}, (400, "bad_request")),
        ({"file": uri, "layer": LAYER, "top_k": "many"}, (400, "bad_request")),
        ({"file": uri, "layer": "block9_conv9"}, (422, "unknown_layer")),
        ({"layer": LAYER}, (400, "bad_request")),
    ):
        status, payload = served_kpack.post(form, "/v1/deconv")
        assert (status, payload["error"]) == want, form


def test_programs_with_different_top_k_never_share_a_batch(jax_params):
    service = DeconvService(_bundle(jax_params), max_batch=2, batch_window_ms=50.0)
    xs = [service.decode_preprocess(_image_uri(s)) for s in (13, 14, 15)]
    futures = [
        service.submit(Program(LAYER, "all", k, "tiles"), x) for k, x in zip((2, 3, 2), xs)
    ]
    service.start()
    try:
        results = [f.result(timeout=60) for f in futures]
    finally:
        service.close()
    # the first window takes the two oldest requests and runs one batch per
    # program (the JAX dispatcher's drain-then-group)
    assert list(service.batch_sizes) == [1, 1, 1]
    assert [r[LAYER]["tiles"].shape[0] for r in results] == [2, 3, 2]


def test_a_bad_lowc_kpack_policy_is_refused_at_boot(jax_params, capsys):
    with pytest.raises(SystemExit):
        build_server(["serve", "--model", "vgg_tiny", "--device", "cpu", "--lowc-kpack", "sometimes"])
    assert "--lowc-kpack" in capsys.readouterr().err
    with pytest.raises(ValueError, match="lowc_kpack"):
        DeconvService(_bundle(jax_params), lowc_kpack="sometimes")


# --- host codec fallbacks, held against cv2 ---------------------------------------


@pytest.mark.parametrize("src,dst", [((40, 48), (224, 224)), ((300, 257), (224, 224)), ((448, 448), (224, 224)), ((31, 17), (53, 29))])
def test_numpy_resize_is_cv2_exact(src, dst):
    img = np.random.default_rng(src[0]).integers(0, 256, (*src, 3), dtype=np.uint8)
    np.testing.assert_array_equal(codec.resize_linear(img, dst), cv2.resize(img, dst))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_numpy_png_decoder_matches_cv2(channels):
    rng = np.random.default_rng(channels)
    yy, xx = np.mgrid[:37, :45]
    smooth = np.stack([xx * 5, yy * 3, xx + yy, 255 - xx], -1)[..., :channels]
    for img in (rng.integers(0, 256, (37, 45, channels)), smooth):
        img = img.astype(np.uint8).squeeze()
        ok, buf = cv2.imencode(".png", img)
        np.testing.assert_array_equal(
            codec.decode_png(buf.tobytes()), cv2.imdecode(buf, cv2.IMREAD_COLOR)
        )


def test_numpy_jpeg_encoder_decodes_within_jpeg_tolerance():
    yy, xx = np.mgrid[:67, :90]
    img = np.stack([xx * 2, yy * 3, (xx + yy) % 256], -1).astype(np.uint8)
    raw = codec.encode_jpeg(img)
    dec = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
    assert dec.shape == img.shape
    assert codec.jpeg_size(raw) == (67, 90)
    assert _psnr(dec, img) >= 35.0


def test_pillow_backend_serves_the_wire_format(monkeypatch):
    monkeypatch.setattr(codec, "backend", lambda: "pil")
    img = np.random.default_rng(8).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img)
    np.testing.assert_array_equal(
        codec.decode_data_url(base64.b64encode(buf.tobytes()).decode()), img
    )
    assert _decode_response(codec.encode_data_url(img)).shape == img.shape
    with pytest.raises(codec.CodecError):
        codec.decode_data_url(base64.b64encode(b"not an image").decode())


def test_numpy_backend_serves_the_wire_format(monkeypatch):
    monkeypatch.setattr(codec, "backend", lambda: "numpy")
    img = np.random.default_rng(7).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img)
    uri = "data:image/png;base64," + base64.b64encode(buf.tobytes()).decode()
    np.testing.assert_array_equal(codec.decode_data_url(uri), img)
    np.testing.assert_array_equal(codec.resize224(img), cv2.resize(img, (224, 224)))
    dec = _decode_response(codec.encode_data_url(img))
    assert dec.shape == img.shape
    with pytest.raises(codec.CodecError):
        codec.decode_data_url("data:image/jpeg;base64," + base64.b64encode(b"\xff\xd8junk").decode())
