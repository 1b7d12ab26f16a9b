"""The port's multi-model server and control routes on the CPU against the
JAX package's: a two-model mix server in each package from the same
``_mix_spec`` widths and params, ``model=``/``x-model`` routing, the 422
for a model not served, ``/v1/models``, ``/v1/config``, ``/readyz``,
``/healthz`` and ``/metrics``, and the metrics exposition text for the
same observations."""

import base64
import json
import re
import threading
import urllib.error
import urllib.parse
import urllib.request

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deconv_api_tpu.config import ServerConfig as JServerConfig
from deconv_api_tpu.models.spec import init_params as j_init_params
from deconv_api_tpu.serving.app import DeconvService as JDeconvService
from deconv_api_tpu.serving.metrics import Metrics as JMetrics
from deconv_api_tpu.serving.models import registry_info as j_registry_info
from deconv_api_tpu.serving.models import spec_bundle as j_spec_bundle
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.models.spec import Layer, ModelSpec
from deconv_api_tpu_torch.models.weights import params_from_jax
from deconv_api_tpu_torch.serving import codec
from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService
from deconv_api_tpu_torch.serving.metrics import Metrics
from deconv_api_tpu_torch.serving.models import ModelBundle, registry_info
from tests.test_serving import ServiceFixture, _data_url
from tests.test_weight_manager import _mix_spec

WIDTHS = ((8, 16), (16, 32))  # tests/test_weight_manager.py's mix_server
LAYER = "b2c1"
GRID_PSNR_DB = 52.0  # the grids' bar with the bf16 backward both servers run
WEIGHT_LINES = ("deconv_weight_page_ins_total", "deconv_weight_page_outs_total", "deconv_weight_page_bytes_total",
                "deconv_weight_budget_overcommit_total", "deconv_weight_evict_inflight_total",
                'deconv_resident_models{lane="0"}', 'deconv_weight_resident_bytes{lane="0"}')


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_spec(name, f1, f2):
    return ModelSpec(name, (16, 16, 3), (
        Layer("in0", "input"), Layer("b1c1", "conv", activation="relu", filters=f1),
        Layer("b1p", "pool"), Layer("b2c1", "conv", activation="relu", filters=f2),
    ))


@pytest.fixture(scope="module")
def mix_params():
    """name -> (JAX spec, numpy params), as ``_mix_registry`` makes them."""
    out = {}
    for i, (f1, f2) in enumerate(WIDTHS):
        name = f"mix{chr(ord('a') + i)}"
        spec = _mix_spec(name, f1, f2)
        out[name] = (spec, jax.tree_util.tree_map(np.asarray, j_init_params(spec, jax.random.PRNGKey(100 + i))))
    return out


def _port_registry(mix_params):
    return {
        name: (lambda name=name, p=p: ModelBundle(_port_spec(name, *WIDTHS[ord(name[-1]) - ord("a")]),
                                                 params_from_jax(p), torch.device("cpu")))
        for name, (_, p) in mix_params.items()
    }


def _mix_cfg(**kw):
    return ServerConfig(**{"model": "mixa", "serve_models": "mixa,mixb", "max_batch": 4,
                           "batch_window_ms": 1.0, **kw})


class _Served:
    def __init__(self, service, warm=True):
        self.service = service
        service.start()
        if warm:
            service.warmup()
        self.server = DeconvHTTPServer(service, "127.0.0.1", 0)
        self.base_url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.service.close()
        self.thread.join(10)


@pytest.fixture(scope="module")
def servers(mix_params):
    """(port, JAX) mix servers over the same params, each asked the same
    requests in the same order by the tests below."""
    jreg = {name: (lambda s=s, p=p: j_spec_bundle(s, p)) for name, (s, p) in mix_params.items()}
    jcfg = JServerConfig(image_size=0, max_batch=4, batch_window_ms=1.0, compilation_cache_dir="", model="mixa",
                         serve_models="mixa,mixb", serve_lanes="off", warmup_all_buckets=False, cache_bytes=0,
                         singleflight=False)
    # both without the response cache and singleflight: the requests
    # below reach the dispatchers on both; and with the JAX server's
    # warmup settings, which the port honours too
    port = _Served(DeconvService(cfg=_mix_cfg(cache_bytes=0, singleflight=False, warmup_all_buckets=False,
                                              warmup_dream=False),
                                 registry=_port_registry(mix_params)))
    try:
        with ServiceFixture(None, service=JDeconvService(jcfg, registry=jreg)) as jax_served:
            yield port, jax_served
    finally:
        port.close()


def _grid(body) -> np.ndarray:
    import cv2

    raw = base64.b64decode(urllib.parse.unquote(body.split(",", 1)[1]))
    return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)


def test_model_field_and_header_route_alike(servers, mix_params):
    """``model=`` and ``x-model`` select the same model on both servers, the
    two models answer differently, and each grid is its model's program's
    grid, within the bar of the JAX package's program for that model."""
    port, jx = servers
    body = {"file": _data_url(), "layer": LAYER}
    answers = {}
    for name, served in (("port", port), ("jax", jx)):
        default = httpx.post(served.base_url, data=body, timeout=60)
        field = httpx.post(served.base_url, data={**body, "model": "mixb"}, timeout=60)
        header = httpx.post(served.base_url, data=body, headers={"x-model": "mixb"}, timeout=60)
        assert default.status_code == field.status_code == header.status_code == 200, name
        assert field.content == header.content and default.content != field.content, name
        answers[name] = {"mixa": default.json(), "mixb": field.json()}
    x = port.service.decode_preprocess(_data_url(), port.service.weights.bundle("mixb"))[None]
    for model in ("mixa", "mixb"):
        got = port.service.visualize_batch(LAYER, x, model=model)
        assert answers["port"][model] == codec.encode_data_url(got["grid"][0])  # the served bytes
        spec, params = mix_params[model]
        fn = j_spec_bundle(spec, params).batched_visualizer(LAYER, "all", 4, True, "bfloat16", post="grid")
        want = jax.tree_util.tree_map(np.asarray, fn(params, jnp.asarray(x))[LAYER])
        np.testing.assert_array_equal(got["indices"], want["indices"])
        mse = np.mean((got["grid"].astype(np.float64) - want["grid"].astype(np.float64)) ** 2)
        assert mse == 0 or 10 * np.log10(255.0**2 / mse) >= GRID_PSNR_DB, model
        assert _grid(answers["jax"][model]).shape == _grid(answers["port"][model]).shape == (32, 32, 3)
    snap = port.service.weights.snapshot()
    assert snap["lanes"]["0"]["resident"] == ["mixa", "mixb"] and snap["page_ins"] == 2


@pytest.mark.parametrize("fields,headers", [({"model": "resnet50"}, None), ({}, {"x-model": "zzz"}),
                                            ({"model": "ghost"}, {"x-model": "mixb"})])
def test_unknown_model_is_the_jax_422(servers, fields, headers):
    port, jx = servers
    form = {"file": _data_url(), "layer": LAYER, **fields}
    got = httpx.post(port.base_url, data=form, headers=headers, timeout=30)
    want = httpx.post(jx.base_url, data=form, headers=headers, timeout=30)
    assert got.status_code == want.status_code == 422
    assert got.json()["error"] == want.json()["error"] == "unknown_model"
    assert got.json()["detail"] == want.json()["detail"]


def test_v1_models_equals_jax(servers):
    port, jx = servers
    got = httpx.get(port.base_url + "/v1/models", timeout=30).json()
    assert got == httpx.get(jx.base_url + "/v1/models", timeout=30).json()
    assert registry_info() == j_registry_info()
    assert [e["model"] for e in got["models"] if e["active"]] == ["mixa"]


def test_v1_config_shares_the_jax_values(servers):
    """Every key /v1/config shares with the JAX package's has its value,
    ``warmup_wall_s`` (a measured time) aside; the weights block is the
    manager's residency after the same requests."""
    port, jx = servers
    for served in (port, jx):  # the same request on both: mixb, then the default
        assert httpx.post(served.base_url, data={"file": _data_url(5), "layer": LAYER, "model": "mixb"},
                          timeout=60).status_code == 200
        assert httpx.post(served.base_url, data={"file": _data_url(5), "layer": LAYER}, timeout=60).status_code == 200
    got = httpx.get(port.base_url + "/v1/config", timeout=30).json()
    want = httpx.get(jx.base_url + "/v1/config", timeout=30).json()
    shared = (set(got) & set(want)) - {"warmup_wall_s"}
    assert {"model", "max_batch", "batch_window_ms", "lowc_kpack", "serve_models", "pinned_models",
            "hbm_budget_bytes", "weight_dtype", "model_active", "weights", "lowc_kpack_chan",
            "draining"} <= shared
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["weights"]["lanes"]["0"]["resident"] == ["mixb", "mixa"]
    assert got["graph_pool_bytes"] == {"mixb": {"deconv": 0, "dream": 0}, "mixa": {"deconv": 0, "dream": 0}}
    assert isinstance(got["warmup_wall_s"], float)


def test_metrics_route_carries_the_weight_families(servers):
    port, _ = servers
    text = httpx.get(port.base_url + "/metrics", timeout=30).text
    assert _masked(text) == _masked(httpx.get(port.base_url + "/v1/metrics", timeout=30).text)
    lines = text.splitlines()
    for family in WEIGHT_LINES:
        assert any(line.startswith(family + " ") for line in lines), family
    assert "deconv_weight_evict_inflight_total 0" in lines
    assert 'deconv_resident_models{lane="0"} 2' in lines
    assert any(line.startswith('deconv_stage_seconds{stage="weight_page_in"') for line in lines)
    assert any(line.startswith("deconv_requests_total ") for line in lines)
    assert any(line.startswith("dream_requests_total ") for line in lines)
    types = [line.split()[2] for line in lines if line.startswith("# TYPE")]
    assert len(types) == len(set(types))  # one TYPE line per family


def test_readyz_and_healthz_through_boot_and_drain(mix_params):
    """/readyz is 503 before warmup (``warmed``), 200 after with the models
    block, 503 again once ``close()`` begins (``not_draining``); /healthz
    answers 200 throughout."""
    served = _Served(DeconvService(cfg=_mix_cfg(), registry=_port_registry(mix_params)), warm=False)

    def get(path):
        try:
            with urllib.request.urlopen(served.base_url + path, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        assert get("/healthz") == (200, {"status": "ok"})
        status, body = get("/readyz")
        assert status == 503 and body["checks"] == {"warmed": False, "not_draining": True, "batcher_tasks": True,
                                                    "codec_pool_quorum": True, "breaker_not_open": True}
        served.service.warmup()
        status, body = get("/readyz")
        assert status == 200 and body["ready"] and all(body["checks"].values())
        assert body["models"] == {"served": 2, "pinned": 1, "resident": {"0": ["mixa"]}}
        served.service.close()
        status, body = get("/readyz")
        assert status == 503 and body["checks"]["not_draining"] is False
        assert body["checks"]["batcher_tasks"] is False
        assert get("/healthz") == (200, {"status": "ok"})
    finally:
        served.close()


def test_boot_rejects_bad_config_with_the_jax_messages(mix_params):
    reg = _port_registry(mix_params)
    for kwargs, match in (({"weight_dtype": "fp4"}, "weight_dtype"), ({"serve_models": "mixa,ghost"}, "serve_models"),
                          ({"pinned_models": "ghost"}, "pinned")):
        with pytest.raises(ValueError, match=match):
            DeconvService(cfg=_mix_cfg(**kwargs), registry=reg)
    with pytest.raises(ValueError, match="pinned"):
        DeconvService(cfg=_mix_cfg(serve_models="mixa", pinned_models="mixb"), registry=reg)
    all_served = DeconvService(cfg=_mix_cfg(serve_models="all", pinned_models="mixb"), registry=reg)
    assert sorted(all_served.weights.served) == ["mixa", "mixb"] and all_served.weights.pinned == ("mixa", "mixb")


def _masked(text: str) -> str:
    return re.sub(r"^(\w+_images_per_sec) .*$", r"\1 <uptime>", text, flags=re.M)


def test_metrics_exposition_matches_jax_for_the_same_observations():
    """The same observations fed to both registries render the same text,
    the uptime-dependent images/s line masked."""
    for prefix in ("deconv", "dream"):
        port, jx = Metrics(prefix), JMetrics(prefix)
        for m in (port, jx):
            m.observe_request(0.012)
            m.observe_request(0.5, "unknown_model")
            m.observe_request(0.03, 'odd"code\\x\n')
            m.observe_batch(3, 0.01, 0.002)
            m.observe_batch(8, 0.02, 0.0)
            m.observe_cadence(0.011)
            m.observe_stage("weight_page_in", 0.25)
            m.observe_stage("encode", 0.001)
            m.inc_counter("weight_page_ins_total")
            m.inc_counter("weight_page_bytes_total", 4160)
            m.inc_counter("weight_evict_inflight_total", 0)
            m.inc_labeled("faults_injected_total", "site", "a")
            m.inc_labeled("tenant_requests_total", ("tenant", "class"), ("t1", "bulk"), 2.5)
            m.observe_hist("request_duration_seconds", ("route", "qos_class"), ("/", "standard"), 0.03, "rid-1")
            m.observe_hist("request_duration_seconds", ("route", "qos_class"), ("/", "standard"), 99.0)
            m.set_labeled_gauge("resident_models", "lane", "0", 2)
            m.set_labeled_gauge("weight_resident_bytes", "lane", "0", 8320)
            m.set_gauge("warmup_seconds", 1.25)
        assert _masked(port.prometheus()) == _masked(jx.prometheus())
        drop = ("uptime_s", "images_per_sec")
        assert ({k: v for k, v in port.snapshot().items() if k not in drop}
                == {k: v for k, v in jx.snapshot().items() if k not in drop})
        assert port.compute_p50() == jx.compute_p50() and port.batch_size_p50() == jx.batch_size_p50()
    bare_port, bare_jax = Metrics("x", core=False), JMetrics("x", core=False)
    assert bare_port.prometheus() == bare_jax.prometheus()
