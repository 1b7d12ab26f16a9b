"""The request pipeline as a whole on the CPU: a port server and the JAX
package's ``ServiceFixture`` (``tests/test_serving.py``) over the same tiny
model and params, as ``tests/test_torch_control_routes.py`` builds them,
asked the same requests: concurrent ``POST /`` through the asyncio server,
the codec pool and the pipelined dispatcher; ``x-deadline-ms``; a forced
shed; ``/readyz`` during a drain; ``/v1/debug/requests``; the ``/metrics``
names of the dispatcher's series.  Last, the port alone: a page-out that
races a batch in flight never frees its model."""

import base64
import concurrent.futures
import re
import urllib.parse

import cv2
import httpx
import jax
import numpy as np
import pytest
import torch

from deconv_api_tpu.config import ServerConfig as JServerConfig
from deconv_api_tpu.models.spec import init_params as j_init_params
from deconv_api_tpu.serving.app import DeconvService as JDeconvService
from deconv_api_tpu.serving.models import spec_bundle as j_spec_bundle
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.models.weights import params_from_jax
from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService, Program
from deconv_api_tpu_torch.serving.models import ModelBundle
from deconv_api_tpu_torch.serving.weight_manager import tree_nbytes
from tests.test_serving import ServiceFixture, _data_url
from tests.test_torch_control_routes import _port_spec
from tests.test_weight_manager import _mix_spec

LAYER = "b2c1"
WIDTHS = {"mixa": (8, 16), "mixb": (16, 32), "mixc": (8, 24)}
GRID_PSNR_DB = 52.0  # the grids' bar with the bf16 backward both servers run
NEW_SERIES = ("collect_queue_depth", "dispatch_queue_depth", "inflight_batches", "breaker_state",
              "breaker_open_total", "deadline_expired_total", "task_restarts_total", "batch_cadence_seconds",
              "codec_queue_depth", "codec_workers_live", "lane_inflight", "lane_breaker_state",
              "lane_batches_total", "lane_requests_total", "lane_imbalance", "lanes_accepting")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def params():
    """name -> (JAX spec, numpy params)."""
    return {name: (_mix_spec(name, *w), jax.tree_util.tree_map(np.asarray, j_init_params(
        _mix_spec(name, *w), jax.random.PRNGKey(200 + i)))) for i, (name, w) in enumerate(WIDTHS.items())}


def _port_registry(params, names):
    return {n: (lambda n=n: ModelBundle(_port_spec(n, *WIDTHS[n]), params_from_jax(params[n][1]),
                                        torch.device("cpu"))) for n in names}


class _Port:
    """A port server on the service's event loop, warmed."""

    def __init__(self, service):
        self.service = service
        service.start()
        service.warmup()
        self.server = DeconvHTTPServer(service, "127.0.0.1", 0)
        self.base_url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.service.close()


def _pair(params, **kw):
    """(port, JAX) servers of model ``mixa`` with the same settings ``kw``,
    both without the response cache and singleflight, so that every
    request reaches the dispatcher."""
    port = _Port(DeconvService(cfg=ServerConfig(model="mixa", max_batch=4, batch_window_ms=1.0, cache_bytes=0,
                                                singleflight=False, **kw),
                               registry=_port_registry(params, ["mixa"])))
    jcfg = JServerConfig(image_size=0, max_batch=4, batch_window_ms=1.0, compilation_cache_dir="", model="mixa",
                         serve_lanes="off", warmup_all_buckets=False, cache_bytes=0, singleflight=False, **kw)
    spec, p = params["mixa"]
    jax_served = ServiceFixture(None, service=JDeconvService(jcfg, registry={"mixa": lambda: j_spec_bundle(spec, p)}))
    return port, jax_served


@pytest.fixture(scope="module")
def servers(params):
    port, jx = _pair(params)
    try:
        with jx:
            yield port, jx
    finally:
        port.close()


def _grid(body: str) -> np.ndarray:
    raw = base64.b64decode(urllib.parse.unquote(body.split(",", 1)[1]))
    return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR).astype(np.float64)


def _psnr(a, b) -> float:
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def test_concurrent_posts_match_jax(servers):
    """32 concurrent ``POST /`` over 4 images (bodies above
    ``codec_inline_bytes``, so they decode on the codec pool): all 200 on
    both servers, each grid within 52 dB of the JAX server's for its image,
    and each image's ranking (``/v1/deconv``) equal."""
    port, jx = servers
    uris = [_data_url(seed, size=96) for seed in range(4)]
    assert all(len(u) > ServerConfig.codec_inline_bytes for u in uris)
    answers = {}
    for name, served in (("port", port), ("jax", jx)):
        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            answers[name] = list(pool.map(
                lambda i, url=served.base_url: httpx.post(url, data={"file": uris[i % 4], "layer": LAYER},
                                                          timeout=60), range(32)))
    assert [r.status_code for r in answers["port"]] == [r.status_code for r in answers["jax"]] == [200] * 32
    want = {i: _grid(answers["jax"][i].json()) for i in range(4)}
    for i, r in enumerate(answers["port"]):
        assert _psnr(_grid(r.json()), want[i % 4]) >= GRID_PSNR_DB, i
    assert max(port.service.batch_sizes) > 1  # the load coalesced
    for uri in uris:
        filters = [httpx.post(s.base_url + "/v1/deconv", data={"file": uri, "layer": LAYER, "top_k": "4"},
                              timeout=60).json()["filters"] for s in (port, jx)]
        assert filters[0] == filters[1]


@pytest.mark.parametrize("budget_ms,status,code", [("0.001", 504, "deadline_expired"), ("0", 200, None),
                                                   ("60000", 200, None)])
def test_deadline_header_as_jax(servers, budget_ms, status, code):
    """``x-deadline-ms`` of 1 us lapses before the request is queued: 504
    ``deadline_expired`` on both; 0 is no deadline on both (the JAX
    parser's rule), as is a long one."""
    port, jx = servers
    got = [httpx.post(s.base_url, data={"file": _data_url(9), "layer": LAYER},
                      headers={"x-deadline-ms": budget_ms}, timeout=60) for s in (port, jx)]
    assert [r.status_code for r in got] == [status, status]
    if code:
        assert [r.json()["error"] for r in got] == [code, code]


def test_debug_requests_lists_the_pipeline_spans(servers):
    port, jx = servers
    for s in (port, jx):
        rid = f"trace-{'p' if s is port else 'j'}-1"
        r = httpx.post(s.base_url, data={"file": _data_url(11), "layer": LAYER}, headers={"x-request-id": rid},
                       timeout=60)
        assert r.status_code == 200 and r.headers["x-request-id"] == rid
        body = httpx.get(s.base_url + "/v1/debug/requests", params={"id": rid}, timeout=30).json()
        (trace,) = body["requests"]
        names = {span["name"] for span in trace["spans"]}
        assert {"decode", "queue_wait", "dispatch", "fetch", "compute"} <= names, names
        assert trace["status"] == 200 and trace["route"] == "/" and trace["batch_size"] >= 1
    assert httpx.get(port.base_url + "/v1/debug/requests", params={"limit": "x"}, timeout=30).status_code == 400


def _families(text: str) -> set:
    return {m.group(1) for m in re.finditer(r"^# TYPE (\S+) ", text, re.M)}


def test_metrics_name_the_new_series_as_jax(servers):
    port, jx = servers
    for s in (port, jx):  # an expiry on both, so its counter exists on both
        httpx.post(s.base_url, data={"file": _data_url(12), "layer": LAYER}, headers={"x-deadline-ms": "0.001"},
                   timeout=60)
    got, want = (_families(httpx.get(s.base_url + "/metrics", timeout=30).text) for s in (port, jx))
    new = {f"{p}_{n}" for p in ("deconv", "dream", "sweep") for n in NEW_SERIES}
    assert got & new == want & new
    assert {"deconv_inflight_batches", "deconv_breaker_state", "deconv_deadline_expired_total",
            "deconv_codec_workers_live", "deconv_collect_queue_depth"} <= got
    assert {f for f in want if f.startswith("deconv_trace")} <= got


def test_a_forced_shed_is_a_503_with_retry_after_as_jax(params):
    """Each dispatch held 100 ms (``device.dispatch_delay_ms``) and a batch
    p50 of 10 s on record: a burst queues, and arrivals behind the queue
    are shed with 503 ``overloaded`` and a ``Retry-After`` on both."""
    port, jx = _pair(params, faults="device.dispatch_delay_ms=p1:100", request_timeout_s=0.5)
    try:
        with jx:
            for svc in (port.service, jx.service):
                for _ in range(8):
                    svc.metrics.observe_batch(size=1, compute_s=10.0, queue_s=0.0)
            for s in (port, jx):
                with concurrent.futures.ThreadPoolExecutor(16) as pool:
                    got = list(pool.map(lambda i, url=s.base_url: httpx.post(
                        url, data={"file": _data_url(20 + i), "layer": LAYER}, timeout=60), range(16)))
                shed = [r for r in got if r.status_code == 503]
                assert shed and all(r.json()["error"] == "overloaded" for r in shed), [r.status_code for r in got]
                assert all(int(r.headers["retry-after"]) >= 1 for r in shed)
                assert all(r.status_code in (200, 503, 504) for r in got)
    finally:
        port.close()


def test_readyz_is_503_while_draining_as_jax(params):
    port, jx = _pair(params)
    try:
        with jx:
            for s in (port, jx):
                assert httpx.get(s.base_url + "/readyz", timeout=30).status_code == 200
                s.service.begin_drain()
                r = httpx.get(s.base_url + "/readyz", timeout=30)
                assert r.status_code == 503 and r.json()["checks"]["not_draining"] is False
                assert r.headers["connection"] == "close"
    finally:
        port.close()


def test_a_page_out_never_hits_a_batch_in_flight(params):
    """A batch of ``mixb`` dispatched and not yet fetched pins it: paging
    ``mixc`` in under a budget that holds one of the two overcommits rather
    than evict ``mixb``, the batch then fetches the same grid as alone, and
    ``weight_evict_inflight_total`` stays 0."""
    reg = _port_registry(params, WIDTHS)
    nbytes = {n: tree_nbytes(b().params) for n, b in reg.items()}
    budget = nbytes["mixa"] + max(nbytes["mixb"], nbytes["mixc"])
    service = DeconvService(cfg=ServerConfig(model="mixa", serve_models="mixa,mixb,mixc", max_batch=4,
                                             hbm_budget_bytes=budget), registry=reg)
    xs = np.stack([service.decode_preprocess(_data_url(s), service.weights.bundle("mixb")) for s in (30, 31)])
    alone = service.visualize_batch(LAYER, xs, model="mixb")["grid"]
    fetch = service._enqueue_program(Program(LAYER), xs, model="mixb")  # the dispatch step: in flight
    assert service.weights.inflight_pins("mixb") == 1
    service.visualize_batch(LAYER, xs, model="mixc")  # pages mixc in while mixb's batch is in flight
    assert service.weights.overcommits == 1 and "mixb" in service.weights.resident_models()
    np.testing.assert_array_equal(fetch()[LAYER]["grid"], alone)
    assert service.weights.inflight_pins("mixb") == 0
    assert service.metrics.counter("weight_evict_inflight_total") == 0
    service.visualize_batch(LAYER, xs, model="mixc")  # mixb, no longer in flight, may now go
    assert service.metrics.counter("weight_evict_inflight_total") == 0
    service.close()
