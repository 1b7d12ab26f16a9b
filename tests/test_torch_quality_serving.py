"""Per-request ``quality`` and the QoS admission wrap on the served routes:
a port server and a JAX package server of vgg_tiny (the same params,
``params_from_jax``) on the CPU, each at its defaults (the response cache
and singleflight on), asked the same requests in the same order.

This pins the port's fault of ignoring ``quality`` (``quality=bogus``
answered 200 where the reference answers 422; bf16 and int8 answered with
the full-precision grid).  Bars: equal status codes, error codes and
``x-cache`` headers; bf16 and int8 grids, JPEG to JPEG, at
``GRID_PSNR_DB`` (``tests/test_torch_quality.py`` holds the int8 walk
itself at the same bar before the JPEG); a dream is the full dream at
every tier; a ``quality=full`` cache key is byte-equal to the key without
tiers; with ``qos`` a bulk tenant is served int8 through
``quality_by_class`` and a cache hit refunds its device debit down to the
hit cost."""

import base64
import json
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
from deconv_api_tpu_torch.__main__ import main
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.engine import quant
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.weights import params_from_jax
from deconv_api_tpu_torch.serving.app import DeconvService
from deconv_api_tpu_torch.serving.cache import canonical_digest
from deconv_api_tpu_torch.serving.http import Request
from deconv_api_tpu_torch.serving.models import ModelBundle
from tests.test_serving import ServiceFixture
from tests.test_torch_pipeline_serving import _Port

LAYER = "block3_conv1"
DREAM_LAYERS = ("block2_conv2", "block3_conv1")
QUICK_DREAM = {"steps": "1", "octaves": "1"}
GRID_PSNR_DB = 52.0
TENANTS = ('{"bulk1": {"class": "bulk", "rate_ms": 0.001, "burst_ms": 100000},'
           ' "inter": {"class": "interactive"}}')
FORM = "application/x-www-form-urlencoded"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jparams():
    return vgg_tiny_init(jax.random.key(2, impl="rbg"))[1]


def _pair(jparams, **kw):
    """(port, JAX) vgg_tiny servers with the same settings ``kw``."""
    bundle = ModelBundle(VGG_TINY_SPEC, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
                         torch.device("cpu"), dream_layers=DREAM_LAYERS)
    port = _Port(DeconvService(bundle, ServerConfig(model="vgg_tiny", max_batch=4, batch_window_ms=1.0, **kw)))
    jcfg = JServerConfig(image_size=0, max_batch=4, batch_window_ms=1.0, compilation_cache_dir="",
                         model="vgg_tiny", serve_lanes="off", warmup_all_buckets=False, **kw)
    jbundle = lambda: j_spec_bundle(J_TINY_SPEC, jparams, dream_layers=DREAM_LAYERS)  # noqa: E731
    return port, ServiceFixture(None, service=JDeconvService(jcfg, registry={"vgg_tiny": jbundle}))


@pytest.fixture(scope="module")
def servers(jparams):
    port, jx = _pair(jparams)
    try:
        with jx:
            yield port, jx
    finally:
        port.close()


def _uri(seed: int) -> str:
    img = np.random.default_rng(seed).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return "data:image/png;base64," + base64.b64encode(buf.tobytes()).decode()


def _post(served, path, form, headers=None):
    r = httpx.post(served.base_url + path, data=form, headers=headers or {}, timeout=120)
    return r.status_code, r.json(), r.headers.get("x-cache")


def _jpeg(data_url: str) -> np.ndarray:
    raw = base64.b64decode(urllib.parse.unquote(data_url.split(",", 1)[1]))
    return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR).astype(np.float64)


def _psnr(a, b) -> float:
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _form(route: str, seed: int) -> dict:
    if route == "/v1/dream":
        return {"file": _uri(seed), **QUICK_DREAM}
    return {"file": _uri(seed), "layer": LAYER}


CASES = {  # name -> (form fields, headers)
    "bogus": ({"quality": "bogus"}, {}),
    "header_bogus": ({}, {"x-quality": "int4"}),
    "bf16": ({"quality": "bf16"}, {}),
    "int8_upper": ({"quality": "INT8"}, {}),
    "full": ({"quality": "full"}, {}),
    "header_int8": ({}, {"x-quality": "int8"}),
    "form_wins": ({"quality": "bogus"}, {"x-quality": "full"}),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("route", ["/", "/v1/deconv", "/v1/dream"])
def test_every_route_answers_quality_as_the_reference(servers, route, case):
    port, jx = servers
    fields, headers = CASES[case]
    form = {**_form(route, 1), **fields}
    got, want = _post(port, route, form, headers), _post(jx, route, form, headers)
    assert got[0] == want[0], (got, want)
    assert got[2] == want[2]  # x-cache: the 422 answers before any lookup on both
    if got[0] >= 400:
        assert got[1]["error"] == want[1]["error"]
    if "bogus" in case or case == "form_wins":
        assert got[0] == 422 and got[1]["error"] == "illegal_quality"


def test_bf16_and_int8_grids_match_the_reference(servers):
    port, jx = servers
    grids = {}
    for tier in ("full", "bf16", "int8"):
        form = {**_form("/", 2), "quality": tier}
        (s1, got, _), (s2, want, _) = _post(port, "/", form), _post(jx, "/", form)
        assert s1 == s2 == 200
        grids[tier] = _jpeg(got)
        assert _psnr(grids[tier], _jpeg(want)) >= GRID_PSNR_DB, tier
        tiles = {**_form("/v1/deconv", 2), "quality": tier, "top_k": "4"}
        (s1, got, _), (s2, want, _) = _post(port, "/v1/deconv", tiles), _post(jx, "/v1/deconv", tiles)
        assert s1 == s2 == 200 and got["filters"] == want["filters"], tier
    # the tiers really ran: each grid differs from the full one
    assert _psnr(grids["int8"], grids["full"]) < 80 and _psnr(grids["bf16"], grids["full"]) < 80
    counters = port.service.metrics
    assert counters.counter("quant_int8_batches_total") >= 2 and counters.counter("quant_bf16_batches_total") >= 2


def test_dreams_run_full_at_every_tier(servers):
    """``_effective_quality``: a dream has no int8 or bf16 form, so every
    tier shares the full dream's cache key and its bytes; a forced
    recompute at full gives the same image."""
    port, jx = servers
    for served in (port, jx):
        form = _form("/v1/dream", 3)
        s1, int8, x1 = _post(served, "/v1/dream", {**form, "quality": "int8"})
        s2, bf16, x2 = _post(served, "/v1/dream", {**form, "quality": "bf16"})
        s3, full, x3 = _post(served, "/v1/dream", {**form, "quality": "full"}, {"cache-control": "no-cache"})
        assert (s1, s2, s3) == (200, 200, 200) and (x1, x2, x3) == ("miss", "hit", "bypass")
        assert int8 == bf16 == full


def _key(service, route, fields, headers=None):
    body = urllib.parse.urlencode({**_form(route, 4), **fields}).encode()
    return service._request_key(Request("POST", route, {}, {"content-type": FORM, **(headers or {})}, body), route)


def test_the_full_cache_key_is_the_key_without_tiers(servers):
    """A bare request, ``quality=full`` and ``x-quality: full`` hash to the
    key of the service without tiers (the model prefix, the route, the
    form without ``model`` and ``quality``), so existing L2 entries still
    hit; bf16 and int8 keys carry the tier (int8 with its calibration
    tag)."""
    service = servers[0].service
    body = urllib.parse.urlencode(_form("/", 4)).encode()
    without_tiers = canonical_digest(f"{service._model_prefix('vgg_tiny')}|/", FORM, body,
                                     exclude=("model", "quality"))
    for fields, headers in (({}, {}), ({"quality": "full"}, {}), ({}, {"x-quality": "full"}),
                            ({"quality": "full", "model": "vgg_tiny"}, {})):
        assert _key(service, "/", fields, headers) == without_tiers
    prefix = f"{service._model_prefix('vgg_tiny')}|/"
    assert _key(service, "/", {"quality": "bf16"}) == canonical_digest(prefix + "|q=bf16", FORM, body,
                                                                       exclude=("model", "quality"))
    assert _key(service, "/", {}, {"x-quality": "int8"}) == canonical_digest(
        prefix + "|q=int8:dynamic", FORM, body, exclude=("model", "quality"))
    # dreams key every tier as full
    assert _key(service, "/v1/dream", {"quality": "int8"}) == _key(service, "/v1/dream", {})


def test_a_bulk_tenant_is_served_int8_and_a_hit_refunds_its_charge(jparams):
    """With ``--qos``, the default ``quality_by_class="bulk=int8"``: a
    bulk tenant's bare request runs the int8 program (the counter, the
    cache key an explicit int8 request then hits), an interactive
    tenant's bare request the full one; the bulk tenant's repeat is a hit
    whose debit is refunded down to ``qos_hit_cost_ms``.  The same on both
    servers."""
    port, jx = _pair(jparams, qos=True, tenants=TENANTS)
    try:
        with jx:
            seen = {}
            for name, served in (("port", port), ("jax", jx)):
                form = _form("/", 5)
                svc = served.service
                bulk = _post(served, "/", form, {"x-tenant": "bulk1"})
                int8 = _post(served, "/", {**form, "quality": "int8"}, {"x-tenant": "inter"})
                full = _post(served, "/", form, {"x-tenant": "inter"})
                before = svc.qos.snapshot()["tenants"]["bulk1"]["tokens_ms"]
                again = _post(served, "/", form, {"x-tenant": "bulk1"})
                after = svc.qos.snapshot()["tenants"]["bulk1"]["tokens_ms"]
                assert [r[0] for r in (bulk, int8, full, again)] == [200] * 4
                assert [r[2] for r in (bulk, int8, full, again)] == ["miss", "hit", "miss", "hit"]
                assert bulk[1] == int8[1] == again[1] and full[1] != bulk[1]
                assert svc.metrics.counter("quant_int8_batches_total") == 1
                # the hit's provisional debit (the measured cost) came back
                # down to the fixed hit cost
                assert before - after == pytest.approx(svc.cfg.qos_hit_cost_ms, abs=0.004)
                seen[name] = bulk[1]
                text = httpx.get(served.base_url + "/metrics", timeout=30).text
                assert 'qos_class="bulk"' in text and 'qos_class="interactive"' in text
            assert _psnr(_jpeg(seen["port"]), _jpeg(seen["jax"])) >= GRID_PSNR_DB
            got = httpx.get(port.base_url + "/v1/config", timeout=30).json()
            want = httpx.get(jx.base_url + "/v1/config", timeout=30).json()
            for key in ("qos", "tenants", "qos_active", "qos_default_class", "qos_weights", "qos_hit_cost_ms",
                        "quality", "quality_default", "quality_by_class", "calibration_dir"):
                assert got[key] == want[key], key
            assert got["qos_state"]["tenants"].keys() == want["qos_state"]["tenants"].keys()
            ready = httpx.get(port.base_url + "/readyz", timeout=30).json()
            assert ready["qos"] == httpx.get(jx.base_url + "/readyz", timeout=30).json()["qos"]
    finally:
        port.close()


def test_a_calibrated_server_serves_the_artifacts_int8(jparams, tmp_path):
    """An artifact the port's ``collect_ranges`` writes: both servers load
    it, bind their int8 keys to its digest, and serve int8 grids at the
    bar; ``/v1/config`` and ``/readyz`` name it."""
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    images = [(np.random.default_rng(s).standard_normal((32, 32, 3)) * 50).astype(np.float32) for s in range(4)]
    _, digest = quant.save_calibration(str(tmp_path), "vgg_tiny",
                                       quant.collect_ranges(VGG_TINY_SPEC, tparams, images), image_size=32,
                                       n_images=4)
    assert j_quant.load_calibration(str(tmp_path), "vgg_tiny")["digest"] == digest
    port, jx = _pair(jparams, calibration_dir=str(tmp_path))
    try:
        with jx:
            form = {**_form("/", 6), "quality": "int8"}
            (s1, got, _), (s2, want, _) = _post(port, "/", form), _post(jx, "/", form)
            assert s1 == s2 == 200 and _psnr(_jpeg(got), _jpeg(want)) >= GRID_PSNR_DB
            assert _post(port, "/", {**form, "quality": ""}, {"x-quality": "int8"})[2] == "hit"
            cfg = httpx.get(port.base_url + "/v1/config", timeout=30).json()
            assert cfg["quality"] == httpx.get(jx.base_url + "/v1/config", timeout=30).json()["quality"]
            assert cfg["quality"]["calibration"] == {"vgg_tiny": digest} and cfg["calibration_dir"] is True
            assert httpx.get(port.base_url + "/readyz", timeout=30).json()["quality"]["calibrated"] == ["vgg_tiny"]
            body = urllib.parse.urlencode(form).encode()
            key = port.service._request_key(Request("POST", "/", {}, {"content-type": FORM}, body), "/")
            prefix = f"{port.service._model_prefix('vgg_tiny')}|/|q=int8:{digest}"
            assert key == canonical_digest(prefix, FORM, body, exclude=("model", "quality"))
    finally:
        port.close()


@pytest.mark.parametrize("bad", [
    {"quality_default": "int4"},
    {"quality_by_class": "gold=int8"},
    {"quality_by_class": "bulk=int4"},
    {"qos": True, "qos_default_class": "gold"},
    {"qos": True, "tenants": "{not json"},
    {"qos": True, "qos_weights": "bulk=0"},
])
def test_boot_rejects_a_bad_tier_or_policy_as_the_reference(jparams, bad):
    jcfg = JServerConfig(image_size=0, compilation_cache_dir="", model="vgg_tiny", serve_lanes="off", **bad)
    with pytest.raises(ValueError) as want:
        JDeconvService(jcfg, registry={"vgg_tiny": lambda: j_spec_bundle(J_TINY_SPEC, jparams)})
    with pytest.raises(ValueError) as got:
        DeconvService(cfg=ServerConfig(model="vgg_tiny", **bad), device="cpu")
    assert str(got.value) == str(want.value)


def test_the_cli_takes_the_quality_and_qos_flags():
    with pytest.raises(ValueError, match="quality_default"):
        main(["serve", "--model", "vgg_tiny", "--device", "cpu", "--port", "0", "--quality-default", "int4"])
    with pytest.raises(ValueError, match="qos_default_class"):  # --tenants implies --qos
        main(["serve", "--model", "vgg_tiny", "--device", "cpu", "--port", "0", "--tenants", "{}",
              "--qos-default-class", "gold"])
    with pytest.raises(ValueError, match="quality_by_class"):
        main(["serve", "--model", "vgg_tiny", "--device", "cpu", "--port", "0", "--quality-by-class", "x=int8"])
    defaults = ServerConfig()
    for field in ("qos", "tenants", "qos_default_class", "qos_weights", "qos_hit_cost_ms", "quality_default",
                  "quality_by_class", "calibration_dir"):
        assert getattr(defaults, field) == getattr(JServerConfig(), field), field
    body = json.dumps({"file": "x", "quality": "bf16"}).encode()
    req = Request("POST", "/", {}, {"content-type": "application/json"}, body)
    service = DeconvService(cfg=ServerConfig(model="vgg_tiny"), device="cpu")
    assert service._resolve_quality(req) == "bf16" and req.quality == "bf16"


def test_a_dag_model_runs_int8_as_bf16():
    """``_effective_quality`` on a DAG model (no int8 walk): ``int8`` runs
    the bf16-staged program and shares the bf16 key; ``full`` stays full."""
    from deconv_api_tpu_torch.models import mobilenet_v1
    from deconv_api_tpu_torch.serving import codec
    from tests.torch_dag_families import both_params

    bundle = ModelBundle(None, both_params("mobilenet_v1")[1], torch.device("cpu"), name="mobilenet_v1",
                         image_size=64, preprocess=codec.preprocess_tf, layer_names=mobilenet_v1.DECONV_LAYERS,
                         forward_fn=mobilenet_v1.mobilenet_v1_forward)
    port = _Port(DeconvService(bundle, ServerConfig(model="mobilenet_v1", max_batch=2, batch_window_ms=1.0)))
    try:
        form = {"file": _uri(7), "layer": "conv_pw_13_relu"}
        int8 = _post(port, "/", {**form, "quality": "int8"})
        bf16 = _post(port, "/", {**form, "quality": "bf16"})
        full = _post(port, "/", form)
        assert [r[0] for r in (int8, bf16, full)] == [200] * 3
        assert [r[2] for r in (int8, bf16, full)] == ["miss", "hit", "miss"]
        assert int8[1] == bf16[1] != full[1]
        m = port.service.metrics
        assert (m.counter("quant_int8_batches_total"), m.counter("quant_bf16_batches_total")) == (0, 1)
    finally:
        port.close()
