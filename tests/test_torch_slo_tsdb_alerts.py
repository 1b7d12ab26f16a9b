"""The port's latency SLOs (``serving/metrics.py``), metric history
(``serving/tsdb.py``) and alerts (``serving/alerts.py``) against the JAX
package's on the same fake clock and inputs: equal burn rates, exposition
text, query JSON, firing transitions and incident bundles; the boot-time
validation and defaults of their config fields; then the routes on a
vgg_tiny CPU server with all of them on (``/v1/metrics/history``,
``/v1/alerts``, ``/v1/debug/incidents``, ``POST /v1/debug/faults``, the
``/readyz`` blocks) and their 404s on a default server."""

from __future__ import annotations

import dataclasses
import json
import time

import httpx
import pytest
import torch

from deconv_api_tpu.config import ServerConfig as JServerConfig
from deconv_api_tpu.serving import alerts as j_alerts
from deconv_api_tpu.serving import metrics as j_metrics
from deconv_api_tpu.serving import tsdb as j_tsdb
from deconv_api_tpu_torch import __main__ as cli
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.serving import alerts, metrics, tsdb
from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService
from tests.test_serving import _data_url

LAYER = "block3_conv1"
SLICE_FIELDS = ("cache_bytes", "cache_ttl_s", "cache_negative_ttl_s", "cache_shards", "singleflight", "l2_dir",
                "l2_bytes", "slos", "tsdb", "tsdb_interval_s", "alerts", "incidents_dir", "incidents_retention_s")
RULES = json.dumps({"rules": [
    {"name": "busy", "kind": "threshold", "family": "requests_total", "agg": "max", "op": ">", "value": 0.5,
     "range_s": 3, "for_s": 1, "severity": "page"},
    {"name": "burning", "kind": "burn", "slo": "api", "windows": {"5m": 2.0, "1h": 0.5}},
    {"name": "quiet", "kind": "absence", "family": "cache_hits_total", "stale_s": 4},
]})


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- the modules against the JAX package's ----------------------------------


def _slo_run(mod):
    clock = Clock()
    trackers = mod.parse_slos("api=100:99,deconv=50:99.9:/v1/deconv", clock=clock,
                              observable_routes=frozenset(("/", "/v1/deconv", "/v1/dream")))
    out = []
    for step in range(40):
        clock.t += 37.0  # crosses the 10 s buckets and, late on, the 5m window
        for t in trackers:
            if t.matches("/v1/deconv" if step % 3 else "/"):
                t.observe(0.02 + 0.01 * (step % 9), 503 if step % 11 == 0 else 200)
        out.append([t.burn_rates() for t in trackers])
    out.append([t.snapshot() for t in trackers])
    out.append(mod.slo_prometheus(trackers, "deconv"))
    return out


def test_slo_trackers_match_jax():
    got, want = _slo_run(metrics), _slo_run(j_metrics)
    assert got == want
    assert 'deconv_slo_burn_rate{slo="api",window="5m"}' in got[-1]
    assert metrics.SLO_WINDOWS == j_metrics.SLO_WINDOWS


@pytest.mark.parametrize("spec", [
    "", "api=250:99", "api=250:99,deconv=100:99.9:/v1/deconv", "api", "api=250", "api=x:99", "api=250:100",
    "api=0:99", "api=250:99:v1", "api=250:99:/v1/jobs", "a b=1:99", "api=1:99,api=2:99",
])
def test_parse_slos_matches_jax(spec):
    """The same trackers, or the same ValueError text, for each spec."""
    routes = frozenset(("/", "/v1/deconv", "/v1/dream"))
    try:
        want = [t.snapshot() for t in j_metrics.parse_slos(spec, observable_routes=routes)]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            metrics.parse_slos(spec, observable_routes=routes)
        assert str(got.value) == str(e)
    else:
        assert [t.snapshot() for t in metrics.parse_slos(spec, observable_routes=routes)] == want


def _registry(mod):
    """A metrics registry fed the same observations in either package."""
    m = mod.Metrics("deconv")
    m.observe_request(0.012)
    m.observe_request(0.050, error_code="overloaded")
    m.inc_counter("cache_hits_total", 2)
    m.set_gauge("cache_entries", 3.0)
    m.set_labeled_gauge("lane_inflight", "lane", "0", 1.0)
    m.observe_hist("request_duration_seconds", ("route", "qos_class"), ("/", "default"), 0.012, exemplar="r1")
    return m


def _tsdb_run(mod, mmod):
    clock = Clock(0.0)
    db = mod.Tsdb(1.0, raw_slots=40, rollup_slots=20, rollup_mult=5, clock=clock)
    m = _registry(mmod)
    out = []
    for i in range(1, 120):
        clock.t = float(i)
        m.observe_request(0.001 * (i % 7))
        m.inc_counter("cache_hits_total", i % 3)
        m.set_gauge("cache_entries", float((i * 7919) % 101))
        samples = mod.flatten_snapshot(m.snapshot())
        for k in list(samples):
            if k[0] in ("requests_per_s", "images_per_s", "uptime_s"):
                del samples[k]  # wall-clock rates: they differ between two registries
        db.ingest(samples)
        if i % 17 == 0:
            out.append([db.window_agg(f, "", 10.0, agg) for f in ("cache_entries", "cache_hits_total")
                        for agg in ("mean", "max", "min", "last")])
    out.append(db.query("cache_entries", "", range_s=30.0))
    out.append(db.query("cache_hits_total", None, range_s=100.0, step_s=5.0))
    out.append(db.query("request_duration_seconds_bucket", None, range_s=10.0))
    out.append((db.last_age("cache_entries", ""), db.last_age("missing", "")))
    out.append(db.families())
    stats = db.stats()
    out.append({k: v for k, v in stats.items() if k != "bytes_est"})
    return out


def test_flatten_snapshot_matches_jax():
    flat, jflat = tsdb.flatten_snapshot(_registry(metrics).snapshot()), \
        j_tsdb.flatten_snapshot(_registry(j_metrics).snapshot())
    wall = ("requests_per_s", "images_per_s", "uptime_s")
    assert {k: v for k, v in flat.items() if k[0] not in wall} == {k: v for k, v in jflat.items() if k[0] not in wall}


def test_tsdb_ingest_query_and_window_agg_match_jax():
    got, want = _tsdb_run(tsdb, metrics), _tsdb_run(j_tsdb, j_metrics)
    assert json.dumps(got) == json.dumps(want)
    assert got[-6][0]["tier"] == "raw" and got[-5][0]["tier"] == "rollup"


def _alert_run(amod, tmod, mmod, root):
    clock = Clock()
    slo = mmod.SloTracker("api", 100.0, 99.0, clock=clock)
    db = tmod.Tsdb(1.0, clock=clock)
    engine = amod.AlertEngine(amod.parse_alert_rules(RULES, known_slos=frozenset({"api"})), db, slos=[slo],
                              clock=clock)
    store = amod.IncidentStore(str(root), retention_s=30.0, max_bundles=3, clock=clock)
    out = []
    cum = hits = 0.0
    for i in range(30):
        clock.t += 1.0
        cum += 3.0 if 5 <= i < 15 else 0.0
        hits += 1.0 if i < 8 else 0.0
        samples = {("requests_total", ""): (tmod.KIND_COUNTER, cum)}
        if i < 8:
            samples[("cache_hits_total", "")] = (tmod.KIND_COUNTER, hits)
        db.ingest(samples)
        for _ in range(5):
            slo.observe(0.5 if 10 <= i < 14 else 0.01, 200)
        fired = engine.evaluate()
        out.append((i, engine.firing(), [(c["rule"]["name"], c.get("value")) for c in fired]))
        for ctx in fired:
            out.append(store.record(ctx["rule"]["name"], ctx))
    out.append(engine.snapshot())
    out.append(engine.prometheus("deconv"))
    out.append([d["id"] for d in store.list()])
    out.append(store.sweep())
    return out


def test_alert_engine_and_incidents_match_jax(tmp_path):
    """The same rules over the same series and SLO on the same clock: the
    same pending, firing and resolved transitions, counters, exposition
    and incident ids; each package loads the other's bundles."""
    got = _alert_run(alerts, tsdb, metrics, tmp_path / "port")
    want = _alert_run(j_alerts, j_tsdb, j_metrics, tmp_path / "jax")
    assert json.dumps(got) == json.dumps(want)
    assert {name for step in got[:-4] if isinstance(step, tuple) for name in step[1]} == \
        {"busy", "burning", "quiet"}
    ids = [x for x in got if isinstance(x, str) and x.startswith("inc-")]
    port_store = alerts.IncidentStore(str(tmp_path / "jax"), retention_s=1e9)
    jax_store = j_alerts.IncidentStore(str(tmp_path / "port"), retention_s=1e9)
    for inc_id in [d["id"] for d in port_store.list()]:
        assert inc_id in ids
        assert port_store.load(inc_id) == jax_store.load(inc_id) is not None


@pytest.mark.parametrize("spec", [
    '[{"name": "x", "kind": "treshold", "family": "f", "value": 1}]',
    '[{"name": "x", "kind": "threshold", "family": "f", "value": 1, "unknown_key": 1}]',
    '[{"name": "x", "kind": "threshold", "value": 1}]',
    '[{"name": "x", "kind": "burn", "slo": "api", "windows": {"2d": 1.0}}]',
    '[{"name": "x", "kind": "burn", "slo": "nope", "windows": {"5m": 1.0}}]',
    '{"rules": [], "extra": 1}',
    "not json and not a file that exists",
])
def test_malformed_alert_rules_fail_as_jax(spec):
    with pytest.raises(ValueError) as want:
        j_alerts.parse_alert_rules(spec, known_slos=frozenset({"api"}))
    with pytest.raises(ValueError) as got:
        alerts.parse_alert_rules(spec, known_slos=frozenset({"api"}))
    assert str(got.value) == str(want.value)


# --- config, boot and CLI -----------------------------------------------------


@pytest.mark.parametrize("field", SLICE_FIELDS)
def test_defaults_are_the_jax_packages(field):
    assert getattr(ServerConfig(), field) == getattr(JServerConfig(), field)


@pytest.mark.parametrize("overrides,prefix", [
    ({"slos": "api=250"}, "invalid slos spec: "),
    ({"slos": "api=250:99:/v1/jobs"}, "invalid slos spec: "),
    ({"alerts": '[{"name": "x", "kind": "burn", "slo": "api", "windows": {"5m": 1}}]'}, "invalid alerts spec: "),
    ({"alerts": "[{]"}, "invalid alerts spec: "),
    ({"tsdb": "maybe"}, None),
    ({"tsdb_interval_s": 0.0}, None),
])
def test_a_malformed_spec_fails_boot_with_the_jax_message(overrides, prefix):
    routes = frozenset(("/", "/v1/deconv", "/v1/dream"))
    if "slos" in overrides:
        with pytest.raises(ValueError) as e:
            j_metrics.parse_slos(overrides["slos"], observable_routes=routes)
        want = prefix + str(e.value)
    elif "alerts" in overrides:
        with pytest.raises(ValueError) as e:
            j_alerts.parse_alert_rules(overrides["alerts"], known_slos=frozenset())
        want = prefix + str(e.value)
    elif "tsdb" in overrides:
        want = "tsdb must be 'off' or 'on', got 'maybe'"
    else:
        want = "tsdb_interval_s must be > 0, got 0.0"
    with pytest.raises(ValueError) as got:
        DeconvService(cfg=ServerConfig(model="vgg_tiny", **overrides), device="cpu")
    assert str(got.value) == want


def test_cli_flags_set_the_fields(monkeypatch, tmp_path):
    seen = {}

    class Stop(Exception):
        pass

    def fake_service(cfg, device):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(cli, "DeconvService", fake_service)
    with pytest.raises(Stop):
        cli.build_server(["serve", "--model", "vgg_tiny", "--device", "cpu", "--cache-bytes", "1000",
                          "--cache-ttl-s", "5", "--cache-negative-ttl-s", "0", "--cache-shards", "2",
                          "--no-singleflight", "--l2-dir", str(tmp_path), "--l2-bytes", "99",
                          "--slo", "api=250:99", "--tsdb", "on", "--tsdb-interval-s", "0.5", "--alerts", "[]",
                          "--incidents-dir", str(tmp_path), "--incidents-retention-s", "60"])
    cfg = seen["cfg"]
    assert (cfg.cache_bytes, cfg.cache_ttl_s, cfg.cache_negative_ttl_s, cfg.cache_shards, cfg.singleflight) == \
        (1000, 5.0, 0.0, 2, False)
    assert (cfg.l2_dir, cfg.l2_bytes, cfg.slos, cfg.tsdb, cfg.tsdb_interval_s, cfg.alerts, cfg.incidents_dir,
            cfg.incidents_retention_s) == (str(tmp_path), 99, "api=250:99", "on", 0.5, "[]", str(tmp_path), 60.0)
    with pytest.raises(Stop):
        cli.build_server(["serve", "--model", "vgg_tiny", "--device", "cpu"])
    assert {f: getattr(seen["cfg"], f) for f in SLICE_FIELDS} == {f: getattr(ServerConfig(), f) for f in SLICE_FIELDS}


# --- the routes ---------------------------------------------------------------


class _Served:
    def __init__(self, **cfg):
        self.service = DeconvService(cfg=ServerConfig(model="vgg_tiny", max_batch=4, batch_window_ms=1.0, **cfg),
                                     device="cpu")
        self.service.start()
        self.service.warmup()
        self.server = DeconvHTTPServer(self.service, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.client = httpx.Client(timeout=60)

    def get(self, path, **params):
        return self.client.get(self.url + path, params=params)

    def close(self):
        self.client.close()
        self.server.server_close()
        self.service.close()


def _until(cond, timeout_s=20.0):
    t_end = time.perf_counter() + timeout_s
    while not cond():
        assert time.perf_counter() < t_end
        time.sleep(0.01)


def test_observability_routes_on_a_server_with_them_on(tmp_path):
    rules = json.dumps([{"name": "busy", "kind": "threshold", "family": "requests_total", "agg": "max",
                         "op": ">", "value": 0.0, "range_s": 1, "for_s": 0}])
    s = _Served(slos="api=3000:99,dreams=1:99:/v1/dream", tsdb="on", tsdb_interval_s=0.05, alerts=rules,
                incidents_dir=str(tmp_path), fault_injection=True)
    try:
        assert s.client.post(s.url, data={"file": _data_url(1, size=32), "layer": LAYER}).status_code == 200
        _until(lambda: s.get("/v1/alerts").json()["firing"] == 1)
        ready = s.get("/readyz")
        assert ready.status_code == 200
        body = ready.json()
        assert body["slo"]["api"]["requests_total"] == 1 and body["slo"]["api"]["ok"] is True
        assert body["slo"]["dreams"]["requests_total"] == 0 and body["alerts"]["eval_errors"] == 0
        assert body["durability"]["surfaces"]["alerts.incidents"]["degraded"] is False
        text = s.get("/metrics").text
        for line in ('deconv_slo_burn_rate{slo="api",window="5m"} 0', 'deconv_slo_requests_total{slo="api"} 1',
                     'deconv_alert_state{rule="busy"}'):
            assert line in text, line
        assert 'deconv_request_duration_seconds_count{route="/",qos_class="default"} 1' in text
        catalog = s.get("/v1/metrics/history").json()
        assert "requests_total" in catalog["families"] and catalog["stats"]["scrapes_total"] >= 1
        hist = s.get("/v1/metrics/history", family="request_duration_seconds_count", range_s="30").json()
        assert hist["family"] == "request_duration_seconds_count" and hist["series"]
        burn = s.get("/v1/metrics/history", family="slo_burn_rate", label="slo=api,window=5m").json()
        assert burn["series"][0]["points"]
        assert s.get("/v1/metrics/history", family="requests_total", range_s="-1").status_code == 400
        assert s.get("/v1/metrics/history", family="requests_total", step_s="x").status_code == 400
        listed = s.get("/v1/debug/incidents").json()
        assert listed["writes_total"] >= 1
        inc = s.get("/v1/debug/incidents", id=listed["incidents"][0]["id"]).json()
        assert inc["rule"]["name"] == "busy" and inc["config"]["incidents_dir"] is True
        assert s.get("/v1/debug/incidents", id="inc-0-0-nope").status_code == 400
        armed = s.client.post(s.url + "/v1/debug/faults", data={"arm": "device.dispatch_error=n1"})
        assert armed.status_code == 200 and "device.dispatch_error" in json.dumps(armed.json()["faults"])
        failed = s.client.post(s.url, data={"file": _data_url(2, size=32), "layer": LAYER})
        assert failed.status_code == 500 and failed.json()["error"] == "fault_injected"
        assert s.client.post(s.url + "/v1/debug/faults", data={"disarm": "all"}).status_code == 200
        assert s.client.post(s.url + "/v1/debug/faults", data={"arm": "nope=p1"}).status_code == 400
        cfg = s.get("/v1/config").json()
        assert cfg["tsdb_active"] is True and cfg["slos"] is True and cfg["alerts"] is True
        assert set(cfg["slo_state"]) == {"api", "dreams"} and cfg["alerts_state"]["rules"] == 1
        assert cfg["incidents_state"]["writes_total"] >= 1
    finally:
        s.close()
    assert s.service._tsdb_task is None


def test_a_default_server_has_none_of_them():
    s = _Served()
    try:
        for path in ("/v1/metrics/history", "/v1/alerts", "/v1/debug/incidents"):
            assert s.get(path).status_code == 404, path
        assert s.client.post(s.url + "/v1/debug/faults", data={"disarm": "all"}).status_code == 404
        body = s.get("/readyz").json()
        assert not {"slo", "alerts", "durability"} & set(body)
        assert s.service.tsdb is None and s.service._tsdb_task is None
        assert "slo_burn_rate" not in s.get("/metrics").text
        cfg = s.get("/v1/config").json()
        want = dataclasses.asdict(JServerConfig())
        want.update(slos=False, alerts=False, incidents_dir=False)
        assert {f: cfg[f] for f in SLICE_FIELDS} == {f: want[f] for f in SLICE_FIELDS}
        assert (cfg["cache_active"], cfg["singleflight_active"], cfg["tsdb_active"]) == (True, True, False)
    finally:
        s.close()


def test_an_incident_bundle_masks_the_jax_packages_paths():
    """Both packages' incident ``config`` on the same set paths: the same
    keys become bools, and the port masks every key the JAX package masks
    that it has (not ``compilation_cache_dir``: no field here)."""
    from types import SimpleNamespace

    from deconv_api_tpu.serving.app import DeconvService as JDeconvService

    paths = dict(weights_path="/w", profile_dir="/p", jobs_dir="/j", calibration_dir="/c", aot_dir="/a",
                 incidents_dir="/i", l2_dir="/l2")
    tsdb_stub = SimpleNamespace(query=lambda *a, **k: [])

    def config(service_cls, cfg):
        stub = SimpleNamespace(cfg=cfg, tsdb=tsdb_stub, recorder=None, alert_engine=None)
        return service_cls._incident_bundle(stub, {"rule": {"kind": "absence"}})["config"]

    port = config(DeconvService, ServerConfig(**paths))
    jax = config(JDeconvService, JServerConfig(compilation_cache_dir="/cc", **paths))
    masked = {k for k, v in jax.items() if v is True and JServerConfig.__dataclass_fields__[k].type == "str"}
    assert masked == set(paths) - {"l2_dir"} | {"compilation_cache_dir"}
    assert {k for k in masked if k in port} == masked - {"compilation_cache_dir"}
    assert {k: port[k] for k in paths} == {k: jax[k] for k in paths}
