"""The port's autoscaler (``deconv_api_tpu_torch/serving/autoscale.py``)
against the JAX package's on the same inputs: the exposition parse and
``FleetSignals`` (also over a real router's federation splice), the
``DecisionEngine`` on scripted signal and clock sequences, the
``ArrivalHistory`` forecasts, decision journals written by one package
and replayed by the other, and the embedded controller's tick.  Then the
port's own wiring: the controller in the router (``--autoscale off``
constructs nothing), the fail-static tick, launch retries, boot-to-warm,
the jobs gate on reaping, a zero-loss scale-down over in-process stub
backends, and the ``autoscaler`` command.  No test starts a ``serve``
process; every wait is bounded at 30 s."""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys

import pytest
import torch

from deconv_api_tpu.serving import autoscale as j_autoscale
from deconv_api_tpu.serving import fleet as j_fleet
from deconv_api_tpu.serving.metrics import Metrics as JMetrics
from deconv_api_tpu_torch.serving import autoscale, fleet
from deconv_api_tpu_torch.serving.autoscale import (
    AutoscaleController,
    BackendLauncher,
    Decision,
    DecisionJournal,
    FleetSignals,
    LaunchedBackend,
)
from deconv_api_tpu_torch.serving.http import HttpServer, Request, Response
from deconv_api_tpu_torch.serving.metrics import Metrics
from tests.test_metrics_exposition import lint_exposition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND_S = 30.0
PACKAGES = {"port": (autoscale, fleet, Metrics), "jax": (j_autoscale, j_fleet, JMetrics)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND_S))


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _backend_exposition(metrics_cls, jobs_active=0.0, l2_hits=0, device_ms=None, aot_hits=0) -> str:
    """A backend's ``/v1/metrics`` body through the package's registry."""
    m = metrics_cls(prefix="deconv", core=False)
    m.set_gauge("jobs_active", jobs_active)
    m.inc_counter("cache_l2_hits_total", l2_hits)
    if aot_hits:
        m.inc_counter("aot_cache_hits_total", aot_hits)
    for tenant, ms in (device_ms or {}).items():
        m.inc_labeled("tenant_device_ms_total", ("tenant", "class"), (tenant, "interactive"), ms)
    return m.prometheus()


def _script(monkeypatch, fleet_mod, expositions: dict, jobs=None):
    """``raw_request`` of ``fleet_mod`` answering the probe, the scrape and
    ``/v1/jobs`` of a set of fake backends."""
    jobs = jobs if jobs is not None else {}

    async def fake(host, port, method, target, headers, body, timeout_s):
        name = f"{host}:{port}"
        if target == "/readyz":
            return 200, {}, b'{"ready": true}'
        if target == "/v1/metrics":
            return 200, {}, expositions[name].encode()
        if target == "/v1/jobs":
            return 200, {}, json.dumps({"counts": jobs.get(name, {"running": 0, "parked": 0})}).encode()
        return 200, {}, b"{}"

    monkeypatch.setattr(fleet_mod, "raw_request", fake)


def _signals(mod, queue=None, burn=0.0, device_ms=None, warm=None):
    s = mod.FleetSignals()
    s.queue_depth = dict(queue or {})
    s.scrape_ok = {b: True for b in s.queue_depth}
    if burn:
        s.burn[("api", "5m")] = burn
    s.device_ms = dict(device_ms or {})
    s.warm_hits = dict(warm or {})
    return s


# ------------------------------------------------------------- signals

FORGIVING = "\n".join([
    "# HELP x_total help", "# TYPE x_total counter", "x_total 3",
    'y{backend="b0:8000",slo="api"} 1.5', "not a metric line @@", "z_bad_value nope",
    'esc{name="a\\"b\\\\c\\nd"} 2', 'router_slo_burn_rate{slo="api",window="5m"} 0.4',
    'router_slo_burn_rate{slo="api",window="5m"} 1.2', 'router_slo_burn_rate{slo="api",window="1h"} 0.1',
    'deconv_jobs_active{backend="b0:8000"} 8', 'deconv_jobs_active{backend="b1:8001"} 100',
    'deconv_jobs_running{backend="b0:8000"} 1', 'deconv_jobs_parked{backend="b1:8001"} 2',
    'fleet_scrape_ok{backend="b0:8000"} 1', 'fleet_scrape_ok{backend="b1:8001"} 0', "fleet_backends_scraped 2",
    'deconv_tenant_device_ms_total{tenant="acme",class="bulk"} 40',
    'deconv_tenant_device_ms_total{tenant="acme",class="interactive"} 2', "router_requests_total 7",
    'router_requests_total{backend="b0:8000"} 5', 'deconv_aot_cache_hits_total{backend="b1:8001"} 4',
    'deconv_cache_l2_hits_total{backend="b1:8001"} 1', "inf_value +Inf", "",
])


def _digest(s) -> dict:
    return {k: getattr(s, k) for k in FleetSignals.__slots__} | {
        "burn_max": (s.burn_max("5m"), s.burn_max("1h")), "queue_mean": s.queue_mean()}


def test_the_exposition_and_its_signals_parse_as_jax():
    assert autoscale.WARM_HIT_FAMILIES == j_autoscale.WARM_HIT_FAMILIES
    assert autoscale.parse_exposition(FORGIVING) == j_autoscale.parse_exposition(FORGIVING)
    port = _digest(FleetSignals.from_exposition(FORGIVING))
    assert port == _digest(j_autoscale.FleetSignals.from_exposition(FORGIVING))
    assert port["burn_max"] == (1.2, 0.1) and port["queue_mean"] == 8.0 and port["warm_hits"] == {"b1:8001": 5.0}


def test_a_routers_federation_splice_reads_as_jax(monkeypatch):
    """Each package's router federates the same two backends: the port's
    splice gives the port's signals what the JAX splice gives the JAX
    package's."""
    digests = {}
    for name, (mod, fleet_mod, metrics_cls) in PACKAGES.items():
        router = fleet_mod.FleetRouter(["b0:8000", "b1:8001"], clock=_Clock())
        _script(monkeypatch, fleet_mod, {
            "b0:8000": _backend_exposition(metrics_cls, jobs_active=5, l2_hits=7, device_ms={"acme": 900}),
            "b1:8001": _backend_exposition(metrics_cls, jobs_active=1, aot_hits=4),
        })

        async def go(router=router):
            await router.probe_once()
            return (await router._metrics_fleet(None)).body.decode()

        digests[name] = _digest(mod.FleetSignals.from_exposition(_run(go())))
    assert digests["port"] == digests["jax"]
    assert digests["port"]["warm_hits"] == {"b0:8000": 7.0, "b1:8001": 4.0}
    assert digests["port"]["queue_mean"] == 3.0 and digests["port"]["device_ms"] == {"acme": 900.0}


# -------------------------------------------------------------- engine

# each step: (signals, fleet size, pending, seconds to the next step);
# "arrivals" steps record tenants' arrivals into a one-second history
HOT, COLD, QUIET = {"queue": {"b0": 10.0}}, {"queue": {"b0": 0.0}}, {"queue": {"b0": 0.6}}
ENGINE_SCRIPTS = {
    "flapping": (dict(up_queue=4.0, down_queue=0.5, up_consecutive=2, down_consecutive=3),
                 [(HOT if i % 2 == 0 else COLD, 2, 0, 5.0) for i in range(12)]),
    "sustained_hot": (dict(up_queue=4.0, up_consecutive=2, cooldown_up_s=30.0, max_backends=4),
                      [(HOT, 1, 0, 5.0), (HOT, 1, 0, 5.0), (HOT, 2, 0, 5.0), (HOT, 2, 0, 35.0), (HOT, 2, 0, 5.0)]),
    "burn": (dict(up_burn=0.9, up_consecutive=1),
             [({"queue": {"b0": 0.0}, "burn": 1.5}, 1, 0, 5.0), ({"queue": {"b0": 0.0}, "burn": 0.95}, 2, 0, 40.0),
              ({"queue": {"b0": 0.0}, "burn": 0.5}, 3, 0, 5.0)]),
    "max_and_pending": (dict(up_queue=4.0, up_consecutive=1, max_backends=3),
                        [(HOT, 2, 1, 5.0), (HOT, 3, 0, 5.0), (HOT, 1, 1, 5.0)]),
    "down_gates": (dict(up_queue=4.0, up_consecutive=1, down_queue=0.5, down_consecutive=3, cooldown_down_s=60.0,
                        cooldown_up_s=1.0, min_backends=1, max_backends=4),
                   [(HOT, 2, 0, 5.0)] + [(COLD, 3, 0, 5.0)] * 3 + [(COLD, 3, 0, 20.0)] * 3 + [(COLD, 2, 0, 5.0)] * 3
                   + [(COLD, 1, 0, 5.0)] * 3),
    "qos_gate": (dict(down_queue=0.5, down_consecutive=2, cooldown_down_s=1.0, qos_device_ms_budget=800.0),
                 [({"queue": {"b0": 0.0}, "device_ms": {"acme": 0.0}}, 3, 0, 5.0),
                  ({"queue": {"b0": 0.0}, "device_ms": {"acme": 10000.0}}, 3, 0, 5.0),
                  ({"queue": {"b0": 0.0}, "device_ms": {"acme": 10000.0}}, 3, 0, 5.0),
                  ({"queue": {"b0": 0.0}, "device_ms": {"acme": 9000.0}}, 2, 0, 5.0)]),
    "pre_scale": (dict(up_queue=100.0, cooldown_up_s=30.0, predict_horizon_s=10.0, predict_ramp=2.0,
                       predict_min_rate=1.0),
                  [("arrivals", n) for n in (4, 8, 16, 24, 32, 40)]
                  + [(QUIET, 1, 0, 1.0), (QUIET, 2, 0, 1.0), (QUIET, 2, 0, 40.0)]),
}


def _decide(mod, opts: dict, script: list) -> list:
    clock = _Clock()
    engine = mod.DecisionEngine(clock=clock, **opts)
    history = mod.ArrivalHistory(bucket_s=1.0, clock=clock)
    out = []
    for step in script:
        if step[0] == "arrivals":
            history.record("t", step[1])
            clock.t += 1.0
            continue
        sig, size, pending, dt = step
        d = engine.evaluate(_signals(mod, **sig), size, pending=pending,
                            arrivals=history if opts.get("predict_horizon_s") else None)
        out.append((d.action, d.reason, d.detail))
        clock.t += dt
    return out + [(engine.last_up_ts, engine.last_down_ts)]


@pytest.mark.parametrize("scenario", sorted(ENGINE_SCRIPTS))
def test_the_decision_engine_decides_as_jax(scenario):
    opts, script = ENGINE_SCRIPTS[scenario]
    port = _decide(autoscale, opts, script)
    assert port == _decide(j_autoscale, opts, script)
    # each script reaches the decisions it is named after
    reached = {(a, r) for a, r, *_ in port[:-1]}
    assert {
        "flapping": {("hold", "steady")},
        "sustained_hot": {("hold", "steady"), ("up", "queue"), ("hold", "cooldown-up")},
        "burn": {("up", "burn"), ("hold", "cooldown-up"), ("hold", "steady")},
        "max_and_pending": {("hold", "at-max"), ("up", "queue")},
        "down_gates": {("up", "queue"), ("hold", "up-recent"), ("down", "idle"), ("hold", "cooldown-down"),
                       ("hold", "at-min"), ("hold", "steady")},
        "qos_gate": {("hold", "steady"), ("hold", "qos-budget"), ("down", "idle")},
        "pre_scale": {("up", "predictive"), ("hold", "steady")},
    }[scenario] == reached


def test_engine_restore_reads_a_journal_as_jax():
    records = [{"action": "up", "clock": 500.0}, {"action": "down", "clock": 99999.0}, {"action": "up"},
               {"action": "up", "clock": 700.0}, {"kind": "warm", "clock": 900.0}]
    anchors = []
    for mod in (autoscale, j_autoscale):
        engine = mod.DecisionEngine(clock=_Clock())
        engine.restore(records, now=1000.0)
        anchors.append((engine.last_up_ts, engine.last_down_ts))
    assert anchors[0] == anchors[1] == (700.0, 1000.0)


# ------------------------------------------------------------ arrivals


def _arrivals(mod) -> list:
    clock = _Clock()
    h = mod.ArrivalHistory(bucket_s=1.0, max_buckets=8, max_tenants=2, clock=clock)
    out = []
    for n in (2, 4, 8, 12, 16, 20, 5, 0, 30):
        for i in range(n):
            h.record(("a", "b", f"tail-{i}")[i % 3])
        clock.t += 1.0
        out.append((h.rate(), h.rate(1), h.forecast(10.0), h.forecast(30.0, n=4)))
    return out + [sorted((k, sorted(v.items())) for k, v in h._buckets.items())]


def test_arrival_history_forecasts_as_jax():
    port = _arrivals(autoscale)
    assert port == _arrivals(j_autoscale)
    assert port[5][2][1] > 2 * port[5][2][0] > 0  # the ramp is seen
    assert len(port[-1]) == 8 and all(len(dict(v)) <= 3 for _, v in port[-1])  # a + b + other


# ------------------------------------------------------------- journal


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_journal_replays_in_the_other_package(tmp_path, writer):
    records = [{"kind": "decision", "action": "up", "reason": "queue", "clock": 5.0},
               {"kind": "launched", "backend": "127.0.0.1:9001", "clock": 6.5},
               {"kind": "decision", "action": "down", "reason": "idle", "clock": 9.0}]
    paths = {}
    for name, (mod, _f, _m) in PACKAGES.items():
        paths[name] = str(tmp_path / f"{name}.jsonl")
        j = mod.DecisionJournal(paths[name])
        for rec in records:
            j.append(rec)
        j.close()
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    with open(paths[writer], "a") as f:
        f.write('{"kind": "decision", "action": "up", "cl')  # a crash mid-append
    reader = j_autoscale if writer == "port" else autoscale
    assert reader.DecisionJournal.replay(paths[writer]) == records
    engine = reader.DecisionEngine(clock=_Clock())
    engine.restore(reader.DecisionJournal.replay(paths[writer]), now=1000.0)
    assert (engine.last_up_ts, engine.last_down_ts) == (5.0, 9.0)


# ---------------------------------------------------------- controller


def test_an_embedded_advisory_tick_decides_and_surfaces_as_jax(monkeypatch, tmp_path):
    seen = {}
    for name, (mod, fleet_mod, metrics_cls) in PACKAGES.items():
        clock = _Clock()
        jpath = str(tmp_path / f"{name}.jsonl")
        router = fleet_mod.FleetRouter(["b0:8000", "b1:8001"], clock=clock, autoscale="advisory",
                                       slos="api=250:99", autoscale_opts={
                                           "journal_path": jpath,
                                           "engine_opts": {"up_queue": 3.0, "up_consecutive": 1}})
        ctl = router.autoscaler

        async def go(router=router, ctl=ctl, fleet_mod=fleet_mod, metrics_cls=metrics_cls, clock=clock):
            out = []
            for jobs_active in (0, 50, 50, 0):
                _script(monkeypatch, fleet_mod, {b: _backend_exposition(metrics_cls, jobs_active=jobs_active)
                                                 for b in ("b0:8000", "b1:8001")})
                await router.probe_once()
                await ctl.tick()
                out.append(ctl.ready_block())
                clock.t += 5.0
            cfg = json.loads((await router._config(None)).body)
            ready = json.loads((await router._readyz(None)).body)
            text = (await router._metrics_route(None)).body.decode()
            await ctl.stop()
            return out, cfg["autoscale"], ready["autoscale"], text

        blocks, cfg, ready, text = _run(go())
        assert ctl.launcher.intents == [] and not ctl.pending  # advisory: nothing acted on
        assert "autoscaler_decisions_total" in text
        cfg["journal"] = os.path.basename(cfg["journal"])
        records = [{k: v for k, v in r.items() if k != "mode"} for r in mod.DecisionJournal.replay(jpath)]
        seen[name] = (blocks, cfg, ready, records, ctl.metrics.labeled("decisions_total"))
    port, jax = seen["port"], seen["jax"]
    port[1]["journal"] = jax[1]["journal"] = "j.jsonl"
    assert port == jax
    assert [b["last_decision"]["action"] for b in port[0]] == ["hold", "up", "hold", "hold"]
    assert port[4][("up", "queue")] == 1


def test_autoscale_off_leaves_the_router_as_it_was(monkeypatch):
    """Off constructs nothing: no block on /v1/config or /readyz, no
    autoscaler_ family, and the proxy path records no arrival; the same
    keys as the JAX router's off surface."""
    keys = {}
    for name, (mod, fleet_mod, metrics_cls) in PACKAGES.items():
        router = fleet_mod.FleetRouter(["b0:8000"], clock=_Clock())
        assert router.autoscaler is None
        _script(monkeypatch, fleet_mod, {"b0:8000": _backend_exposition(metrics_cls)})

        async def go(router=router):
            await router.probe_once()
            cfg = json.loads((await router._config(None)).body)
            ready = json.loads((await router._readyz(None)).body)
            text = (await router._metrics_route(None)).body.decode()
            return cfg, ready, text

        cfg, ready, text = _run(go())
        assert "autoscale" not in cfg and "autoscale" not in ready and "autoscaler_" not in text
        keys[name] = (set(ready), {k for k in cfg if "autoscal" in k or k.startswith("tsdb")})
    assert keys["port"] == keys["jax"]
    with pytest.raises(ValueError, match="advisory|enforce"):
        AutoscaleController(mode="off", router_addr="x:1")


class _RecLauncher(BackendLauncher):
    """Launches mint names; reaps are remembered."""

    def __init__(self, fail_first: int = 0):
        self.launches, self.fail_first = 0, fail_first
        self.reaps: list[str] = []
        self.procs: dict[str, object] = {}

    async def launch(self) -> LaunchedBackend:
        self.launches += 1
        if self.launches <= self.fail_first:
            raise autoscale.LaunchError("boom")
        return LaunchedBackend(f"b{self.launches}:9{self.launches:03d}")

    async def reap(self, name: str, handle=None) -> None:
        self.reaps.append(name)


def test_the_controller_fails_static_retries_launches_and_times_boot_to_warm(monkeypatch, tmp_path):
    clock = _Clock()
    launcher = _RecLauncher(fail_first=1)
    jpath = str(tmp_path / "j.jsonl")
    router = fleet.FleetRouter(["b0:8000", "b2:8002"], clock=clock, autoscale="enforce", fault_injection=True,
                               autoscale_opts={"launcher": launcher, "retry_backoff_s": 0.0,
                                               "warm_timeout_s": 60.0, "journal_path": jpath})
    _script(monkeypatch, fleet, {b: _backend_exposition(Metrics, jobs_active=99) for b in ("b0:8000", "b2:8002")})
    ctl = router.autoscaler

    async def go():
        await router.probe_once()
        router.faults.arm("autoscale.decision_error", "n1")
        await ctl.tick()
        assert ctl.metrics.counter("errors_total") == 1 and ctl._last_decision is None
        await ctl._scale_up(Decision("up", "queue"))  # one failure, then a launch
        await ctl._scale_up(Decision("up", "queue"))  # pending: never stacked
        assert (launcher.launches, list(ctl.pending)) == (2, ["b2:9002"])
        assert ctl.metrics.counter("launch_failures_total") == 1
        ctl.pending = {"b2:8002": LaunchedBackend("b2:8002", t_launch=clock.t)}
        ctl._check_pending_warm(_signals(autoscale))  # registered, no warm hit yet
        assert "b2:8002" in ctl.pending
        clock.t += 2.5
        ctl._check_pending_warm(_signals(autoscale, warm={"b2:8002": 4.0}))
        assert not ctl.pending
        (_, hist), = ctl.metrics.hist_series("boot_to_warm_seconds").items()
        assert hist["count"] == 1 and abs(hist["sum"] - 2.5) < 1e-9
        ctl.pending = {"b2:8002": LaunchedBackend("b2:8002", t_launch=clock.t)}
        clock.t += 61.0
        ctl._check_pending_warm(_signals(autoscale))
        assert not ctl.pending and ctl.metrics.counter("errors_total") == 2
        await ctl.stop()

    _run(go())
    kinds = [r["kind"] for r in DecisionJournal.replay(jpath)]
    assert kinds == ["launch_failed", "launched", "warm", "warm_timeout"]
    families, samples = lint_exposition(ctl.metrics.prometheus())
    assert families["autoscaler_boot_to_warm_seconds"] == "histogram"
    assert samples[("autoscaler_reap_blocked_total", "")] == 0.0


def test_the_jobs_gate_blocks_a_reap_until_its_jobs_are_done(monkeypatch):
    clock = _Clock()
    launcher = _RecLauncher()
    launcher.procs["b1:8001"] = object()  # owned: the preferred victim
    router = fleet.FleetRouter(["b0:8000", "b1:8001"], clock=clock, autoscale="enforce",
                               autoscale_opts={"launcher": launcher, "drain_grace_s": 0.2, "drain_settle_s": 0.0,
                                               "interval_s": 0.02})
    ctl = router.autoscaler
    counts = {"running": 1, "parked": 0}

    async def fake(host, port, method, target, headers, body, timeout_s):
        if target == "/readyz":
            return 200, {}, b'{"ready": true}'
        if target == "/v1/jobs":
            clock.t += 0.06
            if counts is None:
                raise fleet._BackendError("unreachable")
            return 200, {}, json.dumps({"counts": dict(counts)}).encode()
        return 200, {}, b"{}"

    monkeypatch.setattr(fleet, "raw_request", fake)

    async def go():
        await router.probe_once()
        ctl._last_signals = _signals(autoscale, queue={"b0:8000": 0.0, "b1:8001": 0.0})
        await ctl._scale_down(Decision("down", "idle"))
        assert list(ctl.draining) == ["b1:8001"] and router.members["b1:8001"].announced_drain
        await ctl.draining["b1:8001"]
        assert (ctl.metrics.counter("reap_blocked_total"), launcher.reaps) == (1, [])
        counts.update(running=0, parked=1)
        assert await ctl._jobs_clear("b1:8001") is False
        counts.update(parked=0)
        await ctl._drain_and_reap("b1:8001")
        assert launcher.reaps == ["b1:8001"] and ctl.metrics.counter("reaped_total") == 1

    _run(go())


class _Stub:
    """An in-process backend on the test's loop: ``/readyz``, ``/v1/metrics``
    (an L2 hit, so it reads warm), ``/v1/jobs`` and ``POST /v1/deconv``."""

    def __init__(self):
        self.server = HttpServer(max_connections=64)
        metrics = Metrics(prefix="deconv", core=False)
        metrics.set_gauge("jobs_active", 0)
        metrics.inc_counter("cache_l2_hits_total", 1)

        async def readyz(_req):
            return Response.json({"ready": True})

        async def exposition(_req):
            return Response.text(metrics.prometheus(), content_type="text/plain; version=0.0.4")

        async def jobs(_req):
            return Response.json({"counts": {"running": 0, "parked": 0, "queued": 0}})

        async def work(_req):
            await asyncio.sleep(0.01)
            return Response.json({"ok": True})

        for method, path, fn in (("GET", "/readyz", readyz), ("GET", "/v1/metrics", exposition),
                                 ("GET", "/v1/jobs", jobs), ("POST", "/v1/deconv", work)):
            self.server.route(method, path)(fn)

    async def start(self) -> str:
        return f"127.0.0.1:{await self.server.start('127.0.0.1', 0)}"


def test_a_scale_down_over_stub_backends_loses_no_request():
    """The controller drain-announces its victim, proves its jobs tier
    empty over HTTP and reaps it (the stub's listener closes) while
    traffic flows through the router: every answer is a 200."""
    statuses: list[int] = []

    class StopLauncher(_RecLauncher):
        async def reap(self, name, handle=None):
            self.reaps.append(name)
            await self.procs[name].server.stop(1.0)

    async def go():
        stubs = [_Stub(), _Stub()]
        names = [await s.start() for s in stubs]
        launcher = StopLauncher()
        launcher.procs[names[1]] = stubs[1]
        router = fleet.FleetRouter(names, probe_interval_s=0.2, autoscale="enforce",
                                   autoscale_opts={"launcher": launcher, "drain_grace_s": 5.0,
                                                   "drain_settle_s": 0.2, "interval_s": 0.5})
        ctl = router.autoscaler
        try:
            await router.probe_once()
            await ctl.tick()
            stop = asyncio.Event()

            async def traffic():
                i = 0
                while not stop.is_set():
                    resp = await router._proxy(Request(
                        method="POST", path="/v1/deconv", query={},
                        headers={"content-type": "application/x-www-form-urlencoded"},
                        body=f"layer=c3&file=k{i % 16}".encode(), id=f"rid-{i}"))
                    statuses.append(resp.status)
                    i += 1
                    await asyncio.sleep(0.01)

            t = asyncio.create_task(traffic())
            await asyncio.sleep(0.3)
            await ctl._scale_down(Decision("down", "idle"))
            assert list(ctl.draining) == [names[1]]
            await ctl.draining[names[1]]
            assert launcher.reaps == [names[1]]
            await asyncio.sleep(0.3)
            stop.set()
            await t
        finally:
            await ctl.stop()
            for pool in router.pools.values():
                pool.flush()
            await stubs[0].server.stop(1.0)

    _run(go())
    assert len(statuses) > 20 and set(statuses) == {200}


def test_the_autoscaler_command_and_the_routers_flags():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import runpy, sys\n"
            "sys.argv = ['x', 'autoscaler', '--help']\n"
            "try:\n"
            "    runpy.run_module('deconv_api_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    print('exit', e.code)\n"
            "print('torch' in sys.modules, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-2:] == ["exit 0", "False False"]
    assert "advisory" in out.stdout and "--launch-cmd" in out.stdout and "--once" in out.stdout
    flags = subprocess.run([sys.executable, "-m", "deconv_api_tpu_torch", "fleet-router", "--help"], cwd=ROOT,
                           env=env, capture_output=True, text=True, timeout=60)
    assert flags.returncode == 0
    for flag in ("--autoscale-interval-s", "--autoscale-min", "--autoscale-max", "--autoscale-journal",
                 "--autoscale-launch-cmd", "--autoscale-up-queue", "--autoscale-qos-budget-ms"):
        assert flag in flags.stdout, flag
