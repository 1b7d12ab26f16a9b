"""The fleet tier (``deconv_api_tpu_torch/serving/fleet.py``, the backends'
half in ``serving/app.py`` and the ``serve`` drain) against the JAX
package's router.

The port's ``HashRing`` places 2000 seeded keys as JAX's does over member
sets with capacities 1-3, before and after a member joins and one leaves.
The port's and the JAX ``FleetRouter`` over the same two raw stubs route
32 seeded form posts to the same backends, answer an empty ring with the
same 502 body and ``Retry-After`` and carry the same ``/v1/config`` keys.
Two vgg_tiny backends on the CPU behind the port's router: registration
(a wrong token refused), an answer byte-equal to the owner's own, one
logical cache, a job that stays on its backend, and a drain announcement
after which the drained backend's keys fill from its cache.  A hedge
loser's pooled socket is destroyed.  ``fleet-router`` loads no torch.  A
``serve`` process sent SIGTERM answers ``/readyz`` 503 through its grace,
parks its running job and exits 0; ``reuse_port`` lets two listeners
share a port.

Every stub handler here returns when its client closes (it reads to EOF):
a stub that sleeps would hold ``wait_closed`` for as long as it sleeps."""

import asyncio
import json
import os
import pathlib
import random
import signal
import socket
import subprocess
import sys
import threading
import time

import cv2
import httpx
import numpy as np
import pytest
import torch

from deconv_api_tpu.serving import fleet as j_fleet
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.serving import fleet
from deconv_api_tpu_torch.serving.app import DeconvService
from deconv_api_tpu_torch.serving.http import HttpServer
from deconv_api_tpu_torch.serving.jobs import JobJournal
from tests.test_torch_pipeline_serving import _Port

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYER = "block3_conv1"
TOKEN = "fleet-secret"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _keys(n: int, seed: int = 0) -> list[str]:
    rng = random.Random(seed)
    return [f"{rng.getrandbits(256):064x}" for _ in range(n)]


def _uri(seed: int) -> str:
    img = np.random.default_rng(seed).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    import base64

    return "data:image/png;base64," + base64.b64encode(buf.tobytes()).decode()


# ------------------------------------------------------------------- ring

MEMBERS = {"a.host:8001": 1, "b.host:8002": 2, "c.host:8003": 3, "d.host:8004": 1}
RING_CASES = {
    "base": (MEMBERS, None),
    "joined": ({**MEMBERS, "e.host:8005": 2}, None),
    "left": ({k: v for k, v in MEMBERS.items() if k != "b.host:8002"}, None),
    "uniform": ({k: 1 for k in MEMBERS}, None),
    "vnodes16": (MEMBERS, 16),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_places_every_key_as_the_jax_ring(case):
    members, vnodes = RING_CASES[case]
    kw = {"vnodes": vnodes} if vnodes else {}
    ours = fleet.HashRing(members, capacities=members, **kw)
    theirs = j_fleet.HashRing(members, capacities=members, **kw)
    assert ours.members == theirs.members and len(ours) == len(theirs)
    keys = _keys(2000, seed=len(case))
    assert [ours.owner(k) for k in keys] == [theirs.owner(k) for k in keys]
    assert [ours.owners(k) for k in keys] == [theirs.owners(k) for k in keys]
    assert fleet.HashRing((), capacities={}).owner(keys[0]) is None


# ---------------------------------------------------------------- routing


async def _read_request(reader):
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head[:-4].decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length") or 0)
    body = await reader.readexactly(n) if n else b""
    return lines[0].split(" ")[:2], headers, body


def _stub_handler(name: str):
    """A keep-alive stub backend: ``/readyz`` 200, anything else 200 with
    its name; it returns at its client's EOF."""

    async def handle(reader, writer):
        try:
            while True:
                (_method, target), _headers, _body = await _read_request(reader)
                payload = b'{"ready": true}' if target == "/readyz" else json.dumps({"stub": name}).encode()
                writer.write(b"HTTP/1.1 200 OK\r\ncontent-type: application/json\r\n"
                             b"content-length: %d\r\n\r\n" % len(payload) + payload)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    return handle


async def _raw(port: int, method: str, target: str, headers: dict, body: bytes = b""):
    return await fleet.raw_request("127.0.0.1", port, method, target, headers, body, 10.0)


def test_the_port_router_routes_as_the_jax_router():
    async def go():
        stubs = []
        for i in range(2):
            srv = await asyncio.start_server(_stub_handler(f"s{i}"), "127.0.0.1", 0)
            stubs.append(srv)
        names = [f"127.0.0.1:{s.sockets[0].getsockname()[1]}" for s in stubs]
        routers = [mod.FleetRouter(names, probe_interval_s=60.0) for mod in (fleet, j_fleet)]
        # a ring no backend ever joins: every member's port refuses
        dead = []
        for _ in range(2):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                dead.append(f"127.0.0.1:{s.getsockname()[1]}")
        empty = [mod.FleetRouter(dead, probe_interval_s=60.0, cooldown_s=7.0) for mod in (fleet, j_fleet)]
        ports = [await r.start("127.0.0.1", 0) for r in routers + empty]
        try:
            rng = np.random.default_rng(5)
            seqs = []
            for port in ports[:2]:
                seq = []
                for i in range(32):
                    form = f"layer=block{1 + i % 3}_conv1&file=data%3A{rng.bytes(12).hex()}&n={i}".encode()
                    status, headers, body = await _raw(
                        port, "POST", "/", {"content-type": "application/x-www-form-urlencoded"}, form)
                    assert status == 200
                    assert json.loads(body)["stub"] == f"s{names.index(headers['x-backend'])}"
                    seq.append(headers["x-backend"])
                seqs.append(seq)
                rng = np.random.default_rng(5)
            assert seqs[0] == seqs[1] and len(set(seqs[0])) == 2
            answers = [await _raw(port, "POST", "/", {"x-request-id": "rid-empty-1"}, b"layer=x")
                       for port in ports[2:]]
            (s0, h0, b0), (s1, h1, b1) = answers
            assert (s0, h0["retry-after"], json.loads(b0)) == (s1, h1["retry-after"], json.loads(b1))
            assert s0 == 502 and json.loads(b0)["error"] == "backend_unavailable" and h0["retry-after"] == "7"
            configs = [json.loads((await _raw(port, "GET", "/v1/config", {}))[2]) for port in ports[:2]]
            assert set(configs[0]) == set(configs[1])
            assert set(configs[0]["tail_tolerance"]) == set(configs[1]["tail_tolerance"])
            member = names[0]
            assert set(configs[0]["members"][member]) == set(configs[1]["members"][member])
            # the policy values too (the live latency windows and counts aside)
            live = ("bound_port", "trace_counts", "members", "tail_tolerance")
            assert {k: v for k, v in configs[0].items() if k not in live} == \
                {k: v for k, v in configs[1].items() if k not in live}
        finally:
            for r in routers + empty:
                await r.stop(grace_s=1.0)
            for s in stubs:
                s.close()
                await s.wait_closed()

    asyncio.run(asyncio.wait_for(go(), 30))


def test_autoscale_other_than_off_is_refused():
    """Only off, advisory and enforce are modes: another is refused, and
    advisory and enforce embed the controller (off constructs none)."""
    with pytest.raises(ValueError, match="expected off"):
        fleet.FleetRouter(["127.0.0.1:1"], autoscale="sometimes")
    assert fleet.FleetRouter(["127.0.0.1:1"]).autoscaler is None
    for mode in ("advisory", "enforce"):
        router = fleet.FleetRouter(["127.0.0.1:1"], autoscale=mode)
        assert router.autoscaler.mode == mode and router.autoscaler.router is router


# ------------------------------------------------------------------- pool


def test_a_hedge_losers_pooled_socket_is_destroyed():
    async def go():
        eof = asyncio.Event()

        async def never_answers(reader, writer):
            try:
                await _read_request(reader)
                await reader.read()  # returns at the client's close
                eof.set()
            except (asyncio.IncompleteReadError, ConnectionError):
                eof.set()
            finally:
                writer.close()

        srv = await asyncio.start_server(never_answers, "127.0.0.1", 0)
        pool = fleet.BackendPool("stub", "127.0.0.1", srv.sockets[0].getsockname()[1])
        try:
            task = asyncio.create_task(pool.request("GET", "/", {}, b"", 20.0))
            while pool.in_use == 0:
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.05)
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            assert pool.in_use == 0 and len(pool._idle) == 0
            await asyncio.wait_for(eof.wait(), 5)  # the stub saw the socket close
        finally:
            pool.flush()
            srv.close()
            await srv.wait_closed()

    asyncio.run(asyncio.wait_for(go(), 30))


# ------------------------------------------------------------- end to end


class _LoopThread:
    """An event loop on a thread of its own, for a router beside the
    backends' loops."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 30.0):
        return asyncio.run_coroutine_threadsafe(asyncio.wait_for(coro, timeout), self.loop).result(timeout + 5)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


def _until(pred, timeout_s: float = 20.0, what: str = ""):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def _metric(url: str, family: str) -> float:
    for line in httpx.get(url + "/metrics", timeout=30).text.splitlines():
        if line.startswith(family + " "):
            return float(line.split()[1])
    return 0.0


@pytest.fixture(scope="module")
def fleet2(tmp_path_factory):
    """Two vgg_tiny backends behind a router that neither hedges nor marks
    a member slow: a hedge's duplicate computes its key on the other
    backend too (the loser's answer lands in that backend's cache), so a
    CPU under load, where a miss outlasts the 30 ms hedge floor, would
    put the same key in both caches and break what these tests pin, that
    a key lives on its ring owner.  Hedging has tests of its own."""
    lt = _LoopThread()
    router = fleet.FleetRouter(fleet_token=TOKEN, probe_interval_s=0.2, cooldown_s=1.0, tail_tolerance=False)
    rport = lt.run(router.start("127.0.0.1", 0))
    backends = []
    try:
        for i in range(2):
            cfg = ServerConfig(model="vgg_tiny", max_batch=4, batch_window_ms=1.0, warmup_all_buckets=False,
                               warmup_dream=False, fleet_peer_fill=True, fleet_routers=f"127.0.0.1:{rport}",
                               fleet_token=TOKEN, jobs_dir=str(tmp_path_factory.mktemp(f"jobs{i}")))
            b = _Port(DeconvService(cfg=cfg, device="cpu"))
            b.service.cfg.fleet_advertise = f"127.0.0.1:{b.server.server_address[1]}"
            backends.append(b)
        yield lt, router, f"http://127.0.0.1:{rport}", backends
    finally:
        for b in backends:
            b.service.cfg.fleet_routers = ""  # no announcement to a router already gone
            b.close()
        lt.run(router.stop(grace_s=1.0))
        lt.close()


def _registered(fleet2):
    """Both backends announced and admitted (each test may run alone)."""
    _lt, _router, url, backends = fleet2
    for b in backends:
        if not b.service.draining:
            assert b.service.on_loop(b.service.announce_to_routers("register")) == 1
    _until(lambda: httpx.get(url + "/readyz", timeout=30).json()["backends"].get("healthy") == 2, what="admission")


def _post(url: str, seed: int, **headers):
    return httpx.post(url, data={"file": _uri(seed), "layer": LAYER}, headers=headers, timeout=60)


def test_backends_register_and_the_router_is_one_cache(fleet2):
    lt, router, url, backends = fleet2
    names = {b.service.cfg.fleet_advertise: b for b in backends}
    # a wrong token is refused, and the backend's announcement then acks nothing
    bad = httpx.post(url + "/v1/internal/register", data={"backend": "127.0.0.1:9", "action": "register"},
                     headers={"x-fleet-token": "wrong"}, timeout=30)
    assert bad.status_code == 403 and bad.json()["error"] == "bad_fleet_token"
    good_token = backends[0].service.cfg.fleet_token
    backends[0].service.cfg.fleet_token = "wrong"
    assert backends[0].service.on_loop(backends[0].service.announce_to_routers("register")) == 0
    backends[0].service.cfg.fleet_token = good_token
    assert "127.0.0.1:9" not in router.members and backends[0].service.cfg.fleet_advertise not in router.members
    _registered(fleet2)
    assert {n: m.capacity for n, m in router.members.items()} == {n: 1 for n in names}

    misses0 = sum(b.service.metrics.counter("cache_misses_total") for b in backends)
    owners = {}
    for seed in range(6):
        r = _post(url, seed)
        assert r.status_code == 200 and r.headers["x-cache"] == "miss", r.text
        owners[seed] = r.headers["x-backend"]
        # the owner's own answer to the same post is the same bytes
        direct = _post(names[owners[seed]].base_url, seed)
        assert direct.headers["x-cache"] == "hit" and direct.content == r.content
    assert len(set(owners.values())) == 2
    for seed in range(6):
        r = _post(url, seed)
        assert (r.headers["x-cache"], r.headers["x-backend"]) == ("hit", owners[seed])
    assert sum(b.service.metrics.counter("cache_misses_total") for b in backends) - misses0 == 6


def test_a_job_submitted_through_the_router_stays_on_its_backend(fleet2):
    _lt, _router, url, backends = fleet2
    _registered(fleet2)
    sub = httpx.post(url + "/v1/jobs", data={"type": "deconv", "layer": LAYER, "file": _uri(40)}, timeout=60)
    assert sub.status_code == 202, sub.text
    owner, job = sub.headers["x-backend"], sub.json()["id"]
    deadline = time.monotonic() + 30
    while True:
        poll = httpx.get(url + f"/v1/jobs/{job}", timeout=30)
        assert poll.status_code == 200 and poll.headers["x-backend"] == owner
        if poll.json()["state"] == "done":
            break
        assert time.monotonic() < deadline, poll.json()
        time.sleep(0.05)
    result = httpx.get(url + f"/v1/jobs/{job}/result", timeout=30)
    assert result.status_code == 200 and result.headers["x-backend"] == owner
    listing = httpx.get(url + "/v1/jobs", timeout=30).json()
    assert [j["backend"] for j in listing["jobs"] if j["id"] == job] == [owner] and listing["backends"] == 2


def test_a_drained_backends_keys_fill_from_its_cache(fleet2):
    """Runs last in the module: backend 0 drains."""
    _lt, router, url, backends = fleet2
    _registered(fleet2)
    gone, stays = backends
    gone_name = gone.service.cfg.fleet_advertise
    mine = []
    for seed in range(100, 116):
        r = _post(url, seed)
        assert r.status_code == 200
        if r.headers["x-backend"] == gone_name:
            mine.append((seed, r.content))
    assert mine
    # the SIGTERM order: /readyz 503 first, then the announcement, which
    # names the grace its listener stays up
    gone.service.begin_drain()
    gone.service.cfg.drain_grace_s = 30.0
    assert gone.service.on_loop(gone.service.announce_to_routers("drain")) == 1
    assert router.members[gone_name].state == "draining"  # at once, by the announcement
    fills0 = stays.service.metrics.counter("cache_peer_fills_total")
    for seed, body in mine:
        r = _post(url, seed)
        assert (r.status_code, r.headers["x-cache"], r.headers["x-backend"]) == (200, "peer-fill",
                                                                              stays.service.cfg.fleet_advertise)
        assert r.content == body
        again = _post(url, seed)
        assert (again.headers["x-cache"], again.content) == ("hit", body)
    assert stays.service.metrics.counter("cache_peer_fills_total") - fills0 == len(mine)
    gone.service.cfg.drain_grace_s = 0.0


def test_a_default_server_has_no_fleet_surface():
    b = _Port(DeconvService(cfg=ServerConfig(model="vgg_tiny", warmup_all_buckets=False, warmup_dream=False),
                            device="cpu"))
    try:
        assert httpx.get(b.base_url + "/v1/internal/cache/" + "ab" * 16, timeout=30).status_code == 404
        r = _post(b.base_url, 3, **{"x-peer-fill": "127.0.0.1:9"})
        assert r.status_code == 200 and r.headers["x-cache"] == "miss"
        assert b.service.metrics.counter("cache_peer_fill_misses_total") == 0
        cfg = httpx.get(b.base_url + "/v1/config", timeout=30).json()
        assert (cfg["fleet_peer_fill"], cfg["fleet_routers"], cfg["fleet_token"], cfg["fleet_capacity"]) == \
            (False, "", "", 0)
        assert b.service.on_loop(b.service.announce_to_routers("register")) == 0
    finally:
        b.close()


# ------------------------------------------------------- the router's CLI


def _python(code: str, timeout: float = 60.0, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout, **kw)


def test_the_router_loads_no_torch():
    code = (
        "import asyncio, runpy, sys\n"
        "sys.argv = ['x', 'fleet-router', '--fleet-token', 't', '--autoscale', 'enforce', '--workers', '2']\n"
        "try:\n"
        "    runpy.run_module('deconv_api_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('exit', e.code)\n"
        "from deconv_api_tpu_torch.serving.fleet import FleetRouter\n"
        "async def go():\n"
        "    r = FleetRouter(fleet_token='t', autoscale='advisory')\n"
        "    await r.start('127.0.0.1', 0)\n"
        "    await r.stop(grace_s=0.5)\n"
        "asyncio.run(go())\n"
        "print('torch' in sys.modules, 'jax' in sys.modules)\n"
    )
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["exit 2", "False False"], out.stdout + out.stderr
    assert "--autoscale requires --workers 1" in out.stderr


# ------------------------------------------------------------- the repairs


def test_reuse_port_lets_two_listeners_share_a_port():
    async def go():
        a, b, c = HttpServer(), HttpServer(), HttpServer()
        port = await a.start("127.0.0.1", 0, reuse_port=True)
        try:
            assert await b.start("127.0.0.1", port, reuse_port=True) == port
            with pytest.raises(OSError):
                await c.start("127.0.0.1", port)
        finally:
            await a.stop(0.5)
            await b.stop(0.5)

    asyncio.run(asyncio.wait_for(go(), 30))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sigterm_drains_the_server(tmp_path):
    """``serve`` sent SIGTERM: /readyz 503 through the grace, the running
    job parked in the journal, exit 0."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(DECONV_WARMUP_ALL_BUCKETS="0", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deconv_api_tpu_torch", "serve", "--model", "vgg_tiny", "--device", "cpu",
         "--port", str(port), "--drain-grace-s", "1", "--jobs-dir", str(tmp_path), "--jobs-workers", "1",
         "--no-warmup-dream", "--fault", "device.dispatch_delay_ms=p1:150"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        def ready():
            try:
                return httpx.get(url + "/readyz", timeout=5).status_code == 200
            except httpx.HTTPError:
                assert proc.poll() is None, proc.stderr.read()
                return False

        _until(ready, 120.0, "boot")
        job = httpx.post(url + "/v1/jobs", data={"type": "dream", "steps": "2", "octaves": "4", "file": _uri(9)},
                         timeout=30).json()["id"]
        _until(lambda: httpx.get(url + f"/v1/jobs/{job}", timeout=30).json()["checkpoints"] >= 2, 60.0, "running")
        proc.send_signal(signal.SIGTERM)
        t0 = time.monotonic()
        statuses = []
        while time.monotonic() - t0 < 0.8:
            statuses.append(httpx.get(url + "/readyz", timeout=5).status_code)
            time.sleep(0.1)
        assert statuses and set(statuses) == {503}, statuses
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    records, torn = JobJournal.replay(str(tmp_path / "journal.jsonl"))
    states = [r["state"] for r in records if r.get("job") == job and r.get("rec") == "state"]
    assert torn == 0 and states == ["running", "parked"], states
