"""The response cache, singleflight and the durable L2 tier of the port
(``deconv_api_tpu_torch/serving/cache.py``) against the JAX package's
(``deconv_api_tpu/serving/cache.py``) on the CPU: the same keys for the same
prefix and body, the same hits, misses, evictions and counters for the same
operations on the same fake clock, L2 files each package reads from the
other; then the port's served routes behind the cache (one module-scoped
vgg_tiny server): a hit byte-equal to its miss, concurrent identical
requests on one dispatched row, ``no-cache``/``no-store``, an unknown model
answered before any flight, a leader's deadline answered 503 to its
waiters, and a server with the cache and singleflight off, which sets no
``x-cache``."""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import threading
import time
import urllib.parse

import httpx
import numpy as np
import pytest
import torch

from deconv_api_tpu import errors as j_errors
from deconv_api_tpu.serving import cache as j_cache
from deconv_api_tpu.serving.http import Request as JRequest
from deconv_api_tpu.serving.metrics import Metrics as JMetrics
from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.serving import cache
from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService
from deconv_api_tpu_torch.serving.http import Request
from deconv_api_tpu_torch.serving.metrics import Metrics
from tests.test_serving import _data_url

LAYER = "block3_conv1"
PREFIX = "vgg_tiny|32|all|4|8|True|False|float32|bfloat16|off|off|f32|he-normal:seed=0|cpu|/"
URLENC = "application/x-www-form-urlencoded"


class Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _multipart(fields: dict[str, str], boundary: str = "b0und") -> bytes:
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'
             for k, v in fields.items()]
    return ("".join(parts) + f"--{boundary}--\r\n").encode()


BODIES = {
    "urlencoded": (URLENC, b"file=data%3Aimage%2Fpng%3Bbase64%2CAAAA&layer=block3_conv1"),
    "urlencoded_reordered": (URLENC, b"layer=block3_conv1&file=data%3Aimage%2Fpng%3Bbase64%2CAAAA"),
    "multipart": ("multipart/form-data; boundary=b0und", _multipart({"file": "data:image/png;base64,AAAA",
                                                                     "layer": "block3_conv1"})),
    "json": ("application/json", b'{"layer": "block3_conv1", "file": "data:image/png;base64,AAAA"}'),
    "model_and_quality_excluded": (URLENC, b"file=x&layer=block3_conv1&model=vgg_tiny&quality=full"),
    "unparseable_raw_bytes": ("application/octet-stream", b"\x00\x01not a form"),
    "broken_multipart": ("multipart/form-data", b"--x\r\nno boundary"),
    "separator_byte_inside_a_field": (URLENC, b"a=1%3A1%3Ab&c=2"),
    "separator_byte_split": (URLENC, b"a=1&b=c%3D2"),
    "empty_body": (URLENC, b""),
}


@pytest.mark.parametrize("case", sorted(BODIES))
def test_canonical_digest_matches_jax(case):
    """The same prefix and body give the same hex digest in both packages,
    from the raw body and from a live request's memoized parse, with the
    ``model`` and ``quality`` fields excluded as the services exclude
    them."""
    ctype, body = BODIES[case]
    for exclude in ((), ("model", "quality")):
        want = j_cache.canonical_digest(PREFIX, ctype, body, exclude=exclude)
        assert cache.canonical_digest(PREFIX, ctype, body, exclude=exclude) == want
        req = Request("POST", "/", {}, {"content-type": ctype}, body)
        jreq = JRequest("POST", "/", {}, {"content-type": ctype}, body)
        assert cache.canonical_digest(PREFIX, ctype, body, req=req, exclude=exclude) == \
            j_cache.canonical_digest(PREFIX, ctype, body, req=jreq, exclude=exclude) == want


def test_canonical_digest_separates_what_differs():
    keys = {cache.canonical_digest(PREFIX, *BODIES[c]) for c in ("urlencoded", "separator_byte_inside_a_field",
                                                                  "separator_byte_split", "empty_body")}
    assert len(keys) == 4
    assert cache.canonical_digest(PREFIX, *BODIES["urlencoded"]) == \
        cache.canonical_digest(PREFIX, *BODIES["multipart"]) == cache.canonical_digest(PREFIX, *BODIES["json"])
    assert cache.canonical_digest(PREFIX + "x", *BODIES["urlencoded"]) != \
        cache.canonical_digest(PREFIX, *BODIES["urlencoded"])


def _key(i: int) -> str:
    return f"{i:08x}" + "ab" * 16


def _cache_ops(mod, metrics, clock):
    """One operation sequence through ``mod.ResponseCache``: stores of 200s,
    a deterministic 422, a 503, an oversized entry, lookups across the TTLs
    and an LRU eviction; returns what each step answered."""
    c = mod.ResponseCache(4 * (mod.ENTRY_OVERHEAD + 100), ttl_s=5.0, negative_ttl_s=1.0, shards=2,
                          metrics=metrics, clock=clock)
    out = []

    def look(k):
        e = c.lookup(k)
        out.append(None if e is None else (e.status, e.body, e.negative, e.error_code,
                                           e.to_response().headers["x-cache"]))

    neg = b'{"error": "unknown_layer", "detail": "x"}'
    for i in range(4):
        out.append(c.store(_key(i), 200, bytes([i]) * 100, "application/json"))
    look(_key(0))
    out.append(c.store(_key(4), 422, neg, "application/json"))
    out.append(c.store(_key(5), 503, b"{}", "application/json"))
    out.append(c.store(_key(6), 200, b"x" * 10_000, "application/json"))
    for i in range(7):
        look(_key(i))
    clock.t += 1.5  # past the negative TTL
    look(_key(4))
    clock.t += 4.0  # past the positive TTL
    for i in range(4):
        look(_key(i))
    out.append((c.resident_bytes, c.entry_count, c.hits, c.misses))
    return out


def test_response_cache_matches_jax():
    """The same operations on the same fake clock: the same answers, the
    same counters and gauges under the same names."""
    port_metrics, jax_metrics = Metrics("deconv"), JMetrics("deconv")
    got = _cache_ops(cache, port_metrics, Clock())
    want = _cache_ops(j_cache, jax_metrics, Clock())
    assert got == want
    snap, jsnap = port_metrics.snapshot(), jax_metrics.snapshot()
    assert snap["counters"] == jsnap["counters"]
    assert {k: v for k, v in snap["gauges"].items() if k.startswith("cache_")} == \
        {k: v for k, v in jsnap["gauges"].items() if k.startswith("cache_")}
    assert {"cache_hits_total", "cache_misses_total", "cache_negative_hits_total", "cache_expired_total",
            "cache_evictions_total", "cache_stores_total"} <= set(snap["counters"])


def _flights(mod, errs):
    """A singleflight sequence: one leader and two waiters published a
    result; a failed leader's exception reaching its waiter; a waiter
    whose own deadline lapses while the flight lives on; a double finish."""

    async def run():
        sf = mod.Singleflight()
        out = []
        lead, fut = sf.begin("k1")
        w1, f1 = sf.begin("k1")
        w2, f2 = sf.begin("k1")
        out += [lead, w1, w2, f1 is fut, f2 is fut, len(sf)]
        waits = [asyncio.ensure_future(mod.Singleflight.wait(f)) for f in (f1, f2)]
        await asyncio.sleep(0)
        sf.finish("k1", "payload")
        out += [await w for w in waits] + [len(sf)]
        sf.finish("k1", "again")  # a no-op
        lead, fut = sf.begin("k2")
        _, f3 = sf.begin("k2")
        sf.finish("k2", exc=errs.Unavailable("leader failed"))
        try:
            await mod.Singleflight.wait(f3)
        except errs.Unavailable as e:
            out.append(("unavailable", str(e)))
        lead, fut = sf.begin("k3")
        _, f4 = sf.begin("k3")
        try:
            await mod.Singleflight.wait(f4, time.perf_counter() + 0.01)
        except errs.DeadlineExpired as e:
            out.append(("deadline", str(e)))
        out.append(fut.done())  # the waiter's deadline did not end the flight
        sf.finish("k3", "late")
        out.append(await mod.Singleflight.wait(fut))
        return out

    return asyncio.run(run())


def test_singleflight_matches_jax():
    assert _flights(cache, errors) == _flights(j_cache, j_errors)


def _l2_ops(mod, root, metrics):
    """Puts over a byte budget that holds two entries, reads that touch the
    LRU, a corrupt and a truncated file, a 404 that is never stored, and
    the index a rescan rebuilds."""
    framed = len(mod.durable.frame("cache.l2", 1, b"x" * 200, extra={"status": 200, "ct": "application/json"}))
    l2 = mod.L2Store(str(root), max_bytes=2 * framed + 10, metrics=metrics)
    out = []
    for i in range(3):
        out.append(l2.put(_key(i), 200, bytes([65 + i]) * 200, "application/json"))
        os.utime(os.path.join(root, _key(i) + ".l2"), (1000 + i, 1000 + i))
    out.append(l2.put(_key(9), 404, b"{}", "application/json"))
    out += [l2.get(_key(i)) for i in range(4)]
    with open(os.path.join(root, _key(1) + ".l2"), "r+b") as f:
        f.seek(-3, os.SEEK_END)
        f.write(b"zzz")
    out.append(l2.get(_key(1)))
    out.append(l2.put(_key(5), 200, b"y" * 200, "image/jpeg"))
    with open(os.path.join(root, _key(5) + ".l2"), "r+b") as f:
        f.truncate(40)
    out.append(l2.get(_key(5)))
    out.append(l2.get("not-a-key/../x"))
    l2.close()
    again = mod.L2Store(str(root), metrics=metrics)
    out.append((sorted(again._index), again.resident_bytes))
    again.close()
    return out


def test_l2_store_matches_jax(tmp_path):
    port_metrics, jax_metrics = Metrics("deconv"), JMetrics("deconv")
    got = _l2_ops(cache, tmp_path / "port", port_metrics)
    want = _l2_ops(j_cache, tmp_path / "jax", jax_metrics)
    assert got == want
    assert got[4] is None and got[6] == (200, b"C" * 200, "application/json")  # evicted, then read
    assert port_metrics.snapshot()["counters"] == jax_metrics.snapshot()["counters"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_l2_entries_read_across_the_packages(tmp_path, writer):
    """An entry one package's ``L2Store`` wrote (its async writer, flushed
    at close) reads back byte-equal in the other's (``durable.frame``)."""
    mods = {"jax": j_cache, "port": cache}
    reader = "port" if writer == "jax" else "jax"
    w = mods[writer].L2Store(str(tmp_path))
    w.put_async(_key(1), 200, b'"data:image/webp;base64,AAAA"', "application/json")
    w.put_async(_key(2), 200, b"\x00\xff" * 100, "image/jpeg")
    w.close()
    r = mods[reader].L2Store(str(tmp_path))
    assert r.get(_key(1)) == (200, b'"data:image/webp;base64,AAAA"', "application/json")
    assert r.get(_key(2)) == (200, b"\x00\xff" * 100, "image/jpeg")
    assert r.get(_key(3)) is None
    r.close()


# --- the served routes ------------------------------------------------------


class _Served:
    def __init__(self, **cfg):
        self.service = DeconvService(cfg=ServerConfig(model="vgg_tiny", max_batch=4, batch_window_ms=1.0, **cfg),
                                     device="cpu")
        self.service.start()
        self.service.warmup()
        self.server = DeconvHTTPServer(self.service, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.client = httpx.Client(timeout=60)
        runner = self.service.dispatcher._dispatch_runner
        self.rows = self.entered = 0
        self.gate = threading.Event()
        self.gate.set()

        def counted(key, images):
            self.entered += 1
            self.gate.wait(30)
            self.rows += len(images)
            return runner(key, images)

        self.service.dispatcher._dispatch_runner = counted

    def post(self, path="/", headers=None, **form):
        return self.client.post(self.url + path, data=form, headers=headers or {})

    def close(self):
        self.client.close()
        self.server.server_close()
        self.service.close()


@pytest.fixture(scope="module")
def served():
    s = _Served()
    yield s
    s.close()


def _until(cond, timeout_s=20.0):
    t_end = time.perf_counter() + timeout_s
    while not cond():
        assert time.perf_counter() < t_end
        time.sleep(0.005)


@pytest.mark.parametrize("path", ["/", "/v1/deconv"])
def test_a_hit_is_byte_equal_to_its_miss(served, path):
    """A repeated request is answered from the cache (``x-cache: hit``),
    byte for byte, with no device row; field order and the default
    model's explicit name do not change the key."""
    uri = _data_url(11 if path == "/" else 12, size=32)
    rows = served.rows
    miss = served.post(path, file=uri, layer=LAYER)
    assert miss.status_code == 200 and miss.headers["x-cache"] == "miss"
    assert served.rows == rows + 1
    hits = [served.post(path, file=uri, layer=LAYER),
            served.post(path, layer=LAYER, file=uri, model="vgg_tiny"),
            served.post(path, file=uri, layer=LAYER, headers={"x-model": "vgg_tiny"})]
    assert [h.headers["x-cache"] for h in hits] == ["hit"] * 3
    assert all(h.content == miss.content for h in hits)
    assert len({h.headers["x-request-id"] for h in hits + [miss]}) == 4
    assert served.rows == rows + 1


def test_concurrent_identical_requests_share_one_row(served):
    """N identical requests in flight: one dispatched row, one ``miss``,
    N-1 ``coalesced``, every answer byte-equal with its own request id."""
    n = 8
    uri = _data_url(21, size=32)
    coalesced = served.service.metrics.counter("cache_coalesced_total")
    rows = served.rows
    served.gate.clear()
    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        futs = [pool.submit(served.post, file=uri, layer=LAYER, headers={"x-request-id": f"same-{i}"})
                for i in range(n)]
        _until(lambda: served.service.metrics.counter("cache_coalesced_total") >= coalesced + n - 1)
        served.gate.set()
        answers = [f.result() for f in futs]
    assert [a.status_code for a in answers] == [200] * n
    assert sorted(a.headers["x-cache"] for a in answers) == ["coalesced"] * (n - 1) + ["miss"]
    assert len({a.content for a in answers}) == 1
    assert [a.headers["x-request-id"] for a in answers] == [f"same-{i}" for i in range(n)]
    assert served.rows == rows + 1


def test_no_cache_recomputes_and_no_store_leaves_the_entry(served):
    uri = _data_url(31, size=32)
    first = served.post(file=uri, layer=LAYER)
    key = served.service._request_key(
        Request("POST", "/", {}, {"content-type": URLENC},
                urllib.parse.urlencode({"file": uri, "layer": LAYER}).encode()), "/")
    entry = served.service.cache.peek(key)
    assert entry is not None and entry.body == first.content
    rows = served.rows
    again = served.post(file=uri, layer=LAYER, headers={"cache-control": "no-cache"})
    assert again.status_code == 200 and again.headers["x-cache"] == "bypass" and served.rows == rows + 1
    assert served.service.cache.peek(key) is not entry  # refreshed
    entry = served.service.cache.peek(key)
    kept = served.post(file=uri, layer=LAYER, headers={"cache-control": "no-cache, no-store"})
    assert kept.headers["x-cache"] == "bypass" and served.rows == rows + 2
    assert served.service.cache.peek(key) is entry
    assert served.post(file=uri, layer=LAYER).headers["x-cache"] == "hit"


def test_deterministic_4xx_is_negative_cached_and_unknown_model_precedes_any_flight(served):
    uri = _data_url(41, size=32)
    misses = served.service.metrics.counter("cache_misses_total")
    first = served.post(file=uri, layer="no_such_layer")
    assert first.status_code == 422 and first.json()["error"] == "unknown_layer"
    assert first.headers["x-cache"] == "miss"
    again = served.post(file=uri, layer="no_such_layer")
    assert again.status_code == 422 and again.headers["x-cache"] == "hit-negative" and again.content == first.content
    misses = served.service.metrics.counter("cache_misses_total")
    rows = served.rows
    bad = served.post(file=uri, layer=LAYER, model="vgg16")
    assert bad.status_code == 422 and bad.json()["error"] == "unknown_model"
    assert "x-cache" not in bad.headers and len(served.service.flights) == 0
    assert served.service.metrics.counter("cache_misses_total") == misses and served.rows == rows


def test_a_leaders_deadline_answers_its_waiters_503(served):
    """The leader queues behind a held batch until its own ``x-deadline-ms``
    lapses (504); its waiters, with no deadline, get a retryable 503
    ``unavailable``, and the key's flight is gone."""
    blocker, uri = _data_url(51, size=32), _data_url(52, size=32)
    coalesced = served.service.metrics.counter("cache_coalesced_total")
    served.gate.clear()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        entered = served.entered
        held = pool.submit(served.post, file=blocker, layer=LAYER)
        _until(lambda: served.entered == entered + 1)  # its batch holds the dispatch worker
        leader = pool.submit(served.post, file=uri, layer=LAYER, headers={"x-deadline-ms": "600"})
        _until(lambda: len(served.service.flights) == 2)
        waiters = [pool.submit(served.post, file=uri, layer=LAYER) for _ in range(2)]
        _until(lambda: served.service.metrics.counter("cache_coalesced_total") == coalesced + 2)
        time.sleep(0.7)  # the leader's deadline lapses in the queue
        served.gate.set()
        assert held.result().status_code == 200
        assert leader.result().status_code == 504 and leader.result().json()["error"] == "deadline_expired"
        for w in waiters:
            r = w.result()
            assert r.status_code == 503 and r.json()["error"] == "unavailable"
            assert r.headers["x-cache"] == "coalesced"
    assert len(served.service.flights) == 0
    assert served.post(file=uri, layer=LAYER).status_code == 200


def test_cache_and_singleflight_off_are_inert():
    s = _Served(cache_bytes=0, singleflight=False)
    try:
        assert s.service.cache is None and s.service.flights is None and s.service.l2 is None
        uri = _data_url(61, size=32)
        answers = [s.post(file=uri, layer=LAYER) for _ in range(2)]
        assert [a.status_code for a in answers] == [200, 200]
        assert all("x-cache" not in a.headers for a in answers) and s.rows == 2
        cfg = s.client.get(s.url + "/v1/config").json()
        assert (cfg["cache_active"], cfg["singleflight_active"], cfg["cache_bytes"]) == (False, False, 0)
    finally:
        s.close()


def test_l2_answers_a_fresh_server_without_compute(tmp_path):
    """One server writes its answers through to ``l2_dir``; a fresh server
    on the same directory answers ``x-cache: l2``, byte-equal, with no
    device row, and then from its memory tier."""
    uri = _data_url(71, size=32)
    first = _Served(l2_dir=str(tmp_path))
    try:
        miss = first.post(file=uri, layer=LAYER)
        assert miss.headers["x-cache"] == "miss"
    finally:
        first.close()  # flushes the L2 writer
    second = _Served(l2_dir=str(tmp_path))
    try:
        got = second.post(file=uri, layer=LAYER)
        assert got.status_code == 200 and got.headers["x-cache"] == "l2" and got.content == miss.content
        assert second.rows == 0
        assert second.post(file=uri, layer=LAYER).headers["x-cache"] == "hit"
        assert second.service.metrics.counter("cache_l2_hits_total") == 1
    finally:
        second.close()
    assert np.all([f.endswith(".l2") for f in os.listdir(tmp_path)])
