"""The port's copies of the request-trace, fault-injection and codec-pool
modules (``deconv_api_tpu_torch/serving/trace.py``, ``faults.py``,
``codec_pool.py``) against the JAX package's: the header parsers over a
table of values, the fault grammar over valid and invalid strings, the
flight recorder's queries on the same recorded traces, the worker pool's
supervision (``tests/test_supervision.py``'s pool cases) through both, and
the port's pinned-buffer ring on the CPU.  Results must be equal."""

import asyncio
import re
import time
import types

import numpy as np
import pytest
import torch

from deconv_api_tpu import errors as j_errors
from deconv_api_tpu.serving import codec_pool as j_pool
from deconv_api_tpu.serving import faults as j_faults
from deconv_api_tpu.serving import metrics as j_metrics
from deconv_api_tpu.serving import trace as j_trace
from deconv_api_tpu_torch import errors as p_errors
from deconv_api_tpu_torch.serving import codec_pool as p_pool
from deconv_api_tpu_torch.serving import faults as p_faults
from deconv_api_tpu_torch.serving import metrics as p_metrics
from deconv_api_tpu_torch.serving import trace as p_trace

IMPLS = {
    "jax": types.SimpleNamespace(errors=j_errors, faults=j_faults, pool=j_pool, Metrics=j_metrics.Metrics),
    "port": types.SimpleNamespace(errors=p_errors, faults=p_faults, pool=p_pool, Metrics=p_metrics.Metrics),
}
BOUND_S = 10.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


HEADER_VALUES = [None, "", "0", "-5", "1", "250", "0.01", "1e3", "86400000", "86400001", "abc", "nan", "inf",
                 " 12 ", "abc-123", "a" * 64, "a" * 65, "bad id!", "x\r\ny", "7:primary", "0:hedge", "12:replica",
                 "1234:primary", "3:bogus", "3:", ":primary"]


@pytest.mark.parametrize("raw", HEADER_VALUES)
def test_header_parsers_agree(raw):
    now = 1000.0
    assert p_trace.deadline_from(raw, now) == j_trace.deadline_from(raw, now)
    assert p_trace.hop_from(raw) == j_trace.hop_from(raw)
    rid_p, rid_j = p_trace.request_id_from(raw), j_trace.request_id_from(raw)
    if raw and j_trace.RID_RE.match(raw):
        assert rid_p == rid_j == raw  # honoured
    else:  # minted: the same shape, a fresh id
        assert rid_p != raw and re.fullmatch(r"[0-9a-f]{6}-[0-9a-f]{8}", rid_p)


SPECS = ["p0.5", "0.25", "n3", "n1:250", "p1:0", "p0.1@b0:8000", "n2:1@host:9", "p0", "p1.5", "n0", "n-1", "x",
         "p", "n", "0.5:abc", "n2@", "", "p0.5:1:2"]
ARMS = ["device.dispatch_error=n8", "device.dispatch_delay_ms=n1:50,http.slow_write=p0.5:20",
        "codec.worker_raise=p0.05, dispatch.worker_hang=n2:1000", "batcher.dispatch_raise=n1",
        "jobs.journal_write_error=n1", "nope.site=n1", "device.dispatch_error", "device.dispatch_error=q1", ""]


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))
    if isinstance(out, dict):
        return {k: str(v) for k, v in out.items()}
    return str(out), vars(out)


@pytest.mark.parametrize("raw", SPECS)
def test_parse_spec_agrees(raw):
    assert _outcome(p_faults.parse_spec, raw) == _outcome(j_faults.parse_spec, raw)


@pytest.mark.parametrize("raw", ARMS)
def test_parse_fault_specs_agrees(raw):
    assert _outcome(p_faults.parse_fault_specs, raw) == _outcome(j_faults.parse_fault_specs, raw)


def test_fault_registries_fire_alike():
    """The same arms on both registries (seeded RNG, one-shot counts, lane
    targets) fire on the same consultations."""
    fired = {}
    for name, mod in (("port", p_faults), ("jax", j_faults)):
        reg = mod.FaultRegistry(seed=7)
        reg.arm_string("device.dispatch_error=n3:1,codec.worker_raise=p0.3,http.slow_write=n2:40")
        seq = [reg.check("device.dispatch_error", where=w) is not None for w in (0, 1, 0, 1, 1, 1)]
        seq += [reg.check("codec.worker_raise") is not None for _ in range(20)]
        seq += [getattr(reg.check("http.slow_write"), "param", None) for _ in range(3)]
        fired[name] = (seq, reg.snapshot())
        mod.install(reg)
        assert mod.check("batcher.dispatch_raise") is None
        mod.uninstall(reg)
        assert mod.installed() is None and mod.check("device.dispatch_error", where=1) is None
    assert fired["port"] == fired["jax"]


def _recorded(mod):
    """A recorder of each package fed the same finished traces: fast and
    slow, ok and failed, two models."""
    rec = mod.FlightRecorder(4, slow_ms=50.0, sample=0.5)
    for i in range(9):
        tr = mod.RequestTrace(f"rid-{i}", "/" if i % 2 else "/v1/deconv")
        tr.t0 -= 0.1 if i % 3 == 0 else 0.0  # every third is slow
        tr.add_span("queue_wait", tr.t0, 0.002 * i, batch_id=i)
        tr.add_span("dispatch", tr.t0, 0.001)
        tr.annotate(model="vgg16" if i < 5 else "resnet50")
        tr.finish(status=500 if i == 4 else (504 if i == 7 else 200), error="x" if i in (4, 7) else None)
        tr.start_ts = 1000.0 + i  # one clock for both packages
        rec.record(tr)
    return rec


def _shape(traces):
    return [(t["id"], t["status"], t.get("model"), [s["name"] for s in t["spans"]]) for t in traces]


@pytest.mark.parametrize("query", [{}, {"slow": True}, {"error": True}, {"slow": True, "error": True},
                                   {"trace_id": "rid-3"}, {"trace_id": "rid-0"}, {"model": "resnet50"},
                                   {"error": True, "model": "vgg16"}, {"limit": 2}])
def test_flight_recorder_queries_agree(query):
    port, jax_ = _recorded(p_trace), _recorded(j_trace)
    assert _shape(port.query(**query)) == _shape(jax_.query(**query))
    assert port.counts() == jax_.counts()
    strip = re.compile(r"span_(seconds_total|max_seconds)\{[^}]*\} \S+")
    assert strip.sub("", port.prometheus()) == strip.sub("", jax_.prometheus())
    args = {"slow": "1", "limit": "9999", "id": "rid-2"}
    assert p_trace.debug_query_args(args, 4) == j_trace.debug_query_args(args, 4)


def test_assemble_timeline_agrees():
    router = {"ts": 100.0, "spans": [{"name": "ring_pick", "start_ms": 0.0, "ms": 0.1}]}
    backends = {"b:1": [{"ts": 100.002, "total_ms": 5.0, "status": 200, "route": "/", "hop": 1,
                         "spans": [{"name": "queue_wait", "start_ms": 0.5, "ms": 1.0}]}]}
    assert p_trace.assemble_timeline(router, backends) == j_trace.assemble_timeline(router, backends)


def _wait_until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.01)
    return cond()


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND_S))


def test_worker_crash_fails_only_that_task_and_respawns(impl):
    m = impl.Metrics()
    reg = impl.faults.FaultRegistry(metrics=m)
    impl.faults.install(reg)
    try:
        pool = impl.pool.WorkerPool(2, name="codec", metrics=m)
        reg.arm("codec.worker_raise", "n1")

        async def go():
            return await asyncio.gather(*(pool.run(lambda i=i: i * 10) for i in range(6)), return_exceptions=True)

        results = _run(go())
        crashes = [r for r in results if isinstance(r, impl.errors.FaultInjected)]
        assert len(crashes) == 1
        assert sorted(r for r in results if not isinstance(r, Exception)) == [
            i * 10 for i in range(6) if results[i] not in crashes]
        assert _wait_until(lambda: pool.live_workers == 2)
        assert m.labeled("worker_deaths_total") == {"codec": 1} and pool.at_quorum
        pool.close()
    finally:
        impl.faults.uninstall(reg)


def test_respawn_budget_bounds_crash_loops(impl):
    reg = impl.faults.FaultRegistry()
    impl.faults.install(reg)
    try:
        pool = impl.pool.WorkerPool(2, respawn_budget=1, respawn_window_s=60.0)
        reg.arm("codec.worker_raise", "n3")

        async def crash_all():
            out = []
            for _ in range(3):
                try:
                    await asyncio.wait_for(pool.run(lambda: 1), 5)
                except impl.errors.FaultInjected:
                    out.append("crash")
            return out

        assert _run(crash_all()) == ["crash"] * 3
        assert _wait_until(lambda: pool.live_workers == 0) and not pool.at_quorum

        async def rejected():
            with pytest.raises(impl.errors.Unavailable, match="no live workers"):
                await pool.run(lambda: 1)

        _run(rejected())
        pool.close()
    finally:
        impl.faults.uninstall(reg)


def test_capacity_self_restores_after_the_window_slides(impl):
    reg = impl.faults.FaultRegistry()
    impl.faults.install(reg)
    try:
        pool = impl.pool.WorkerPool(2, respawn_budget=2, respawn_window_s=0.2)
        reg.arm("codec.worker_raise", "n3")

        async def crash_all():
            for _ in range(3):
                try:
                    await asyncio.wait_for(pool.run(lambda: 1), 5)
                except impl.errors.FaultInjected:
                    pass

        _run(crash_all())
        assert _wait_until(lambda: pool.live_workers == 1)
        time.sleep(0.25)  # the respawn window slides past the storm
        assert _run(pool.run(lambda: "ok")) == "ok" and pool.live_workers == 2
        pool.close()
    finally:
        impl.faults.uninstall(reg)


def test_map_sync_settle_isolates_per_item_failures(impl):
    pool = impl.pool.WorkerPool(2)

    def job(i):
        if i == 2:
            raise RuntimeError("tile exploded")
        return i * 10

    out = pool.map_sync_settle(job, [0, 1, 2, 3])
    assert out[:2] == [0, 10] and out[3] == 30 and isinstance(out[2], RuntimeError)
    pool.close()
    out = pool.map_sync_settle(job, [1, 2])  # closed: inline, settled alike
    assert out[0] == 10 and isinstance(out[1], RuntimeError)


def test_host_buffer_ring_pads_like_the_batcher_and_reuses_buffers():
    from deconv_api_tpu_torch.serving.batcher import pad_to_bucket

    ring = p_pool.HostBufferRing(2)
    imgs = [np.full((3, 2, 3), i, np.float32) for i in range(3)]
    buf = ring.assemble(imgs, 4)
    assert buf.dtype == torch.float32 and np.array_equal(buf.numpy(), pad_to_bucket(np.stack(imgs), 4))
    ring.release(buf)
    assert ring.assemble(imgs[:1], 4) is buf and ring.allocations == 1
    with pytest.raises(ValueError, match="do not fit"):
        ring.assemble(imgs, 2)
    for b in [ring.acquire((4, 3, 2, 3)) for _ in range(4)]:
        ring.release(b)
    assert len(ring._free[((4, 3, 2, 3), torch.float32)]) == 2  # pageable: at most depth kept
    ring.clear()
    assert ring.acquire((4, 3, 2, 3)) is not buf
