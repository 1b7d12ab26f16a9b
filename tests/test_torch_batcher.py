"""The port's ``BatchingDispatcher`` and ``CircuitBreaker``
(``deconv_api_tpu_torch/serving/batcher.py``) against the JAX package's
(``deconv_api_tpu/serving/batcher.py``): every scenario of
``tests/test_batcher_pipeline.py`` and of the batcher half of
``tests/test_supervision.py`` runs through both with the same fake
runners, and each asserts the same outcome on both.  No device work: the
runners return strings."""

import asyncio
import threading
import time
import types

import numpy as np
import pytest
import torch

from deconv_api_tpu import errors as j_errors
from deconv_api_tpu.serving import batcher as j_batcher
from deconv_api_tpu.serving import faults as j_faults
from deconv_api_tpu.serving import metrics as j_metrics
from deconv_api_tpu_torch import errors as p_errors
from deconv_api_tpu_torch.serving import batcher as p_batcher
from deconv_api_tpu_torch.serving import faults as p_faults
from deconv_api_tpu_torch.serving import metrics as p_metrics

IMPLS = {
    "jax": types.SimpleNamespace(batcher=j_batcher, errors=j_errors, faults=j_faults, Metrics=j_metrics.Metrics),
    "port": types.SimpleNamespace(batcher=p_batcher, errors=p_errors, faults=p_faults, Metrics=p_metrics.Metrics),
}
BOUND_S = 10.0  # every scenario's event loop is bounded by this


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _img():
    return np.zeros((2, 2, 3), np.float32)


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND_S))


def _pipelined(impl, dispatch, **kw):
    kw = {"pipeline_depth": 2, "max_batch": 1, "window_ms": 1.0, **kw}
    return impl.batcher.BatchingDispatcher(lambda k, i: [None], dispatch_runner=dispatch, **kw)


def test_fetch_overlaps_next_dispatch(impl):
    """At depth 2 batch b dispatches and resolves while batch a's fetch is
    still blocked."""
    events, gate = [], threading.Event()

    def dispatch(key, images):
        events.append(("dispatch", key))

        def thunk():
            if key == "a":
                gate.wait(5)
            events.append(("fetched", key))
            return [f"{key}-res"] * len(images)

        return thunk

    async def go():
        d = _pipelined(impl, dispatch)
        await d.start()
        fa = asyncio.create_task(d.submit(_img(), "a"))
        await asyncio.sleep(0.1)
        rb = await d.submit(_img(), "b")
        overlapped = ("fetched", "a") not in events
        gate.set()
        ra = await fa
        await d.stop()
        return rb, ra, overlapped

    assert _run(go()) == ("b-res", "a-res", True)


def test_pipeline_depth_bounds_inflight(impl):
    dispatched, gate = [], threading.Event()

    def dispatch(key, images):
        dispatched.append(key)
        return lambda: (gate.wait(5), ["ok"] * len(images))[1]

    async def go():
        d = _pipelined(impl, dispatch)
        await d.start()
        futs = [asyncio.create_task(d.submit(_img(), k)) for k in "abc"]
        await asyncio.sleep(0.3)
        held = sorted(dispatched)  # c waits for a permit
        gate.set()
        out = await asyncio.gather(*futs)
        await d.stop()
        return held, out

    assert _run(go()) == (["a", "b"], ["ok", "ok", "ok"])


@pytest.mark.parametrize("where", ["fetch", "dispatch"])
def test_error_propagates_and_pipeline_recovers(impl, where):
    def dispatch(key, images):
        if where == "dispatch" and key == "bad":
            raise RuntimeError("exploded")

        def thunk():
            if key == "bad":
                raise RuntimeError("exploded")
            return ["ok"] * len(images)

        return thunk

    async def go():
        d = _pipelined(impl, dispatch)
        await d.start()
        with pytest.raises(RuntimeError, match="exploded"):
            await d.submit(_img(), "bad")
        good = await d.submit(_img(), "good")  # the permit was not leaked
        inflight = d._inflight
        await d.stop()
        return good, inflight

    assert _run(go()) == ("ok", 0)


def test_stop_drains_inflight_fetches(impl):
    release = threading.Event()

    def dispatch(key, images):
        return lambda: (release.wait(5), ["done"] * len(images))[1]

    async def go():
        d = _pipelined(impl, dispatch)
        await d.start()
        fut = asyncio.create_task(d.submit(_img(), "x"))
        await asyncio.sleep(0.1)
        release.set()
        await d.stop()
        return await fut

    assert _run(go()) == "done"


def test_stop_fails_queued_items_fast(impl):
    release = threading.Event()

    def dispatch(key, images):
        return lambda: (release.wait(5), ["ok"] * len(images))[1]

    async def go():
        d = _pipelined(impl, dispatch, request_timeout_s=30.0)
        await d.start()
        futs = [asyncio.create_task(d.submit(_img(), f"k{i}")) for i in range(6)]
        await asyncio.sleep(0.2)
        release.set()
        stop = asyncio.create_task(d.stop())
        t0 = time.monotonic()
        results = await asyncio.gather(*futs, return_exceptions=True)
        await stop
        ok = sum(r == "ok" for r in results)
        failed = sum(isinstance(r, impl.errors.Unavailable) for r in results)
        return ok + failed, failed > 0, time.monotonic() - t0 < 5

    assert _run(go()) == (6, True, True)


def test_stop_grace_bounds_a_wedged_fetch(impl):
    wedge = threading.Event()

    def dispatch(key, images):
        return lambda: (wedge.wait(30), ["late"] * len(images))[1]

    async def go():
        d = _pipelined(impl, dispatch)
        await d.start()
        fut = asyncio.create_task(d.submit(_img(), "a"))
        await asyncio.sleep(0.1)
        t0 = time.perf_counter()
        await d.stop(grace_s=0.3)
        bounded = time.perf_counter() - t0 < 3.0
        with pytest.raises(impl.errors.Unavailable):
            await fut
        wedge.set()
        await asyncio.sleep(0.05)  # the woken fetch thread posts to a live loop
        return bounded

    assert _run(go()) is True


def test_depth_one_runs_serially(impl):
    used = []

    def runner(key, images):
        used.append("serial")
        return ["s"] * len(images)

    def dispatch(key, images):
        used.append("pipelined")
        return lambda: ["p"] * len(images)

    async def go():
        d = impl.batcher.BatchingDispatcher(runner, dispatch_runner=dispatch, pipeline_depth=1, max_batch=4,
                                            window_ms=1.0)
        await d.start()
        out = await d.submit(_img(), "k")
        await d.stop()
        return out

    assert (_run(go()), used) == ("s", ["serial"])


def test_mixed_keys_share_one_window(impl):
    def dispatch(key, images):
        return lambda: (time.sleep(0.02), [f"{key}:{i}" for i in range(len(images))])[1]

    async def go():
        d = _pipelined(impl, dispatch, max_batch=8, window_ms=30.0)
        await d.start()
        res = await asyncio.gather(*(d.submit(_img(), k) for k in ("a", "b", "a", "b", "a")))
        await d.stop()
        return res

    assert _run(go()) == ["a:0", "b:0", "a:1", "b:1", "a:2"]


def test_cadence_ignores_idle_gaps(impl):
    m = impl.Metrics()

    def dispatch(key, images):
        return lambda: (time.sleep(0.01), ["ok"] * len(images))[1]

    async def go():
        d = _pipelined(impl, dispatch, metrics=m)
        await d.start()
        await asyncio.gather(*(d.submit(_img(), f"a{i}") for i in range(4)))
        await asyncio.sleep(0.5)  # idle gap
        await asyncio.gather(*(d.submit(_img(), f"b{i}") for i in range(4)))
        await d.stop()

    _run(go())
    assert 0.0 < m.cadence_p50() < 0.25


def test_expired_deadline_is_never_dispatched(impl):
    gate, seen, m = threading.Event(), [], impl.Metrics()

    def runner(key, images):
        seen.append(key)
        if key == "slow":
            gate.wait(5)
        return ["ok"] * len(images)

    async def go():
        d = impl.batcher.BatchingDispatcher(runner, max_batch=1, window_ms=0, pipeline_depth=1,
                                            request_timeout_s=30.0, metrics=m)
        await d.start()
        slow = asyncio.create_task(d.submit(_img(), "slow"))
        await asyncio.sleep(0.15)
        with pytest.raises(impl.errors.DeadlineExpired):
            await d.submit(_img(), "doomed", deadline=time.perf_counter() + 0.05)
        gate.set()
        out = await slow
        await asyncio.sleep(0.1)
        await d.stop()
        return out

    assert (_run(go()), "doomed" in seen) == ("ok", False)
    assert m.counter("deadline_expired_total") >= 1


def test_expired_deadline_is_rejected_at_submit(impl):
    async def go():
        d = impl.batcher.BatchingDispatcher(lambda k, i: ["ok"], max_batch=1, window_ms=0, pipeline_depth=1)
        await d.start()
        t0 = time.perf_counter()
        with pytest.raises(impl.errors.DeadlineExpired) as ei:
            await d.submit(_img(), "k", deadline=time.perf_counter() - 1.0)
        await d.stop()
        return (ei.value.status, ei.value.code), time.perf_counter() - t0 < 0.5

    assert _run(go()) == ((504, "deadline_expired"), True)


def test_dispatcher_sheds_when_the_drain_estimate_exceeds_the_timeout(impl):
    metrics = impl.Metrics()
    for _ in range(8):
        metrics.observe_batch(size=1, compute_s=0.5, queue_s=0.0)

    def slow_runner(_key, images):
        time.sleep(0.25)
        return [0] * len(images)

    async def go():
        d = impl.batcher.BatchingDispatcher(slow_runner, max_batch=1, window_ms=0.0, request_timeout_s=0.4,
                                            metrics=metrics)
        await d.start()
        results = await asyncio.gather(*(d.submit(i, "k") for i in range(8)), return_exceptions=True)
        await d.stop()
        return results

    results = _run(go())
    shed = [r for r in results if isinstance(r, impl.errors.Overloaded)]
    assert shed and all(r.retry_after_s > 0 for r in shed)
    assert (shed[0].status, shed[0].code) == (503, "overloaded")
    assert not isinstance(results[0], impl.errors.Overloaded)  # an empty queue never sheds
    assert all(isinstance(r, (int, impl.errors.Overloaded, impl.errors.RequestTimeout)) for r in results)


def test_dispatcher_does_not_shed_cold(impl):
    async def go():
        d = impl.batcher.BatchingDispatcher(lambda _k, imgs: [1] * len(imgs), max_batch=2, window_ms=1.0,
                                            request_timeout_s=5.0, metrics=impl.Metrics())
        await d.start()
        out = await asyncio.gather(*(d.submit(i, "k") for i in range(8)))
        await d.stop()
        return out

    assert _run(go()) == [1] * 8


def test_breaker_lifecycle_closed_open_halfopen_closed(impl):
    clock, m = [0.0], impl.Metrics()
    cb = impl.batcher.CircuitBreaker
    br = cb(3, 10.0, metrics=m, clock=lambda: clock[0])
    states = [br.state]
    br.record_failure()
    br.record_success()
    for _ in range(2):
        br.record_failure()
    states.append(br.state)
    for _ in range(3):
        br.record_failure()
    states.append(br.state)
    allowed, retry = br.allow()
    br.record_success()  # a straggler's success does not close it
    states.append(br.state)
    clock[0] = 10.5
    probes = (br.allow()[0], br.allow()[0])
    states.append(br.state)
    clock[0] = 21.0  # an unanswered probe's claim expires
    probes += (br.allow()[0], br.allow()[0])
    br.record_success()
    states.append(br.state)
    assert states == [cb.CLOSED, cb.CLOSED, cb.OPEN, cb.OPEN, cb.HALF_OPEN, cb.CLOSED]
    assert (allowed, retry > 0, probes) == (False, True, (True, False, True, False))
    assert br.allow() == (True, 0.0) and m.counter("breaker_open_total") == 1


def test_breaker_failed_probe_reopens(impl):
    clock = [0.0]
    br = impl.batcher.CircuitBreaker(1, 5.0, clock=lambda: clock[0])
    br.record_failure()
    was_accepting = br.accepting()
    clock[0] = 6.0
    probe = br.allow()[0]
    br.record_failure()  # a fresh cooldown from here
    clock[0] = 10.0
    early = br.allow()[0]
    clock[0] = 11.5
    assert (was_accepting, probe, br.state, early, br.allow()[0]) == (
        False, True, impl.batcher.CircuitBreaker.OPEN, False, True)


def test_breaker_gates_dispatcher_submits(impl):
    clock = [0.0]
    br = impl.batcher.CircuitBreaker(2, 5.0, clock=lambda: clock[0])
    healthy = [False]

    def runner(key, images):
        if not healthy[0]:
            raise RuntimeError("device wedged")
        return ["ok"] * len(images)

    async def go():
        d = impl.batcher.BatchingDispatcher(runner, max_batch=1, window_ms=0, pipeline_depth=1,
                                            request_timeout_s=5.0, breaker=br)
        await d.start()
        for _ in range(2):
            with pytest.raises(RuntimeError, match="device wedged"):
                await d.submit(_img(), "k")
        t0 = time.perf_counter()
        with pytest.raises(impl.errors.BreakerOpen) as ei:
            await d.submit(_img(), "k")
        fast = time.perf_counter() - t0 < 1.0
        healthy[0] = True
        clock[0] = 6.0  # this submit is the half-open probe
        probe = await d.submit(_img(), "k")
        closed = br.state == impl.batcher.CircuitBreaker.CLOSED
        await d.stop()
        return fast, ei.value.retry_after_s > 0, (ei.value.status, ei.value.code), probe, closed

    assert _run(go()) == (True, True, (503, "breaker_open"), "ok", True)


def test_crashed_dispatch_task_fails_fast_and_restarts(impl):
    m = impl.Metrics()
    reg = impl.faults.FaultRegistry(metrics=m)
    impl.faults.install(reg)

    def dispatch(key, images):
        return lambda: [f"{key}-ok"] * len(images)

    async def go():
        d = _pipelined(impl, dispatch, max_batch=4, window_ms=0, request_timeout_s=30.0, metrics=m)
        await d.start()
        warm = await d.submit(_img(), "warm")
        reg.arm("batcher.dispatch_raise", "n1")
        t0 = time.perf_counter()
        with pytest.raises(impl.errors.FaultInjected):
            await d.submit(_img(), "a")
        fast = time.perf_counter() - t0 < 5.0
        after = await d.submit(_img(), "b")
        alive = d.tasks_alive()
        await d.stop()
        return warm, fast, after, alive, d.tasks_alive()

    try:
        assert _run(go()) == ("warm-ok", True, "b-ok", True, False)
    finally:
        impl.faults.uninstall(reg)
    assert m.labeled("task_restarts_total") == {"dispatch": 1}


def test_crashed_collect_task_restarts(impl):
    m = impl.Metrics()

    async def go():
        d = impl.batcher.BatchingDispatcher(lambda k, images: ["ok"] * len(images), max_batch=2, window_ms=0,
                                            pipeline_depth=1, request_timeout_s=30.0, metrics=m)
        await d.start()
        warm = await d.submit(_img(), "warm")
        original = d._drain_nowait

        def boom(batch):
            d._drain_nowait = original  # crash exactly once
            raise RuntimeError("collect bug")

        d._drain_nowait = boom
        with pytest.raises(impl.errors.Unavailable, match="collect task crashed"):
            await d.submit(_img(), "a")
        after = await d.submit(_img(), "b")
        await d.stop()
        return warm, after

    assert _run(go()) == ("ok", "ok")
    assert m.labeled("task_restarts_total") == {"collect": 1}


def test_submit_after_stop_fails_fast(impl):
    async def go():
        d = impl.batcher.BatchingDispatcher(lambda k, i: ["r"] * len(i), max_batch=1, window_ms=1.0,
                                            request_timeout_s=30.0)
        await d.start()
        await d.stop()
        with pytest.raises(impl.errors.Unavailable):
            await d.submit(_img(), "a")

    _run(go())


def test_the_port_serves_only_the_qos_none_path():
    """qos=None keeps the plain FIFO path, as the JAX dispatcher does; a
    QoS policy's DRR queue replaces it only when one is given (the qos
    path itself: tests/test_torch_qos.py)."""
    from deconv_api_tpu_torch.serving.qos import DrrQueue, QosPolicy

    assert isinstance(p_batcher.BatchingDispatcher(lambda k, i: i)._queue, asyncio.Queue)
    assert isinstance(j_batcher.BatchingDispatcher(lambda k, i: i)._queue, asyncio.Queue)
    assert isinstance(p_batcher.BatchingDispatcher(lambda k, i: i, qos=QosPolicy(""))._queue, DrrQueue)
