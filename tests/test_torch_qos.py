"""The port's multi-tenant QoS (``deconv_api_tpu_torch/serving/qos.py``,
a copy of the JAX package's module) against the JAX package's: the same
scripted traffic, under one injected clock, goes through both, and every
admit, shed, refund and pop decision must be the same.  Then both
packages' dispatchers on a QoS queue: the class-ordered shed and the
device-time charge.  No device work: the runners return their inputs."""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from deconv_api_tpu import errors as j_errors
from deconv_api_tpu.serving import batcher as j_batcher
from deconv_api_tpu.serving import faults as j_faults
from deconv_api_tpu.serving import metrics as j_metrics
from deconv_api_tpu.serving import qos as j_qos
from deconv_api_tpu_torch import errors as p_errors
from deconv_api_tpu_torch.serving import batcher as p_batcher
from deconv_api_tpu_torch.serving import faults as p_faults
from deconv_api_tpu_torch.serving import metrics as p_metrics
from deconv_api_tpu_torch.serving import qos as p_qos

PACKAGES = {
    "jax": (j_qos, j_errors, j_batcher, j_metrics, j_faults),
    "port": (p_qos, p_errors, p_batcher, p_metrics, p_faults),
}
TENANTS = ('{"vic": {"class": "interactive", "rate_ms": 40, "burst_ms": 60, "max_inflight": 3},'
           ' "abu": {"class": "bulk", "rate_ms": 5, "burst_ms": 8},'
           ' "*": {"class": "standard", "rate_ms": 20, "burst_ms": 20}}')


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@dataclasses.dataclass
class _Item:
    n: int
    tenant: str
    tclass: str
    deadline: float | None = None


def test_parsing_matches_jax(tmp_path):
    for raw in ("", "bulk=2,interactive=16", "standard=1"):
        assert p_qos.parse_weights(raw) == j_qos.parse_weights(raw)
    for bad in ("premium=3", "interactive=0", "interactive", "bulk=x"):
        for mod in (p_qos, j_qos):
            with pytest.raises(ValueError):
                mod.parse_weights(bad)
    path = tmp_path / "tenants.json"
    path.write_text(TENANTS)
    for raw in (TENANTS, str(path), ""):
        got, want = p_qos.parse_tenant_specs(raw), j_qos.parse_tenant_specs(raw)
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == {k: dataclasses.asdict(v)
                                                                     for k, v in want.items()}
    for bad in ('{"a": {"class": "premium"}}', '{"a": {"rate_ms": -1}}', "[1, 2]", "{not json",
                str(tmp_path / "missing.json")):
        for mod in (p_qos, j_qos):
            with pytest.raises(ValueError):
                mod.parse_tenant_specs(bad)
    for mod in (p_qos, j_qos):
        with pytest.raises(ValueError, match="qos_default_class"):
            mod.QosPolicy(default_class="gold")


def test_token_bucket_matches_jax():
    """A scripted sequence of takes and credits at stepped clock times."""
    results = {}
    for name, (qos, *_) in PACKAGES.items():
        clock = _Clock()
        bucket = qos.TokenBucket(10.0, 25.0, clock)
        out = []
        for dt, op, ms in ((0, "take", 20), (0, "take", 10), (0.3, "take", 10), (0, "credit", 4),
                           (0, "take", 7), (5.0, "take", 25), (0, "take", 0.5), (0.01, "take", 2)):
            clock.t += dt
            out.append(bucket.take(ms) if op == "take" else bucket.credit(ms))
            out.append(round(bucket.tokens, 9))
        results[name] = out
    assert results["port"] == results["jax"]


def _admission_script(qos, errors, faults, metrics_mod):
    """Admissions, device charges, hit refunds and releases of several
    tenants at stepped clock times, with one admission crash: every
    outcome, then the snapshot and the labeled counters."""
    clock = _Clock()
    m = metrics_mod.Metrics()
    pol = qos.QosPolicy(TENANTS, hit_cost_ms=0.05, metrics=m, clock=clock)
    reg = faults.FaultRegistry(seed=0)
    reg.arm_string("qos.admission_raise=n1")
    out, grants = [], []
    headers = [{"x-tenant": "vic"}, {"x-api-key": "vic"}, {"x-tenant": "abu"}, {"x-api-key": "s3cret-key"},
               {"x-tenant": "other"}, {}, {"x-tenant": "bad name!"}, {"x-tenant": ""}]
    for step in range(60):
        clock.t += 0.037 * (step % 5)
        h = headers[step % len(headers)]
        if step == 17:
            faults.install(reg)
        try:
            g = pol.admit(h)
        except errors.TenantOverQuota as e:
            out.append(("429", e.tenant, round(e.retry_after_s, 9)))
        else:
            out.append(("ok", g.tenant, g.tclass, round(g.charged_ms, 9), g.metered, g.failed_open))
            grants.append(g)
        finally:
            if step == 17:
                faults.uninstall(reg)
        if step % 3 == 0 and grants:
            g = grants.pop(0)
            pol.charge(g.tenant, 0.004 + 0.001 * (step % 7))
            pol.release(g)
        elif step % 4 == 1 and grants:
            g = grants.pop()
            pol.charge_hit(g)
            pol.charge_hit(g)  # idempotent
            pol.release(g)
            pol.release(g)  # idempotent
    pol.record_shed("abu")
    snap = pol.snapshot()
    return out, snap, {f: m.labeled(f) for f in ("tenant_requests_total", "tenant_device_ms_total",
                                                 "tenant_shed_total")}, m.counter("qos_admission_errors_total"), \
        pol.counts()


def test_admission_and_accounting_match_jax():
    got = _admission_script(p_qos, p_errors, p_faults, p_metrics)
    want = _admission_script(j_qos, j_errors, j_faults, j_metrics)
    assert got == want
    outcomes = got[0]
    assert {o[0] for o in outcomes} == {"ok", "429"}  # both decisions occur
    assert any(o[0] == "ok" and o[5] for o in outcomes)  # the crash failed open
    assert any(o[1].startswith("key-") for o in outcomes)  # the unconfigured key is pseudonymized
    assert not any("s3cret" in str(o) for o in outcomes) and "s3cret" not in str(got[1:])


def _drr_script(qos, weights):
    clock = _Clock(100.0)
    q = qos.DrrQueue(weights, clock=clock)
    rng = np.random.default_rng(11)
    tenants = [("vic", "interactive"), ("std", "standard"), ("abu", "bulk"), ("ab2", "bulk"), ("v2", "interactive")]
    popped, n = [], 0
    for step in range(400):
        clock.t += 0.01
        r = rng.random()
        if r < 0.55:
            t, c = tenants[rng.integers(len(tenants))]
            deadline = clock.t + float(rng.choice([0.1, 0.3, 2.0])) if rng.random() < 0.5 else None
            q.put_nowait(_Item(n, t, c, deadline))
            n += 1
        elif r < 0.93:
            try:
                popped.append(("get", q.get_nowait().n))
            except asyncio.QueueEmpty:
                popped.append(("empty",))
        else:
            e = q.evict_bulk()
            popped.append(("evict", None if e is None else e.n))
        popped.append(q.qsize())
    popped.append(q.depths())
    return popped


@pytest.mark.parametrize("weights", [None, {"interactive": 3, "standard": 2, "bulk": 1}])
def test_drr_pop_order_matches_jax(weights):
    """Random puts (five tenants over three classes, some near their
    deadlines), gets and bulk evictions under one clock: the same pops,
    evictions and sizes, item by item."""
    assert _drr_script(p_qos, weights) == _drr_script(j_qos, weights)


def _dispatch_script(qos, errors, batcher, metrics_mod):
    """The class-ordered shed through a dispatcher on a QoS queue: a
    non-bulk arrival under overload evicts the newest queued bulk item; a
    bulk arrival sheds itself; then executed batches charge device time."""

    async def go():
        m = metrics_mod.Metrics()
        pol = qos.QosPolicy(metrics=m)
        d = batcher.BatchingDispatcher(lambda key, images: list(images), max_batch=4, window_ms=1.0,
                                       request_timeout_s=5.0, shed_factor=0.0, qos=pol)
        out = [type(d._queue).__name__]
        bulk = asyncio.ensure_future(d.submit("b", "k", tenant="abu", tclass="bulk"))
        await asyncio.sleep(0)
        d._shed_factor = 1.0
        d._estimated_drain_s = lambda: 1e9
        vic = asyncio.ensure_future(d.submit("v", "k", tenant="vic", tclass="interactive"))
        await asyncio.sleep(0.01)
        try:
            await bulk
        except errors.Overloaded as e:
            out.append(("evicted", e.code))
        try:
            await d.submit("b2", "k", tenant="abu", tclass="bulk")
        except errors.Overloaded as e:
            out.append(("shed", e.code))
        out.append(dict(m.labeled("tenant_shed_total")))
        out.append(d.queued_by_class())
        vic.cancel()
        d._shed_factor = 0.0
        await d.start()
        try:
            got = await asyncio.gather(*(d.submit(i, "k", tenant="a", tclass="standard") for i in range(3)))
        finally:
            await d.stop()
        out.append(got)
        out.append(sorted(m.labeled("tenant_device_ms_total")))
        snap = pol.snapshot()["tenants"]["a"]
        out.append((snap["device_ms"] > 0, snap["ewma_cost_ms"] > 0))
        return out

    return asyncio.run(asyncio.wait_for(go(), 10.0))


def test_dispatchers_on_a_qos_queue_match_jax():
    got = _dispatch_script(p_qos, p_errors, p_batcher, p_metrics)
    assert got == _dispatch_script(j_qos, j_errors, j_batcher, j_metrics)
    assert got[0] == "DrrQueue" and got[1] == ("evicted", "overloaded") and got[2] == ("shed", "overloaded")
    assert got[3] == {"abu": 2} and got[-1] == (True, True)


def test_quota_error_payload_and_retry_after_match_jax():
    for mod in (p_errors, j_errors):
        e = mod.TenantOverQuota("over budget", retry_after_s=0.2, tenant="abu")
        assert (e.status, e.code) == (429, "tenant_over_quota")
        assert mod.to_payload(e, "rid-1") == {"error": "tenant_over_quota", "detail": "over budget",
                                              "tenant": "abu", "request_id": "rid-1"}
        assert mod.retry_after_value(e.retry_after_s) == "1"
        q = mod.IllegalQuality("quality must be one of ...")
        assert (q.status, q.code) == (422, "illegal_quality")
