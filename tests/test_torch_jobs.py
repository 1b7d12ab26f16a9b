"""The durable job tier (``deconv_api_tpu_torch/serving/jobs.py`` and the
``/v1/jobs`` routes) against the JAX package's.

The manager, its journal and its spill store run the same scripted
executor under the same fake clock in both packages: equal journal
records (job ids mapped to their order, timestamps from the clock), equal
``describe`` documents and SSE streams, the same 429 with the same
``Retry-After``, the same crash budget, torn tail, boot compaction and
retention.  A jobs directory written by either package is reclaimed and
finished by the other.  A port and a JAX vgg_tiny server (the same params)
answer the same job requests with equal statuses, error codes and
checkpoint counts; the port's deconv, sweep and dream job answers are its
synchronous routes' bytes and within the reference's bars of the JAX
server's (tiles 52 dB JPEG to JPEG, a dream 40 dB and its loss within
2e-4).  On the port: a crash-resumed dream is byte-identical to an
uninterrupted one, a cancel mid-dream runs no further octave, and a job
parked by a drain is finished by the next server on its directory."""

import asyncio
import base64
import json
import os
import re
import time
import urllib.parse

import cv2
import httpx
import jax
import numpy as np
import pytest
import torch

from deconv_api_tpu import errors as j_errors
from deconv_api_tpu.config import ServerConfig as JServerConfig
from deconv_api_tpu.models.tiny import VGG_TINY_SPEC as J_TINY_SPEC, vgg_tiny_init
from deconv_api_tpu.serving import jobs as j_jobs
from deconv_api_tpu.serving.app import DeconvService as JDeconvService
from deconv_api_tpu.serving.models import spec_bundle as j_spec_bundle
from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.weights import params_from_jax
from deconv_api_tpu_torch.serving import jobs
from deconv_api_tpu_torch.serving.app import DeconvService
from deconv_api_tpu_torch.serving.models import ModelBundle
from tests.test_serving import ServiceFixture
from tests.test_torch_pipeline_serving import _Port

DREAM_LAYERS = ("block2_conv2", "block3_conv1")
# 32 px: octave_shapes(32, 32, 3, min_size=16) is a 3-rung ladder
DREAM_FORM = {"type": "dream", "steps": "2", "octaves": "3"}
LAYER = "block3_conv1"
TILE_PSNR_DB = 52.0
DREAM_PSNR_DB = 40.0
PACKAGES = {"port": (jobs, errors), "jax": (j_jobs, j_errors)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


async def _until(pred, timeout_s: float = 10.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        await asyncio.sleep(0.005)


def _normalise(obj, ids: dict):
    """``obj`` with every job id and input-spill name replaced by its order
    of first appearance (they are random in both packages)."""
    text = json.dumps(obj, sort_keys=True, default=lambda o: o.decode() if isinstance(o, bytes) else repr(o))

    def sub(m):
        return ids.setdefault(m.group(0), f"<{m.group(0).split('-')[0]}{len(ids)}>")

    return re.sub(r"(job-[0-9a-f]{12}|input-[0-9a-f]{10})", sub, text)


async def _stream(m, job, last: int = -1) -> bytes:
    return b"".join([chunk async for chunk in m.event_stream(job, last)])


def _executor(mod, seen: list):
    """The scripted executor: two steps (an array checkpoint, then a JSON
    one) and a result; ``crash`` in the params raises after the first step
    once, ``doom`` always.  ``seen`` records each attempt's checkpoints."""

    async def exec_(job, ckpts, load):
        seen.append((job.params.get("tag"), [load(r) is not None for r in ckpts]))
        have = {r["index"] for r in ckpts if r["stage"] == "step"}
        if job.params.get("doom"):
            raise RuntimeError("always boom")
        if 0 not in have:
            yield mod.Checkpoint("step", 0, 2, arrays={"x": np.arange(6.0).reshape(2, 3)}, meta={"loss": 1.5})
            if job.params.get("crash"):
                raise RuntimeError("boom")
        yield mod.Checkpoint("step", 1, 2, data={"v": [2, "two"]})
        yield mod.Result(200, "application/json", json.dumps({"tag": job.params.get("tag")}).encode())

    return exec_


async def _scenario(mod, errs, root: str) -> dict:
    """One scripted life of a manager: submits (with an input spill), a
    dedup, a full queue, a crash resumed from its checkpoint, a crash
    budget spent, a cancel, streams, then two boots: the first compacts
    (a torn tail appended before it), the second past the retention."""
    clock, seen, out = Clock(), [], {}
    m = mod.JobManager(root, _executor(mod, seen), queue_depth=3, workers=1, max_attempts=2, clock=clock)
    a, _ = m.submit("dream", {"tag": "a"}, "idem-a", input_arrays={"input": np.ones((4, 4, 3), np.float32)})
    b, _ = m.submit("sweep", {"tag": "b", "crash": "1"}, "idem-b", tenant="t1")
    c, _ = m.submit("deconv", {"tag": "c", "doom": "1"}, "idem-c", deadline_ts=5000.0)
    with pytest.raises(errs.JobQueueFull) as full:
        m.submit("dream", {"tag": "d"}, "idem-d")
    out["full"] = (full.value.status, full.value.code, full.value.retry_after_s)
    out["dedup"] = m.submit("dream", {"tag": "a2"}, "idem-a")[1]
    out["tenant_depth"] = m.tenant_depth("t1")
    with pytest.raises(errs.TenantOverQuota) as quota:
        m.ensure_tenant_capacity("t1", 1)
    out["quota"] = (quota.value.status, quota.value.retry_after_s, quota.value.tenant)
    m.start()
    await _until(lambda: all(j.state in jobs.TERMINAL_STATES for j in (a, b, c)))
    e, _ = m.submit("dream", {"tag": "e"}, "idem-e")
    out["cancel"] = m.describe(m.cancel(e.id))
    await m.stop()
    out["docs"] = [m.describe(j) for j in (a, b, c, e)]
    out["snapshot"] = m.jobs_snapshot()
    out["counts"] = m.counts()
    out["streams"] = [await _stream(m, j) for j in (a, b, c, e)]
    out["replay_from_3"] = await _stream(m, a, 3)
    out["result"] = m.result_body(a)
    out["seen"] = seen
    out["journal"] = mod.JobJournal.replay(m.journal.path)
    with open(m.journal.path, "ab") as f:
        f.write(b'{"rec":"checkpoint","job":"x","se')
    clock.t += 1800.0  # inside the retention: compacted, kept
    m2 = mod.JobManager(root, _executor(mod, seen), clock=clock)
    out["boot"] = (m2.torn_records, m2.reclaimed, m2.counts(), mod.JobJournal.replay(m2.journal.path),
                   sorted(os.listdir(m2.spill.root), key=lambda f: f.split("-", 2)[-1]), m2.result_body(m2.get(a.id)))
    clock.t += 3600.0  # past it: dropped, spills swept
    m3 = mod.JobManager(root, _executor(mod, seen), clock=clock)
    out["expired"] = (m3.counts(), mod.JobJournal.replay(m3.journal.path), os.listdir(m3.spill.root))
    with pytest.raises(errs.JobNotFound):
        m3.get(a.id)
    return out


def test_the_manager_lives_as_the_jax_one(tmp_path):
    got = asyncio.run(_scenario(jobs, errors, str(tmp_path / "port")))
    want = asyncio.run(_scenario(j_jobs, j_errors, str(tmp_path / "jax")))
    assert got["full"] == want["full"] == (429, "job_queue_full", 3.0)
    assert got["dedup"] is want["dedup"] is True
    assert got["quota"] == want["quota"] == (429, 1.0, "t1")
    for key in ("cancel", "docs", "snapshot", "counts", "streams", "replay_from_3", "result", "seen", "journal",
                "boot", "expired", "tenant_depth"):
        assert _normalise(got[key], {}) == _normalise(want[key], {}), key
    docs = {d["id"]: d for d in got["docs"]}
    states = [(d["state"], d["attempts"], d["resumed"], d["error"], d["checkpoints"]) for d in docs.values()]
    assert states == [("done", 1, False, None, 3), ("done", 2, True, None, 2),
                      ("failed", 2, True, "runner_crash", 0), ("cancelled", 0, False, None, 0)]
    assert got["boot"][:2] == (1, 0) and got["expired"][0]["done"] == 0 and not got["expired"][2]


def test_the_spill_and_the_journal_are_the_jax_bytes(tmp_path):
    arrays = {"x": np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32)}
    files = {}
    for name, (mod, _) in PACKAGES.items():
        store = mod.SpillStore(str(tmp_path / name / "spill"))
        fname, digest = store.put_arrays("job-0123456789ab", 3, arrays)
        jname, jdigest = store.put_json("job-0123456789ab", 4, {"name": "c1", "entry": {"filters": [1, 2]}})
        rname, _ = store.put_result("job-0123456789ab", b'{"ok": true}')
        journal = mod.JobJournal(str(tmp_path / name / "journal.jsonl"))
        journal.append({"rec": "submitted", "job": "job-0123456789ab", "seq": 0})
        journal.close()
        files[name] = {f: open(os.path.join(store.root, f), "rb").read() for f in (fname, jname, rname)}
        files[name]["journal"] = open(journal.path, "rb").read()
        # a corrupt spill reads as absent
        with open(os.path.join(store.root, fname), "r+b") as f:
            f.seek(40)
            f.write(b"\xff\xff")
        assert store.load_arrays(fname, digest) is None
        assert store.load_json(jname, jdigest) == {"name": "c1", "entry": {"filters": [1, 2]}}
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_a_jobs_dir_written_by_one_package_is_finished_by_the_other(tmp_path, writer, reader):
    """The writer's job parks at its first checkpoint (a drain); the
    reader boots on the directory, reclaims it, resumes from the writer's
    spilled checkpoint and finishes it."""
    root = str(tmp_path)
    (wmod, _), (rmod, _) = PACKAGES[writer], PACKAGES[reader]
    loaded = []

    managers = []

    def executor(mod):
        async def exec_(job, ckpts, load):
            loaded.extend(load(r) for r in ckpts)
            if not any(r["stage"] == "octave" for r in ckpts):
                managers[-1].draining = True  # this checkpoint's boundary parks the job
                yield mod.Checkpoint("octave", 0, 2, arrays={"x": np.full((3, 3), 7.0, np.float32)},
                                     meta={"loss": 0.25})
            yield mod.Result(200, "application/json", b'{"done": true}')

        return exec_

    async def write():
        m = wmod.JobManager(root, executor(wmod), workers=1)
        managers.append(m)
        job, _ = m.submit("dream", {"model": "vgg_tiny"}, "idem-x", input_arrays={"input": np.zeros((2, 2, 3))})
        m.start()
        await _until(lambda: job.state == "parked")
        await m.stop()
        return job.id

    async def read(job_id):
        m = rmod.JobManager(root, executor(rmod), workers=1)
        managers.append(m)
        assert m.reclaimed == 1 and m.get(job_id).resumed
        m.start()
        await _until(lambda: m.get(job_id).state == "done")
        await m.stop()
        return m.describe(m.get(job_id)), m.result_body(m.get(job_id))

    job_id = asyncio.run(write())
    loaded.clear()
    doc, body = asyncio.run(read(job_id))
    assert body == b'{"done": true}'
    assert (doc["checkpoints"], doc["last_checkpoint"], doc["attempts"]) == (2, {"stage": "octave", "index": 0,
                                                                                  "total": 2}, 2)
    np.testing.assert_array_equal(loaded[0]["input"], np.zeros((2, 2, 3)))
    np.testing.assert_array_equal(loaded[1]["x"], np.full((3, 3), 7.0, np.float32))


# --- the served routes ----------------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return vgg_tiny_init(jax.random.key(2, impl="rbg"))[1]


def _port_server(jparams, jobs_dir, **kw):
    bundle = ModelBundle(VGG_TINY_SPEC, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
                         torch.device("cpu"), dream_layers=DREAM_LAYERS)
    return _Port(DeconvService(bundle, ServerConfig(model="vgg_tiny", max_batch=4, batch_window_ms=1.0, cache_bytes=0,
                                                    jobs_dir=str(jobs_dir), fault_injection=True, **kw)))


def _jax_server(jparams, jobs_dir, **kw):
    jcfg = JServerConfig(image_size=0, max_batch=4, batch_window_ms=1.0, compilation_cache_dir="", model="vgg_tiny",
                         serve_lanes="off", warmup_all_buckets=False, cache_bytes=0, jobs_dir=str(jobs_dir), **kw)
    jbundle = lambda: j_spec_bundle(J_TINY_SPEC, jparams, dream_layers=DREAM_LAYERS)  # noqa: E731
    return ServiceFixture(None, service=JDeconvService(jcfg, registry={"vgg_tiny": jbundle}))


@pytest.fixture(scope="module")
def servers(jparams, tmp_path_factory):
    port = _port_server(jparams, tmp_path_factory.mktemp("port-jobs"))
    try:
        with _jax_server(jparams, tmp_path_factory.mktemp("jax-jobs")) as jx:
            yield port, jx
    finally:
        port.close()


def _uri(seed: int) -> str:
    img = np.random.default_rng(seed).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return "data:image/png;base64," + base64.b64encode(buf.tobytes()).decode()


def _jpeg(data_url: str) -> np.ndarray:
    raw = base64.b64decode(urllib.parse.unquote(data_url.split(",", 1)[1]))
    return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR).astype(np.float64)


def _psnr(a, b) -> float:
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _submit(served, form, headers=None):
    return httpx.post(served.base_url + "/v1/jobs", data=form, headers=headers or {}, timeout=120)


def _wait(served, job_id, timeout_s=120.0) -> dict:
    deadline = time.monotonic() + timeout_s
    while True:
        doc = httpx.get(served.base_url + f"/v1/jobs/{job_id}", timeout=30).json()
        if doc["state"] in ("done", "failed", "cancelled", "parked"):
            return doc
        assert time.monotonic() < deadline, doc
        time.sleep(0.02)


def _wait_checkpoints(served, job_id, n: int) -> dict:
    deadline = time.monotonic() + 60
    while True:
        doc = httpx.get(served.base_url + f"/v1/jobs/{job_id}", timeout=30).json()
        if doc["checkpoints"] >= n or doc["state"] in ("done", "failed", "cancelled"):
            return doc
        assert time.monotonic() < deadline, doc
        time.sleep(0.01)


def _faults(served, **form):
    r = httpx.post(served.base_url + "/v1/debug/faults", data=form, timeout=30)
    assert r.status_code == 200, r.text


def _events(text: str) -> list:
    out = []
    for block in text.split("\n\n"):
        ev = {}
        for line in block.splitlines():
            key, _, value = line.partition(": ")
            if key in ("id", "event", "data"):
                ev[key] = int(value) if key == "id" else json.loads(value) if key == "data" else value
        if "event" in ev:
            out.append(ev)
    return out


CASES = {  # name -> (form fields over a file, headers)
    "no_file": ({"type": "dream", "file": ""}, {}),
    "bad_type": ({"type": "nope"}, {}),
    "deconv_no_layer": ({"type": "deconv"}, {}),
    "unknown_layer": ({"type": "deconv", "layer": "nope"}, {}),
    "sweep_unknown_layer": ({"type": "sweep", "layer": "block9_conv9"}, {}),
    "bad_idempotency_key": (DREAM_FORM, {"x-idempotency-key": "has spaces!"}),
    "bad_mode": ({"type": "deconv", "layer": LAYER, "mode": "bogus"}, {}),
    "top_k_0": ({"type": "deconv", "layer": LAYER, "top_k": "0"}, {}),
    "steps_0": ({"type": "dream", "steps": "0"}, {}),
    "lr_nan": ({"type": "dream", "lr": "nan"}, {}),
    "dream_dense_layer": ({"type": "dream", "layers": "fc1"}, {}),
    "unknown_model": ({"type": "deconv", "layer": LAYER, "model": "vgg16"}, {}),
    "bad_quality": ({"type": "deconv", "layer": LAYER, "quality": "int4"}, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_bad_submit_is_answered_as_the_reference(servers, case):
    fields, headers = CASES[case]
    form = {"file": _uri(1), **fields}
    got, want = _submit(servers[0], form, headers), _submit(servers[1], form, headers)
    assert got.status_code == want.status_code, (got.text, want.text)
    if got.status_code >= 400:
        assert got.json()["error"] == want.json()["error"]
    else:  # accepted by both (a dream's layers are checked when it runs): it fails alike
        docs = [_wait(s, r.json()["id"]) for s, r in zip(servers, (got, want))]
        assert [(d["state"], d["error"]) for d in docs] == [("failed", "unknown_layer")] * 2


def test_unknown_jobs_and_subresources_are_answered_as_the_reference(servers):
    for path, method in (("/v1/jobs/job-nonexistent", "GET"), ("/v1/jobs/job-nonexistent/result", "GET"),
                         ("/v1/jobs/job-nonexistent", "DELETE")):
        got, want = (httpx.request(method, s.base_url + path, timeout=30) for s in servers)
        assert got.status_code == want.status_code == 404
        assert got.json()["error"] == want.json()["error"] == "job_not_found"


def test_without_a_jobs_dir_the_routes_are_404_as_the_reference(jparams, tmp_path):
    bundle = ModelBundle(VGG_TINY_SPEC, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
                         torch.device("cpu"), dream_layers=DREAM_LAYERS)
    port = DeconvService(bundle, ServerConfig(model="vgg_tiny"))
    jx = JDeconvService(JServerConfig(image_size=0, compilation_cache_dir="", model="vgg_tiny", serve_lanes="off"),
                        registry={"vgg_tiny": lambda: j_spec_bundle(J_TINY_SPEC, jparams)})
    for service in (port, jx):
        assert service.jobs is None
        assert ("POST", "/v1/jobs") not in service.server._routes and not service.server._prefix_routes
    assert port.config()["jobs_active"] is False


@pytest.mark.parametrize("kind", ["deconv", "sweep", "dream"])
def test_job_answers_match_the_sync_route_and_the_reference(servers, kind):
    port, jx = servers
    uri = _uri(3)
    form = {"deconv": {"type": "deconv", "layer": LAYER, "top_k": "4"},
            "sweep": {"type": "sweep", "layer": "block2_conv2", "top_k": "2"},
            "dream": DREAM_FORM}[kind]
    docs, bodies = [], []
    for served in servers:
        r = _submit(served, {**form, "file": uri})
        assert r.status_code == 202, r.text
        assert r.headers["location"] == f"/v1/jobs/{r.json()['id']}"
        doc = _wait(served, r.json()["id"])
        assert doc["state"] == "done", doc
        res = httpx.get(served.base_url + f"/v1/jobs/{doc['id']}/result", timeout=30)
        assert res.status_code == 200 and res.headers["x-job-id"] == doc["id"]
        docs.append(doc)
        bodies.append(res)
    assert (docs[0]["checkpoints"], docs[0]["last_checkpoint"]) == (docs[1]["checkpoints"], docs[1]["last_checkpoint"])
    got, want = bodies[0].json(), bodies[1].json()
    if kind == "dream":
        sync = httpx.post(port.base_url + "/v1/dream", data={"file": uri, **{k: form[k] for k in ("steps", "octaves")}},
                          timeout=120)
        assert sync.content == bodies[0].content  # the synchronous dream's bytes
        assert docs[0]["last_checkpoint"] == {"stage": "octave", "index": 2, "total": 3}
        assert got["layers"] == want["layers"] == list(DREAM_LAYERS)
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-4)
        assert _psnr(_jpeg(got["image"]), _jpeg(want["image"])) >= DREAM_PSNR_DB
        return
    layers = got["layers"] if kind == "sweep" else {LAYER: got}
    want_layers = want["layers"] if kind == "sweep" else {LAYER: want}
    assert list(layers) == list(want_layers)
    for name, entry in layers.items():
        sync = httpx.post(port.base_url + "/v1/deconv", data={"file": uri, "layer": name, "top_k": form["top_k"]},
                          timeout=120).json()
        assert (sync["filters"], sync["images"]) == (entry["filters"], entry["images"])  # the sync bytes
        assert entry["filters"] == want_layers[name]["filters"]
        for a, b in zip(entry["images"], want_layers[name]["images"]):
            assert _psnr(_jpeg(a), _jpeg(b)) >= TILE_PSNR_DB
    if kind == "sweep":
        assert docs[0]["checkpoints"] == 1 + len(layers)


def test_a_resubmit_dedups_and_the_sse_stream_replays(servers):
    port, _ = servers
    form = {**DREAM_FORM, "file": _uri(4)}
    first = _submit(port, form).json()
    again = _submit(port, form).json()
    assert again["id"] == first["id"] and again["deduped"]
    _wait(port, first["id"])
    stream = httpx.get(port.base_url + f"/v1/jobs/{first['id']}/events", timeout=30)
    assert stream.headers["content-type"] == "text/event-stream"
    events = _events(stream.text)
    assert [e["event"] for e in events][0] == "submitted" and events[-1]["event"] == "done"
    assert [e["event"] for e in events].count("checkpoint") == 4
    cut = events[len(events) // 2]["id"]
    rest = _events(httpx.get(port.base_url + f"/v1/jobs/{first['id']}/events", headers={"last-event-id": str(cut)},
                             timeout=30).text)
    assert [e["id"] for e in rest] == [e["id"] for e in events if e["id"] > cut]
    fresh = _submit(port, form, {"x-idempotency-key": "fresh-1"}).json()
    assert fresh["id"] != first["id"] and not fresh["deduped"]
    _wait(port, fresh["id"])
    listing = httpx.get(port.base_url + "/v1/jobs", timeout=30).json()
    assert {first["id"], fresh["id"]} <= {j["id"] for j in listing["jobs"]}
    assert httpx.get(port.base_url + "/readyz", timeout=30).json()["jobs"] == {"running": 0, "parked": 0, "queued": 0}
    config = httpx.get(port.base_url + "/v1/config", timeout=30).json()
    assert config["jobs_active"] and config["jobs_dir"] is True and config["jobs"]["queue_depth"] == 64
    assert "deconv_jobs_checkpoints_total" in httpx.get(port.base_url + "/metrics", timeout=30).text


def test_a_crash_resumed_dream_is_byte_identical(servers, monkeypatch):
    port, _ = servers
    form = {**DREAM_FORM, "file": _uri(5)}
    ref = _submit(port, form, {"x-idempotency-key": "parity-ref"}).json()
    assert _wait(port, ref["id"])["attempts"] == 1
    body_ref = httpx.get(port.base_url + f"/v1/jobs/{ref['id']}/result", timeout=30).content
    # The crash is armed while octave 1's dispatch is held, after octave
    # 0 is durable: the runner consults the crash site before each octave,
    # so it fires before octave 2 however slowly this test's polls run (a
    # delay fault's window alone let a loaded host arm it after the last
    # octave had started, and the job then finished on its first attempt).
    release = asyncio.Event()
    dispatches = []
    job_dispatch = port.service._job_dispatch

    async def held(job, *args):
        dispatches.append(job.id)
        if len(dispatches) == 2:
            await asyncio.wait_for(release.wait(), 30)
        return await job_dispatch(job, *args)

    monkeypatch.setattr(port.service, "_job_dispatch", held)
    try:
        job = _submit(port, form, {"x-idempotency-key": "parity-crash"}).json()
        assert _wait_checkpoints(port, job["id"], 2)["checkpoints"] == 2
        _faults(port, arm="jobs.runner_crash=n1")
        port.service.on_loop(_set(release))
        doc = _wait(port, job["id"])
    finally:
        _faults(port, disarm="all")
        if not release.is_set():
            port.service.on_loop(_set(release))
    assert (doc["state"], doc["attempts"], doc["resumed"], doc["checkpoints"]) == ("done", 2, True, 4), doc
    events = _events(httpx.get(port.base_url + f"/v1/jobs/{job['id']}/events", timeout=30).text)
    assert [e["data"]["index"] for e in events if e["data"].get("stage") == "octave"] == [0, 1, 2]
    assert httpx.get(port.base_url + f"/v1/jobs/{job['id']}/result", timeout=30).content == body_ref


async def _set(event: asyncio.Event) -> None:
    event.set()


def test_a_cancel_mid_dream_runs_no_further_octave(servers):
    port, _ = servers
    _faults(port, arm="device.dispatch_delay_ms=p1:200")
    try:
        job = _submit(port, {**DREAM_FORM, "file": _uri(6)}, {"x-idempotency-key": "cancel-1"}).json()
        assert _wait_checkpoints(port, job["id"], 2)["checkpoints"] >= 2
        batches = len(port.service.dream_dispatcher.batch_sizes)
        assert httpx.delete(port.base_url + f"/v1/jobs/{job['id']}", timeout=30).status_code == 200
        doc = _wait(port, job["id"])
    finally:
        _faults(port, disarm="all")
    assert doc["state"] == "cancelled" and doc["checkpoints"] < 4, doc
    time.sleep(0.3)
    # at most the octave in flight ran after the cancel
    assert len(port.service.dream_dispatcher.batch_sizes) <= batches + 1
    assert httpx.get(port.base_url + f"/v1/jobs/{job['id']}/result", timeout=30).status_code == 400
    again = httpx.delete(port.base_url + f"/v1/jobs/{job['id']}", timeout=30)
    assert again.status_code == 200 and again.json()["state"] == "cancelled"


def test_a_job_parked_by_a_drain_is_finished_by_the_next_server(jparams, tmp_path):
    form = {**DREAM_FORM, "file": _uri(7)}
    ref = _port_server(jparams, tmp_path / "ref")
    try:
        want = httpx.get(ref.base_url + f"/v1/jobs/{_wait(ref, _submit(ref, form).json()['id'])['id']}/result",
                         timeout=30).content
    finally:
        ref.close()
    first = _port_server(jparams, tmp_path / "jobs", jobs_workers=1)
    try:
        _faults(first, arm="device.dispatch_delay_ms=p1:200")
        job = _submit(first, form).json()
        assert _wait_checkpoints(first, job["id"], 2)["checkpoints"] >= 2
    finally:
        first.close()  # the drain parks the running job at its next checkpoint
    second = _port_server(jparams, tmp_path / "jobs", jobs_workers=1)
    try:
        assert second.service.jobs.reclaimed == 1
        doc = _wait(second, job["id"])
        assert doc["state"] == "done" and doc["resumed"], doc
        assert httpx.get(second.base_url + f"/v1/jobs/{job['id']}/result", timeout=30).content == want
    finally:
        second.close()
