"""Durable async jobs: crash-safe checkpointed execution for long-running
work (a copy of ``deconv_api_tpu/serving/jobs.py``, byte-compatible with it
on disk: a jobs directory written by either package is reclaimed and
finished by the other).

Heavy dreams and layer sweeps run for seconds on the card, which is
hostile to synchronous HTTP, ``x-deadline-ms`` budgets and load-balancer
idle timeouts.  ``POST /v1/jobs`` answers 202 and a job id; execution
proceeds octave by octave or layer by layer through the service's
dispatchers (and so its ``LanePool`` and breaker), and every stage
boundary is checkpointed, so a runner crash, an open breaker or a whole
process restart resumes from the last checkpoint instead of restarting,
with the resumed output byte-identical to an uninterrupted run.

Three persistence pieces:

- ``JobJournal``: a write-ahead journal of append-only JSONL records
  (``submitted`` -> ``state: running`` -> ``checkpoint`` ... -> ``state:
  done|failed|cancelled|parked``), fsync'd at every state edge.  Replay
  tolerates a torn final record; boot compacts the journal: live jobs
  keep their checkpoint chains, terminal jobs within the retention
  window collapse to ``submitted`` + final state (result refs intact),
  older ones drop with their spill files.
- ``SpillStore``: checkpoint arrays (``.npz``), per-layer payloads
  (``.json``) and final result bodies under a spill directory, keyed by
  job id and content digest, written tmp-then-rename and digest-verified
  on load, so a half-written spill reads as "no checkpoint".
- ``JobManager``: the queue, the runner tasks and the idempotency index.
  An ``x-idempotency-key`` (default: the ``canonical_digest`` of the body)
  dedups duplicate submits onto the live or completed job; a full queue
  429s with a ``Retry-After`` from the running job cost (seeded from the
  lanes' batch cost); a runner crash (as opposed to a deterministic
  taxonomy failure) re-queues the job to resume from its last checkpoint,
  up to ``max_attempts``; ``begin_drain`` parks queued jobs at once and
  running jobs at their next checkpoint boundary, and a restarted process
  reclaims parked and interrupted jobs at boot.

Progress streams over SSE at ``GET /v1/jobs/{id}/events``: every
checkpoint and state edge is an event with a monotone per-job id, and a
reconnecting client's ``Last-Event-ID`` replays what it missed.

The executor (what a job computes) is injected by the service
(``serving/app.py``): an async generator over ``(job, checkpoints, load)``
yielding ``Checkpoint`` steps and one final ``Result``.  The manager owns
everything durable around it; the executor owns the device work.
"""

from __future__ import annotations

import asyncio
import hashlib
import io
import json
import logging
import math
import os
import threading
import time
from dataclasses import dataclass, field

from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.serving import durable, faults
from deconv_api_tpu_torch.utils import slog

_log = slog.get_logger("deconv.jobs")

# Non-terminal states are reclaimed on boot; terminal ones are retained
# for the retention window (idempotent resubmit + late GET).
TERMINAL_STATES = frozenset(("done", "failed", "cancelled"))
# Events that end an SSE stream: terminal states plus ``parked`` (no
# further events until a restart re-claims the job — the client should
# reconnect later rather than hold a dead stream).
STREAM_END_EVENTS = frozenset(("done", "failed", "cancelled", "parked"))


@dataclass
class Checkpoint:
    """One durable stage boundary yielded by an executor: ``arrays``
    (numpy dict, spilled as .npz) or ``data`` (JSON-able, spilled as
    .json) is what a resume needs to continue AFTER this stage."""

    stage: str  # 'input' | 'octave' | 'layer'
    index: int  # stage ordinal (-1 for the input checkpoint)
    total: int  # stages of this kind the job will run
    arrays: dict | None = None
    data: object | None = None
    meta: dict = field(default_factory=dict)


@dataclass
class Result:
    """The job's final payload — exactly what the synchronous route
    would have answered, so clients can share response parsers."""

    status: int
    content_type: str
    body: bytes


@dataclass
class Job:
    id: str
    kind: str  # 'deconv' | 'dream' | 'sweep'
    params: dict
    idem: str
    state: str  # queued | running | parked | done | failed | cancelled
    created_ts: float
    # Owning tenant (multi-tenant QoS): journaled at submit so parked and
    # resumed jobs keep their identity across restarts — the resumed
    # job's device work is still charged to (and queued under) the
    # tenant that submitted it.  '' = pre-QoS / qos-off submissions.
    tenant: str = ""
    deadline_ts: float | None = None  # wall-clock completion deadline
    finished_ts: float | None = None  # when a terminal state was reached
    attempts: int = 0
    seq: int = 0  # last event id (monotone per job)
    error: str | None = None
    checkpoints: list = field(default_factory=list)  # journal ckpt records
    events: list = field(default_factory=list)  # SSE replay history
    result: dict | None = None  # {status, content_type, spill, digest, size}
    cancel_requested: bool = False
    resumed: bool = False  # ever re-claimed after a crash/park/restart
    _inflight: object | None = field(default=None, repr=False)
    _subs: list = field(default_factory=list, repr=False)
    # the per-attempt RequestTrace the service's executor stashes so the
    # dispatch wrapper can activate it around device submits
    _trace: object | None = field(default=None, repr=False)


class JobJournal(durable.Journal):
    """Append-only JSONL write-ahead journal with torn-tail-tolerant
    replay and whole-file compaction, written through the unified
    durable layer under the ``jobs.journal`` surface.

    Appends run on the event loop: one small line + flush + fsync per
    STATE EDGE (submits, checkpoints, transitions) — microseconds-to-
    low-milliseconds against jobs that run for seconds, and exactly the
    durability the resume contract needs.  The surface is FAIL-LOUD: an
    append that cannot fsync raises ``durable.DurableWriteError`` (the
    submit path turns the pre-202 case into a 503 + Retry-After), and a
    journal whose header declares a future format version refuses boot
    (``durable.FutureVersionError`` out of ``replay``).  The armable
    disk-fault sites are ``fs.*@jobs.journal``; the legacy
    ``jobs.journal_write_error`` spelling aliases onto
    ``fs.fsync_error@jobs.journal``."""

    _FORMAT = "jobs.journal"
    _VERSION = 1

    def __init__(self, path: str, *, metrics=None):
        super().__init__(
            path,
            durable.Surface("jobs.journal", metrics=metrics),
            fmt=self._FORMAT,
            version=self._VERSION,
        )

    @staticmethod
    def replay(path: str) -> tuple[list[dict], int]:
        """(decodable records in order, undecodable line count).  A torn
        final record — the crash-mid-append case — is skipped, never
        fatal: the preceding fsync'd edge is the recovered state.  A
        future-version header record raises (refuse boot, fail-static):
        replaying a journal this binary cannot fully parse could
        re-run acknowledged work."""
        return durable.Journal.replay(
            path, JobJournal._FORMAT, JobJournal._VERSION
        )


class SpillStore:
    """Checkpoint/result staging under one directory, content-digested,
    written through the unified durable layer under the
    ``jobs.spill`` surface.

    Every file is a framed artifact (a versioned ``{format, version,
    len, digest}`` header line + payload); every read verifies both the
    frame digest and the digest recorded in the journal — a corrupt or
    future-version spill reads as None, which executors treat as "that
    checkpoint never happened" (resume falls back to an earlier one).
    The surface is FAIL-LOUD on writes: a spill that cannot be made
    durable raises, and the submit path refuses the job rather than
    acknowledge work it cannot resume."""

    _FORMAT = "jobs.spill"
    _VERSION = 1

    def __init__(self, root: str, *, metrics=None):
        self.root = root
        self.surface = durable.Surface("jobs.spill", metrics=metrics)
        os.makedirs(root, exist_ok=True)
        durable.sweep_tmp(root)

    @staticmethod
    def _digest(data: bytes) -> str:
        return hashlib.blake2b(data, digest_size=16).hexdigest()

    def _write(self, fname: str, data: bytes) -> None:
        durable.atomic_write(
            os.path.join(self.root, fname),
            durable.frame(self._FORMAT, self._VERSION, data),
            surface=self.surface,
        )

    def _read(self, fname: str, digest: str | None) -> bytes | None:
        got = durable.read_framed(
            os.path.join(self.root, fname), self._FORMAT, self._VERSION,
            surface="jobs.spill",
        )
        if got is None:
            return None
        _meta, data = got
        if digest is not None and self._digest(data) != digest:
            slog.event(
                _log, "spill_digest_mismatch", level=logging.ERROR,
                file=fname,
            )
            return None
        return data

    def put_arrays(self, job_id: str, seq: int, arrays: dict) -> tuple[str, str]:
        import numpy as np

        buf = io.BytesIO()
        np.savez(buf, **arrays)
        data = buf.getvalue()
        digest = self._digest(data)
        fname = f"{job_id}-{seq:05d}-{digest[:12]}.npz"
        self._write(fname, data)
        return fname, digest

    def load_arrays(self, fname: str, digest: str | None) -> dict | None:
        import numpy as np

        data = self._read(fname, digest)
        if data is None:
            return None
        with np.load(io.BytesIO(data)) as z:
            return {k: z[k] for k in z.files}

    def put_json(self, job_id: str, seq: int, obj) -> tuple[str, str]:
        data = json.dumps(obj, separators=(",", ":")).encode()
        digest = self._digest(data)
        fname = f"{job_id}-{seq:05d}-{digest[:12]}.json"
        self._write(fname, data)
        return fname, digest

    def load_json(self, fname: str, digest: str | None):
        data = self._read(fname, digest)
        if data is None:
            return None
        try:
            return json.loads(data)
        except ValueError:
            return None

    def put_result(self, job_id: str, body: bytes) -> tuple[str, str]:
        digest = self._digest(body)
        fname = f"{job_id}-result-{digest[:12]}.bin"
        self._write(fname, body)
        return fname, digest

    def load_result(self, fname: str, digest: str | None) -> bytes | None:
        return self._read(fname, digest)

    def sweep(self, keep: set[str]) -> int:
        """Delete every spill file not in ``keep`` (dropped jobs' spills,
        terminal jobs' intermediate checkpoints, stale .tmp halves).
        Returns how many files were removed."""
        removed = 0
        for fname in os.listdir(self.root):
            if fname in keep:
                continue
            try:
                os.unlink(os.path.join(self.root, fname))
                removed += 1
            except OSError:
                pass
        return removed


def _sse(ev: dict) -> bytes:
    """One SSE frame: the event's per-job seq is the SSE id, so a
    reconnecting client's Last-Event-ID addresses the replay exactly."""
    return (
        f"id: {ev['seq']}\nevent: {ev['event']}\n"
        f"data: {json.dumps(ev['data'], separators=(',', ':'))}\n\n"
    ).encode()


class JobManager:
    """Queue + runner tasks + durability around an injected executor.

    All mutation happens on the service's event loop (routes and runner
    tasks live there); the journal/spill writes themselves are cheap
    synchronous file appends.  ``clock`` is wall time (job deadlines and
    retention must survive restarts, unlike perf_counter)."""

    def __init__(
        self,
        jobs_dir: str,
        executor,
        *,
        metrics=None,
        lane_pool=None,
        queue_depth: int = 64,
        workers: int = 2,
        retention_s: float = 3600.0,
        max_attempts: int = 3,
        clock=time.time,
    ):
        self.dir = jobs_dir
        self._executor = executor
        self._metrics = metrics
        self._lane_pool = lane_pool
        self.queue_depth = max(1, int(queue_depth))
        self.workers = max(1, int(workers))
        self.retention_s = float(retention_s)
        self.max_attempts = max(1, int(max_attempts))
        self._clock = clock
        # the manager OWNS jobs_dir (it creates journal + spill inside):
        # the uniform boot sweep may take the whole directory, not just
        # the journal's own <path>.tmp
        os.makedirs(jobs_dir, exist_ok=True)
        durable.sweep_tmp(jobs_dir)
        self.journal = JobJournal(
            os.path.join(jobs_dir, "journal.jsonl"), metrics=metrics
        )
        self.spill = SpillStore(
            os.path.join(jobs_dir, "spill"), metrics=metrics
        )
        self._jobs: dict[str, Job] = {}
        self._idem: dict[str, str] = {}
        self._queue: asyncio.Queue[str] = asyncio.Queue()
        self._tasks: list[asyncio.Task] = []
        self.draining = False
        self._stopping = False
        self._ewma_job_s = 0.0
        self.torn_records = 0
        self.reclaimed = 0
        self._boot()

    # ------------------------------------------------------------- boot

    def _boot(self) -> None:
        """Replay the journal, reclaim interrupted work, compact."""
        records, torn = JobJournal.replay(self.journal.path)
        self.torn_records = torn
        # each job's newest record timestamp, built in the same pass —
        # the retention check below must not rescan the whole record
        # list per job (O(jobs x records) stalls boot on big journals)
        last_ts: dict[str, float] = {}
        for rec in records:
            kind = rec.get("rec")
            jid = rec.get("job")
            if jid and "ts" in rec:
                last_ts[jid] = rec["ts"]
            if kind == "submitted" and jid:
                job = Job(
                    id=jid,
                    kind=rec.get("kind", "dream"),
                    params=rec.get("params") or {},
                    idem=rec.get("idem", jid),
                    state="queued",
                    created_ts=rec.get("ts", self._clock()),
                    deadline_ts=rec.get("deadline_ts"),
                    tenant=rec.get("tenant", ""),
                )
                job.events.append(
                    {"seq": 0, "event": "submitted",
                     "data": {"job": jid, "kind": job.kind}}
                )
                self._jobs[jid] = job
                self._idem[job.idem] = jid
                continue
            job = self._jobs.get(jid)
            if job is None:
                continue
            if kind == "checkpoint":
                job.checkpoints.append(rec)
                job.seq = max(job.seq, rec.get("seq", 0))
                job.events.append(
                    {
                        "seq": rec.get("seq", job.seq),
                        "event": "checkpoint",
                        "data": {
                            "job": jid,
                            "stage": rec.get("stage"),
                            "index": rec.get("index"),
                            "total": rec.get("total"),
                            **(rec.get("meta") or {}),
                        },
                    }
                )
            elif kind == "state":
                job.state = rec.get("state", job.state)
                job.seq = max(job.seq, rec.get("seq", 0))
                job.attempts = rec.get("attempt", job.attempts)
                if rec.get("error"):
                    job.error = rec["error"]
                if rec.get("result"):
                    job.result = rec["result"]
                job.events.append(
                    {
                        "seq": rec.get("seq", job.seq),
                        "event": job.state,
                        "data": {"job": jid, "state": job.state,
                                 "error": job.error},
                    }
                )
        # retention: drop terminal jobs whose last edge is out of window
        now = self._clock()
        for jid in list(self._jobs):
            job = self._jobs[jid]
            if job.state in TERMINAL_STATES:
                job.finished_ts = last_ts.get(jid, job.created_ts)
                if now - job.finished_ts > self.retention_s:
                    del self._jobs[jid]
                    if self._idem.get(job.idem) == jid:
                        del self._idem[job.idem]
        # reclaim interrupted work: queued/running/parked all become
        # queued — running means the process died mid-job and the last
        # checkpoint is the resume point (pinned by test)
        compact: list[dict] = []
        keep_spills: set[str] = set()
        for job in self._jobs.values():
            compact.append(
                {
                    "rec": "submitted", "job": job.id, "kind": job.kind,
                    "params": job.params, "idem": job.idem,
                    "ts": job.created_ts, "deadline_ts": job.deadline_ts,
                    "tenant": job.tenant, "seq": 0,
                }
            )
            if job.state in TERMINAL_STATES:
                # checkpoints collapse; the result spill (if any) stays.
                # The record keeps the job's ORIGINAL finish timestamp —
                # stamping `now` would reset the retention window every
                # restart, so a frequently-redeployed server would never
                # expire anything (and stale idempotency entries would
                # dedup forever)
                if job.result and job.result.get("spill"):
                    keep_spills.add(job.result["spill"])
                compact.append(
                    {
                        "rec": "state", "job": job.id, "state": job.state,
                        "seq": job.seq, "error": job.error,
                        "result": job.result,
                        "ts": job.finished_ts or now,
                        "attempt": job.attempts,
                    }
                )
                continue
            was = job.state
            job.state = "queued"
            job.resumed = True
            self.reclaimed += 1
            for rec in job.checkpoints:
                if rec.get("spill"):
                    keep_spills.add(rec["spill"])
                compact.append(rec)
            job.seq += 1
            compact.append(
                {
                    "rec": "state", "job": job.id, "state": "queued",
                    "seq": job.seq, "resumed": True, "reclaimed_from": was,
                    "ts": now, "attempt": job.attempts,
                }
            )
            job.events.append(
                {"seq": job.seq, "event": "queued",
                 "data": {"job": job.id, "state": "queued",
                          "resumed": True}}
            )
            self._queue.put_nowait(job.id)
        self.journal.rewrite(compact)
        removed = self.spill.sweep(keep_spills)
        if self.reclaimed or torn or removed:
            slog.event(
                _log, "jobs_boot", reclaimed=self.reclaimed,
                torn_records=torn, spills_swept=removed,
                jobs=len(self._jobs),
            )
        self._publish()

    # -------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._tasks:
            return
        self._stopping = False
        for i in range(self.workers):
            self._tasks.append(
                asyncio.create_task(self._worker(), name=f"job-runner-{i}")
            )

    async def stop(self, grace_s: float = 5.0) -> None:
        """Tear the runners down.  Called AFTER ``begin_drain`` (which
        parked the queue) and BEFORE the dispatchers stop.

        Running jobs get up to ``grace_s`` to reach their next
        checkpoint boundary, where the draining flag parks them CLEANLY
        — the in-flight octave completes and checkpoints, and no device
        work is live when the process exits.  Cancelling mid-octave is
        the fallback past the grace: the job still parks (the
        cancellation handler journals it) but the abandoned octave's
        device work keeps running on a dispatch thread past the
        process's teardown — hence boundary-first."""
        self._stopping = True
        self.draining = True
        deadline = time.monotonic() + max(0.0, grace_s)
        while time.monotonic() < deadline and any(
            j.state == "running" for j in self._jobs.values()
        ):
            await asyncio.sleep(0.05)
        for t in self._tasks:
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []

    def begin_drain(self) -> None:
        """Park queued jobs NOW (journaled, so a restart re-claims
        them); running jobs park at their next checkpoint boundary."""
        self.draining = True
        for job in self._jobs.values():
            if job.state == "queued":
                self._set_state(job, "parked")

    # --------------------------------------------------------- surface

    def get(self, job_id: str) -> Job:
        job = self._jobs.get(job_id)
        if job is None:
            raise errors.JobNotFound(f"no job {job_id!r}")
        return job

    def _evict_expired(self) -> None:
        """Runtime retention (the boot pass alone would let a
        long-running server grow RAM and spill disk without bound):
        terminal jobs past ``retention_s`` drop from the index and their
        spill files are deleted.  Called opportunistically from submit —
        the exact path whose traffic drives the growth."""
        now = self._clock()
        for jid in list(self._jobs):
            job = self._jobs[jid]
            if (
                job.state not in TERMINAL_STATES
                or job.finished_ts is None
                or now - job.finished_ts <= self.retention_s
            ):
                continue
            del self._jobs[jid]
            if self._idem.get(job.idem) == jid:
                del self._idem[job.idem]
            spills = [
                rec["spill"] for rec in job.checkpoints if rec.get("spill")
            ]
            if job.result and job.result.get("spill"):
                spills.append(job.result["spill"])
            for fname in spills:
                try:
                    os.unlink(os.path.join(self.spill.root, fname))
                except OSError:
                    pass

    def lookup(self, idem: str) -> Job | None:
        """The live-or-retained job an idempotency key dedups onto, or
        None.  The submit route asks BEFORE decoding the image, so a
        retried submit never re-pays the expensive part of submission."""
        existing = self._idem.get(idem)
        if existing is not None and existing in self._jobs:
            if self._metrics is not None:
                self._metrics.inc_counter("jobs_deduped_total")
            return self._jobs[existing]
        return None

    def ensure_capacity(self) -> None:
        """Raise JobQueueFull when the queue is at depth.  The submit
        route asks before decoding (reject cheap, an overload must not
        burn codec-pool slots on doomed submits); ``submit`` re-checks
        under the same rule since a decode await sits between the two."""
        depth = sum(
            1 for j in self._jobs.values() if j.state in ("queued", "running")
        )
        if depth >= self.queue_depth:
            raise errors.JobQueueFull(
                f"job queue at capacity ({depth}/{self.queue_depth})",
                retry_after_s=self.retry_after_s(depth),
            )

    def tenant_depth(self, tenant: str) -> int:
        """Queued+running jobs owned by one tenant — what the
        per-tenant ``max_jobs`` budget is checked against (the global
        ``ensure_capacity`` still guards the whole queue)."""
        return sum(
            1
            for j in self._jobs.values()
            if j.tenant == tenant and j.state in ("queued", "running")
        )

    def ensure_tenant_capacity(self, tenant: str, budget: int) -> None:
        """Raise TenantOverQuota when the tenant is at its ``max_jobs``
        budget (0 = unlimited).  ONE rule for both callers: the submit
        route's cheap pre-decode check and ``submit``'s atomic re-check
        must reject with the same message and Retry-After or the two
        sites drift."""
        if budget <= 0:
            return
        depth = self.tenant_depth(tenant)
        if depth >= budget:
            raise errors.TenantOverQuota(
                f"tenant {tenant!r} at its job budget ({depth}/{budget})",
                retry_after_s=self.retry_after_s(depth),
                tenant=tenant,
            )

    def submit(
        self,
        kind: str,
        params: dict,
        idem: str,
        input_arrays: dict | None = None,
        deadline_ts: float | None = None,
        input_spilled: tuple[str, str, str] | None = None,
        tenant: str = "",
        tenant_budget: int = 0,
    ) -> tuple[Job, bool]:
        """Create (or dedup onto) a job.  Returns (job, deduped).

        ``input_spilled`` is a (fname, digest, fmt) from ``spill_input``
        — the HTTP route writes the input spill off-loop first and
        hands the reference in, so submit itself never blocks the event
        loop on a large fsync.  ``input_arrays`` is the synchronous
        convenience form (tests, embedders).  ``tenant_budget`` (> 0)
        re-checks the tenant's ``max_jobs`` here, under the same rule as
        ``ensure_capacity``: the route's cheap pre-decode check can race
        N concurrent submits across its awaits, and only this re-check
        runs with no await between it and the job registering."""
        self._evict_expired()
        existing = self.lookup(idem)
        if existing is not None:
            return existing, True
        self.ensure_capacity()
        self.ensure_tenant_capacity(tenant, tenant_budget)
        job = Job(
            id=f"job-{os.urandom(6).hex()}",
            kind=kind,
            params=params,
            idem=idem,
            state="queued",
            created_ts=self._clock(),
            deadline_ts=deadline_ts,
            tenant=tenant,
        )
        # journal FIRST: a submit whose record cannot be made durable is
        # refused — an accepted job must survive a crash.  The refusal
        # is a 503 + Retry-After, NOT a 500: answering 202
        # would acknowledge work this process cannot promise to
        # remember, and the client's retry is the recovery path.
        try:
            self.journal.append(
                {
                    "rec": "submitted", "job": job.id, "kind": kind,
                    "params": params, "idem": idem, "ts": job.created_ts,
                    "deadline_ts": deadline_ts, "tenant": tenant, "seq": 0,
                }
            )
        except OSError as e:
            self._journal_error(e)
            raise errors.UndurableWrite(
                f"job journal write failed: {e}"
            ) from e
        self._jobs[job.id] = job
        self._idem[idem] = job.id
        job.events.append(
            {"seq": 0, "event": "submitted",
             "data": {"job": job.id, "kind": kind}}
        )
        if input_spilled is not None:
            self._record_checkpoint(
                job,
                Checkpoint(stage="input", index=-1, total=0),
                spilled=input_spilled,
            )
        elif input_arrays:
            try:
                # the decoded input is its own checkpoint: resume (and
                # the journal) never depend on re-decoding the body
                self._record_checkpoint(
                    job, Checkpoint(stage="input", index=-1, total=0,
                                    arrays=input_arrays)
                )
            except OSError as e:
                # the spill write (the LARGE submit-time write) failed:
                # roll the job back — leaving it 'queued' but never
                # enqueued would pin phantom capacity until restart,
                # ratcheting every later submit into a 429
                del self._jobs[job.id]
                if self._idem.get(idem) == job.id:
                    del self._idem[idem]
                self._journal_append(
                    {
                        "rec": "state", "job": job.id, "state": "failed",
                        "seq": 1, "error": "spill_write_error",
                        "ts": round(self._clock(), 3), "attempt": 0,
                    }
                )
                self._journal_error(e)
                raise errors.UndurableWrite(
                    f"job input spill write failed: {e}"
                ) from e
        self._queue.put_nowait(job.id)
        if self._metrics is not None:
            self._metrics.inc_counter("jobs_submitted_total")
            self._metrics.inc_labeled(
                "jobs_state_total", "job_state", "queued"
            )
        self._publish()
        return job, False

    def cancel(self, job_id: str) -> Job:
        """DELETE /v1/jobs/{id}: terminal jobs are a no-op; queued and
        parked jobs cancel immediately; a running job's in-flight device
        wait is cancelled, which the batcher's reap boundary turns into
        "the device never runs the dead octave"."""
        job = self.get(job_id)
        if job.state in TERMINAL_STATES:
            return job
        job.cancel_requested = True
        if job.state in ("queued", "parked"):
            self._set_state(job, "cancelled")
        elif job._inflight is not None and not job._inflight.done():
            job._inflight.cancel()
        return job

    def result_body(self, job: Job) -> bytes | None:
        """The result payload, read (and digest-verified) from the
        spill per call — deliberately uncached, see _record_result."""
        if job.result and job.result.get("spill"):
            return self.spill.load_result(
                job.result["spill"], job.result.get("digest")
            )
        return None

    def counts(self) -> dict:
        out = {"queued": 0, "running": 0, "parked": 0, "done": 0,
               "failed": 0, "cancelled": 0}
        for job in self._jobs.values():
            out[job.state] = out.get(job.state, 0) + 1
        return out

    def describe(self, job: Job) -> dict:
        last = job.checkpoints[-1] if job.checkpoints else None
        return {
            "id": job.id,
            "kind": job.kind,
            "state": job.state,
            "tenant": job.tenant or None,
            "created_ts": round(job.created_ts, 3),
            "attempts": job.attempts,
            "resumed": job.resumed,
            "seq": job.seq,
            "error": job.error,
            "checkpoints": len(job.checkpoints),
            "last_checkpoint": (
                {
                    "stage": last.get("stage"),
                    "index": last.get("index"),
                    "total": last.get("total"),
                }
                if last is not None
                else None
            ),
            "result_ready": job.state == "done" and job.result is not None,
            "events_url": f"/v1/jobs/{job.id}/events",
            "result_url": f"/v1/jobs/{job.id}/result",
        }

    def jobs_snapshot(self) -> list[dict]:
        return [
            self.describe(j)
            for j in sorted(self._jobs.values(), key=lambda j: j.created_ts)
        ]

    def retry_after_s(self, depth: int | None = None) -> float:
        """Backoff guidance for a 429: queue depth times what a job has
        been costing, over the worker parallelism.  Before any job has
        completed, the lanes' EWMA batch cost seeds the estimate (a
        job is several batches; 4x is the conservative multiplier)."""
        if depth is None:
            depth = sum(
                1
                for j in self._jobs.values()
                if j.state in ("queued", "running")
            )
        base = self._ewma_job_s
        if base <= 0.0 and self._lane_pool is not None:
            lanes = getattr(self._lane_pool, "lanes", [])
            walls = [l.ewma_s for l in lanes if l.ewma_s > 0]
            if walls:
                base = 4.0 * sum(walls) / len(walls)
        if base <= 0.0:
            base = 1.0
        return float(
            max(1, math.ceil(depth * base / max(1, self.workers)))
        )

    # ------------------------------------------------------ SSE events

    def subscribe(self, job: Job, last_seq: int):
        """(replay events with seq > last_seq, live queue or None when
        the job is already terminal/parked).  Snapshot + registration
        happen without an await, so no event can fall in the gap."""
        replay = [ev for ev in job.events if ev["seq"] > last_seq]
        if job.state in STREAM_END_EVENTS:
            return replay, None
        q: asyncio.Queue = asyncio.Queue()
        job._subs.append(q)
        return replay, q

    def unsubscribe(self, job: Job, q) -> None:
        if q is not None and q in job._subs:
            job._subs.remove(q)

    def event_stream(self, job: Job, last_seq: int):
        """Async byte-chunk generator for the SSE route: replay first
        (Last-Event-ID reconnect), then live events until a terminal or
        parked edge ends the stream."""

        async def stream():
            replay, q = self.subscribe(job, last_seq)
            try:
                yield b"retry: 2000\n\n"
                for ev in replay:
                    yield _sse(ev)
                # only the LAST replayed event may end the stream: a
                # HISTORICAL parked edge (job since re-claimed and
                # running again) must not close a live stream.  q is
                # None covers the job being parked/terminal RIGHT NOW
                # even when the replay is empty (caught-up reconnect).
                if q is None or (
                    replay and replay[-1]["event"] in STREAM_END_EVENTS
                ):
                    return
                while True:
                    ev = await q.get()
                    yield _sse(ev)
                    if ev["event"] in STREAM_END_EVENTS:
                        return
            finally:
                self.unsubscribe(job, q)

        return stream()

    def _emit(self, job: Job, event: str, data: dict) -> None:
        ev = {"seq": job.seq, "event": event, "data": data}
        job.events.append(ev)
        for q in job._subs:
            q.put_nowait(ev)

    # ------------------------------------------------------ durability

    def _journal_error(self, e: Exception) -> None:
        slog.event(
            _log, "journal_write_error", level=logging.ERROR,
            error=f"{type(e).__name__}: {e}",
        )
        if self._metrics is not None:
            self._metrics.inc_counter("jobs_journal_errors_total")

    def _journal_append(self, rec: dict) -> None:
        """Best-effort append for post-submit edges: a failed write
        degrades durability (a crash would replay from the previous
        edge) but never wedges a running job."""
        try:
            self.journal.append(rec)
        except OSError as e:
            self._journal_error(e)

    def _set_state(self, job: Job, state: str, **extra) -> None:
        job.state = state
        if state in TERMINAL_STATES:
            job.finished_ts = self._clock()
        if extra.get("error"):
            job.error = extra["error"]
        job.seq += 1
        rec = {
            "rec": "state", "job": job.id, "state": state, "seq": job.seq,
            "ts": round(self._clock(), 3), "attempt": job.attempts,
            **extra,
        }
        if state == "done" and job.result is not None:
            rec["result"] = job.result
        self._journal_append(rec)
        data = {"job": job.id, "state": state}
        if job.error:
            data["error"] = job.error
        if extra.get("resumed"):
            data["resumed"] = True
        self._emit(job, state, data)
        if self._metrics is not None:
            self._metrics.inc_labeled("jobs_state_total", "job_state", state)
        self._publish()
        slog.event(
            _log, "job_state", job=job.id, state=state,
            attempt=job.attempts, error=job.error,
        )

    def _spill_step(
        self, job: Job, step: Checkpoint
    ) -> tuple[str, str, str] | None:
        """The BLOCKING part of recording a checkpoint — the spill file
        write (multi-hundred-KB npz + fsync).  The runner calls this via
        asyncio.to_thread so per-octave writes never stall the event
        loop; the filename's seq is job.seq+1 (a job is owned by one
        worker at a time, so no concurrent bump can race it)."""
        if step.arrays is not None:
            return (*self.spill.put_arrays(job.id, job.seq + 1, step.arrays),
                    "npz")
        if step.data is not None:
            return (*self.spill.put_json(job.id, job.seq + 1, step.data),
                    "json")
        return None

    def spill_input(self, arrays: dict) -> tuple[str, str, str]:
        """Write a submit-time input spill under a job-independent name
        (the journal references spills by exact filename, never by
        prefix) so the HTTP route can run this off-loop BEFORE the job
        exists.  A spill orphaned by a lost submit race is swept at the
        next boot."""
        fname, digest = self.spill.put_arrays(
            f"input-{os.urandom(5).hex()}", 0, arrays
        )
        return fname, digest, "npz"

    def _record_checkpoint(
        self,
        job: Job,
        step: Checkpoint,
        spilled: tuple[str, str, str] | None = None,
    ) -> None:
        if spilled is None:
            # synchronous path (submit's test-facing input_arrays form);
            # _spill_step names the file with job.seq+1, the seq this
            # record is about to take
            spilled = self._spill_step(job, step)
        job.seq += 1
        fname, digest, fmt = spilled if spilled is not None else (None,) * 3
        rec = {
            "rec": "checkpoint", "job": job.id, "seq": job.seq,
            "stage": step.stage, "index": step.index, "total": step.total,
            "fmt": fmt, "spill": fname, "digest": digest,
            "meta": step.meta, "ts": round(self._clock(), 3),
        }
        self._journal_append(rec)
        job.checkpoints.append(rec)
        self._emit(
            job, "checkpoint",
            {
                "job": job.id, "stage": step.stage, "index": step.index,
                "total": step.total, **step.meta,
            },
        )
        if self._metrics is not None:
            self._metrics.inc_labeled(
                "jobs_checkpoints_total", "job_state", job.state
            )

    def load_checkpoint(self, rec: dict):
        """Journal checkpoint record -> its spilled payload (arrays dict
        or JSON object), None when missing or digest-corrupt."""
        if rec.get("fmt") == "npz":
            return self.spill.load_arrays(rec.get("spill"), rec.get("digest"))
        if rec.get("fmt") == "json":
            return self.spill.load_json(rec.get("spill"), rec.get("digest"))
        return None

    def _record_result(
        self, job: Job, res: Result, fname: str | None = None,
        digest: str | None = None,
    ) -> None:
        if fname is None:
            fname, digest = self.spill.put_result(job.id, res.body)
        job.result = {
            "status": res.status,
            "content_type": res.content_type,
            "spill": fname,
            "digest": digest,
            "size": len(res.body),
        }
        # NOT cached in memory: result bodies are multi-hundred-KB data
        # URLs, and pinning one per retained job for the whole retention
        # window is a slow RAM leak — GET /result re-reads (and
        # digest-verifies) the spill instead
        self._set_state(job, "done")
        # the intermediate checkpoints' spills are dead weight once the
        # result exists; only the result file outlives the job's run
        for rec in job.checkpoints:
            if rec.get("spill"):
                try:
                    os.unlink(os.path.join(self.spill.root, rec["spill"]))
                except OSError:
                    pass

    def _publish(self) -> None:
        if self._metrics is None:
            return
        c = self.counts()
        self._metrics.set_gauge("jobs_active", c["queued"] + c["running"])
        self._metrics.set_gauge("jobs_queued", c["queued"])
        self._metrics.set_gauge("jobs_running", c["running"])
        self._metrics.set_gauge("jobs_parked", c["parked"])

    # ---------------------------------------------------------- runner

    async def _worker(self) -> None:
        while True:
            job_id = await self._queue.get()
            job = self._jobs.get(job_id)
            if job is None or job.state != "queued":
                continue  # cancelled/parked while queued
            if self.draining:
                self._set_state(job, "parked")
                continue
            if (
                job.deadline_ts is not None
                and self._clock() >= job.deadline_ts
            ):
                # queued-but-expired: reaped before it touches a device
                if self._metrics is not None:
                    self._metrics.inc_counter("deadline_expired_total")
                self._set_state(job, "failed", error="deadline_expired")
                continue
            await self._run_job(job)

    async def _run_job(self, job: Job) -> None:
        job.attempts += 1
        self._set_state(job, "running")
        t0 = time.monotonic()
        gen = self._executor(job, list(job.checkpoints), self.load_checkpoint)
        try:
            async for step in gen:
                if isinstance(step, Checkpoint):
                    # the big array write + fsync runs OFF the event
                    # loop; the journal line + event emission stay on it
                    spilled = await asyncio.to_thread(
                        self._spill_step, job, step
                    )
                    self._record_checkpoint(job, step, spilled=spilled)
                    if job.cancel_requested:
                        self._set_state(job, "cancelled")
                        return
                    if self.draining:
                        self._set_state(job, "parked")
                        return
                elif isinstance(step, Result):
                    fname, digest = await asyncio.to_thread(
                        self.spill.put_result, job.id, step.body
                    )
                    self._record_result(job, step, fname, digest)
                    wall = time.monotonic() - t0
                    self._ewma_job_s = (
                        wall
                        if self._ewma_job_s == 0.0
                        else 0.8 * self._ewma_job_s + 0.2 * wall
                    )
                    return
            # executor ended without a Result: a runner bug, not retryable
            self._set_state(job, "failed", error="no_result")
        except asyncio.CancelledError:
            if job.cancel_requested:
                # DELETE cancelled the in-flight device wait
                self._set_state(job, "cancelled")
                if not self._stopping:
                    # the worker itself is alive — swallow and serve the
                    # next job.  Under teardown the SAME CancelledError
                    # may be the stop()'s task cancellation (DELETE and
                    # stop racing on one await deliver only one), and
                    # swallowing it would leave the worker looping while
                    # stop()'s un-timed gather waits forever.
                    return
                raise
            # the worker task is being torn down (stop/drain): park when
            # we can; an un-parked `running` job is reclaimed on boot
            self._set_state(job, "parked")
            raise
        except errors.FaultInjected as e:
            # the jobs.runner_crash site: a simulated runner death, which
            # must exercise the CRASH path (resume from checkpoint), not
            # the deterministic-failure path
            self._crash(job, f"{type(e).__name__}: {e}")
        except errors.BreakerOpen as e:
            if self.draining:
                self._set_state(job, "parked")
                return
            # TRANSIENT by definition: every lane's breaker is cooling
            # and self-heals after its cooldown — re-queue to resume
            # from the last checkpoint after a backoff, burning no
            # attempt (failing the job here would contradict the resume
            # contract; counting an attempt would let one long outage
            # exhaust the crash budget)
            job.resumed = True
            delay = min(float(e.retry_after_s or 1.0), 30.0)
            slog.event(
                _log, "job_breaker_backoff", level=logging.WARNING,
                job=job.id, backoff_s=delay,
            )
            self._set_state(job, "queued", resumed=True, backoff_s=delay)
            # non-blocking requeue (like _crash): sleeping here would
            # stall this worker — and with a small pool, ALL job
            # progress — for the whole cooldown while other queued jobs
            # could be running on healthy lanes
            asyncio.get_running_loop().call_later(
                delay, self._queue.put_nowait, job.id
            )
        except errors.Unavailable as e:
            if self.draining:
                # dispatchers shutting down under a drain is not the
                # job's fault: park for the restart
                self._set_state(job, "parked")
                return
            # a crashed-and-restarting dispatcher task fails in-flight
            # work with `unavailable` — transient, so take the
            # crash-resume path (attempt-bounded) rather than failing
            self._crash(job, f"unavailable: {e.message}")
        except errors.DeconvError as e:
            self._set_state(job, "failed", error=e.code, detail=e.message)
        except Exception as e:  # noqa: BLE001 — crash-resume path
            self._crash(job, f"{type(e).__name__}: {e}")
        finally:
            job._inflight = None
            # close the generator HERE, in the worker's own context —
            # abandoning it to the event loop's asyncgen finalizer would
            # run its cleanup in a foreign context
            try:
                await gen.aclose()
            except Exception:  # noqa: BLE001 — cleanup must not mask
                pass

    def _crash(self, job: Job, why: str) -> None:
        slog.event(
            _log, "job_runner_crash", level=logging.ERROR,
            job=job.id, attempt=job.attempts, error=why,
        )
        if self._metrics is not None:
            self._metrics.inc_counter("jobs_runner_crashes_total")
        if job.attempts >= self.max_attempts:
            self._set_state(job, "failed", error="runner_crash", detail=why)
            return
        job.resumed = True
        # exponential backoff before the resume: an immediate requeue
        # lets a transient device-error burst eat the whole attempt
        # budget in under a second — before a circuit breaker could
        # even open (threshold failures needed); spacing the attempts
        # gives the fault window time to pass
        delay = min(0.25 * (2 ** (job.attempts - 1)), 5.0)
        self._set_state(
            job, "queued", resumed=True, crash=why, backoff_s=delay
        )
        asyncio.get_running_loop().call_later(
            delay, self._queue.put_nowait, job.id
        )
