"""One durable-write layer for every persistence surface (a copy of
``deconv_api_tpu/serving/durable.py``; the port's surfaces are the L2
response cache, ``cache.l2``, the alert engine's incident bundles,
``alerts.incidents``, the job tier's ``jobs.journal`` and ``jobs.spill``,
the fleet's ``fleet.membership``, the kernel-library store,
``aot.store``, and the autoscaler's decisions, ``autoscale.journal``).

- **One write idiom.**  ``atomic_write`` (tmp + fsync + rename +
  directory fsync) for whole-file artifacts, ``append_bytes`` (write +
  flush + fsync) for journals, ``frame``/``unframe`` for the versioned
  ``{format, version, len, digest}`` header every binary artifact
  carries, and ``sweep_tmp`` for the boot-time ``.tmp`` debris sweep.
  Reads verify the blake2b digest; ANY defect reads as absent, never as
  an error or as wrong bytes.  The frame format is the JAX package's, so
  either package reads the other's artifacts.

- **A declared degradation contract per surface.**  ``SURFACES`` names
  the JAX package's eight surfaces and splits them into ``best_effort``
  (a failed write degrades to a counted no-op: the tier is an
  optimisation and must never fail a request) and ``fail_loud`` (the
  write raises ``DurableWriteError`` and the caller answers 503).  A
  future-version header is fail-static under the same split: best-effort
  surfaces read it as absent.  The ``Surface`` state machine counts
  ``durable_write_errors_total{surface=}`` and flips
  ``durable_degraded{surface=}`` ONCE per failure episode (one log
  line, not one per request), clearing on the next success.

- **Armable filesystem faults.**  Every write consults the ``fs.*``
  fault sites (serving/faults.py) with ``who=<surface>``, so
  ``fs.enospc=p1@cache.l2`` starves exactly one surface:

  - ``fs.enospc``       — the write raises ENOSPC before any byte lands
  - ``fs.eio_read``     — a read raises EIO (reads as absent)
  - ``fs.short_write``  — the write silently truncates (torn artifact;
                          the digest catches it at read time)
  - ``fs.fsync_error``  — fsync raises EIO (data may be in the page
                          cache but is NOT durable)
  - ``fs.crash_point``  — SIGKILL this process at a numbered crashpoint
                          (``:param`` selects the point, see CRASH_*)

  The crash points are the instants a real crash distinguishes:
  before anything (1/5), after the data is written but before fsync
  (2/6), after fsync but before rename (3), after rename but before
  the directory fsync (4), and after a journal append's fsync (7).
"""

from __future__ import annotations

import errno
import hashlib
import json
import logging
import os
import signal
import threading

from deconv_api_tpu_torch.serving import faults
from deconv_api_tpu_torch.utils import slog

_log = slog.get_logger("deconv.durable")

BEST_EFFORT = "best_effort"
FAIL_LOUD = "fail_loud"

# The eight declared persistence surfaces and their degradation
# contract.  A Surface for an unlisted name is a programming error —
# every store must declare which side of the split it is on.
SURFACES = {
    "jobs.journal": FAIL_LOUD,
    "jobs.spill": FAIL_LOUD,
    "fleet.membership": FAIL_LOUD,
    "autoscale.journal": FAIL_LOUD,
    "cache.l2": BEST_EFFORT,
    "aot.store": BEST_EFFORT,
    "alerts.incidents": BEST_EFFORT,
    "quant.calib": BEST_EFFORT,
}

# sanity bound on a framed artifact's header line: a corrupt file whose
# first newline is megabytes in must read as corrupt, not
# allocate-and-parse
HEADER_MAX = 4096

# fs.crash_point crashpoint ids (the ``:param`` selector, matched
# against the consult's ``where=`` exactly like lane targeting)
CRASH_ATOMIC_PRE = 1        # before the tmp file exists
CRASH_ATOMIC_WRITTEN = 2    # tmp written, not fsynced
CRASH_ATOMIC_FSYNCED = 3    # tmp fsynced, not renamed
CRASH_ATOMIC_RENAMED = 4    # renamed, directory not fsynced
CRASH_APPEND_PRE = 5        # before the journal write
CRASH_APPEND_WRITTEN = 6    # bytes written, not fsynced
CRASH_APPEND_FSYNCED = 7    # append fully durable
ATOMIC_CRASH_POINTS = (1, 2, 3, 4)
APPEND_CRASH_POINTS = (5, 6, 7)


class DurableWriteError(OSError):
    """A fail-loud surface could not make a write durable.  Subclasses
    OSError so pre-existing ``except OSError`` contracts (the jobs
    submit rollback) keep holding."""

    def __init__(self, surface: str, op: str, cause: BaseException):
        super().__init__(
            getattr(cause, "errno", None) or errno.EIO,
            f"durable {op} failed on {surface}: "
            f"{type(cause).__name__}: {cause}",
        )
        self.surface = surface
        self.op = op


class FutureVersionError(ValueError):
    """An artifact's header declares a LATER format version than this
    binary supports.  Fail-static per the surface's contract:
    best-effort surfaces catch it and read the artifact as absent; the
    jobs journal lets it propagate and refuses boot."""

    def __init__(self, fmt: str, version: int, supported: int):
        super().__init__(
            f"{fmt} artifact is version {version}; this binary supports "
            f"<= {supported} (rolling upgrade? refuse rather than misparse)"
        )
        self.format = fmt
        self.version = version
        self.supported = supported


def digest(data: bytes) -> str:
    """The one content digest every surface shares (blake2b-128)."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def _crash() -> None:
    # SIGKILL, not sys.exit: the torture drill's contract is that NO
    # cleanup runs — atexit handlers, finally blocks and buffered
    # writes all die with the process, exactly like a power cut
    os.kill(os.getpid(), signal.SIGKILL)


# monkeypatchable in unit tests (tests assert WHERE the crash would
# have landed without killing the test runner)
_CRASH_HOOK = _crash


def _maybe_crash(surface: str, point: int) -> None:
    if faults.check("fs.crash_point", where=point, who=surface) is not None:
        slog.event(
            _log, "fs_crash_point", level=logging.ERROR,
            surface=surface, point=point,
        )
        _CRASH_HOOK()


def _fault_enospc(surface: str) -> None:
    if faults.check("fs.enospc", who=surface) is not None:
        raise OSError(errno.ENOSPC, f"injected fault at fs.enospc@{surface}")


def _fault_fsync(surface: str) -> None:
    if faults.check("fs.fsync_error", who=surface) is not None:
        raise OSError(
            errno.EIO, f"injected fault at fs.fsync_error@{surface}"
        )


def _maybe_short(surface: str, data: bytes) -> bytes:
    if faults.check("fs.short_write", who=surface) is not None:
        # a silent partial write: the writer believes it succeeded, the
        # digest catches the lie at read time
        return data[: max(1, len(data) // 2)]
    return data


class Surface:
    """Degraded-state machine for one named persistence surface.

    Counts every failed durable write into ``durable_write_errors_total
    {surface=}`` and flips ``durable_degraded{surface=}`` ONCE per
    failure episode (one ERROR log at the flip, silence until the next
    success clears it) — a persistently failing disk moves two metrics,
    not one log line per request.  ``fail_loud`` surfaces additionally
    raise ``DurableWriteError`` from ``record_error``."""

    def __init__(self, name: str, *, metrics=None):
        if name not in SURFACES:
            raise ValueError(
                f"undeclared durable surface {name!r}; "
                f"known: {', '.join(sorted(SURFACES))}"
            )
        self.name = name
        self.policy = SURFACES[name]
        self._metrics = metrics
        self._lock = threading.Lock()
        self._degraded = False
        self.write_errors = 0
        if metrics is not None:
            # present at zero from the first scrape: a dashboard query
            # for a healthy surface finds 0, not absence
            metrics.inc_labeled(
                "durable_write_errors_total", "surface", name, 0
            )
            metrics.set_labeled_gauge("durable_degraded", "surface", name, 0)

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def record_error(self, op: str, e: BaseException) -> None:
        with self._lock:
            self.write_errors += 1
            flipped = not self._degraded
            self._degraded = True
        if self._metrics is not None:
            self._metrics.inc_labeled(
                "durable_write_errors_total", "surface", self.name
            )
            if flipped:
                self._metrics.set_labeled_gauge(
                    "durable_degraded", "surface", self.name, 1
                )
        if flipped:
            slog.event(
                _log, "durable_degraded", level=logging.ERROR,
                surface=self.name, policy=self.policy, op=op,
                error=f"{type(e).__name__}: {e}",
            )
        if self.policy == FAIL_LOUD:
            raise DurableWriteError(self.name, op, e) from e

    def record_ok(self) -> None:
        with self._lock:
            cleared = self._degraded
            self._degraded = False
        if cleared:
            if self._metrics is not None:
                self._metrics.set_labeled_gauge(
                    "durable_degraded", "surface", self.name, 0
                )
            slog.event(_log, "durable_recovered", surface=self.name)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "policy": self.policy,
                "degraded": self._degraded,
                "write_errors": self.write_errors,
            }


def register_metrics(metrics, surfaces=None) -> None:
    """Pre-register the durable families at zero for every declared
    surface (the server does this at boot so the exposition is
    present-at-zero even for surfaces whose store is not configured)."""
    for name in surfaces or SURFACES:
        metrics.inc_labeled("durable_write_errors_total", "surface", name, 0)
        metrics.set_labeled_gauge("durable_degraded", "surface", name, 0)


# ------------------------------------------------------------- writes


def _fsync_dir(path: str) -> None:
    # the rename is not durable until the DIRECTORY entry is: a crash
    # after rename but before this can resurrect the old file
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return  # platforms/filesystems without dir-open semantics
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(
    path: str, data: bytes, *, surface: Surface, fsync_dir: bool = True
) -> bool:
    """Whole-file durable write: tmp + fsync + rename + dir-fsync.

    Returns True on success.  On failure: a best-effort surface counts
    the error, flips its degraded gauge once, removes the tmp half and
    returns False; a fail-loud surface raises ``DurableWriteError``.
    A crash at any armed ``fs.crash_point`` leaves either the old
    complete file or the new complete file plus at most one ``.tmp``
    the next boot sweeps — never a torn ``path``."""
    name = surface.name
    tmp = path + ".tmp"
    try:
        _maybe_crash(name, CRASH_ATOMIC_PRE)
        _fault_enospc(name)
        payload = _maybe_short(name, data)
        with open(tmp, "wb") as f:
            f.write(payload)
            _maybe_crash(name, CRASH_ATOMIC_WRITTEN)
            f.flush()
            _fault_fsync(name)
            os.fsync(f.fileno())
        _maybe_crash(name, CRASH_ATOMIC_FSYNCED)
        os.replace(tmp, path)
        _maybe_crash(name, CRASH_ATOMIC_RENAMED)
        if fsync_dir:
            _fsync_dir(os.path.dirname(path))
    except OSError as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        surface.record_error("atomic_write", e)  # raises when fail_loud
        return False
    surface.record_ok()
    return True


def append_bytes(f, data: bytes, *, surface: Surface) -> bool:
    """Durable journal append against an open binary handle: write +
    flush + fsync.  Same failure contract as ``atomic_write``; a torn
    tail from a crash or short write is the REPLAY side's problem
    (both journals tolerate it by construction)."""
    name = surface.name
    try:
        _maybe_crash(name, CRASH_APPEND_PRE)
        _fault_enospc(name)
        f.write(_maybe_short(name, data))
        _maybe_crash(name, CRASH_APPEND_WRITTEN)
        f.flush()
        _fault_fsync(name)
        os.fsync(f.fileno())
        _maybe_crash(name, CRASH_APPEND_FSYNCED)
    except OSError as e:
        surface.record_error("append", e)  # raises when fail_loud
        return False
    surface.record_ok()
    return True


# -------------------------------------------------------------- reads


def read_bytes(path: str, surface: str) -> bytes | None:
    """The file's bytes, or None when absent or unreadable (EIO reads
    as absent by contract — corruption and disk failure degrade to a
    miss, never an exception on the serving path).  ``surface`` is the
    consulting identity for ``fs.eio_read``."""
    if faults.check("fs.eio_read", who=surface) is not None:
        slog.event(
            _log, "fs_eio_read", level=logging.WARNING,
            surface=surface, path=os.path.basename(path),
        )
        return None
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


# ------------------------------------------------------------ framing


def frame(fmt: str, version: int, payload: bytes, extra: dict | None = None) -> bytes:
    """One framed artifact: a JSON header line ``{"format", "version",
    "len", "digest", **extra}`` followed by the raw payload bytes.
    JSON-document artifacts (membership, calibration) carry the same
    two keys in-document instead — one vocabulary, two carriers."""
    head = {
        "format": fmt,
        "version": int(version),
        "len": len(payload),
        "digest": digest(payload),
    }
    if extra:
        head.update(extra)
    return json.dumps(head, separators=(",", ":")).encode() + b"\n" + payload


def unframe(
    data: bytes, fmt: str, version: int
) -> tuple[dict, bytes] | None:
    """``(header, payload)`` for a verified framed artifact; None for
    ANY defect (torn header, wrong format, length or digest mismatch).
    Raises ``FutureVersionError`` when the header parses cleanly but
    declares a later version — the version check runs BEFORE the digest
    check because a future format may hash differently."""
    head, sep, body = data.partition(b"\n")
    if not sep or len(head) > HEADER_MAX:
        return None
    try:
        meta = json.loads(head)
    except ValueError:
        return None
    if not isinstance(meta, dict) or meta.get("format") != fmt:
        return None
    v = meta.get("version")
    if not isinstance(v, int):
        return None
    if v > version:
        raise FutureVersionError(fmt, v, version)
    if meta.get("len") != len(body) or meta.get("digest") != digest(body):
        return None
    return meta, body


def read_framed(
    path: str, fmt: str, version: int, *, surface: str
) -> tuple[dict, bytes] | None:
    """``read_bytes`` + ``unframe`` with best-effort future-version
    handling folded in: a future version reads as absent (logged once
    per file at WARNING).  Fail-loud boot paths call ``unframe``
    directly so ``FutureVersionError`` propagates."""
    data = read_bytes(path, surface)
    if data is None:
        return None
    try:
        return unframe(data, fmt, version)
    except FutureVersionError as e:
        slog.event(
            _log, "durable_future_version", level=logging.WARNING,
            surface=surface, path=os.path.basename(path), error=str(e),
        )
        return None


# ------------------------------------------------------------- sweeps


def sweep_tmp(root: str) -> int:
    """Uniform boot-time debris sweep: unlink every ``*.tmp`` directly
    under ``root`` (the half-written leavings of a writer that died
    between open and rename).  Every store calls this exactly once at
    boot; returns how many were shed."""
    removed = 0
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    for fn in names:
        if not fn.endswith(".tmp"):
            continue
        try:
            os.unlink(os.path.join(root, fn))
            removed += 1
        except OSError:
            pass
    if removed:
        slog.event(_log, "tmp_sweep", root=root, removed=removed)
    return removed


def sweep_tmp_file(path: str) -> int:
    """Single-file variant for artifacts that live in a SHARED
    user-provided directory (the membership file): sweeps only
    ``<path>.tmp`` so a sibling application's files are never touched."""
    try:
        os.unlink(path + ".tmp")
        return 1
    except OSError:
        return 0


# ------------------------------------------------------------ journal


class Journal:
    """Append-only fsync'd JSONL with a versioned header record,
    torn-tail-tolerant replay, and atomic compaction — the shared body
    of the jobs journal and the autoscale decision journal.

    The first record of a fresh file is ``{"format": <fmt>, "version":
    N}`` (written durably WITH the first data record); a legacy
    headerless file replays as version 1.  ``replay`` raises
    ``FutureVersionError`` on a later version — the caller decides
    whether that refuses boot (jobs) or aborts the tool (autoscale)."""

    def __init__(
        self, path: str, surface: Surface, *, fmt: str | None = None,
        version: int = 1,
    ):
        self.path = path
        self.surface = surface
        self.fmt = fmt or surface.name
        self.version = int(version)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # a crashed compaction leaves <path>.tmp; shed it before the
        # first append can race it
        sweep_tmp_file(path)
        self._f = None
        self._lock = threading.Lock()

    def _header_line(self) -> bytes:
        return json.dumps(
            {"format": self.fmt, "version": self.version},
            separators=(",", ":"),
        ).encode() + b"\n"

    def _handle(self):
        if self._f is None or self._f.closed:
            self._f = open(self.path, "ab")
        return self._f

    def append(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":")).encode() + b"\n"
        with self._lock:
            f = self._handle()
            if f.tell() == 0:
                line = self._header_line() + line
            append_bytes(f, line, surface=self.surface)

    def close(self) -> None:
        with self._lock:
            if self._f is not None and not self._f.closed:
                try:
                    self._f.close()
                except OSError:
                    pass

    def rewrite(self, records: list[dict]) -> None:
        """Compaction: atomically replace the journal (header first) so
        a crash mid-compaction leaves either the old journal or the new
        one, never a mix."""
        body = self._header_line() + b"".join(
            json.dumps(rec, separators=(",", ":")).encode() + b"\n"
            for rec in records
        )
        with self._lock:
            if self._f is not None and not self._f.closed:
                self._f.close()
            atomic_write(self.path, body, surface=self.surface)

    @staticmethod
    def replay(
        path: str, fmt: str, version: int = 1
    ) -> tuple[list[dict], int]:
        """(decodable data records in order, undecodable line count).
        A torn final record — the crash-mid-append case — is skipped,
        never fatal: the preceding fsync'd edge is the recovered state.
        Header records are validated and excluded from the result."""
        if not os.path.exists(path):
            return [], 0
        records: list[dict] = []
        torn = 0
        with open(path, "rb") as f:
            for raw in f.read().split(b"\n"):
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    rec = json.loads(raw)
                except ValueError:
                    torn += 1
                    continue
                if not isinstance(rec, dict):
                    torn += 1
                    continue
                if "format" in rec and "version" in rec and len(rec) == 2:
                    v = rec.get("version")
                    if (
                        rec.get("format") == fmt
                        and isinstance(v, int)
                        and v > version
                    ):
                        raise FutureVersionError(fmt, v, version)
                    continue  # header record, not data
                records.append(rec)
        return records, torn
