"""The warm boot: a digest-verified store of the built kernel libraries
(the counterpart of ``deconv_api_tpu/serving/aot.py``).

The JAX package stores serialized XLA executables so that a freshly
scaled-out backend skips its compile storm.  The port compiles no program:
its compiled artifacts are the four ``sm_90a`` kernel libraries that
``ops/_build.py`` builds with ``nvcc`` (about 10 s of wall time on a fresh
checkout, all four in parallel).  This module stores those:

- ``ArtifactStore``: the JAX package's, unchanged.  One ``<key>.aot`` file
  per artifact under ``aot_dir``, written through ``durable.atomic_write``
  (tmp, fsync, rename, directory fsync) under the ``aot.store`` frame
  (format, version, length and blake2b digest of the payload; a file is
  byte-identical to the one the JAX package writes for the same key and
  payload).  Any defect (a torn header, a short body, a digest mismatch)
  deletes the file and reads as a miss; a future version reads as a miss
  and is left in place.  An mtime-LRU byte budget, the counters
  ``aot_cache_{hits,misses,stores,corrupt,errors,sweeps}_total`` and the
  gauges ``aot_store_resident_bytes`` and ``aot_store_entries``.  A failed
  write is counted on the best-effort ``aot.store`` durable surface.

- ``KernelResolver``: where a kernel library's bytes come from, in place
  of the JAX package's ``AotExecutor``.  Its key (``artifact_digest``)
  covers the kernel's name, its source's digest, ``NVCC_FLAGS``, ``nvcc
  --version``, the card's compute capability and torch's and CUDA's
  versions, so two builds that could differ never share a key.  A hit is
  written to ``ops/_build.library_path(name)`` (tmp and rename) and loaded
  with ``ctypes``, and counts as a hit once the load succeeds; a miss, or
  a stored payload that fails to load (invalidated and counted corrupt),
  is built with ``nvcc`` as without a store, then stored; the build is
  forced, so a library already in the build directory (which may be
  another toolchain's) is rebuilt, never stored under this key.  Each
  resolution counts one hit or one miss.  There is no fallback: a build
  that fails raises as it does without a store.

``ops/_build.py`` imports nothing of ``serving/``: the service sets the
resolver on ``_build.resolver`` at boot when ``aot_dir`` is set, and
``_build.load`` asks it for a library before it would run ``nvcc``.

The store trusts its directory as the build directory is trusted: a
stored library is loaded into the process, so point ``aot_dir`` at
storage the operator controls (a shared volume is the build-once,
boot-warm-everywhere deployment), never at a world-writable path.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import re
import subprocess
import threading
from pathlib import Path

from deconv_api_tpu_torch.serving import durable
from deconv_api_tpu_torch.utils import slog

_log = slog.get_logger("deconv.aot")

_KEY_RE = re.compile(r"^[0-9a-f]{16,128}$")
_FORMAT = "aot.store"
_VERSION = 1


def artifact_digest(meta: dict) -> str:
    """Canonical digest of an artifact's identity metadata, its address
    in the store.  Everything that decides the artifact's bytes must ride
    ``meta``: two artifacts that could differ must never share one."""
    blob = json.dumps(meta, sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


class ArtifactStore:
    """Durable artifact files under ``root`` (see the module docstring).
    Thread-safe."""

    def __init__(self, root: str, max_bytes: int = 0, *, metrics=None):
        self.root = root
        self.max_bytes = int(max_bytes)
        self._metrics = metrics
        # best-effort surface: a failed write degrades to a rebuild,
        # counted through the durable families
        self.surface = durable.Surface("aot.store", metrics=metrics)
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)
        # stale .tmp from a crashed writer: the boot sweep
        durable.sweep_tmp(root)
        self._resident = 0
        self._entries = 0
        for fn in self._listdir():
            path = os.path.join(self.root, fn)
            if fn.endswith(".aot"):
                try:
                    self._resident += os.stat(path).st_size
                    self._entries += 1
                except OSError:
                    pass
        self._publish()

    def _listdir(self) -> list[str]:
        try:
            return os.listdir(self.root)
        except OSError:
            return []

    def _count(self, name: str, n: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.inc_counter(name, n)

    def _publish(self) -> None:
        if self._metrics is not None:
            self._metrics.set_gauge("aot_store_resident_bytes", self._resident)
            self._metrics.set_gauge("aot_store_entries", self._entries)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".aot")

    @property
    def entry_count(self) -> int:
        with self._lock:
            return self._entries

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident

    def get(self, key: str) -> bytes | None:
        """The verified payload, or None.  Corruption in any form deletes
        the file and counts ``aot_cache_corrupt_total`` on top of the
        miss; it never raises and never returns wrong bytes."""
        if not _KEY_RE.match(key):
            return None
        path = self._path(key)
        raw = durable.read_bytes(path, "aot.store")
        if raw is None:
            # absent (or an injected EIO): the resolver counts the miss,
            # one per resolution, not one per probe
            return None
        try:
            framed = durable.unframe(raw, _FORMAT, _VERSION)
        except durable.FutureVersionError:
            # a newer binary's artifact reads as a miss and is left alone
            return None
        if framed is None:
            slog.event(_log, "aot_corrupt_artifact", level=logging.WARNING, key=key)
            self.invalidate(key)
            self._count("aot_cache_corrupt_total")
            return None
        _meta, body = framed
        try:
            # recency survives restarts: the budget sweep is mtime-LRU
            os.utime(path)
        except OSError:
            pass
        # not counted as a hit here: a digest-valid payload can still fail
        # to load, so the resolver counts the hit once it has loaded, and
        # hits + misses is the number of resolutions
        return body

    def put(self, key: str, payload: bytes) -> bool:
        """Store one artifact (tmp, fsync, rename); sweeps the oldest
        entries past the byte budget.  Returns whether it was stored (one
        larger than the whole budget is not)."""
        if not _KEY_RE.match(key):
            return False
        data = durable.frame(_FORMAT, _VERSION, payload)
        if self.max_bytes and len(data) > self.max_bytes:
            return False
        # best-effort: a failed write counts into the durable families and
        # flips durable_degraded{surface="aot.store"} once per episode
        if not durable.atomic_write(self._path(key), data, surface=self.surface):
            return False
        self._count("aot_cache_stores_total")
        self._resweep()
        return True

    def invalidate(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass
        self._resweep(count_sweeps=False)

    def _resweep(self, count_sweeps: bool = True) -> None:
        """Re-derive the ledger from the directory and enforce the byte
        budget, oldest mtime first (a stat walk per write: one write per
        artifact per process lifetime)."""
        entries: list[tuple[float, str, int]] = []
        for fn in self._listdir():
            if not fn.endswith(".aot"):
                continue
            path = os.path.join(self.root, fn)
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, fn, st.st_size))
        entries.sort()
        total = sum(size for _mt, _fn, size in entries)
        swept = 0
        while self.max_bytes and total > self.max_bytes and len(entries) > 1:
            _mt, fn, size = entries.pop(0)
            try:
                os.unlink(os.path.join(self.root, fn))
            except OSError:
                pass
            total -= size
            swept += 1
        if swept and count_sweeps:
            self._count("aot_cache_sweeps_total", swept)
        with self._lock:
            self._resident = total
            self._entries = len(entries)
        self._publish()


def toolchain_identity(store: ArtifactStore) -> dict:
    """What of the machine decides a kernel library's bytes: ``nvcc
    --version``, the card's compute capability and torch's and CUDA's
    versions.  The ``nvcc --version`` text is kept beside the store,
    under the nvcc binary's path, size and mtime, so that a boot against
    a filled store starts no nvcc process at all."""
    import torch

    from deconv_api_tpu_torch.ops import _build

    nvcc = _build.nvcc()
    st = os.stat(nvcc)
    tag = hashlib.blake2b(f"{os.path.realpath(nvcc)}:{st.st_size}:{st.st_mtime_ns}".encode(),
                          digest_size=8).hexdigest()
    memo = os.path.join(store.root, f"nvcc-{tag}.version")
    try:
        with open(memo) as f:
            version = f.read()
    except OSError:
        version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True).stdout
        durable.atomic_write(memo, version.encode(), surface=store.surface)
    return {"nvcc": version, "capability": list(torch.cuda.get_device_capability()),
            "torch": torch.__version__, "cuda": torch.version.cuda}


class KernelResolver:
    """Resolve kernel libraries through an ``ArtifactStore`` (see the
    module docstring).  One loaded library per name and process; the
    resolution is locked, so concurrent first launches resolve once.

    ``build`` (names, force -> seconds per kernel built), ``library_path``,
    ``source`` (name -> the source's bytes), ``load`` (path -> library)
    and ``toolchain`` (the machine's identity) default to
    ``ops/_build.py``'s nvcc build and ``ctypes``; tests inject others."""

    def __init__(self, store: ArtifactStore, *, metrics=None, build=None, library_path=None, source=None,
                 load=None, toolchain=None):
        from deconv_api_tpu_torch.ops import _build

        self.store = store
        self._metrics = metrics
        self._build = build or _build.build
        self._library_path = library_path or _build.library_path
        self._source = source or (lambda name: (_build.CSRC / f"{name}.cu").read_bytes())
        self._load = load or (lambda path: ctypes.CDLL(str(path)))
        self._toolchain = toolchain or (lambda: toolchain_identity(store))
        self._flags = _build.NVCC_FLAGS
        self._machine: dict | None = None
        self._lock = threading.Lock()
        self.loaded: dict[str, object] = {}
        # per kernel: 'hit' or 'miss', and the nvcc seconds of each miss
        self.outcomes: dict[str, str] = {}
        self.build_seconds: dict[str, float] = {}

    def _count(self, name: str, n: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.inc_counter(name, n)

    def key(self, name: str) -> str:
        """The store key of kernel ``name`` on this machine."""
        if self._machine is None:
            self._machine = self._toolchain()
        return artifact_digest({
            "kernel": name,
            "source": hashlib.sha256(self._source(name)).hexdigest(),
            "flags": list(self._flags),
            **self._machine,
        })

    def library(self, name: str):
        """The loaded library ``name``, resolved on its first call."""
        lib = self.loaded.get(name)
        return lib if lib is not None else self.resolve([name])[name]

    def resolve(self, names) -> dict:
        """Resolve every library of ``names`` not loaded yet: the stored
        ones are written and loaded, the others built together (one
        ``nvcc`` each, all started at once) and stored.  Returns name ->
        library; raises if a build fails."""
        with self._lock:
            todo = [n for n in names if n not in self.loaded]
            keys = {n: self.key(n) for n in todo}
            missed = []
            for name in todo:
                payload = self.store.get(keys[name])
                lib = self._install(name, keys[name], payload) if payload is not None else None
                if lib is None:
                    missed.append(name)
                    continue
                self._count("aot_cache_hits_total")
                self.loaded[name] = lib
                self.outcomes[name] = "hit"
            if missed:
                self._count("aot_cache_misses_total", len(missed))
                for name in missed:
                    self.outcomes[name] = "miss"
                # forced: a library already at its path (an earlier build
                # in this checkout, maybe by another toolchain) is not
                # what the key names, so it is never what gets stored
                self.build_seconds.update(self._build(missed, force=True))
                for name in missed:
                    path = self._library_path(name)
                    self.loaded[name] = self._load(path)
                    self.store.put(keys[name], Path(path).read_bytes())
            if todo:
                slog.event(_log, "aot_resolved", hits=len(todo) - len(missed), misses=len(missed),
                           kernels=",".join(todo))
            return {n: self.loaded[n] for n in names}

    def _install(self, name: str, key: str, payload: bytes):
        """Write a stored library where the build would put it (tmp and
        rename) and load it; None, with the entry invalidated and counted
        corrupt, if it does not load."""
        path = Path(self._library_path(name))
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            tmp.write_bytes(payload)
            os.replace(tmp, path)
            return self._load(path)
        except Exception as e:  # noqa: BLE001 — any defect: invalidate and rebuild
            slog.event(_log, "aot_load_error", level=logging.WARNING, key=key, kernel=name,
                       error=f"{type(e).__name__}: {e}")
            self.store.invalidate(key)
            self._count("aot_cache_corrupt_total")
            path.unlink(missing_ok=True)
            return None
