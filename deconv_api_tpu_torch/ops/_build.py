"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` for ``sm_90a``,
into a shared library with a plain C interface under
``build/torch_kernels/`` in the checkout.  The library's file name carries
a hash of its source and flags, so an edited source rebuilds and an
unchanged one loads at once.  ``build()`` starts one ``nvcc`` per source,
all together.

Nothing here runs at import: this module, like the wrappers, imports on a
machine with no ``nvcc``; only a kernel's first launch needs one.

``resolver`` is the one seam of the warm boot: a service booted with
``aot_dir`` sets it to a ``serving/aot.py:KernelResolver``, and ``load``
then takes each library from it (a stored copy, else its nvcc build,
stored) instead of building it here.  Unset, nothing changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

KERNELS = ("pool_argmax", "unpool_argmax", "fused_unpool_conv", "conv_q8")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# where load() takes a library from when set: an object whose
# library(name) returns it loaded (serving/aot.py:KernelResolver)
resolver = None
# nvcc's output (ptxas register and spill lines) from this process's builds
build_logs: dict[str, str] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels build on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=KERNELS, force: bool = False) -> dict[str, float]:
    """Compile every named kernel whose library is missing (every one with
    ``force``: the file there may be another toolchain's), one ``nvcc``
    per source, all started together; each lands by rename, so a reader
    sees an old library or a new one, whole.  Returns seconds per kernel
    built; raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists() and not force:
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, target, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, target, t0) in started.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed, with ``argtypes``
    set from ``signatures`` (entry -> ctypes argument types).  Every
    entry returns ``cudaGetLastError()`` as an int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if resolver is not None:
                lib = resolver.library(name)
            else:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
            for entry, argtypes in signatures.items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc} launching {what}")
