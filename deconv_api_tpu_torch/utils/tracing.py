"""Profiling hook (counterpart of ``deconv_api_tpu/utils/tracing.py``'s
``profile_trace``): a ``torch.profiler`` scope whose trace lands in a
directory as a Chrome trace (``chrome://tracing``, Perfetto), with the
card's kernels (CUDA activity, through CUPTI) beside the host's ops where
there is a card.  A captured CUDA graph's replay shows its kernels one by
one.  The serving stage spans are ``serving/app.py:stage``."""

from __future__ import annotations

import contextlib
import os
import time

import torch

def _activities() -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


def prime_profiler() -> None:
    """Start and stop ``torch.profiler`` once on the calling thread.  The
    first start registers the profiler's client on its thread, which later
    starts on other threads (the dispatchers') need, and pays CUPTI's slow
    first initialisation here rather than inside a traced batch."""
    from torch.profiler import profile

    with profile(activities=_activities()):
        pass


@contextlib.contextmanager
def profile_trace(profile_dir: str):
    """Trace the scope into ``profile_dir`` as
    ``trace-<pid>-<ns>.pt.trace.json``; inert when ``profile_dir`` is
    empty.  The trace is written when the scope ends, also on an error."""
    if not profile_dir:
        yield
        return
    from torch.profiler import profile

    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=_activities())
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(profile_dir, f"trace-{os.getpid()}-{time.time_ns()}.pt.trace.json"))
