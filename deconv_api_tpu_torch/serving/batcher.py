"""Batch buckets (counterpart of ``pad_bucket`` in
``deconv_api_tpu/serving/batcher.py`` and of the tail padding in
``deconv_api_tpu/serving/codec_pool.py:assemble``).

A dispatched batch runs at the smallest power-of-two bucket that holds it,
its tail filled with copies of its last image, so the set of program shapes
a server ever captures is bounded (1, 2, 4, 8 at ``max_batch`` 8).  Each
row's result depends on its own image alone, so the padding rows are
computed and dropped.
"""

from __future__ import annotations

import numpy as np


def pad_bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch: bounds the set of
    batch shapes ever captured."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def buckets(max_batch: int) -> list[int]:
    """Every bucket a batch of 1..max_batch images lands in."""
    return sorted({pad_bucket(n, max_batch) for n in range(1, max_batch + 1)})


def pad_to_bucket(xs: np.ndarray, bucket: int) -> np.ndarray:
    """(n, ...) images -> (bucket, ...) float32, the tail filled with the
    last image."""
    xs = np.asarray(xs, dtype=np.float32)
    n = len(xs)
    if not 1 <= n <= bucket:
        raise ValueError(f"{n} images do not fit a bucket of {bucket}")
    if n == bucket:
        return np.ascontiguousarray(xs)
    out = np.empty((bucket, *xs.shape[1:]), np.float32)
    out[:n] = xs
    out[n:] = xs[-1]
    return out
