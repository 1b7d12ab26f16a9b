"""Int8 execution-tier calibration (counterpart of
``deconv_api_tpu/engine/quant.py``): per-layer activation ranges as a
digest-addressed artifact.

``quality=int8`` runs the forward walk with each conv and dense layer's
input quantized to symmetric int8, the contraction int8 x int8 -> int32 on
the card's int8 kernel (``ops/cuda_q8.py``), the bias folded into the
accumulator and one dequantisation per layer (``engine/deconv.py:
_up_step_q8``).  A layer's input scale comes either from a calibration
artifact, the per-layer input max-abs over a set of images
(``collect_ranges``), stored one JSON file per model under a calibration
directory with a content digest verified on load, or, with no artifact,
from each example's own max-abs (``DYNAMIC``), per example and never per
batch, so a request's bytes never depend on what it was batched with.
Kernel scales are per tensor, from the weights, with the weight tier's
amax -> scale rule (``utils/quantize.py``).

The artifact's bytes are the JAX package's: the same ranges give the same
digest and the same file, and a file written by either package loads in
the other.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from deconv_api_tpu_torch.serving import durable
from deconv_api_tpu_torch.utils.quantize import Q8_LEVELS, int8_scale

__all__ = [
    "DYNAMIC",
    "Q8_LEVELS",
    "QUALITY_TIERS",
    "collect_ranges",
    "int8_scale",
    "load_calibration",
    "quant_spec",
    "ranges_digest",
    "save_calibration",
]

# The per-request quality vocabulary: 'full' is the server's configured
# fidelity, 'bf16' stages the forward in bfloat16, 'int8' runs the quantized
# walk.
QUALITY_TIERS = ("full", "bf16", "int8")

# The quant spec with no calibration artifact: scales computed in the
# program, per example.
DYNAMIC = "dynamic"

_CALIB_VERSION = 1


def _canonical_ranges(ranges: dict) -> dict[str, float]:
    """Ranges in their serialized form: sorted keys, values rounded to
    float32, so the artifact's bytes and digest are the same on every run
    and host."""
    return {str(k): float(np.float32(v)) for k, v in sorted(ranges.items())}


def ranges_digest(ranges: dict) -> str:
    """Content digest of a range set: it addresses the artifact and rides
    the response-cache key of ``quality=int8``."""
    blob = json.dumps(_canonical_ranges(ranges), sort_keys=True, separators=(",", ":")).encode()
    return hashlib.blake2b(blob, digest_size=12).hexdigest()


@torch.no_grad()
def collect_ranges(spec, params, images, *, layer: str | None = None, batch: int = 8) -> dict:
    """Per-layer input max-abs of every conv and dense entry of ``spec``'s
    forward walk (up to ``layer``, default the last) over ``images``, an
    iterable of (H, W, C) preprocessed float arrays, run ``batch`` at a
    time on the device of ``params``.

    The walk is the visualizer's own entry chain and ``_up_step``, so a
    calibrated entry name is always the one the quantized walk looks up.
    It runs in full precision, and a range is the maximum over the images,
    so a fixed image set gives the same artifact every time."""
    from deconv_api_tpu_torch.engine.deconv import _up_step
    from deconv_api_tpu_torch.models.spec import entry_chain

    entries = entry_chain(spec.truncated(layer or spec.layers[-1].name))
    device = next(iter(next(iter(params.values())).values())).device
    ranges: dict[str, float] = {}
    images = list(images)
    for i in range(0, len(images), batch):
        x = torch.as_tensor(np.stack(images[i:i + batch]), dtype=torch.float32).to(device)
        switches: dict = {}
        for e in entries:
            if not e.is_companion_act and e.layer.kind in ("conv", "dense"):
                a = float(x.abs().max())
                if e.name not in ranges or a > ranges[e.name]:
                    ranges[e.name] = a
            x = _up_step(e, params, x, switches)
    return _canonical_ranges(ranges)


def save_calibration(
    calib_dir: str,
    model: str,
    ranges: dict,
    *,
    image_size: int = 0,
    n_images: int = 0,
    source: str = "",
    metrics=None,
) -> tuple[str, str]:
    """Write one model's artifact, ``<calib_dir>/<model>.calib.json``,
    through ``serving/durable.py`` (tmp, fsync, rename, directory fsync)
    and return ``(path, digest)``.  Best effort: a failed write is counted
    under ``durable_write_errors_total{surface="quant.calib"}`` and the
    artifact reads as absent (the server uses dynamic ranges)."""
    os.makedirs(calib_dir, exist_ok=True)
    durable.sweep_tmp(calib_dir)
    canon = _canonical_ranges(ranges)
    digest = ranges_digest(canon)
    payload = {
        "format": "quant.calib",
        "version": _CALIB_VERSION,
        "v": _CALIB_VERSION,
        "model": model,
        "image_size": int(image_size),
        "n_images": int(n_images),
        "source": source,
        "ranges": canon,
        "digest": digest,
    }
    path = os.path.join(calib_dir, f"{model}.calib.json")
    data = json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
    durable.atomic_write(path, data, surface=durable.Surface("quant.calib", metrics=metrics))
    return path, digest


def load_calibration(calib_dir: str, model: str) -> dict | None:
    """One model's verified artifact, or None: a missing, torn,
    digest-mismatched or future-version file reads as absent, never as an
    error (calibration improves accuracy; it must not fail requests)."""
    path = os.path.join(calib_dir, f"{model}.calib.json")
    raw = durable.read_bytes(path, "quant.calib")
    if raw is None:
        return None
    try:
        payload = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(payload, dict):
        return None
    version = payload.get("version", payload.get("v"))
    if (
        payload.get("format", "quant.calib") != "quant.calib"
        or not isinstance(version, int)
        or version != _CALIB_VERSION
        or not isinstance(payload.get("ranges"), dict)
        or not payload.get("ranges")
    ):
        return None
    try:
        if ranges_digest(payload["ranges"]) != payload.get("digest"):
            return None
    except (TypeError, ValueError):
        return None
    return payload


def quant_spec(ranges: dict) -> tuple:
    """A range set as the hashable static-scale spec the visualizer takes
    (``engine/deconv.py`` ``quant=``): sorted (entry name, amax) pairs."""
    return tuple(sorted(_canonical_ranges(ranges).items()))
