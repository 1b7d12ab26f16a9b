"""Weights across packages: JAX params as numpy arrays, and the slash-keyed
``.npz`` archive that ``deconv_api_tpu/models/weights.py:save_npz`` writes.

Both packages keep HWIO conv kernels and (din, dout) dense kernels, so the
conversion is a copy keyed by layer name."""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree) -> dict:
    """``{layer: {"w", "b"}}`` of array-likes (e.g. the reference's params
    after ``np.asarray``) -> the port's dict of CPU tensors."""
    return {
        layer: {leaf: torch.from_numpy(np.array(arr, copy=True)) for leaf, arr in leaves.items()}
        for layer, leaves in tree.items()
    }


def load_npz(path: str) -> dict:
    """Read a ``<layer>/<leaf>``-keyed archive into the port's dict."""
    out: dict[str, dict[str, np.ndarray]] = {}
    with np.load(path) as archive:
        for key in archive.files:
            layer, _, leaf = key.rpartition("/")
            out.setdefault(layer, {})[leaf] = archive[key]
    return params_from_jax(out)


def save_npz(params: dict, path: str) -> None:
    """Write the port's dict as a ``<layer>/<leaf>``-keyed archive."""
    np.savez(
        path,
        **{
            f"{layer}/{leaf}": t.detach().cpu().numpy()
            for layer, leaves in params.items()
            for leaf, t in leaves.items()
        },
    )
