"""Weights across packages: JAX params as numpy arrays, and the slash-keyed
``.npz`` archive that ``deconv_api_tpu/models/weights.py:save_npz`` writes.

Both packages keep HWIO conv kernels, (din, dout) dense kernels and the same
tree layout (``{layer: {"w", "b"}}`` for sequential specs, deeper for the
DAG models: ``params["conv2_block1"]["c1"]["w"]``), so the conversion is a
copy keyed by path."""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree: dict) -> dict:
    """``fn`` applied to every leaf of a nested params dict (moving params
    between devices, or to ``meta`` for shapes only)."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def params_from_jax(tree) -> dict:
    """A nested dict of array-likes (e.g. the reference's params after
    ``np.asarray``), any depth -> the same tree of CPU tensors."""
    return tree_map(lambda v: torch.from_numpy(np.array(v, copy=True)), tree)


def load_npz(path: str) -> dict:
    """Read an ``a/b/leaf``-keyed archive into the port's nested dict."""
    out: dict = {}
    with np.load(path) as archive:
        for key in archive.files:
            *parents, leaf = key.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = archive[key]
    return params_from_jax(out)


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v.detach().cpu().numpy()
    return flat


def save_npz(params: dict, path: str) -> None:
    """Write the port's nested dict as an ``a/b/leaf``-keyed archive."""
    np.savez(path, **_flatten(params))
