"""The port's checkpoints: a model's params, or a whole training state, in a
directory (the counterpart of ``deconv_api_tpu/utils/checkpoint.py``).

The JAX package writes orbax checkpoints.  The card's machine has neither
orbax nor JAX, so the port writes a format of its own, which both sides of
the train -> checkpoint -> serve loop read:

- ``params.npz``: the params as ``models/weights.py:flat_arrays`` keys
  them (``a/b/leaf``), uncompressed, bfloat16 leaves widened to float32;
- ``opt_state.npz`` (a training state only): the AdamW moments, keyed
  ``mu/a/b/leaf`` and ``nu/a/b/leaf``;
- ``checkpoint.json``: the manifest, with the format tag, ``kind``
  (``params`` or ``train_state``), the model's name, the step and, for a
  training state, the optimizer's ``count``.

A training state's directory is also a params checkpoint: ``serve
--weights`` reads its ``params.npz``.

Every save replaces the directory as a whole, as orbax's ``force=True``
does: it is written to a temporary sibling, then renamed into place.  A
kill during a save leaves the previous checkpoint readable: at the one
moment between the two renames, it is ``<path>.old``, which the readers
take when ``<path>`` is missing.  To convert a JAX checkpoint, where both
packages are installed: the JAX package's ``restore_params``, then
``save_params`` here on ``params_from_jax`` of the result.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from deconv_api_tpu_torch.models.weights import flat_arrays, flat_leaves, leaf_like, tree_map

FORMAT = "deconv_api_tpu_torch.checkpoint"
VERSION = 1
MANIFEST = "checkpoint.json"
PARAMS = "params.npz"
OPT_STATE = "opt_state.npz"


def _readable(path: str) -> str:
    """``path``, or the previous checkpoint a save had just moved aside."""
    path = os.path.abspath(path)
    old = path + ".old"
    if not os.path.exists(path) and os.path.isdir(old):
        return old
    return path


def is_checkpoint(path: str) -> bool:
    """Whether ``path`` is a directory holding the port's manifest."""
    return os.path.isfile(os.path.join(_readable(path), MANIFEST))


def read_manifest(path: str) -> dict:
    """The manifest of the checkpoint at ``path``; a ValueError when it is
    not one of this format and version."""
    with open(os.path.join(_readable(path), MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT or manifest.get("version") != VERSION:
        raise ValueError(
            f"{path!r}: checkpoint format {manifest.get('format')!r} version {manifest.get('version')!r}, "
            f"expected {FORMAT!r} version {VERSION}"
        )
    return manifest


def _host_arrays(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """``flat_arrays`` of ``tree``, bfloat16 leaves widened to float32
    (numpy has no bfloat16; the widening is exact, and a restore narrows
    them back to the like tree's dtype)."""
    return flat_arrays(tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t, tree), prefix)


def _write_npz(path: str, arrays: dict) -> None:
    with open(path, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())


def _replace_dir(path: str, files: dict[str, dict], manifest: dict) -> None:
    """Write ``files`` (name -> flat arrays) and the manifest into a
    temporary sibling of ``path``, then rename it into place."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp-", dir=parent)
    try:
        for name, arrays in files.items():
            _write_npz(os.path.join(tmp, name), arrays)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump({"format": FORMAT, "version": VERSION, **manifest}, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        old = path + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    shutil.rmtree(old, ignore_errors=True)


def _restore_tree(archive_path: str, like: dict, prefix: str = "") -> dict:
    """``like``'s tree filled from the archive's ``prefix + a/b/leaf`` keys,
    each leaf with the dtype and device of its ``like`` leaf.  The keys must
    be exactly ``like``'s; a shape mismatch names the leaf."""
    want = flat_leaves(like, prefix)
    with np.load(archive_path) as archive:
        have = {k for k in archive.files if k.startswith(prefix)}
        missing, extra = sorted(set(want) - have), sorted(have - set(want))
        if missing or extra:
            raise ValueError(
                f"{archive_path!r} does not match the model's tree: missing {missing[:5]}"
                f"{' ...' if len(missing) > 5 else ''}, unexpected {extra[:5]}{' ...' if len(extra) > 5 else ''}"
            )
        loaded = {}
        for key, like_leaf in want.items():
            got = archive[key]
            if tuple(got.shape) != tuple(like_leaf.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {tuple(got.shape)} != model shape {tuple(like_leaf.shape)}"
                )
            loaded[key] = leaf_like(got, like_leaf)

    def build(tree: dict, path: str) -> dict:
        return {k: build(v, f"{path}{k}/") if isinstance(v, dict) else loaded[f"{path}{k}"]
                for k, v in tree.items()}

    return build(like, prefix)


def save_params(path: str, params: dict, *, model: str = "", step: int = 0) -> None:
    """Write ``params`` as a checkpoint directory at ``path``, replacing
    whatever was there."""
    _replace_dir(path, {PARAMS: _host_arrays(params)}, {"kind": "params", "model": model, "step": int(step)})


def restore_params(path: str, like: dict) -> dict:
    """The params of the checkpoint at ``path`` (a params checkpoint or a
    training state) in ``like``'s tree, dtypes and devices."""
    read_manifest(path)
    return _restore_tree(os.path.join(_readable(path), PARAMS), like)


def save_train_state(path: str, state, *, model: str = "") -> None:
    """Write a whole ``train/step.py:TrainState`` (params, the AdamW moments
    and count, the step), so that a run resumes exactly."""
    opt = state.opt_state
    moments = {**_host_arrays(opt.mu, "mu/"), **_host_arrays(opt.nu, "nu/")}
    _replace_dir(path, {PARAMS: _host_arrays(state.params), OPT_STATE: moments},
                 {"kind": "train_state", "model": model, "step": int(state.step), "count": int(opt.count)})


def restore_train_state(path: str, like):
    """The ``TrainState`` saved at ``path``, in the trees, dtypes and
    devices of ``like`` (a TrainState, e.g. a fresh ``init_fn``'s)."""
    manifest = read_manifest(path)
    if manifest.get("kind") != "train_state":
        raise ValueError(f"{path!r} holds {manifest.get('kind')!r}, not a training state")
    root = _readable(path)
    opt_file = os.path.join(root, OPT_STATE)
    opt = like.opt_state._replace(count=int(manifest["count"]),
                                  mu=_restore_tree(opt_file, like.opt_state.mu, "mu/"),
                                  nu=_restore_tree(opt_file, like.opt_state.nu, "nu/"))
    return like._replace(params=_restore_tree(os.path.join(root, PARAMS), like.params), opt_state=opt,
                         step=int(manifest["step"]))
