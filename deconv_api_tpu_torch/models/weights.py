"""Weights: pretrained Keras ``.h5`` files and slash-keyed ``.npz``
archives loaded into a model's params (the counterpart of
``deconv_api_tpu/models/weights.py``), and JAX params as numpy arrays.

The reference loads ImageNet VGG16 weights at startup.  With no download
here, models initialise with He-normal weights (``models/spec.py``) and
take their trained values from a file when one is given
(``ServerConfig.weights_path``, ``--weights``): ``load_model_weights``.

Both packages keep HWIO conv kernels, (din, dout) dense kernels and the same
tree layout (``{layer: {"w", "b"}}`` for sequential specs, deeper for the
DAG models: ``params["conv2_block1"]["c1"]["w"]``), which is also Keras's
channels-last layout, so every conversion is a copy keyed by name or path.
A loaded leaf keeps its init leaf's dtype and device.

``h5py`` is imported only to read an ``.h5`` file.  Where it is missing
(the card's machine), convert the file once where it is: ``save_npz(
load_model_weights(model, spec, "x.h5", init), "x.npz")``, and load the
``.npz``.  A directory with the port's ``checkpoint.json`` is a checkpoint
of its own format (``utils/checkpoint.py``, written by ``train``); it loads
into the model its manifest names.  A directory with neither is the JAX
package's orbax checkpoint, which the port does not read (the card's
machine has no orbax): convert it where both packages are installed."""

from __future__ import annotations

import os

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


def flat_leaves(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """The port's nested dict as ``{"a/b/leaf": tensor}``, in the tree's
    order."""
    flat: dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def flat_arrays(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """The port's nested dict as ``{"a/b/leaf": array}`` on the host."""
    return {k: v.detach().cpu().numpy() for k, v in flat_leaves(tree, prefix).items()}


def save_npz(params: dict, path: str) -> None:
    """Write the port's nested dict as an ``a/b/leaf``-keyed archive."""
    np.savez(path, **flat_arrays(params))


def leaf_like(value, like: torch.Tensor) -> torch.Tensor:
    """A copy of ``value`` (an array) with the dtype and device of the
    init leaf ``like``."""
    return torch.tensor(np.asarray(value), dtype=like.dtype, device=like.device)


def h5py_module(path: str):
    """``h5py``, imported to read ``path``; where it is missing, an error
    that says how to load the file's weights without it."""
    try:
        import h5py
    except ImportError:
        raise ImportError(
            f"reading the Keras h5 file {path!r} needs h5py, which is not installed here: "
            "convert it to .npz on a host with h5py (deconv_api_tpu_torch.models.weights."
            "load_model_weights, then save_npz) and load the .npz"
        ) from None
    return h5py


def _orbax_dir(path: str) -> ValueError:
    return ValueError(
        f"weights path {path!r} is a directory with no checkpoint.json and no <model>.h5 or <model>.npz "
        "in it: the JAX package's orbax checkpoint format, which the port does not read (the card's "
        "machine has no orbax). Convert it where both packages are installed: the JAX package's "
        "deconv_api_tpu.utils.checkpoint.restore_params, then the port's "
        "deconv_api_tpu_torch.utils.checkpoint.save_params (on models.weights.params_from_jax of the "
        "result); or give a .h5 or .npz file, or a directory of <model>.h5 / <model>.npz files"
    )


def load_checkpoint_dir(model_name: str, path: str, init_params: dict) -> dict:
    """The params of the port's checkpoint directory ``path`` in
    ``init_params``' tree, dtypes and devices.  Its manifest must name
    ``model_name`` (or no model); a directory without a manifest is
    refused with the conversion recipe."""
    from deconv_api_tpu_torch.utils import checkpoint

    if not checkpoint.is_checkpoint(path):
        raise _orbax_dir(path)
    saved = checkpoint.read_manifest(path).get("model", "")
    if saved and saved != model_name:
        raise ValueError(f"checkpoint {path!r} holds model {saved!r}, not {model_name!r}")
    return checkpoint.restore_params(path, init_params)


def load_weights(spec, path: str, init_params: dict) -> dict:
    """Load a sequential spec's weights from ``path`` into a copy of
    ``init_params``.  Formats by extension: ``.h5``/``.hdf5`` (Keras) and
    ``.npz`` (``<layer>/w`` and ``<layer>/b`` keys).  Layers missing from
    the file keep their init values; a shape mismatch raises ValueError
    naming the layer."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"weights file {path!r} does not exist")
    if os.path.isdir(path):
        return load_checkpoint_dir(spec.name, path, init_params)
    if path.endswith((".h5", ".hdf5")):
        loaded = _read_keras_h5(path)
    elif path.endswith(".npz"):
        loaded = {}
        with np.load(path) as archive:
            for key in archive.files:
                layer, _, leaf = key.rpartition("/")
                loaded.setdefault(layer, {})[leaf] = archive[key]
    else:
        raise ValueError(f"unsupported weights format: {path!r}")

    params = {k: dict(v) for k, v in init_params.items()}
    for name, tensors in loaded.items():
        if name not in params:
            continue  # classifier-less checkpoints etc.
        for leaf in ("w", "b"):
            if leaf not in tensors:
                continue
            want = tuple(params[name][leaf].shape)
            got = tuple(tensors[leaf].shape)
            if want != got:
                raise ValueError(f"layer {name!r} {leaf}: checkpoint shape {got} != model shape {want}")
            params[name][leaf] = leaf_like(tensors[leaf], params[name][leaf])
    return params


def _read_keras_h5(path: str) -> dict[str, dict[str, np.ndarray]]:
    """``{layer: {"w", "b"}}`` of a Keras h5: the keras-2 dataset names
    (``layer/layer/kernel:0``) and the keras-1 ones (``layer/layer_W:0``),
    under a ``model_weights`` root or at the top."""
    h5py = h5py_module(path)
    out: dict[str, dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def visit(name, obj):
            if not isinstance(obj, h5py.Dataset):
                return
            layer = name.split("/")[0]
            base = name.split("/")[-1]
            if base.startswith(("kernel", f"{layer}_W", "W")):
                out.setdefault(layer, {})["w"] = np.asarray(obj)
            elif base.startswith(("bias", f"{layer}_b", "b")):
                out.setdefault(layer, {})["b"] = np.asarray(obj)

        root.visititems(visit)
    return out


def load_npz_into(path: str, init_params: dict) -> dict:
    """Merge a ``save_npz`` archive into a copy of ``init_params`` (any
    nesting).  Unknown keys are ignored (classifier-less checkpoints); a
    shape mismatch raises naming the key."""
    want: dict[str, torch.Tensor] = {}

    def index(tree: dict, prefix: str) -> dict:
        copy = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                copy[k] = index(v, f"{prefix}{k}/")
            else:
                copy[k] = want[f"{prefix}{k}"] = v
        return copy

    params = index(init_params, "")
    with np.load(path) as archive:
        for key in archive.files:
            if key not in want:
                continue
            got = archive[key]
            if tuple(got.shape) != tuple(want[key].shape):
                raise ValueError(
                    f"{key}: checkpoint shape {tuple(got.shape)} != model shape {tuple(want[key].shape)}"
                )
            node = params
            *parents, leaf = key.split("/")
            for p in parents:
                node = node[p]
            node[leaf] = leaf_like(got, want[key])
    return params


def load_model_weights(model_name: str, spec, path: str, init_params: dict) -> dict:
    """The one entry point serving uses: ``path``'s weights in a copy of
    ``init_params``.  An ``.npz`` loads into any model; a Keras ``.h5``
    loads by name into a sequential spec (``load_weights``), and through
    the BN-aware mappings of ``models/dag_weights.py`` into ResNet50,
    InceptionV3 and the MobileNets."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"weights file {path!r} does not exist")
    if os.path.isdir(path):
        return load_checkpoint_dir(model_name, path, init_params)
    if path.endswith(".npz"):
        return load_npz_into(path, init_params)
    if path.endswith((".h5", ".hdf5")):
        if spec is not None:
            return load_weights(spec, path, init_params)
        from deconv_api_tpu_torch.models import dag_weights

        loaders = {
            "resnet50": dag_weights.load_resnet50_h5,
            "inception_v3": dag_weights.load_inception_v3_h5,
            "mobilenet_v1": dag_weights.load_mobilenet_v1_h5,
            "mobilenet_v2": dag_weights.load_mobilenet_v2_h5,
        }
        if model_name not in loaders:
            raise ValueError(
                f"no Keras h5 mapping for model {model_name!r}; "
                f"h5 loaders exist for sequential specs and {sorted(loaders)}"
            )
        return loaders[model_name](path, init_params)
    raise ValueError(f"unsupported weights format: {path!r}")
