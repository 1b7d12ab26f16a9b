"""Keras ``.h5`` weight loading for the DAG models (counterpart of
``deconv_api_tpu/models/dag_weights.py``): ResNet50, InceptionV3 and the
MobileNets, into the port's conv_bn trees (``models/blocks.py``: ``w``,
``gamma``, ``beta``, ``mean``, ``var``), which equal the JAX package's
trees leaf for leaf.

Keras layout facts this loader encodes:

- ResNet50 (keras.applications.resnet): convs carry biases and are
  followed by BN.  BN(conv(x) + b) == BN'(conv(x)) with mean' =
  moving_mean - b, so the bias folds into the BN mean.  Current names are
  ``conv{s}_block{i}_{j}_conv`` / ``_bn`` (j=0 the projection shortcut,
  1..3 the bottleneck); the keras-2.2 names (``res2a_branch2a`` /
  ``bn2a_branch2a``, ``fc1000``) load too.
- InceptionV3 (keras.applications.inception_v3): convs have no bias and
  BN no scale (gamma stays 1).  Layers carry INDEX names (``conv2d_42``,
  ``batch_normalization_42``) in the Keras graph's construction order,
  which ``INCEPTION_V3_CONV_ORDER`` mirrors line by line (94 convs).  A
  swap of two same-shape convs passes every shape check, so only the
  order table keeps them apart.
- MobileNets: explicit names; a depthwise kernel is (kh, kw, C, 1) in
  Keras and (kh, kw, 1, C) here, the ``groups=C`` layout.

``h5py`` is imported only when a file is read."""

from __future__ import annotations

import re

import numpy as np

from deconv_api_tpu_torch.models.weights import h5py_module, leaf_like

# ------------------------------------------------------------------ h5 read


def read_h5_layers(path: str) -> dict[str, dict[str, np.ndarray]]:
    """``{layer: {dataset basename without ":0": array}}`` of a Keras h5,
    under a ``model_weights`` root or at the top; the layer is the
    top-level group, the basename the last path component."""
    h5py = h5py_module(path)
    out: dict[str, dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def visit(name, obj):
            if not isinstance(obj, h5py.Dataset):
                return
            layer = name.split("/")[0]
            base = name.split("/")[-1].removesuffix(":0")
            out.setdefault(layer, {})[base] = np.asarray(obj)

        root.visititems(visit)
    return out


# --------------------------------------------------------------- conv_bn map


def _conv_bn_entry(conv: dict[str, np.ndarray], bn: dict[str, np.ndarray] | None, like: dict, where: str) -> dict:
    """A conv_bn entry from Keras conv (+ optional BN) tensors, each leaf
    with its init leaf's dtype and device.  A conv bias folds into the BN
    running mean; without BN it becomes ``beta`` (scale 1, mean 0, var 1:
    the affine is y + beta)."""
    w = conv.get("kernel")
    if w is None:
        raise ValueError(f"{where}: h5 entry has no conv kernel")
    if tuple(w.shape) != tuple(like["w"].shape):
        raise ValueError(f"{where}: kernel shape {tuple(w.shape)} != model {tuple(like['w'].shape)}")
    cout = w.shape[-1]
    bias = conv.get("bias")
    entry = {"w": w}
    if bn is not None:
        mean = bn.get("moving_mean", np.zeros(cout, np.float32))
        entry.update(
            gamma=bn.get("gamma", np.ones(cout, np.float32)),
            beta=bn.get("beta", np.zeros(cout, np.float32)),
            mean=mean - bias if bias is not None else mean,
            var=bn.get("moving_variance", np.ones(cout, np.float32)),
        )
    else:
        entry.update(
            gamma=np.ones(cout, np.float32),
            beta=bias if bias is not None else np.zeros(cout, np.float32),
            mean=np.zeros(cout, np.float32),
            var=np.ones(cout, np.float32),
        )
    return {k: leaf_like(v, like[k]) for k, v in entry.items()}


def _dense_entry(tensors: dict[str, np.ndarray], like: dict, where: str) -> dict:
    w = tensors.get("kernel")
    if w is None:
        raise ValueError(f"{where}: h5 entry has no dense kernel")
    if tuple(w.shape) != tuple(like["w"].shape):
        raise ValueError(f"{where}: dense shape {tuple(w.shape)} != model {tuple(like['w'].shape)}")
    b = tensors.get("bias", np.zeros(w.shape[-1], np.float32))
    return {"w": leaf_like(w, like["w"]), "b": leaf_like(b, like["b"])}


# ------------------------------------------------------------------ ResNet50

# (stage name, n_blocks): models/resnet50.py's stages
_RESNET_STAGES = (("conv2", 3), ("conv3", 4), ("conv4", 6), ("conv5", 3))
# our block key -> current h5 suffix j / legacy branch name
_RESNET_BRANCHES = (("proj", "0", "1"), ("c1", "1", "2a"), ("c2", "2", "2b"), ("c3", "3", "2c"))


def load_resnet50_h5(path: str, init_params: dict) -> dict:
    """A Keras ResNet50 .h5 (current or legacy names) in the
    models/resnet50.py tree.  A missing trunk layer raises; a missing
    classifier (notop files) keeps its init values."""
    layers = read_h5_layers(path)
    legacy = "res2a_branch2a" in layers
    params = {k: (dict(v) if isinstance(v, dict) else v) for k, v in init_params.items()}

    def take(conv_name: str, bn_name: str, like: dict, where: str) -> dict:
        if conv_name not in layers:
            raise ValueError(f"resnet50 h5 {path!r} missing layer {conv_name!r}")
        return _conv_bn_entry(layers[conv_name], layers.get(bn_name), like, where)

    if legacy:
        params["conv1"] = take("conv1", "bn_conv1", params["conv1"], "conv1")
    else:
        params["conv1"] = take("conv1_conv", "conv1_bn", params["conv1"], "conv1")
    for stage, n_blocks in _RESNET_STAGES:
        s = stage[-1]  # "2".."5"
        for i in range(1, n_blocks + 1):
            block_key = f"{stage}_block{i}"
            block = dict(params[block_key])
            for ours, current_j, legacy_br in _RESNET_BRANCHES:
                if ours not in block:
                    continue  # only a stage's first block has a projection
                if legacy:
                    blk_letter = chr(ord("a") + i - 1)
                    conv_name = f"res{s}{blk_letter}_branch{legacy_br}"
                    bn_name = f"bn{s}{blk_letter}_branch{legacy_br}"
                else:
                    conv_name = f"{block_key}_{current_j}_conv"
                    bn_name = f"{block_key}_{current_j}_bn"
                block[ours] = take(conv_name, bn_name, block[ours], f"{block_key}.{ours}")
            params[block_key] = block
    head = "fc1000" if legacy else "predictions"
    if head in layers:
        params["predictions"] = _dense_entry(layers[head], params["predictions"], "predictions")
    return params


# --------------------------------------------------------------- InceptionV3


def _inception_conv_order() -> tuple[tuple[str, ...], ...]:
    """Param paths of every conv_bn, in Keras graph construction order
    (keras.applications.inception_v3.InceptionV3)."""
    order: list[tuple[str, ...]] = [(f"stem{i}",) for i in range(1, 6)]
    for name in ("mixed0", "mixed1", "mixed2"):
        order += [(name, k) for k in ("b1", "b5_1", "b5_2", "b3_1", "b3_2", "b3_3", "pool")]
    order += [("mixed3", k) for k in ("b3", "b3d_1", "b3d_2", "b3d_3")]
    for name in ("mixed4", "mixed5", "mixed6", "mixed7"):
        order += [
            (name, k)
            for k in ("b1", "b7_1", "b7_2", "b7_3", "b7d_1", "b7d_2", "b7d_3", "b7d_4", "b7d_5", "pool")
        ]
    order += [("mixed8", k) for k in ("b3_1", "b3_2", "b7_1", "b7_2", "b7_3", "b7_4")]
    for name in ("mixed9", "mixed10"):
        order += [
            (name, k)
            for k in ("b1", "b3_1", "b3_2a", "b3_2b", "b3d_1", "b3d_2", "b3d_3a", "b3d_3b", "pool")
        ]
    return tuple(order)


INCEPTION_V3_CONV_ORDER = _inception_conv_order()
assert len(INCEPTION_V3_CONV_ORDER) == 94  # keras InceptionV3 has 94 conv2d layers


def _indexed(layers: dict, prefix: str) -> dict[int, dict[str, np.ndarray]]:
    """``prefix``, ``prefix_1``, ... as {0-based index: tensors}, files
    numbered from 1 (keras-2.x exports) shifted down."""
    pat = re.compile(re.escape(prefix) + r"(?:_(\d+))?$")
    found: dict[int, dict[str, np.ndarray]] = {}
    for name, tensors in layers.items():
        m = pat.match(name)
        if m:
            found[int(m.group(1) or 0)] = tensors
    if found and 0 not in found:
        found = {i - min(found): t for i, t in found.items()}
    return found


def load_inception_v3_h5(path: str, init_params: dict) -> dict:
    """A Keras InceptionV3 .h5 in the models/inception_v3.py tree, paired
    by construction-order index (module docstring)."""
    layers = read_h5_layers(path)
    convs = _indexed(layers, "conv2d")
    bns = _indexed(layers, "batch_normalization")
    if len(convs) < len(INCEPTION_V3_CONV_ORDER):
        raise ValueError(
            f"inception_v3 h5 {path!r} has {len(convs)} conv2d layers; expected {len(INCEPTION_V3_CONV_ORDER)}"
        )
    params = {k: dict(v) for k, v in init_params.items()}
    for idx, p_path in enumerate(INCEPTION_V3_CONV_ORDER):
        like = params[p_path[0]] if len(p_path) == 1 else params[p_path[0]][p_path[1]]
        entry = _conv_bn_entry(convs[idx], bns.get(idx), like, ".".join(p_path) + f" (conv2d_{idx})")
        if len(p_path) == 1:
            params[p_path[0]] = entry
        else:
            params[p_path[0]][p_path[1]] = entry
    if "predictions" in layers:
        params["predictions"] = _dense_entry(layers["predictions"], params["predictions"], "predictions")
    return params


# ----------------------------------------------------------------- MobileNets


def _mobilenet_take(layers: dict, conv_name: str, bn_name: str, like: dict, is_depthwise: bool,
                    family: str) -> dict:
    """One conv(+BN) entry of either MobileNet.  A depthwise kernel is
    (kh, kw, C, 1) in Keras, under ``depthwise_kernel`` (keras 2) or
    ``kernel`` (keras 3), and (kh, kw, 1, C) here."""
    if conv_name not in layers:
        raise ValueError(f"{family} h5 missing layer {conv_name!r}")
    conv = dict(layers[conv_name])
    dw = conv.pop("depthwise_kernel", None)
    if dw is None and is_depthwise:
        dw = conv.pop("kernel", None)
    if dw is not None:
        conv["kernel"] = np.transpose(dw, (0, 1, 3, 2))
    return _conv_bn_entry(conv, layers.get(bn_name), like, conv_name)


def load_mobilenet_v1_h5(path: str, init_params: dict) -> dict:
    """A Keras MobileNet (v1, alpha 1.0) .h5 in the models/mobilenet_v1.py
    tree, by name (conv1, conv_dw_1 ... conv_pw_13 and their ``_bn``).  A
    missing classifier keeps its init values."""
    layers = read_h5_layers(path)
    params = {k: (dict(v) if isinstance(v, dict) else v) for k, v in init_params.items()}

    def take(conv_name: str, like: dict) -> dict:
        return _mobilenet_take(layers, conv_name, f"{conv_name}_bn", like, conv_name.startswith("conv_dw_"),
                               "mobilenet_v1")

    params["conv1"] = take("conv1", params["conv1"])
    for key in list(params):
        if key.startswith(("conv_dw_", "conv_pw_")):
            params[key] = take(key, params[key])
    # Keras MobileNet's classifier is a 1x1 conv (conv_preds) over the
    # pooled map: squeezed into the dense head
    if "conv_preds" in layers:
        t = dict(layers["conv_preds"])
        if "kernel" in t and t["kernel"].ndim == 4:
            t["kernel"] = t["kernel"].reshape(t["kernel"].shape[2:])
        params["predictions"] = _dense_entry(t, params["predictions"], "conv_preds")
    return params


def load_mobilenet_v2_h5(path: str, init_params: dict) -> dict:
    """A Keras MobileNetV2 (alpha 1.0) .h5 in the models/mobilenet_v2.py
    tree, by name (``Conv1``/``bn_Conv1``, ``expanded_conv_{depthwise,
    project}``, ``block_{i}_{expand,depthwise,project}`` and their
    ``_BN``, ``Conv_1``)."""
    layers = read_h5_layers(path)
    params = {k: (dict(v) if isinstance(v, dict) else v) for k, v in init_params.items()}

    def take(conv_name: str, bn_name: str, like: dict) -> dict:
        return _mobilenet_take(layers, conv_name, bn_name, like, conv_name.endswith("depthwise"), "mobilenet_v2")

    params["Conv1"] = take("Conv1", "bn_Conv1", params["Conv1"])
    params["Conv_1"] = take("Conv_1", "Conv_1_bn", params["Conv_1"])
    blk = dict(params["expanded_conv"])
    blk["depthwise"] = take("expanded_conv_depthwise", "expanded_conv_depthwise_BN", blk["depthwise"])
    blk["project"] = take("expanded_conv_project", "expanded_conv_project_BN", blk["project"])
    params["expanded_conv"] = blk
    for key in list(params):
        if not key.startswith("block_"):
            continue
        blk = dict(params[key])
        for part in ("expand", "depthwise", "project"):
            blk[part] = take(f"{key}_{part}", f"{key}_{part}_BN", blk[part])
        params[key] = blk
    if "predictions" in layers:
        params["predictions"] = _dense_entry(layers["predictions"], params["predictions"], "predictions")
    return params
