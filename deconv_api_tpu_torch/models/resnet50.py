"""ResNet50 (v1, Keras topology) as a forward function + nested params
(counterpart of ``deconv_api_tpu/models/resnet50.py``).

Activation names are the Keras ones: conv1_relu, pool1_pool,
conv2_block1_out ... conv5_block3_out, avg_pool, predictions.  Its
deconvnet projection is the gradient of this forward under
``DECONV_RULES`` (``engine/autodeconv.py``): transposed strided convs,
backward ReLU, and the max-pool's gradient routed to each window's argmax.
"""

from __future__ import annotations

import torch

from deconv_api_tpu_torch.models import blocks as B

# (stage, blocks, bottleneck width, out channels, first-block stride)
_STAGES = (
    ("conv2", 3, 64, 256, 1),
    ("conv3", 4, 128, 512, 2),
    ("conv4", 6, 256, 1024, 2),
    ("conv5", 3, 512, 2048, 2),
)

# Keras ResNet50's BatchNormalization epsilon (not the 1e-3 default)
_BN_EPS = 1.001e-5


def resnet50_init(gen: torch.Generator, num_classes: int = 1000, device="cpu") -> dict:
    """He-normal weights drawn from ``gen`` in the reference's tree layout:
    ``params["conv2_block1"]["c1"]["w"]``."""
    params: dict = {"conv1": B.conv_bn_init(gen, 3, 64, (7, 7), device)}
    cin = 64
    for name, n_blocks, width, cout, _stride in _STAGES:
        for i in range(1, n_blocks + 1):
            block: dict = {}
            if i == 1:
                block["proj"] = B.conv_bn_init(gen, cin, cout, (1, 1), device)
            block["c1"] = B.conv_bn_init(gen, cin, width, (1, 1), device)
            block["c2"] = B.conv_bn_init(gen, width, width, (3, 3), device)
            block["c3"] = B.conv_bn_init(gen, width, cout, (1, 1), device)
            params[f"{name}_block{i}"] = block
            cin = cout
    params["predictions"] = B.dense_init(gen, 2048, num_classes, device)
    return params


def _bottleneck(p: dict, x: torch.Tensor, rules: B.Rules, stride: int) -> torch.Tensor:
    """Keras-v1 bottleneck: the stride sits on the first 1x1 conv and on
    the projection shortcut."""
    s = (stride, stride)
    shortcut = (
        B.conv_bn(p["proj"], x, rules, strides=s, relu=False, eps=_BN_EPS) if "proj" in p else x
    )
    y = B.conv_bn(p["c1"], x, rules, strides=s, eps=_BN_EPS)
    y = B.conv_bn(p["c2"], y, rules, eps=_BN_EPS)
    y = B.conv_bn(p["c3"], y, rules, relu=False, eps=_BN_EPS)
    return rules.relu(y + shortcut)


def resnet50_forward(
    params: dict, x: torch.Tensor, *, rules: B.Rules = B.INFERENCE_RULES, logits: bool = False
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(output, named activations) for NHWC ``x``.  conv1 and pool1 pad
    explicitly, as Keras' ZeroPadding2D does, not by XLA's SAME rule."""
    acts: dict[str, torch.Tensor] = {}
    y = B.conv_bn(params["conv1"], x, rules, strides=(2, 2), padding=((3, 3), (3, 3)), eps=_BN_EPS)
    acts["conv1_relu"] = y
    y = B.maxpool(y, 3, 2, padding=((1, 1), (1, 1)))
    acts["pool1_pool"] = y
    for name, n_blocks, _width, _cout, stride in _STAGES:
        for i in range(1, n_blocks + 1):
            y = _bottleneck(params[f"{name}_block{i}"], y, rules, stride if i == 1 else 1)
            acts[f"{name}_block{i}_out"] = y
    return B.classifier(params, y, acts, "avg_pool", logits=logits)


# the projectable activations as the reference lists them: the block
# outputs in forward order, then conv1_relu (not forward order)
DECONV_LAYERS = tuple(
    [f"{name}_block{i}_out" for name, n, _w, _c, _s in _STAGES for i in range(1, n + 1)]
    + ["conv1_relu"]
)
