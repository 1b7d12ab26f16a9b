"""A scaled-down VGG-topology spec for the CPU tests: the same layer kinds
and names as VGG16 at 32x32 and narrow widths."""

from __future__ import annotations

from deconv_api_tpu_torch.models.spec import Layer, ModelSpec

VGG_TINY_SPEC = ModelSpec(
    name="vgg_tiny",
    input_shape=(32, 32, 3),
    layers=(
        Layer("input_1", "input"),
        Layer("block1_conv1", "conv", activation="relu", filters=16),
        Layer("block1_conv2", "conv", activation="relu", filters=16),
        Layer("block1_pool", "pool"),
        Layer("block2_conv1", "conv", activation="relu", filters=32),
        Layer("block2_conv2", "conv", activation="relu", filters=32),
        Layer("block2_pool", "pool"),
        Layer("block3_conv1", "conv", activation="relu", filters=64),
        Layer("block3_pool", "pool"),
        Layer("flatten", "flatten"),
        Layer("fc1", "dense", activation="relu", filters=256),
        Layer("predictions", "dense", activation="softmax", filters=100),
    ),
)
