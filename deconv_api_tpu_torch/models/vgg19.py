"""VGG19 (the ImageNet classifier topology) as a ModelSpec, with Keras'
layer names: VGG16 with four convolutions in blocks 3-5 instead of three.
The sequential engine and its kernels serve it unchanged."""

from __future__ import annotations

from deconv_api_tpu_torch.models.spec import Layer, ModelSpec
from deconv_api_tpu_torch.models.vgg16 import _conv, _pool

VGG19_SPEC = ModelSpec(
    name="vgg19",
    input_shape=(224, 224, 3),
    layers=(
        Layer("input_1", "input"),
        _conv("block1_conv1", 64),
        _conv("block1_conv2", 64),
        _pool("block1_pool"),
        _conv("block2_conv1", 128),
        _conv("block2_conv2", 128),
        _pool("block2_pool"),
        _conv("block3_conv1", 256),
        _conv("block3_conv2", 256),
        _conv("block3_conv3", 256),
        _conv("block3_conv4", 256),
        _pool("block3_pool"),
        _conv("block4_conv1", 512),
        _conv("block4_conv2", 512),
        _conv("block4_conv3", 512),
        _conv("block4_conv4", 512),
        _pool("block4_pool"),
        _conv("block5_conv1", 512),
        _conv("block5_conv2", 512),
        _conv("block5_conv3", 512),
        _conv("block5_conv4", 512),
        _pool("block5_pool"),
        Layer("flatten", "flatten"),
        Layer("fc1", "dense", activation="relu", filters=4096),
        Layer("fc2", "dense", activation="relu", filters=4096),
        Layer("predictions", "dense", activation="softmax", filters=1000),
    ),
)
