"""Model specs, the DAG model families and weights of the port."""

from deconv_api_tpu_torch.models.spec import (
    Entry,
    Layer,
    ModelSpec,
    entry_chain,
    init_params,
    layer_output_shapes,
)
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.vgg16 import VGG16_SPEC
from deconv_api_tpu_torch.models.vgg19 import VGG19_SPEC

__all__ = [
    "Entry",
    "Layer",
    "ModelSpec",
    "VGG16_SPEC",
    "VGG19_SPEC",
    "VGG_TINY_SPEC",
    "entry_chain",
    "init_params",
    "layer_output_shapes",
]
