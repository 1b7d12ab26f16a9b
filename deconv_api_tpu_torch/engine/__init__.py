"""The engines of the port: the sequential deconvnet walk over a ModelSpec,
the autodiff projection of DAG models, and DeepDream."""

from deconv_api_tpu_torch.engine.autodeconv import autodeconv_visualizer
from deconv_api_tpu_torch.engine.deconv import get_visualizer
from deconv_api_tpu_torch.engine.deepdream import (
    activation_loss,
    deepdream,
    deepdream_batch,
    make_octave_runner,
    octave_shapes,
)

__all__ = [
    "activation_loss",
    "autodeconv_visualizer",
    "deepdream",
    "deepdream_batch",
    "get_visualizer",
    "make_octave_runner",
    "octave_shapes",
]
