"""The deconvnet engines of the port: the sequential walk over a ModelSpec
and the autodiff projection of DAG models."""

from deconv_api_tpu_torch.engine.autodeconv import autodeconv_visualizer
from deconv_api_tpu_torch.engine.deconv import get_visualizer

__all__ = ["autodeconv_visualizer", "get_visualizer"]
