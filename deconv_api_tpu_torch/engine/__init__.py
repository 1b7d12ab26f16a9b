"""The deconvnet engine of the port."""

from deconv_api_tpu_torch.engine.deconv import get_visualizer

__all__ = ["get_visualizer"]
