"""Tensor ops of the port, NHWC at every public function.

Importing this package needs neither ``nvcc`` nor a card: kernels build at
their first launch (``ops/_build.py``)."""

from deconv_api_tpu_torch.ops import cuda_deconv, cuda_pool
from deconv_api_tpu_torch.ops.activations import apply_activation
from deconv_api_tpu_torch.ops.conv import (
    conv2d,
    conv2d_input_backward,
    conv2d_input_backward_grouped,
    flip_kernel,
)
from deconv_api_tpu_torch.ops.cuda_deconv import fused_unpool_backward
from deconv_api_tpu_torch.ops.linear import (
    dense,
    dense_input_backward,
    flatten,
    unflatten,
)
from deconv_api_tpu_torch.ops.pool import maxpool_with_argmax, unpool_with_argmax


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process, by kernel name."""
    return {**cuda_pool.launches, **cuda_deconv.launches}


def reset_launch_counts() -> None:
    for counts in (cuda_pool.launches, cuda_deconv.launches):
        for name in counts:
            counts[name] = 0


__all__ = [
    "apply_activation",
    "conv2d",
    "conv2d_input_backward",
    "conv2d_input_backward_grouped",
    "dense",
    "dense_input_backward",
    "flatten",
    "flip_kernel",
    "fused_unpool_backward",
    "launch_counts",
    "maxpool_with_argmax",
    "reset_launch_counts",
    "unflatten",
    "unpool_with_argmax",
]
