"""Tensor ops of the port, NHWC at every public function.

Importing this package needs neither ``nvcc`` nor a card: kernels build at
their first launch (``ops/_build.py``)."""

from deconv_api_tpu_torch.ops import cuda_deconv, cuda_pool, cuda_q8
from deconv_api_tpu_torch.ops.activations import apply_activation, int8_safe_activation
from deconv_api_tpu_torch.ops.conv import (
    conv2d,
    conv2d_input_backward,
    conv2d_input_backward_grouped,
    conv2d_q8,
    flip_kernel,
)
from deconv_api_tpu_torch.ops.cuda_deconv import fused_unpool_backward
from deconv_api_tpu_torch.ops.linear import (
    dense,
    dense_input_backward,
    dense_q8,
    flatten,
    unflatten,
)
from deconv_api_tpu_torch.ops.pool import maxpool_with_argmax, unpool_with_argmax
from deconv_api_tpu_torch.ops.q8 import (
    conv2d_q8_step,
    dense_q8_step,
    q8_scale,
    row_amax,
)
from deconv_api_tpu_torch.ops.q8 import quantize_weight as quantize_weight_q8


# CUDA graphs captured and replayed (engine/capture.py).  A wrapper called
# inside a capture records its kernel into the graph and launches nothing:
# the capture takes that count back, and every replay adds the graph's
# kernels, so ``launch_counts()`` counts launches on the card.
graph_counts = {"captures": 0, "replays": 0}
# each kernel wrapper's launch counts
_TABLES = (cuda_pool.launches, cuda_deconv.launches, cuda_q8.launches)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process, by kernel name."""
    return {name: n for table in _TABLES for name, n in table.items()}


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches, possibly negative)."""
    for name, n in counts.items():
        table = next(t for t in _TABLES if name in t)
        table[name] += n


def reset_launch_counts() -> None:
    """Zero the kernel launch counts and the graph counts."""
    for counts in (*_TABLES, graph_counts):
        for name in counts:
            counts[name] = 0


__all__ = [
    "add_launch_counts",
    "apply_activation",
    "conv2d",
    "conv2d_input_backward",
    "conv2d_input_backward_grouped",
    "conv2d_q8",
    "conv2d_q8_step",
    "dense",
    "dense_input_backward",
    "dense_q8",
    "dense_q8_step",
    "flatten",
    "flip_kernel",
    "fused_unpool_backward",
    "graph_counts",
    "int8_safe_activation",
    "launch_counts",
    "maxpool_with_argmax",
    "q8_scale",
    "quantize_weight_q8",
    "reset_launch_counts",
    "row_amax",
    "unflatten",
    "unpool_with_argmax",
]
