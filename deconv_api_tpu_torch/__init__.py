"""PyTorch/CUDA port of deconv_api_tpu for one NVIDIA H100.

The JAX package beside it (``deconv_api_tpu``) is the reference every part
of this package is held against; this package imports nothing from it and
never imports jax.  Layouts follow the reference: NHWC activations, HWIO
conv kernels, (din, dout) dense kernels, parameters as a
``{layer: {"w", "b"}}`` dict (nested deeper for the DAG models).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``_device.resolve_device``).  In the sequential engine every pool and
every fused unpool+conv step runs a hand-written kernel (``csrc/``) on the
card and the plain PyTorch version of the same function on the CPU; the
DAG models' autodiff engine runs cuDNN and ATen on either.
"""

__version__ = "0.1.0"
