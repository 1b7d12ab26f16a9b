"""The DAG families the port's CPU tests hold against the JAX package, and
their shared inputs: each family's JAX init and forward beside the port's,
at the JAX tests' own input sizes (ResNet50 at 64x64, InceptionV3 at 75x75,
MobileNet v1/v2 at 64x64, 10 classes).

Params: the JAX init's tree (shapes from ``jax.eval_shape``, no compute),
filled from a seeded numpy generator (He-normal kernels, BatchNorm
statistics away from the identity so the affine is exercised), fed to JAX
as arrays and to the port through ``params_from_jax``."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from deconv_api_tpu.models import inception_v3 as j_inception
from deconv_api_tpu.models import mobilenet_v1 as j_mnv1
from deconv_api_tpu.models import mobilenet_v2 as j_mnv2
from deconv_api_tpu.models import resnet50 as j_resnet
from deconv_api_tpu_torch.models import inception_v3, mobilenet_v1, mobilenet_v2, resnet50
from deconv_api_tpu_torch.models.weights import params_from_jax

# family -> (JAX init, JAX forward, port module, port forward, input size)
FAMILIES = {
    "resnet50": (j_resnet.resnet50_init, j_resnet.resnet50_forward, resnet50,
                 resnet50.resnet50_forward, 64),
    "inception_v3": (j_inception.inception_v3_init, j_inception.inception_v3_forward, inception_v3,
                     inception_v3.inception_v3_forward, 75),
    "mobilenet_v1": (j_mnv1.mobilenet_v1_init, j_mnv1.mobilenet_v1_forward, mobilenet_v1,
                     mobilenet_v1.mobilenet_v1_forward, 64),
    "mobilenet_v2": (j_mnv2.mobilenet_v2_init, j_mnv2.mobilenet_v2_forward, mobilenet_v2,
                     mobilenet_v2.mobilenet_v2_forward, 64),
}


@functools.cache
def numpy_params(family: str, seed: int = 0) -> dict:
    """The JAX init's tree for ``family`` (10 classes), filled from numpy."""
    shapes = jax.eval_shape(functools.partial(FAMILIES[family][0], num_classes=10), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "w":  # HWIO (depthwise: I=1) or (din, dout)
            v = rng.standard_normal(s.shape) * math.sqrt(2.0 / math.prod(s.shape[:-1]))
        elif name in ("gamma", "var"):
            v = rng.uniform(0.6, 1.4, s.shape)
        else:  # beta, mean, dense bias
            v = rng.normal(0.0, 0.1, s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def both_params(family: str):
    tree = numpy_params(family)
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_jax(tree)


def images(family: str, b: int = 2, seed: int = 1) -> np.ndarray:
    size = FAMILIES[family][4]
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)
