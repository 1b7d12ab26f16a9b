"""Model registry for serving (counterpart of
``deconv_api_tpu/serving/models.py``, sequential VGG models only).

A ``ModelBundle`` packages what the HTTP layer needs: the spec, params on
one device, the projectable layer names, and a maker of
batched visualizers whose output carries the uint8 presentation
(``post="grid"`` or ``"tiles"``) instead of the fp32 projections, so only
uint8 leaves the device."""

from __future__ import annotations

import dataclasses

import torch

from deconv_api_tpu_torch._device import resolve_device
from deconv_api_tpu_torch.engine.deconv import get_visualizer, resolve_kpack_chan
from deconv_api_tpu_torch.models.spec import ModelSpec, init_params
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.vgg16 import VGG16_SPEC
from deconv_api_tpu_torch.ops.cuda_deconv import FUSED_DEFAULT
from deconv_api_tpu_torch.serving import codec


@dataclasses.dataclass
class ModelBundle:
    spec: ModelSpec
    params: dict  # {layer: {"w", "b"}} on ``device``
    device: torch.device

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def image_size(self) -> int:
        return self.spec.input_shape[0]

    @property
    def layer_names(self) -> tuple[str, ...]:
        return tuple(l.name for l in self.spec.layers if l.kind != "input")

    def sweep_layers(self, layer: str) -> tuple[str, ...]:
        """The projectable layers at and below ``layer``, deepest first:
        what a sweep from ``layer`` projects."""
        self.check_layer(layer)
        names = self.layer_names
        return tuple(reversed(names[: names.index(layer) + 1]))

    def check_layer(self, layer: str) -> None:
        if layer not in self.layer_names:
            raise ValueError(
                f"model {self.name!r} has no projectable layer {layer!r}; "
                f"known: {list(self.layer_names)}"
            )

    def batched_visualizer(
        self,
        layer: str,
        mode: str,
        top_k: int,
        bug_compat: bool = True,
        backward_dtype: str | None = None,
        post: str | None = None,
        fused_unpool: str = FUSED_DEFAULT,
        sweep: bool = False,
        lowc_kpack: str = "off",
    ):
        """``fn(params, batch)`` -> ``{layer: {indices, sums, valid, ...}}``,
        one entry per projected layer (every layer from ``layer`` down with
        ``sweep=True``).  ``post="grid"`` replaces the fp32 ``images`` with
        a uint8 ``grid`` (2x2 stitch + deprocess, the ``POST /``
        presentation), ``post="tiles"`` with uint8 ``tiles`` (each
        projection deprocessed alone, the ``/v1/deconv`` presentation);
        ``post=None`` keeps the raw projections.  ``lowc_kpack``
        (off|auto|forced|<chan>) sets the packed tail."""
        self.check_layer(layer)
        if post not in (None, "grid", "tiles"):
            raise ValueError(f"illegal post {post!r}; expected None, 'grid' or 'tiles'")
        raw = get_visualizer(
            self.spec, layer, top_k, mode, bug_compat,
            backward_dtype=backward_dtype or None, fused_unpool=fused_unpool,
            device=self.device, sweep=sweep,
            kpack_chan=resolve_kpack_chan(lowc_kpack, top_k),
        )
        return raw if post is None else _fuse_post(raw, post)


def _fuse_post(raw, post: str):
    """Compose the visualizer with the device postprocess: each projected
    layer's fp32 ``images`` become its uint8 ``grid`` or ``tiles``."""

    def fused(params, batch):
        result = {}
        for name, entry in raw(params, batch).items():
            out = dict(entry)
            images = out.pop("images")
            if post == "grid":
                out["grid"] = codec.stitch_grid(images, out["valid"])
            else:
                out["tiles"] = codec.deprocess_tiles(images)
            result[name] = out
        return result

    return fused


REGISTRY = {"vgg16": VGG16_SPEC, "vgg_tiny": VGG_TINY_SPEC}


def build_bundle(model: str, device=None, seed: int = 0) -> ModelBundle:
    """A registry model with He-normal weights from a seeded generator on
    the serving device (no pretrained weights ship with the repo)."""
    if model not in REGISTRY:
        raise ValueError(f"unknown model {model!r}; known: {sorted(REGISTRY)}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = REGISTRY[model]
    return ModelBundle(spec, init_params(spec, gen, dev), dev)
