"""Model registry for serving (counterpart of
``deconv_api_tpu/serving/models.py``).

A ``ModelBundle`` packages what the HTTP layer needs: params on one device,
the input size and preprocessing, the projectable layer names, and a maker
of batched visualizers whose output carries the uint8 presentation
(``post="grid"`` or ``"tiles"``) instead of the fp32 projections, so only
uint8 leaves the device.  Sequential specs (VGG16, VGG19, vgg_tiny) run the
switch-deconv engine (``engine/deconv.py``); DAG models (ResNet50,
InceptionV3, the MobileNets) run the autodiff engine
(``engine/autodeconv.py``), for which the backward dtype, ``bug_compat``,
``lowc_kpack`` and ``fused_unpool`` are inert: the DAG backward stays fp32
over the saved forward, as in the reference.  A bundle also carries its
DeepDream surface: default target layers, the smallest octave edge, the
inverse preprocessing, and ``dream_forward``.

Under a ``WeightManager`` in managed mode (``serving/weight_manager.py``)
a bundle's ``params`` is its f32 tree on the host and its programs read
``stored``, the resident device tree in the weight tier's stored form
(f32, bf16 or int8), which they dequantize inside their captured graph;
``page_out`` drops it with every captured program and its memory pool."""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from deconv_api_tpu_torch._device import resolve_device
from deconv_api_tpu_torch.engine.autodeconv import autodeconv_visualizer
from deconv_api_tpu_torch.engine.capture import BatchProgram, CapturedProgram, ProgramCache
from deconv_api_tpu_torch.engine.deconv import get_visualizer, resolve_kpack_chan
from deconv_api_tpu_torch.engine.deepdream import dream_programs
from deconv_api_tpu_torch.models import inception_v3, mobilenet_v1, mobilenet_v2, resnet50
from deconv_api_tpu_torch.models.apply import spec_forward
from deconv_api_tpu_torch.models.blocks import DECONV_RULES
from deconv_api_tpu_torch.models.spec import ModelSpec, init_params
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.vgg16 import VGG16_SPEC
from deconv_api_tpu_torch.models.vgg19 import VGG19_SPEC
from deconv_api_tpu_torch.models.weights import tree_map
from deconv_api_tpu_torch.ops.cuda_deconv import FUSED_DEFAULT, resolve_fused_unpool
from deconv_api_tpu_torch.serving import codec
from deconv_api_tpu_torch.serving.weight_manager import dequantize_params


@dataclasses.dataclass
class ModelBundle:
    """A sequential model (``spec`` set; name, size and layers default from
    it) or a DAG model (``spec`` None, ``forward_fn`` set)."""

    spec: ModelSpec | None
    params: dict  # nested dict of tensors on ``device``
    device: torch.device
    name: str = ""
    image_size: int = 0
    preprocess: Callable = codec.preprocess_vgg
    layer_names: tuple[str, ...] = ()  # projectable layers
    forward_fn: Callable | None = None  # forward_fn(params, x, *, rules) -> (out, acts)
    dream_layers: tuple[str, ...] = ()  # default DeepDream targets
    min_dream_size: int = 16  # smallest octave edge the trunk accepts
    unpreprocess: Callable = codec.unpreprocess_vgg  # model input -> BGR uint8
    # set by a WeightManager in managed mode: the stored weight tier and
    # the resident device tree the programs read (None while paged out)
    weight_dtype: str = "f32"
    managed: bool = False
    stored: dict | None = dataclasses.field(default=None, repr=False)
    _acts: tuple[str, ...] | None = dataclasses.field(default=None, repr=False)
    _dream_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    _vis_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    # the captured programs of the deconv dispatcher and of the dream one:
    # a memory pool each, since the two run at the same time
    programs: ProgramCache = dataclasses.field(init=False, repr=False)
    dream_programs: ProgramCache = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.programs = ProgramCache(self.device)
        self.dream_programs = ProgramCache(self.device)
        if self.spec is not None:
            self.name = self.name or self.spec.name
            self.image_size = self.image_size or self.spec.input_shape[0]
            self.layer_names = self.layer_names or tuple(
                l.name for l in self.spec.layers if l.kind != "input"
            )

    def program_params(self) -> dict:
        """The tree the programs read: ``params`` itself, or in managed
        mode the resident stored tree."""
        if not self.managed:
            return self.params
        if self.stored is None:
            raise RuntimeError(f"model {self.name!r} is not resident on the device: check it out first")
        return self.stored

    def page_out(self) -> None:
        """Drop the resident tree and every captured program with its
        memory pool (the caller holds ``DEVICE_LOCK`` exclusively, and
        ``torch.cuda.empty_cache`` then releases the pools)."""
        self.stored = None
        self.programs.clear()
        self.dream_programs.clear()

    def _wrap_weight_dtype(self, fn):
        """``fn(params, x, ...)`` reading the stored tier: it dequantizes
        first (stored -> f32), then runs ``fn``, which casts as it always
        does (the bf16 backward).  ``fn`` itself in the f32 tier."""
        if self.weight_dtype == "f32":
            return fn

        def fn_q(params, x, *args, **kwargs):
            return fn(dequantize_params(params), x, *args, **kwargs)

        return fn_q

    def activation_names(self) -> tuple[str, ...]:
        """A DAG model's named activations in forward order: the insertion
        order of one forward on the ``meta`` device (shapes only, no data),
        under the rules the visualizer runs with."""
        if self._acts is None:
            params = tree_map(lambda t: torch.empty_like(t, device="meta"), self.params)
            x = torch.empty((1, self.image_size, self.image_size, 3), device="meta")
            with torch.no_grad():
                _, acts = self.forward_fn(params, x, rules=DECONV_RULES)
            self._acts = tuple(acts)
        return self._acts

    def forward_order(self) -> tuple[str, ...]:
        """The projectable layers in forward order."""
        if self.spec is not None:
            return self.layer_names
        acts = self.activation_names()
        missing = sorted(set(self.layer_names) - set(acts))
        if missing:
            raise ValueError(f"model {self.name!r}: projectable layer(s) {missing} are not named by its forward")
        keep = set(self.layer_names)
        return tuple(n for n in acts if n in keep)

    def deepest_layer(self) -> str:
        """The layer warmup projects: the last conv of a spec, the last
        projectable activation of a DAG model."""
        if self.spec is not None:
            return [l.name for l in self.spec.layers if l.kind == "conv"][-1]
        return self.forward_order()[-1]

    def sweep_layers(self, layer: str) -> tuple[str, ...]:
        """The projectable layers at and below ``layer`` in forward order,
        deepest first: what a sweep from ``layer`` projects."""
        self.check_layer(layer)
        names = self.forward_order()
        return tuple(reversed(names[: names.index(layer) + 1]))

    def check_layer(self, layer: str) -> None:
        if layer not in self.layer_names:
            raise ValueError(
                f"model {self.name!r} has no projectable layer {layer!r}; "
                f"known: {list(self.layer_names)}"
            )

    def dream_forward(self, layers: tuple[str, ...]):
        """The forward a dream of ``layers`` climbs, which must accept every
        octave's size: a DAG model's as it is, a spec's truncated at its
        deepest target (below the flatten and dense head).  Cached per layer
        set.  A layer the model does not name, or a spec's dense or flatten
        layer, is a ``KeyError``."""
        layers = tuple(layers)
        if layers not in self._dream_cache:
            if self.spec is None:
                known = self.activation_names()
                for name in layers:
                    if name not in known:
                        raise KeyError(f"model has no activation {name!r}; known: {list(known)}")
                fwd = self.forward_fn
            else:
                by_name = {l.name: l for l in self.spec.layers}
                for name in layers:
                    if name not in by_name:
                        raise KeyError(f"model has no activation {name!r}")
                    if by_name[name].kind not in ("conv", "pool"):
                        raise KeyError(
                            f"layer {name!r} ({by_name[name].kind}) is not dreamable: octave "
                            "resizing needs conv or pool layers (dense heads are resolution-bound)"
                        )
                names = self.spec.layer_names()
                fwd = spec_forward(self.spec.truncated(max(layers, key=names.index)))
            # one wrapper per layer set: the step programs key on its identity
            self._dream_cache[layers] = self._wrap_weight_dtype(fwd)
        return self._dream_cache[layers]

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
        quant=None,
    ):
        """``fn(params, batch)`` -> ``{layer: {indices, sums, valid, ...}}``,
        one entry per projected layer (every layer from ``layer`` down with
        ``sweep=True``).  ``post="grid"`` replaces the fp32 ``images`` with
        a uint8 ``grid`` (2x2 stitch + deprocess, the ``POST /``
        presentation), ``post="tiles"`` with uint8 ``tiles`` (each
        projection deprocessed alone, the ``/v1/deconv`` presentation);
        ``post=None`` keeps the raw projections.  ``lowc_kpack``
        (off|auto|forced|<chan>) sets the packed tail of a spec; a DAG model
        validates it and ``fused_unpool`` and leaves both inert, and
        ignores ``bug_compat`` and ``backward_dtype``.  ``quant`` (None,
        ``"dynamic"`` or calibrated (entry, amax) pairs) runs a spec's
        forward walk in int8 (``engine/deconv.py``); a DAG model has no
        int8 walk and ignores it (the service runs its ``quality=int8`` as
        bf16).  A ``BatchProgram``, made once per setting (the reference's
        ``_vis_cache``)."""
        key = self._vis_key(layer, mode, top_k, bug_compat, backward_dtype, post, fused_unpool, sweep,
                            lowc_kpack, quant)
        fn = self._vis_cache.get(key)
        if fn is not None:
            return fn
        self.check_layer(layer)
        if post not in (None, "grid", "tiles"):
            raise ValueError(f"illegal post {post!r}; expected None, 'grid' or 'tiles'")
        if self.spec is None:
            raw = autodeconv_visualizer(
                self.forward_fn, layer, top_k, mode,
                sweep_layers=self.sweep_layers(layer) if sweep else None, device=self.device,
                lowc_kpack=lowc_kpack, fused_unpool=fused_unpool,
            )
        else:
            raw = get_visualizer(
                self.spec, layer, top_k, mode, bug_compat,
                backward_dtype=backward_dtype or None, fused_unpool=fused_unpool,
                device=self.device, sweep=sweep,
                kpack_chan=resolve_kpack_chan(lowc_kpack, top_k), quant=quant,
            )
        if self.weight_dtype != "f32":
            # the program reads the stored tree and dequantizes inside its
            # own graph: the card holds the stored bytes
            raw = dataclasses.replace(raw, body=self._wrap_weight_dtype(raw.body))
        fn = self._vis_cache[key] = raw if post is None else _fuse_post(raw, post)
        return fn

    def _vis_key(self, layer, mode, top_k, bug_compat, backward_dtype, post, fused_unpool, sweep, lowc_kpack,
                 quant=None):
        """Everything that changes a visualizer, as ``batched_visualizer``
        resolves it (a DAG model validates the sequential engine's knobs and
        ignores them).  The float walk's key is the one it had before the
        int8 tier; a quantized walk appends its quant spec."""
        fused_unpool, kpack_chan = resolve_fused_unpool(fused_unpool), resolve_kpack_chan(lowc_kpack, top_k)
        if self.spec is None:
            return (self.name, layer, mode, top_k, post, sweep)
        key = (self.name, layer, mode, top_k, post, sweep, fused_unpool, kpack_chan, bool(bug_compat),
               backward_dtype or None)
        return key if quant is None else (*key, quant)

    def program(
        self, layer: str, mode: str, top_k: int, bucket: int, *, bug_compat: bool = True,
        backward_dtype: str | None = None, post: str | None = None,
        fused_unpool: str = FUSED_DEFAULT, sweep: bool = False, lowc_kpack: str = "off", quant=None,
        dtype: torch.dtype = torch.float32, image_size: int = 0,
    ) -> CapturedProgram:
        """The captured ``batched_visualizer`` program of these settings at a
        batch of ``bucket`` images of ``image_size`` (default the model's)
        (``program(batch)`` loads a (bucket, H, W, 3) batch and replays),
        from ``self.programs``: captured at its first use, kept per (program
        key, bucket, shape).  ``dtype`` is the staged batch's (bfloat16 runs
        the forward in bf16: ``quality=bf16``).  Replay it and read its
        outputs inside ``self.programs.replaying()``."""
        vis = self.batched_visualizer(
            layer, mode, top_k, bug_compat, backward_dtype, post, fused_unpool, sweep, lowc_kpack, quant
        )
        size = image_size or self.image_size
        shape = (bucket, size, size, 3)
        key = ("deconv", *self._vis_key(layer, mode, top_k, bug_compat, backward_dtype, post,
                                        fused_unpool, sweep, lowc_kpack, quant), bucket, shape)
        if dtype != torch.float32:
            key = (*key, str(dtype))

        def make():
            return functools.partial(vis.body, self.program_params()), (vis.static_input(shape, dtype),)

        return self.programs.get(key, make)

    def dream_program(
        self, layers: tuple[str, ...], ladder: tuple[tuple[int, int], ...], bucket: int
    ) -> list[tuple[CapturedProgram, CapturedProgram]]:
        """The captured programs of a float32 dream of ``layers`` over the
        octave ``ladder`` (its last rung the image size) at a batch of
        ``bucket`` images, from ``self.dream_programs``: per rung, its
        pyramid step and its ascent step (``engine/deepdream.py:
        dream_programs``), run by ``run_dream_programs`` inside
        ``self.dream_programs.replaying()``."""
        layers = tuple(layers)
        return dream_programs(
            self.dream_programs, self.dream_forward(layers), self.program_params(), layers, tuple(ladder),
            (bucket, *ladder[-1], 3), torch.float32,
        )


def _fuse_post(raw: BatchProgram, post: str) -> BatchProgram:
    """Compose the visualizer with the device postprocess: each projected
    layer's fp32 ``images`` become its uint8 ``grid`` or ``tiles``."""

    def fused(params, batch):
        result = {}
        for name, entry in raw.body(params, batch).items():
            out = dict(entry)
            images = out.pop("images")
            if post == "grid":
                out["grid"] = codec.stitch_grid(images, out["valid"])
            else:
                out["tiles"] = codec.deprocess_tiles(images)
            result[name] = out
        return result

    return dataclasses.replace(raw, body=fused)


def _spec_bundle(spec: ModelSpec, dream_layers: tuple[str, ...]):
    def build(gen: torch.Generator, dev: torch.device) -> ModelBundle:
        return ModelBundle(spec, init_params(spec, gen, dev), dev, dream_layers=dream_layers)

    return build


def _dag_bundle(name, module, init, forward, image_size: int, preprocess, **dream):
    def build(gen: torch.Generator, dev: torch.device) -> ModelBundle:
        return ModelBundle(
            None, init(gen, device=dev), dev, name=name, image_size=image_size,
            preprocess=preprocess, layer_names=module.DECONV_LAYERS, forward_fn=forward, **dream,
        )

    return build


# the reference's image sizes, preprocessing modes, projectable layers and
# dream settings (deconv_api_tpu/serving/models.py, the registry's bundles)
REGISTRY: dict[str, Callable[[torch.Generator, torch.device], ModelBundle]] = {
    "vgg16": _spec_bundle(VGG16_SPEC, ("block4_conv3", "block5_conv1")),
    "vgg19": _spec_bundle(VGG19_SPEC, ("block4_conv4", "block5_conv1")),
    "vgg_tiny": _spec_bundle(VGG_TINY_SPEC, ("block2_conv2", "block3_conv1")),
    # Keras resnet50 uses caffe mode, like VGG
    "resnet50": _dag_bundle("resnet50", resnet50, resnet50.resnet50_init,
                            resnet50.resnet50_forward, 224, codec.preprocess_vgg,
                            dream_layers=("conv4_block3_out", "conv4_block6_out")),
    # the VALID-padded stem needs >= 75 px
    "inception_v3": _dag_bundle("inception_v3", inception_v3, inception_v3.inception_v3_init,
                                inception_v3.inception_v3_forward, 299, codec.preprocess_tf,
                                dream_layers=inception_v3.DREAM_LAYERS, min_dream_size=75,
                                unpreprocess=codec.unpreprocess_tf),
    # five (0, 1)-padded stride-2 convs
    "mobilenet_v1": _dag_bundle("mobilenet_v1", mobilenet_v1, mobilenet_v1.mobilenet_v1_init,
                                mobilenet_v1.mobilenet_v1_forward, 224, codec.preprocess_tf,
                                dream_layers=mobilenet_v1.DREAM_LAYERS, min_dream_size=32,
                                unpreprocess=codec.unpreprocess_tf),
    "mobilenet_v2": _dag_bundle("mobilenet_v2", mobilenet_v2, mobilenet_v2.mobilenet_v2_init,
                                mobilenet_v2.mobilenet_v2_forward, 224, codec.preprocess_tf,
                                dream_layers=mobilenet_v2.DREAM_LAYERS, min_dream_size=32,
                                unpreprocess=codec.unpreprocess_tf),
}


def build_bundle(model: str, device=None, seed: int = 0) -> ModelBundle:
    """A registry model with He-normal weights from a seeded generator on
    the serving device (no pretrained weights ship with the repo)."""
    if model not in REGISTRY:
        raise ValueError(f"unknown model {model!r}; known: {sorted(REGISTRY)}")
    dev = resolve_device(device)
    return REGISTRY[model](torch.Generator(device=dev).manual_seed(seed), dev)


def registry_info() -> list[dict]:
    """Static metadata of each registered model, with no weight init and no
    device touch (``deconv_api_tpu/serving/models.py:registry_info``)."""
    seq, dag = "switch-deconv (sequential spec)", "autodiff-deconv (DAG)"

    def layers(spec: ModelSpec) -> list[str]:
        return [l.name for l in spec.layers if l.kind != "input"]

    return [
        {"model": "vgg16", "image_size": 224, "engine": seq, "layers": layers(VGG16_SPEC),
         "dream_layers": ["block4_conv3", "block5_conv1"]},
        {"model": "vgg19", "image_size": 224, "engine": seq, "layers": layers(VGG19_SPEC),
         "dream_layers": ["block4_conv4", "block5_conv1"]},
        {"model": "resnet50", "image_size": 224, "engine": dag, "layers": list(resnet50.DECONV_LAYERS),
         "dream_layers": ["conv4_block3_out", "conv4_block6_out"]},
        {"model": "inception_v3", "image_size": 299, "engine": dag, "layers": list(inception_v3.DECONV_LAYERS),
         "dream_layers": list(inception_v3.DREAM_LAYERS)},
        {"model": "mobilenet_v1", "image_size": 224, "engine": "autodiff-deconv (DAG, depthwise-separable)",
         "layers": list(mobilenet_v1.DECONV_LAYERS), "dream_layers": list(mobilenet_v1.DREAM_LAYERS)},
        {"model": "mobilenet_v2", "image_size": 224, "engine": "autodiff-deconv (DAG, inverted residuals)",
         "layers": list(mobilenet_v2.DECONV_LAYERS), "dream_layers": list(mobilenet_v2.DREAM_LAYERS)},
        {"model": "vgg_tiny", "image_size": VGG_TINY_SPEC.input_shape[0],
         "engine": "switch-deconv (sequential spec, CI-scale)", "layers": layers(VGG_TINY_SPEC),
         "dream_layers": ["block2_conv2", "block3_conv1"]},
    ]
