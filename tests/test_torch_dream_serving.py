"""``POST /v1/dream`` and the request's ``model`` on the port's service, in
process on the CPU with vgg_tiny: the dream against the JAX package's
``deepdream_batch`` and ``unpreprocess_vgg``, the reference's validation
table, model resolution on every POST route, and the dream dispatcher
beside the deconv one."""

import json
import math
import threading
import urllib.parse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deconv_api_tpu import errors as j_errors
from deconv_api_tpu.engine import deepdream_batch as j_deepdream_batch
from deconv_api_tpu.models.tiny import VGG_TINY_SPEC as J_TINY_SPEC, vgg_tiny_init
from deconv_api_tpu.serving import codec as j_codec
from deconv_api_tpu.serving.models import spec_bundle as j_spec_bundle
from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.serving import codec
from deconv_api_tpu_torch.serving.app import DeconvService, Dream
from deconv_api_tpu_torch.serving.models import REGISTRY
from tests.test_torch_serving import LAYER, _bundle, _image_uri, _Served

TINY_DREAM_LAYERS = ("block2_conv2", "block3_conv1")
QUICK = {"steps": "1", "octaves": "1"}  # one ascent step, for the routing checks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    return vgg_tiny_init(jax.random.key(1, impl="rbg"))[1]


def _tiny_bundle(jparams):
    bundle = _bundle(jparams)
    bundle.dream_layers = TINY_DREAM_LAYERS
    return bundle


@pytest.fixture(scope="module")
def served(jax_params):
    s = DeconvService(_tiny_bundle(jax_params))
    s.warmup()
    srv = _Served(s)
    yield srv
    srv.close()


def test_registry_bundles_carry_the_reference_dream_settings():
    bundle = REGISTRY["vgg_tiny"](torch.Generator().manual_seed(0), torch.device("cpu"))
    assert bundle.dream_layers == TINY_DREAM_LAYERS and bundle.min_dream_size == 16
    assert bundle.unpreprocess is codec.unpreprocess_vgg


def test_dream_matches_jax_deepdream_batch(served, jax_params):
    """The route's defaults (block2_conv2 and block3_conv1, 10 steps, 10
    octaves of which 3 fit over 16 px, lr 0.01): the served image is the
    port's dream, within one uint8 level of JAX's."""
    uri = _image_uri(0)
    status, body = served.post({"file": uri}, "/v1/dream")
    assert status == 200, body
    assert body["layers"] == list(TINY_DREAM_LAYERS)

    service = served.service
    x = service.decode_preprocess(uri)[None]
    out, losses = service.run_dream(Dream(TINY_DREAM_LAYERS), x)
    port = service.bundle.unpreprocess(out[0])
    assert body["image"] == codec.encode_data_url(port)  # the served bytes
    assert body["loss"] == pytest.approx(float(losses[0]), rel=1e-6)

    jbundle = j_spec_bundle(J_TINY_SPEC, jax_params, dream_layers=TINY_DREAM_LAYERS)
    want_x, want_l = j_deepdream_batch(
        jbundle.dream_forward(TINY_DREAM_LAYERS), jax_params, jnp.asarray(x),
        layers=TINY_DREAM_LAYERS, steps_per_octave=10, num_octaves=10, lr=0.01,
        min_size=jbundle.min_dream_size,
    )
    want = j_codec.unpreprocess_vgg(np.asarray(want_x)[0])
    assert np.abs(port.astype(int) - want.astype(int)).max() <= 1
    assert body["loss"] == pytest.approx(float(want_l[0]), rel=2e-4)


@pytest.mark.parametrize(
    "fields, status, code",
    [
        ({"steps": "0"}, 400, "bad_request"),
        ({"steps": "101"}, 400, "bad_request"),
        ({"octaves": "0"}, 400, "bad_request"),
        ({"octaves": "17"}, 400, "bad_request"),
        ({"steps": "50", "octaves": "11"}, 400, "bad_request"),
        ({"lr": "0"}, 400, "bad_request"),
        ({"lr": "1.5"}, 400, "bad_request"),
        ({"lr": "nan"}, 400, "bad_request"),
        ({"steps": "2.5"}, 400, "bad_request"),
        ({"layers": "block9_conv9"}, 422, "unknown_layer"),
        ({"layers": "block2_conv2,fc1"}, 422, "unknown_layer"),
        ({"file": ""}, 400, "bad_request"),
    ],
    ids=["steps_0", "steps_101", "octaves_0", "octaves_17", "steps_x_octaves_550", "lr_0", "lr_1.5",
         "lr_nan", "steps_not_integer", "unknown_layer", "dense_layer", "no_file"],
)
def test_dream_params_table(served, fields, status, code):
    got_status, payload = served.post({"file": _image_uri(1), **fields}, "/v1/dream")
    assert (got_status, payload["error"]) == (status, code)


def test_dream_answers_503_before_warmup_and_null_for_a_non_finite_loss(jax_params):
    service = DeconvService(_tiny_bundle(jax_params))
    form = {"file": _image_uri(2), **QUICK}
    with pytest.raises(errors.ModelNotReady):
        service.dream_v1(form)
    service.ready = True
    service.dream_dispatcher._dispatch_runner = lambda key, xs: lambda: [{"image": x, "loss": math.nan} for x in xs]
    service.start()
    try:
        body = service.dream_v1(form)
    finally:
        service.close()
    assert body["loss"] is None and json.loads(json.dumps(body))["loss"] is None


ROUTES = {
    "/": {"layer": LAYER},
    "/v1/deconv": {"layer": LAYER, "top_k": "2"},
    "/v1/dream": dict(QUICK),
}


def _raw_post(served, path, form, headers=None):
    return served.request(path, urllib.parse.urlencode(form).encode(), headers)


@pytest.mark.parametrize("path", list(ROUTES))
def test_every_route_resolves_the_model_as_the_reference(served, path):
    """The ``model`` field, else the ``x-model`` header: empty or the
    served name answer as no field does, any other name is the reference's
    422 ``unknown_model``; the field wins over the header."""
    form = {"file": _image_uri(3), **ROUTES[path]}
    status, want = _raw_post(served, path, form)
    assert status == 200
    unknown = (j_errors.UnknownModel.status, j_errors.UnknownModel.code)
    for fields, headers in (
        ({"model": "no_such_model"}, None),
        ({"model": "vgg19"}, None),
        ({}, {"x-model": "no_such_model"}),
        ({}, {"x-model": "vgg19"}),
        ({"model": "no_such_model"}, {"x-model": "vgg_tiny"}),
    ):
        status, payload = _raw_post(served, path, {**form, **fields}, headers)
        assert (status, payload["error"]) == unknown, (fields, headers)
    for fields, headers in (
        ({"model": ""}, None),
        ({"model": "vgg_tiny"}, None),
        ({}, {"x-model": "vgg_tiny"}),
        ({}, {"x-model": ""}),
        ({"model": "vgg_tiny"}, {"x-model": "no_such_model"}),
    ):
        assert _raw_post(served, path, {**form, **fields}, headers) == (200, want), (fields, headers)


def test_a_dream_in_flight_does_not_hold_a_deconv_back(jax_params):
    """While a dream batch is held inside its dispatcher, ``POST /`` is
    answered by the other one; the dream then completes."""
    service = DeconvService(_tiny_bundle(jax_params))
    service.ready = True
    assert service.dispatcher is not service.dream_dispatcher
    started, release = threading.Event(), threading.Event()
    run_dream = service.dream_dispatcher._dispatch_runner

    def held(key, xs):
        started.set()
        assert release.wait(60)
        return run_dream(key, xs)

    service.dream_dispatcher._dispatch_runner = held
    srv = _Served(service)
    try:
        dream = {}
        thread = threading.Thread(
            target=lambda: dream.update(r=srv.post({"file": _image_uri(4), **QUICK}, "/v1/dream"))
        )
        thread.start()
        assert started.wait(60)
        status, body = srv.post({"file": _image_uri(5), "layer": LAYER})
        assert status == 200 and body.startswith("data:image/webp;base64,")
        assert thread.is_alive() and not release.is_set()
        release.set()
        thread.join(60)
        assert dream["r"][0] == 200
        assert list(service.batch_sizes) == [1] and list(service.dream_batch_sizes) == [1]
    finally:
        release.set()
        srv.close()
