"""The port's captured programs on the CPU (deconv_api_tpu_torch/engine/
capture.py, serving/batcher.py and their use in serving/models.py and
serving/app.py): the bucket rule against the JAX package's, padded rows
against solo runs, the program cache, the static buffers, the chained
ascent step, the captured-form dream against JAX's, and what warmup
readies.  On the CPU a captured program runs its body on every replay
through the same static buffers; ``tests/test_torch_cuda.py`` holds the
graphs themselves on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deconv_api_tpu.engine import deepdream_batch as j_deepdream_batch
from deconv_api_tpu.models.tiny import VGG_TINY_SPEC as J_TINY_SPEC, vgg_tiny_init
from deconv_api_tpu.serving.batcher import pad_bucket as j_pad_bucket
from deconv_api_tpu.serving.models import spec_bundle as j_spec_bundle
from deconv_api_tpu_torch.engine.capture import ProgramCache, SharedLock
from deconv_api_tpu_torch.engine.crosscheck import psnr_db
from deconv_api_tpu_torch.engine.deepdream import _ascend, dream_programs, octave_shapes, run_dream_programs
from deconv_api_tpu_torch.models import mobilenet_v1
from deconv_api_tpu_torch.serving.app import DEFAULT_TOP_K, STITCH_K, DeconvService, Dream, Program
from deconv_api_tpu_torch.serving.batcher import buckets, pad_bucket, pad_to_bucket
from deconv_api_tpu_torch.serving.models import ModelBundle, build_bundle
from tests.test_torch_serving import _bundle
from tests.torch_dag_families import both_params

LAYER = "block3_conv1"  # vgg_tiny's deepest conv
TINY_DREAM_LAYERS = ("block2_conv2", "block3_conv1")
# the JAX package's bars for a split batch (tests/test_parallel.py) and for
# a batched dream against its solo runs (tests/test_deepdream.py)
RTOL, ATOL = 1e-4, 1e-5
DREAM_RTOL, DREAM_ATOL = 2e-4, 2e-5
BF16_GRID_DB = 52.0
QUICK_DREAM = Dream(TINY_DREAM_LAYERS, steps=2, octaves=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny():
    bundle = build_bundle("vgg_tiny", "cpu")
    bundle.dream_layers = TINY_DREAM_LAYERS
    return bundle


def _images(n: int, size: int = 32, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((n, size, size, 3)) * 50).astype(np.float32)


@pytest.mark.parametrize("max_batch", [1, 3, 4, 8])
def test_pad_bucket_matches_jax(max_batch):
    assert [pad_bucket(n, max_batch) for n in range(1, 65)] == [j_pad_bucket(n, max_batch) for n in range(1, 65)]


def test_buckets_and_tail_padding():
    assert buckets(8) == [1, 2, 4, 8] and buckets(4) == [1, 2, 4] and buckets(3) == [1, 2, 3]
    xs = _images(3)
    padded = pad_to_bucket(xs, 4)
    assert padded.shape == (4, 32, 32, 3) and padded.dtype == np.float32
    np.testing.assert_array_equal(padded[:3], xs)
    np.testing.assert_array_equal(padded[3], xs[2])
    assert pad_to_bucket(xs[:2], 2) is not None and np.array_equal(pad_to_bucket(xs[:2], 2), xs[:2])
    with pytest.raises(ValueError, match="do not fit"):
        pad_to_bucket(_images(9), 8)


def _padded_vs_solo(bundle: ModelBundle, layer: str, n: int, bucket: int, **settings):
    """Each real row of ``n`` images padded to ``bucket`` against its solo
    run, through the bundle's programs: fp32 projections."""
    xs = _images(n, bundle.image_size)
    prog = bundle.program(layer, "all", STITCH_K, bucket, **settings)
    with bundle.programs.replaying():
        got = {k: v[:n].clone() for k, v in prog(torch.from_numpy(pad_to_bucket(xs, bucket)))[layer].items()}
    solo = bundle.program(layer, "all", STITCH_K, 1, **settings)
    for i in range(n):
        with bundle.programs.replaying():
            want = solo(torch.from_numpy(xs[i : i + 1]))[layer]
            assert torch.equal(got["indices"][i], want["indices"][0]), f"row {i}"
            assert torch.equal(got["valid"][i], want["valid"][0]), f"row {i}"
            torch.testing.assert_close(got["images"][i], want["images"][0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,bucket", [(3, 4), (5, 8)])
def test_padded_rows_equal_solo_runs(tiny, n, bucket):
    _padded_vs_solo(tiny, LAYER, n, bucket)
    # the served grids (bf16 backward) against the solo runs
    service = DeconvService(tiny, max_batch=8)
    xs = _images(n, seed=1)
    got = service.run_program(Program(LAYER), xs)[LAYER]
    assert got["grid"].shape == (n, 64, 64, 3)
    for i in range(n):
        want = service.run_program(Program(LAYER), xs[i : i + 1])[LAYER]
        np.testing.assert_array_equal(got["indices"][i], want["indices"][0])
        assert psnr_db(got["grid"][i], want["grid"][0]) >= BF16_GRID_DB


def test_padded_rows_of_a_dag_family_equal_solo_runs():
    bundle = ModelBundle(
        None, both_params("mobilenet_v1")[1], torch.device("cpu"), name="mobilenet_v1", image_size=64,
        layer_names=mobilenet_v1.DECONV_LAYERS, forward_fn=mobilenet_v1.mobilenet_v1_forward,
    )
    _padded_vs_solo(bundle, "conv_pw_11_relu", 3, 4)


def test_padded_dream_rows_equal_solo_dreams(tiny):
    service = DeconvService(tiny)
    xs = _images(3, seed=2)
    got_x, got_l = service.run_dream(QUICK_DREAM, xs)
    assert got_x.shape == xs.shape and got_l.shape == (3,)
    assert len(tiny.dream_programs.keys()) == 2 * 2  # a pyramid and a step program per rung, bucket 4
    for i in range(3):
        want_x, want_l = service.run_dream(QUICK_DREAM, xs[i : i + 1])
        np.testing.assert_allclose(got_x[i], want_x[0], rtol=DREAM_RTOL, atol=DREAM_ATOL)
        np.testing.assert_allclose(got_l[i], want_l[0], rtol=DREAM_RTOL)


def test_program_cache_keys_and_lru_bound(tiny):
    settings = dict(post="grid", backward_dtype="bfloat16")
    a = tiny.program(LAYER, "all", STITCH_K, 2, **settings)
    assert tiny.program(LAYER, "all", STITCH_K, 2, **settings) is a
    b = tiny.program(LAYER, "all", STITCH_K, 4, **settings)  # the bucket is part of the key
    assert b is not a and b.static[0].shape == (4, 32, 32, 3)
    assert tiny.program(LAYER, "all", STITCH_K, 2, **settings, fused_unpool="forced") is not a
    assert tiny.program(LAYER, "all", STITCH_K, 2, **{**settings, "backward_dtype": None}) is not a
    assert tiny.batched_visualizer(LAYER, "all", STITCH_K, post="grid") is tiny.batched_visualizer(
        LAYER, "all", STITCH_K, post="grid")

    cache = ProgramCache(torch.device("cpu"), maxsize=2)

    def make(k):
        return lambda: (lambda x: x * k, (torch.zeros(2),))

    first = cache.get(1, make(1))
    cache.get(2, make(2))
    assert cache.get(1, make(1)) is first  # a hit refreshes 1
    cache.get(3, make(3))  # evicts 2, the least recently used
    assert cache.keys() == [1, 3] and len(cache) == 2
    assert cache.get(2, make(2)) is not None and cache.keys() == [3, 2]


def test_two_calls_through_the_static_buffers(tiny):
    """The second call reuses the first's output buffers; what
    ``run_program`` returned from the first is a copy it leaves intact."""
    service = DeconvService(tiny)
    xa, xb = _images(2, seed=3), _images(2, seed=4)
    eager = tiny.batched_visualizer(LAYER, "all", STITCH_K, True, "bfloat16", post="grid")
    ra = service.run_program(Program(LAYER), xa)[LAYER]
    keep = {k: v.copy() for k, v in ra.items()}
    prog = tiny.program(LAYER, "all", STITCH_K, 2, backward_dtype="bfloat16", post="grid")
    first_outputs = prog.outputs
    rb = service.run_program(Program(LAYER), xb)[LAYER]
    assert prog.outputs is first_outputs  # the same static outputs, overwritten
    for k in keep:
        np.testing.assert_array_equal(ra[k], keep[k])
    for got, xs in ((ra, xa), (rb, xb)):
        want = eager(tiny.params, xs)[LAYER]
        np.testing.assert_array_equal(got["grid"], want["grid"].numpy())
        np.testing.assert_array_equal(got["indices"], want["indices"].numpy())
    assert not np.array_equal(ra["grid"], rb["grid"])


def test_chained_ascent_step_equals_the_eager_loop(tiny):
    fwd = tiny.dream_forward(TINY_DREAM_LAYERS)
    x = torch.from_numpy(_images(2, 23, seed=5) / 50)
    rungs = dream_programs(ProgramCache(torch.device("cpu")), fwd, tiny.params, TINY_DREAM_LAYERS,
                           ((23, 23),), (2, 23, 23, 3), torch.float32)
    _, step = rungs[0]
    step.load(x, torch.tensor(0.01))
    for _ in range(3):
        losses = step.replay()
    want_x, want_l = _ascend(fwd, tiny.params, x, TINY_DREAM_LAYERS, 3, 0.01)
    assert torch.equal(step.static[0], want_x) and torch.equal(losses, want_l)


def test_captured_form_dream_matches_jax():
    jparams = vgg_tiny_init(jax.random.key(1, impl="rbg"))[1]
    bundle = _bundle(jparams)
    bundle.dream_layers = TINY_DREAM_LAYERS
    xs = _images(3, seed=6)
    got_x, got_l = DeconvService(bundle).run_dream(QUICK_DREAM, xs)  # bucket 4
    jbundle = j_spec_bundle(J_TINY_SPEC, jparams, dream_layers=TINY_DREAM_LAYERS)
    want_x, want_l = j_deepdream_batch(
        jbundle.dream_forward(TINY_DREAM_LAYERS), jparams, jnp.asarray(xs), layers=TINY_DREAM_LAYERS,
        steps_per_octave=QUICK_DREAM.steps, num_octaves=QUICK_DREAM.octaves, lr=QUICK_DREAM.lr,
        min_size=jbundle.min_dream_size,
    )
    np.testing.assert_allclose(got_x, np.asarray(want_x), rtol=DREAM_RTOL, atol=DREAM_ATOL)
    np.testing.assert_allclose(got_l, np.asarray(want_l), rtol=DREAM_RTOL)


def test_warmup_readies_every_bucket_of_both_routes_and_the_default_dream():
    # what the card's warmup captures, made here through the same calls
    bundle = build_bundle("vgg_tiny", "cpu")
    service = DeconvService(bundle)
    for program, bucket in service.warmup_programs():
        service.warm(program, bucket)
    deconv = {(k[2], k[4], k[5], k[-2]) for k in bundle.programs.keys()}
    assert deconv == {(LAYER, top_k, post, b) for b in (1, 2, 4, 8)
                      for top_k, post in ((STITCH_K, "grid"), (DEFAULT_TOP_K, "tiles"))}
    ladder = octave_shapes(32, 32, 10, 1.4, bundle.min_dream_size)
    dreams = {(k[0], k[1], k[3] if k[0] == "pyramid" else k[2]) for k in bundle.dream_programs.keys()}
    assert dreams == {(kind, hw, b if kind == "step" else (b, 32, 32, 3)) for hw in ladder
                      for b in (1, 2, 4) for kind in ("pyramid", "step")}

    cpu_default = DeconvService(build_bundle("vgg_tiny", "cpu"))
    assert not cpu_default.ready and cpu_default.warmup_wall_s is None
    cpu_default.warmup()  # on the CPU: the one batch-1 grid
    assert cpu_default.ready and cpu_default.warmup_wall_s > 0
    assert [(k[2], k[5], k[-2]) for k in cpu_default.bundle.programs.keys()] == [(LAYER, "grid", 1)]
    assert not cpu_default.bundle.dream_programs.keys()


def test_run_dream_programs_with_no_steps_returns_the_pyramid_and_zero_losses(tiny):
    fwd = tiny.dream_forward(TINY_DREAM_LAYERS)
    base = torch.from_numpy(_images(1, seed=7))
    rungs = dream_programs(ProgramCache(torch.device("cpu")), fwd, tiny.params, TINY_DREAM_LAYERS,
                           ((16, 16), (32, 32)), (1, 32, 32, 3), torch.float32)
    x, losses = run_dream_programs(rungs, base, 0, 0.01)
    assert x.shape == (1, 32, 32, 3) and torch.equal(losses, torch.zeros(1))


def test_shared_lock_is_reentrant_for_its_exclusive_holder_only():
    """A cache miss holds the lock exclusively over its capture, which takes
    it again: the holder re-enters; another thread's shared and exclusive
    holders wait until it lets go."""
    import threading

    lock, order = SharedLock(), []

    def other(kind):
        with getattr(lock, kind)():
            order.append(kind)

    with lock.exclusive():
        with lock.exclusive():
            threads = [threading.Thread(target=other, args=(k,)) for k in ("shared", "exclusive")]
            for t in threads:
                t.start()
            threads[0].join(0.2)
            assert threads[0].is_alive() and threads[1].is_alive() and not order
        order.append("holder")
    for t in threads:
        t.join(5)
    assert order[0] == "holder" and sorted(order[1:]) == ["exclusive", "shared"]
