"""The port's CUDA kernels and its engine on the card, held against the plain
PyTorch versions.  Needs an NVIDIA GPU and nvcc; skips without a card.  On
a machine without jax, run it without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from deconv_api_tpu_torch import ops
from deconv_api_tpu_torch.engine.deconv import get_visualizer
from deconv_api_tpu_torch.models import VGG_TINY_SPEC, init_params
from deconv_api_tpu_torch.ops import cuda_deconv, cuda_pool, pool
from deconv_api_tpu_torch.ops.activations import deconv_relu, deconv_relu6

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deconv_api_tpu_torch._device import resolve_device

    return resolve_device("cuda")


def _bits(t):
    """The tensor's bits as integers: equal bits, not equal values, so
    -0.0 and +0.0 differ."""
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))


def _misaligned(t):
    """A contiguous copy of ``t`` whose data_ptr is off 16-byte alignment by
    one element: a slice of a larger buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# (shape, pool_size, misaligned): the vector path (2x2, C a multiple of the
# lanes), the scalar path (C 3/5/6/70, C 12 in bf16, windows 3x2 and 1x2, a
# misaligned input), trailing rows and cols dropped, a full-width VGG16 site
POOL_CASES = [
    ((3, 9, 7, 5), (2, 2), False),
    ((2, 12, 12, 33), (3, 2), False),
    ((2, 6, 8, 3), (2, 2), False),
    ((2, 6, 8, 6), (2, 2), False),
    ((2, 6, 8, 12), (2, 2), False),
    ((2, 6, 8, 70), (2, 2), False),
    ((2, 9, 11, 16), (2, 2), False),
    ((2, 9, 8, 16), (3, 2), False),
    ((2, 5, 8, 16), (1, 2), False),
    ((2, 8, 8, 64), (2, 2), True),
    ((8, 224, 224, 64), (2, 2), False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pool_size,misaligned", POOL_CASES, ids=lambda c: str(c).replace(" ", ""))
def test_pool_argmax_kernel_is_bit_exact(dev, dtype, shape, pool_size, misaligned):
    g = torch.Generator(device=dev).manual_seed(0)
    for x in (
        torch.randn(shape, generator=g, device=dev),
        torch.tensor([-0.0, 0.0, 1.0], device=dev)[torch.randint(0, 3, shape, generator=g, device=dev)],
    ):
        x = x.to(dtype)
        if misaligned:
            x = _misaligned(x)
            assert cuda_pool.pool_plan(x.shape, x.element_size(), pool_size, x.data_ptr()).lanes == 1
        got, want = cuda_pool.pool_argmax(x, pool_size), pool.maxpool_argmax_plain(x, pool_size)
        assert torch.equal(got[1], want[1])
        assert torch.equal(_bits(got[0]), _bits(want[0]))


# (switch batch, rep, pooled ho, wo, switch channels, groups, pool_size,
# out_hw padding (rows, cols), relu, misaligned tensor): the vector path and
# the scalar path (C 3/5/6/70, C 12 in bf16, C/groups 6, windows 3x2 and
# 1x2, a misaligned signal or switch tensor), rep 4, odd out_hw
UNPOOL_CASES = [
    (2, 1, 4, 5, 6, 1, (2, 2), (0, 0), False, None),
    (2, 4, 4, 5, 16, 1, (2, 2), (0, 0), True, None),
    (2, 2, 4, 5, 16, 1, (2, 2), (1, 1), True, None),
    (2, 1, 3, 3, 3, 1, (2, 2), (1, 0), False, None),
    (1, 2, 4, 3, 5, 1, (2, 2), (0, 1), True, None),
    (2, 1, 4, 5, 12, 1, (2, 2), (1, 1), False, None),
    (1, 4, 3, 4, 70, 1, (2, 2), (0, 0), True, None),
    (2, 2, 4, 5, 6, 3, (2, 2), (1, 1), False, None),
    (2, 1, 4, 5, 8, 3, (2, 2), (0, 0), True, None),
    (2, 1, 4, 5, 64, 8, (2, 2), (1, 1), True, None),
    (1, 4, 3, 5, 64, 8, (2, 2), (0, 0), False, None),
    (2, 1, 3, 4, 16, 1, (3, 2), (2, 1), False, None),
    (2, 2, 4, 3, 16, 1, (1, 2), (0, 1), True, None),
    (2, 1, 4, 5, 16, 1, (2, 2), (0, 0), False, "y"),
    (2, 1, 4, 5, 16, 2, (2, 2), (1, 1), True, "idx"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", UNPOOL_CASES, ids=lambda c: str(c).replace(" ", ""))
def test_unpool_argmax_kernel_is_exact(dev, dtype, case):
    """Bit for bit, -0.0 included, against the plain version."""
    bi, rep, ho, wo, ci, groups, pool_size, (dh, dw), relu, misaligned = case
    ph, pw = pool_size
    g = torch.Generator(device=dev).manual_seed(1)
    y = torch.randn((bi * rep, ho, wo, groups * ci), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, ph * pw, (bi, ho, wo, ci), generator=g, device=dev, dtype=torch.int8)
    if misaligned == "y":
        y = _misaligned(y)
    elif misaligned == "idx":
        idx = _misaligned(idx)
    out_hw = (ho * ph + dh, wo * pw + dw)
    kind = "unpool_argmax_grouped" if groups > 1 else "unpool_argmax"
    before = cuda_pool.launches[kind]
    got = cuda_pool.unpool_argmax(y, idx, pool_size, out_hw, relu, groups)
    want = pool.unpool_argmax_plain(y, idx, pool_size, out_hw, relu, groups)
    assert got.shape == want.shape == (bi * rep, *out_hw, groups * ci)
    assert torch.equal(_bits(got), _bits(want))
    assert cuda_pool.launches[kind] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups,ci", [(1, 16), (8, 64), (1, 5)])
def test_unpool_kernel_keeps_negative_zero(dev, dtype, groups, ci):
    """Negative values, ReLU off: the slots that are not the argmax hold
    -0.0 (the reference's multiply), not +0.0 (a select)."""
    g = torch.Generator(device=dev).manual_seed(7)
    y = (-torch.rand((4, 3, 5, groups * ci), generator=g, device=dev) - 0.5).to(dtype)
    idx = torch.randint(0, 4, (2, 3, 5, ci), generator=g, device=dev, dtype=torch.int8)
    got = cuda_pool.unpool_argmax(y, idx, (2, 2), None, False, groups)
    want = pool.unpool_argmax_plain(y, idx, (2, 2), None, False, groups)
    neg_zero = _bits(torch.tensor([-0.0], dtype=dtype))[0]
    assert int((_bits(want) == neg_zero).sum()) == 3 * want.numel() // 4
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", ["block1", "packed_block1"])
def test_unpool_kernel_at_a_full_width_vgg16_site(dev, dtype, site):
    """The block1 site of a batch-8 top-4 POST / (y (32,112,112,64), rep 4)
    and the packed block1 site of /v1/deconv (y (8,112,112,512), 8 groups)."""
    rows, groups = (32, 1) if site == "block1" else (8, 8)
    g = torch.Generator(device=dev).manual_seed(8)
    y = torch.randn((rows, 112, 112, groups * 64), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, 4, (8, 112, 112, 64), generator=g, device=dev, dtype=torch.int8)
    for relu in (False, True):
        got = cuda_pool.unpool_argmax(y, idx, (2, 2), None, relu, groups)
        assert torch.equal(_bits(got), _bits(pool.unpool_argmax_plain(y, idx, (2, 2), None, relu, groups)))


def test_unpool_wrapper_refuses_an_output_past_32_bit_indexing(dev):
    """y (1, 16384, 16384, 2) bf16 has 2^29 elements, its unpooled output
    2^31: the wrapper raises before it allocates or launches."""
    y = torch.empty((1, 16384, 16384, 2), dtype=torch.bfloat16, device=dev)
    idx = torch.empty((1, 16384, 16384, 2), dtype=torch.int8, device=dev)
    before = cuda_pool.launches["unpool_argmax"]
    with pytest.raises(ValueError, match="32-bit"):
        cuda_pool.unpool_argmax(y, idx)
    assert cuda_pool.launches["unpool_argmax"] == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-6)])
@pytest.mark.parametrize("rep,relu,k,cin,cout", [(1, True, 3, 5, 6), (4, True, 3, 70, 20), (2, False, 5, 3, 17)])
def test_fused_kernel_matches_pair(dev, dtype, tol, rep, relu, k, cin, cout):
    g = torch.Generator(device=dev).manual_seed(2)
    y = torch.randn((3 * rep, 5, 7, cout), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, 4, (3, 5, 7, cout), generator=g, device=dev, dtype=torch.int8)
    w = torch.randn((k, k, cin, cout), generator=g, device=dev).to(dtype)
    got = cuda_deconv.fused_unpool_conv(y, idx, w, (2, 2), relu).float()
    want = cuda_deconv.fused_plain(y, idx, w, (2, 2), relu).float()
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


# (switch batch, rep, pooled ho, wo, Cout, Cin, k, groups, relu): extents the
# 256-row patch does not divide, ragged Cout and Cin (the masked scalar
# path), 1x1 and 5x5 kernels, a second partial N tile, packed groups (also
# on a 4x4 extent, mostly past the patch's edge), and a kernel too wide for
# the tensor-core tiles (the CUDA-core kernel)
TILING_CASES = [
    (2, 1, 14, 14, 64, 64, 3, 1, True),
    (2, 2, 14, 14, 70, 70, 3, 1, True),
    (3, 1, 5, 7, 17, 3, 5, 1, False),
    (1, 4, 5, 7, 20, 5, 3, 1, True),
    (1, 1, 14, 14, 128, 136, 3, 1, True),
    (2, 1, 5, 7, 32, 32, 1, 1, True),
    (2, 1, 5, 7, 16, 24, 3, 8, True),
    (2, 1, 2, 2, 16, 24, 3, 8, True),
    (2, 2, 7, 9, 24, 16, 5, 3, False),
    (1, 1, 3, 3, 8, 8, 19, 1, True),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-6)])
@pytest.mark.parametrize("case", TILING_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_kernel_tiling_matches_pair(dev, dtype, tol, case):
    bi, rep, ho, wo, cout, cin, k, groups, relu = case
    g = torch.Generator(device=dev).manual_seed(5)
    y = torch.randn((bi * rep, ho, wo, groups * cout), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, 4, (bi, ho, wo, cout), generator=g, device=dev, dtype=torch.int8)
    w = torch.randn((k, k, cin, cout), generator=g, device=dev).to(dtype)
    got = cuda_deconv.fused_unpool_conv(y, idx, w, (2, 2), relu, groups).float()
    want = cuda_deconv.fused_plain(y, idx, w, (2, 2), relu, groups).float()
    assert got.shape == (bi * rep, 2 * ho, 2 * wo, groups * cin)
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-6)])
def test_fused_kernel_at_a_full_width_vgg16_site(dev, dtype, tol):
    """The block5 site of a batch-8 top-4 POST /: y (32,14,14,512), w (3,3,512,512)."""
    g = torch.Generator(device=dev).manual_seed(6)
    y = torch.randn((32, 14, 14, 512), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, 4, (8, 14, 14, 512), generator=g, device=dev, dtype=torch.int8)
    w = (torch.randn((3, 3, 512, 512), generator=g, device=dev) * (2.0 / (9 * 512)) ** 0.5).to(dtype)
    got = cuda_deconv.fused_unpool_conv(y, idx, w, (2, 2), True).float()
    want = cuda_deconv.fused_plain(y, idx, w, (2, 2), True).float()
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups,rep,relu,out_hw", [(8, 1, True, None), (3, 2, False, (9, 11))])
def test_grouped_unpool_kernel_is_exact(dev, dtype, groups, rep, relu, out_hw):
    g = torch.Generator(device=dev).manual_seed(3)
    y = torch.randn((2 * rep, 4, 5, groups * 6), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, 4, (2, 4, 5, 6), generator=g, device=dev, dtype=torch.int8)
    before = cuda_pool.launches["unpool_argmax_grouped"]
    got = cuda_pool.unpool_argmax(y, idx, (2, 2), out_hw, relu, groups)
    assert torch.equal(_bits(got), _bits(pool.unpool_argmax_plain(y, idx, (2, 2), out_hw, relu, groups)))
    assert cuda_pool.launches["unpool_argmax_grouped"] == before + 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-6)])
@pytest.mark.parametrize("groups,rep,relu,k,cin,cout", [(8, 1, True, 3, 64, 64), (3, 2, False, 5, 3, 17)])
def test_grouped_fused_kernel_matches_grouped_pair(dev, dtype, tol, groups, rep, relu, k, cin, cout):
    g = torch.Generator(device=dev).manual_seed(4)
    y = torch.randn((2 * rep, 5, 7, groups * cout), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, 4, (2, 5, 7, cout), generator=g, device=dev, dtype=torch.int8)
    w = torch.randn((k, k, cin, cout), generator=g, device=dev).to(dtype)
    before = cuda_deconv.launches["fused_unpool_conv_grouped"]
    got = cuda_deconv.fused_unpool_conv(y, idx, w, (2, 2), relu, groups).float()
    want = cuda_deconv.fused_plain(y, idx, w, (2, 2), relu, groups).float()
    assert got.shape == (2 * rep, 10, 14, groups * cin)
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    assert cuda_deconv.launches["fused_unpool_conv_grouped"] == before + 1


def test_engine_on_the_card_goes_through_the_kernels(dev):
    params = init_params(VGG_TINY_SPEC, torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1)) * 50
    want = get_visualizer(VGG_TINY_SPEC, "block3_conv1", 4, device="cpu")(params, x)["block3_conv1"]
    gparams = {l: {k: t.to(dev) for k, t in v.items()} for l, v in params.items()}
    ops.reset_launch_counts()
    for policy, kernel in (("auto", "fused_unpool_conv"), ("off", "unpool_argmax")):
        fn = get_visualizer(VGG_TINY_SPEC, "block3_conv1", 4, fused_unpool=policy, device=dev)
        got = fn(gparams, x)["block3_conv1"]
        assert torch.equal(got["indices"].cpu(), want["indices"])
        scale = float(want["images"].abs().max())
        assert float((got["images"].cpu() - want["images"]).abs().max()) <= 1e-4 * scale
        assert ops.launch_counts()[kernel] > 0
    assert ops.launch_counts()["pool_argmax"] == 4  # 2 pools below block3_conv1, 2 runs


def test_packed_tail_on_the_card_goes_through_the_grouped_kernels(dev):
    params = init_params(VGG_TINY_SPEC, torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1)) * 50
    want = get_visualizer(VGG_TINY_SPEC, "block3_conv1", 4, device="cpu", sweep=True)(params, x)
    gparams = {l: {k: t.to(dev) for k, t in v.items()} for l, v in params.items()}
    ops.reset_launch_counts()
    for policy, kernel in (("auto", "fused_unpool_conv_grouped"), ("off", "unpool_argmax_grouped")):
        fn = get_visualizer(
            VGG_TINY_SPEC, "block3_conv1", 4, fused_unpool=policy, device=dev, sweep=True,
            kpack_chan=128,
        )
        got = fn(gparams, x)
        assert list(got) == list(want)
        for name, entry in got.items():
            assert torch.equal(entry["indices"].cpu(), want[name]["indices"])
            scale = float(want[name]["images"].abs().max())
            assert float((entry["images"].cpu() - want[name]["images"]).abs().max()) <= 1e-4 * scale
        assert ops.launch_counts()[kernel] > 0


# --- the DAG slice -----------------------------------------------------------------


@pytest.mark.parametrize("fn", [deconv_relu, deconv_relu6], ids=["relu", "relu6"])
def test_deconv_functions_under_batched_grads_on_the_card(dev, fn):
    """The deconvnet Functions' backward under ``is_grads_batched`` on the
    card: one batched backward equals one backward per row."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 6, 6, 4), generator=g, device=dev).requires_grad_(True)
    y = fn(x * 3) * 2
    gs = torch.randn((5, 2, 6, 6, 4), generator=g, device=dev) * 4
    (batched,) = torch.autograd.grad(y, x, gs, is_grads_batched=True, retain_graph=True)
    rows = torch.stack([torch.autograd.grad(y, x, r, retain_graph=True)[0] for r in gs])
    assert torch.equal(batched, rows)


@pytest.mark.parametrize("model,layer,size", [
    ("resnet50", "conv4_block2_out", 64),
    ("inception_v3", "mixed2", 75),
    ("mobilenet_v1", "conv_pw_11_relu", 64),
    ("mobilenet_v2", "block_6_expand_relu", 64),
])
def test_dag_family_on_the_card_matches_its_cpu_run(dev, model, layer, size):
    """Each DAG family's projection on the card against ``device="cpu"``
    with the same params, at a small input: the CPU's channels projected on
    the card within 1e-4 and at >= 65 dB on every image, equal indices where
    the CPU ranking is separated (``engine/crosscheck.py:card_vs_cpu``)."""
    from deconv_api_tpu_torch.engine.crosscheck import card_vs_cpu
    from deconv_api_tpu_torch.serving.models import build_bundle

    bundle = build_bundle(model, dev)
    bundle.image_size = size
    x = torch.randn((2, size, size, 3), generator=torch.Generator().manual_seed(1))
    out = card_vs_cpu(bundle, layer, x)
    assert out["finite"] and out["images"] == 2


@pytest.mark.parametrize("window,stride,padding", [(3, 1, "SAME"), (3, 2, "SAME"), (3, 2, "VALID")])
def test_avgpool_gradient_on_the_card_matches_the_cpu(dev, window, stride, padding):
    """``blocks.avgpool`` forward and gradient on the card against the CPU
    (its NCHW copy keeps the card's gradient right; see its docstring)."""
    from deconv_api_tpu_torch.models import blocks

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 9, 9, 8), generator=g)
    xc, xg = x.clone().requires_grad_(True), x.to(dev).requires_grad_(True)
    yc, yg = blocks.avgpool(xc, window, stride, padding), blocks.avgpool(xg, window, stride, padding)
    gy = torch.randn(yc.shape, generator=g)
    (gc,) = torch.autograd.grad(yc, xc, gy)
    (gg,) = torch.autograd.grad(yg, xg, gy.to(dev))
    torch.testing.assert_close(yg.detach().cpu(), yc.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gg.cpu(), gc, rtol=1e-6, atol=1e-6)


# --- DeepDream ----------------------------------------------------------------------


def test_mobilenet_v1_dream_on_the_card_matches_its_cpu_run(dev):
    """A MobileNet v1 dream at 64x64 (its default layers, 10 steps on the
    two rungs 46 and 64) on the card against ``device="cpu"`` with the same
    params, with ``chip_smoke.py``'s bars: every float32 step against the
    CPU's from the same input, the whole float64 dream against the CPU's
    (``engine/crosscheck.py:dream_card_vs_cpu``); no kernel launches."""
    from deconv_api_tpu_torch.engine.crosscheck import dream_card_vs_cpu
    from deconv_api_tpu_torch.serving.models import build_bundle

    bundle = build_bundle("mobilenet_v1", dev)
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    ops.reset_launch_counts()
    out = dream_card_vs_cpu(bundle, x, octaves=2)
    assert out["float32_stepwise"]["compared"] == 22 and out["float64"]["finite"] and out["images"] == 2
    assert not any(ops.launch_counts().values())


# --- captured programs ----------------------------------------------------------------


def _tiny_bundle(dev):
    from deconv_api_tpu_torch.serving.models import build_bundle

    bundle = build_bundle("vgg_tiny", dev)
    bundle.dream_layers = ("block2_conv2", "block3_conv1")
    return bundle


def _same_tree(got, want):
    """Equal bits leaf by leaf in a {layer: {name: tensor}} tree."""
    assert list(got) == list(want)
    for name in want:
        for k in want[name]:
            assert torch.equal(_bits(got[name][k].cpu()), _bits(want[name][k].cpu())), (name, k)


@pytest.mark.parametrize("fused_unpool,post", [("off", "grid"), ("auto", "grid"), ("off", None)])
def test_captured_vgg_tiny_program_holds_the_kernels_and_equals_its_eager_run(dev, fused_unpool, post):
    bundle = _tiny_bundle(dev)
    settings = dict(bug_compat=True, backward_dtype="bfloat16", post=post, fused_unpool=fused_unpool)
    prog = bundle.program("block3_conv1", "all", 4, 2, **settings)
    eager = bundle.batched_visualizer("block3_conv1", "all", 4, **settings)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1)) * 50
    assert prog.graph is not None and prog.kernels["pool_argmax"] == 2
    assert prog.kernels.get("fused_unpool_conv" if fused_unpool == "auto" else "unpool_argmax", 0) > 0
    ops.reset_launch_counts()
    with bundle.programs.replaying():
        got = prog(x)
        counts = ops.launch_counts()  # the replay's, before the eager run adds its own
        _same_tree(got, eager(bundle.params, x))
    assert ops.graph_counts == {"captures": 0, "replays": 1}
    assert all(counts[k] == prog.kernels.get(k, 0) for k in counts)


def test_captured_packed_tail_holds_the_grouped_kernels(dev):
    bundle = _tiny_bundle(dev)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(2)) * 50
    for fused_unpool, kernel in (("auto", "fused_unpool_conv_grouped"), ("off", "unpool_argmax_grouped")):
        settings = dict(backward_dtype="bfloat16", post="tiles", fused_unpool=fused_unpool, lowc_kpack="forced")
        prog = bundle.program("block3_conv1", "all", 8, 2, **settings)
        assert prog.kernels.get(kernel, 0) > 0
        with bundle.programs.replaying():
            _same_tree(prog(x), bundle.batched_visualizer("block3_conv1", "all", 8, **settings)(bundle.params, x))


def test_a_program_captured_once_replays_three_times(dev):
    bundle = _tiny_bundle(dev)
    settings = dict(backward_dtype="bfloat16", post="grid")
    prog = bundle.program("block3_conv1", "all", 4, 2, **settings)
    eager = bundle.batched_visualizer("block3_conv1", "all", 4, **settings)
    ops.reset_launch_counts()
    for seed in range(3):
        x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(10 + seed)) * 50
        with bundle.programs.replaying():
            got = prog(x)
            _same_tree(got, eager(bundle.params, x))
    assert ops.graph_counts == {"captures": 0, "replays": 3}
    # three replays and three eager runs, each launching K1 twice
    assert ops.launch_counts()["pool_argmax"] == 3 * 2 * prog.kernels["pool_argmax"]


def test_two_programs_interleaved_in_a_shared_pool(dev):
    """Two programs of one cache (one memory pool), replayed in turns,
    each read before the other replays: both stay right."""
    bundle = _tiny_bundle(dev)
    progs = {
        k: (bundle.program("block3_conv1", "all", k, 2, backward_dtype="bfloat16", post=post),
            bundle.batched_visualizer("block3_conv1", "all", k, True, "bfloat16", post))
        for k, post in ((4, "grid"), (8, "tiles"))
    }
    for seed in range(2):
        x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(20 + seed)) * 50
        for prog, eager in progs.values():
            with bundle.programs.replaying():
                _same_tree(prog(x), eager(bundle.params, x))


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic algorithms: without them two eager runs of a
    DAG backward or a dream step differ in their last bits on the card, so
    a capture could not be held to its eager run bit for bit."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = prev


def test_captured_dag_program_equals_its_eager_run(dev, deterministic_cudnn):
    from deconv_api_tpu_torch.serving.models import build_bundle

    bundle = build_bundle("mobilenet_v2", dev)
    bundle.image_size = 64
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    for sweep in (False, True):
        prog = bundle.program("block_6_expand_relu", "all", 4, 2, sweep=sweep)
        assert prog.graph is not None and not prog.kernels
        eager = bundle.batched_visualizer("block_6_expand_relu", "all", 4, sweep=sweep)
        with bundle.programs.replaying():
            _same_tree(prog(x), eager(bundle.params, x))


def test_captured_dream_step_equals_one_eager_step(dev, deterministic_cudnn):
    from deconv_api_tpu_torch.engine.deepdream import _ascend, run_dream_programs

    bundle = _tiny_bundle(dev)
    layers = bundle.dream_layers
    rungs = bundle.dream_program(layers, ((23, 23), (32, 32)), 2)
    _, step = rungs[1]
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(4), device="cpu").to(dev)
    with bundle.dream_programs.replaying():
        step.load(x, torch.tensor(0.01))
        losses = step.replay().clone()
        got = step.static[0].clone()
    want, want_l = _ascend(bundle.dream_forward(layers), bundle.params, x, layers, 1, 0.01)
    assert torch.equal(got, want) and torch.equal(losses, want_l)

    base = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(5)).to(dev)
    from deconv_api_tpu_torch.engine.deepdream import deepdream_batch

    with bundle.dream_programs.replaying():
        got_x, got_l = (t.clone() for t in run_dream_programs(rungs, base, 3, 0.01))
    want_x, want_l = deepdream_batch(bundle.dream_forward(layers), bundle.params, base, layers=layers,
                                     steps_per_octave=3, num_octaves=2, min_size=16, device=dev)
    assert torch.equal(got_x, want_x) and torch.equal(got_l, want_l)


def test_const_is_never_made_inside_a_capture(dev):
    """``ops/activations.py:_const`` raises on a first use inside a
    capture; a captured body that uses it gets it from its warm-up runs,
    in every dtype it runs (bf16 too), so the cache holds real values."""
    from deconv_api_tpu_torch.engine.capture import CapturedProgram
    from deconv_api_tpu_torch.ops.activations import _const, relu6

    _const.cache_clear()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        with torch.cuda.graph(graph):
            _const(0.0, torch.float32, dev)
    del graph
    x32 = torch.zeros((4, 8), device=dev)
    prog = CapturedProgram(lambda x: (relu6(x * 10), relu6(x.to(torch.bfloat16) * 10)), (x32,))
    for value in (0.0, 6.0):
        for dtype in (torch.float32, torch.bfloat16):
            assert float(_const(value, dtype, dev)) == value
    v = torch.linspace(-2, 2, 32, device=dev).reshape(4, 8)
    got32, got16 = prog(v)
    assert torch.equal(got32, torch.clamp(v * 10, 0, 6))
    assert torch.equal(got16, torch.clamp(v.to(torch.bfloat16) * 10, 0, 6))


def test_two_caches_capture_on_two_threads_at_once(dev):
    """Two caches (two pools, as the deconv and dream dispatchers have)
    miss on two threads at the same time, each miss allocating static
    tensors of a new size while the other thread may be capturing: no
    capture is invalidated, and every program replays its eager result."""
    import threading

    from deconv_api_tpu_torch.engine.capture import ProgramCache

    def body(x):
        return torch.relu(x * 3 - 1) + x.square()

    caches = [ProgramCache(dev), ProgramCache(dev)]
    start, failures = threading.Barrier(2), []

    def capture(cache, offset):
        try:
            start.wait()
            for i in range(8):
                n = 512 * (i + 1) + offset  # a new size each miss: new allocations
                cache.get(n, lambda n=n: (body, (torch.zeros((4, n, 256), device=dev),)))
        except Exception as e:  # noqa: BLE001 - reported below
            failures.append(e)

    threads = [threading.Thread(target=capture, args=(c, 16 * k)) for k, c in enumerate(caches)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures
    gen = torch.Generator().manual_seed(6)
    for cache in caches:
        assert len(cache) == 8
        for n, prog in cache.programs().items():
            assert prog.graph is not None
            x = torch.randn((4, n, 256), generator=gen).to(dev)
            with cache.replaying():
                got = prog(x).clone()
            assert torch.equal(got, body(x))


# --- several models on one card (serving/weight_manager.py) --------------------


def _mix_service(dev, **cfg):
    """A two-model server of the ``_mix_spec`` shape (16x16 input, conv,
    pool, conv; widths 8/16 and 16/32) on the card, mixa the default."""
    import numpy as np

    from deconv_api_tpu_torch.config import ServerConfig
    from deconv_api_tpu_torch.models.spec import Layer, ModelSpec
    from deconv_api_tpu_torch.serving.app import DeconvService
    from deconv_api_tpu_torch.serving.models import ModelBundle

    def build(name, f1, f2, seed):
        spec = ModelSpec(name, (16, 16, 3), (
            Layer("in0", "input"), Layer("b1c1", "conv", activation="relu", filters=f1),
            Layer("b1p", "pool"), Layer("b2c1", "conv", activation="relu", filters=f2),
        ))
        return ModelBundle(spec, init_params(spec, torch.Generator().manual_seed(seed), torch.device("cpu")), dev)

    registry = {"mixa": lambda: _to(build("mixa", 8, 16, 100), dev), "mixb": lambda: _to(build("mixb", 16, 32, 101), dev)}
    cfg = {"model": "mixa", "serve_models": "mixa,mixb", "max_batch": 4, **cfg}
    xs = np.random.default_rng(4).normal(0, 50, (3, 16, 16, 3)).astype(np.float32)
    return DeconvService(cfg=ServerConfig(**cfg), registry=registry), xs


def _to(bundle, dev):
    from deconv_api_tpu_torch.models.weights import tree_map

    bundle.params = tree_map(lambda t: t.to(dev), bundle.params)
    return bundle


def test_page_out_frees_weights_and_pools_and_page_in_recaptures_byte_equal(dev, deterministic_cudnn):
    """mixb paged out under a lowered budget: its stored tree, graphs and
    pools leave the card (allocated memory falls by at least its weights,
    its pools hold nothing); paged in again, its programs are captured anew
    and answer byte for byte as before."""
    from deconv_api_tpu_torch.serving.app import pool_bytes
    from deconv_api_tpu_torch.serving.weight_manager import tree_nbytes

    service, xs = _mix_service(dev)
    weights = service.weights
    service.visualize_batch("b2c1", xs, model="mixa")
    first = service.visualize_batch("b2c1", xs, model="mixb")
    mixb = weights.peek_bundle("mixb")
    pools = (mixb.programs.pool, mixb.dream_programs.pool)
    stored_bytes = tree_nbytes(mixb.stored)
    assert stored_bytes > 0 and len(mixb.programs) == 1 and pool_bytes(pools[0]) > 0
    weights.budget_bytes = tree_nbytes(weights.peek_bundle("mixa").stored)  # mixa is pinned
    torch.cuda.synchronize()
    alloc0, res0, held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved(), pool_bytes(pools[0])
    assert weights.enforce_budget() == ["mixb"]
    assert torch.cuda.memory_allocated() <= alloc0 - stored_bytes
    assert torch.cuda.memory_reserved() <= res0 - held
    assert mixb.stored is None and len(mixb.programs) == 0 and pool_bytes(pools[0]) == pool_bytes(pools[1]) == 0
    weights.budget_bytes = 0
    again = service.visualize_batch("b2c1", xs, model="mixb")
    assert weights.page_ins == 3 and weights.page_outs == 1 and len(mixb.programs) == 1
    assert next(iter(mixb.programs.programs().values())).kernels["pool_argmax"] == 1
    for k in ("grid", "valid", "indices"):
        assert (first[k] == again[k]).all(), k
    assert service.metrics.counter("weight_evict_inflight_total") == 0


def test_page_in_on_one_thread_while_the_other_captures(dev):
    """One thread pages mixb in and out again and again (each page-in
    allocates on the card, each page-out frees and empties the cache)
    while another captures new deconv programs of mixa: every capture
    holds, and each replays its eager run."""
    import threading

    service, xs = _mix_service(dev, hbm_budget_bytes=1)  # only the pinned default stays
    weights = service.weights
    mixa = weights.bundle("mixa")
    weights.checkout("mixa")  # resident and pinned for the test
    start, failures = threading.Barrier(2), []

    def page():
        try:
            start.wait()
            for _ in range(6):
                service.visualize_batch("b2c1", xs[:1], model="mixb")  # page-in, capture, replay
                assert weights.enforce_budget() == ["mixb"]  # page-out
        except Exception as e:  # noqa: BLE001 - reported below
            failures.append(e)

    def capture():
        try:
            start.wait()
            for k in range(1, 7):
                mixa.program("b2c1", "all", k, 2, backward_dtype="bfloat16", post="grid")
        except Exception as e:  # noqa: BLE001 - reported below
            failures.append(e)

    threads = [threading.Thread(target=page), threading.Thread(target=capture)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures, failures
    assert weights.page_ins == 7 and weights.page_outs == 6
    x = torch.from_numpy(xs[:2])
    for k in range(1, 7):
        prog = mixa.program("b2c1", "all", k, 2, backward_dtype="bfloat16", post="grid")
        eager = mixa.batched_visualizer("b2c1", "all", k, True, "bfloat16", "grid")
        with mixa.programs.replaying():
            _same_tree(prog(x), eager(mixa.program_params(), x))
    weights.release("mixa")
    assert service.metrics.counter("weight_evict_inflight_total") == 0


def test_int8_tier_grid_on_the_card_matches_its_cpu_run(dev):
    """vgg_tiny at ``weight_dtype=int8`` served on the card and on the CPU
    from the same params: equal channels, and grids within the JAX
    package's int8 output floor (20 dB)."""
    import numpy as np

    from deconv_api_tpu_torch.config import ServerConfig
    from deconv_api_tpu_torch.engine.crosscheck import psnr_db
    from deconv_api_tpu_torch.serving.app import DeconvService
    from deconv_api_tpu_torch.serving.models import ModelBundle
    from deconv_api_tpu_torch.serving.weight_manager import tree_nbytes

    params = init_params(VGG_TINY_SPEC, torch.Generator().manual_seed(7), torch.device("cpu"))
    xs = np.random.default_rng(8).normal(0, 50, (2, 32, 32, 3)).astype(np.float32)
    out = {}
    for device in (torch.device("cpu"), dev):
        registry = {"vgg_tiny": lambda device=device: _to(ModelBundle(VGG_TINY_SPEC, params, device), device)}
        service = DeconvService(cfg=ServerConfig(model="vgg_tiny", weight_dtype="int8"), registry=registry)
        out[device.type] = service.visualize_batch("block3_conv1", xs)
        resident = service.weights.snapshot()["lanes"]["0"]["bytes"]
        assert resident == tree_nbytes(service.bundle.stored) < tree_nbytes(params) / 3
    np.testing.assert_array_equal(out["cuda"]["indices"], out["cpu"]["indices"])
    for a, b in zip(out["cuda"]["grid"], out["cpu"]["grid"]):
        assert psnr_db(a, b) >= 20.0


def test_a_cleared_cache_frees_its_pool_after_a_cublas_capture(dev):
    """A capture that runs cuBLAS on a thread of its own: the workspace
    cuBLAS makes at its first use on the capture stream is made by the
    warm-up, outside the pool, so clearing the cache frees the pool whole
    (a page-out's promise)."""
    import threading

    from deconv_api_tpu_torch.engine.capture import DEVICE_LOCK, ProgramCache
    from deconv_api_tpu_torch.serving.app import pool_bytes

    cache = ProgramCache(dev)
    w = torch.randn((256, 256), generator=torch.Generator().manual_seed(9)).to(dev)
    thread = threading.Thread(target=lambda: cache.get(
        "mm", lambda: ((lambda x: torch.relu(x @ w)), (torch.zeros((64, 256), device=dev),))))
    thread.start()
    thread.join()
    pool = cache.pool
    assert len(cache) == 1 and pool_bytes(pool) > 0
    with DEVICE_LOCK.exclusive():
        cache.clear()
        torch.cuda.empty_cache()
    assert pool_bytes(pool) == 0 and cache.pool != pool and len(cache) == 0


# --- the pipelined dispatch step (serving/app.py) -------------------------------------


def _pipeline_service(dev):
    """A vgg_tiny service on the card (one model, inert weight manager) and
    three batches of four images."""
    import numpy as np

    from deconv_api_tpu_torch.serving.app import DeconvService

    xs = np.random.default_rng(5).normal(0, 50, (3, 4, 32, 32, 3)).astype(np.float32)
    return DeconvService(_tiny_bundle(dev), max_batch=4), xs


def test_three_batches_in_flight_equal_three_serial_runs(dev, deterministic_cudnn):
    """Three batches of one graph dispatched before any is fetched (the
    dispatch step enqueues replay and copies without a host sync; stream
    order keeps each replay from overwriting the rows queued before it)
    fetch byte for byte what three serial runs return."""
    import numpy as np

    from deconv_api_tpu_torch.serving.app import Program

    service, xs = _pipeline_service(dev)
    for program in (Program("block3_conv1"), Program("block3_conv1", top_k=8, post="tiles")):
        serial = [service.run_program(program, xs[i]) for i in range(3)]
        fetches = [service._enqueue_program(program, xs[i]) for i in range(3)]
        for got, want in zip([f() for f in fetches], serial):
            assert list(got) == list(want)
            for layer in want:
                for k in want[layer]:
                    np.testing.assert_array_equal(got[layer][k], want[layer][k], err_msg=f"{program} {layer} {k}")
    service.close()


def test_the_ring_hands_back_pinned_buffers_and_reuses_them(dev):
    from deconv_api_tpu_torch.serving.codec_pool import HostBufferRing

    ring = HostBufferRing(2, pin_memory=True)
    bufs = [ring.acquire((4, 8, 8, 3)) for _ in range(3)]
    assert all(b.is_pinned() for b in bufs) and ring.allocations == 3
    for b in bufs:
        ring.release(b)  # pinned: all kept, none freed while serving
    again = [ring.acquire((4, 8, 8, 3)) for _ in range(3)]
    assert {b.data_ptr() for b in again} == {b.data_ptr() for b in bufs} and ring.allocations == 3


def test_the_dispatch_step_makes_no_host_sync(dev, deterministic_cudnn):
    """The grid, tiles and dream dispatch steps run under
    ``torch.cuda.set_sync_debug_mode("error")`` (their programs captured
    first), and their fetches then return what a plain run returns."""
    import numpy as np

    from deconv_api_tpu_torch.serving.app import Dream, Program

    service, xs = _pipeline_service(dev)
    dream = Dream(("block2_conv2", "block3_conv1"), steps=2, octaves=2)
    steps = {
        "grid": (lambda: service._enqueue_program(Program("block3_conv1"), xs[0]),
                 lambda: service.run_program(Program("block3_conv1"), xs[0])),
        "tiles": (lambda: service._enqueue_program(Program("block3_conv1", top_k=8, post="tiles"), xs[0]),
                  lambda: service.run_program(Program("block3_conv1", top_k=8, post="tiles"), xs[0])),
        "dream": (lambda: service._enqueue_dream(dream, xs[0]), lambda: service.run_dream(dream, xs[0])),
    }
    for name, (dispatch, plain) in steps.items():
        want = plain()  # captures the programs and fills the rings
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fetch = dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = fetch()
        if name == "dream":
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        else:
            for k in want["block3_conv1"]:
                np.testing.assert_array_equal(got["block3_conv1"][k], want["block3_conv1"][k], err_msg=name)
    service.close()


# --- the response cache in front of the card (serving/cache.py) ----------------


def test_a_hit_and_a_coalesced_waiter_do_no_device_work(dev):
    """On a VGG16 server with captured graphs: a cache hit and the waiters
    of a coalesced flight leave the graph replays and the K1/K2 launch
    counters where the misses left them (the leader's one row is the only
    device work of a flight), and answer byte for byte as the miss."""
    import base64
    import concurrent.futures
    import threading
    import time
    import urllib.parse
    import urllib.request

    import cv2
    import numpy as np

    from deconv_api_tpu_torch.config import ServerConfig
    from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService

    def body(seed):
        img = (np.random.default_rng(seed).random((224, 224, 3)) * 255).astype(np.uint8)
        uri = "data:image/png;base64," + base64.b64encode(cv2.imencode(".png", img)[1].tobytes()).decode()
        return urllib.parse.urlencode({"file": uri, "layer": "block5_conv1"}).encode()

    def post(data):
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=120) as r:
            return r.headers["x-cache"], r.read()

    def counts():
        return ops.graph_counts["replays"], ops.launch_counts()["pool_argmax"], ops.launch_counts()["unpool_argmax"]

    service = DeconvService(cfg=ServerConfig(model="vgg16", max_batch=2, dream_max_batch=1), device=dev)
    service.start()
    service.warmup()
    server = DeconvHTTPServer(service, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}/"
    runner = service.dispatcher._dispatch_runner
    gate = threading.Event()
    gate.set()
    service.dispatcher._dispatch_runner = lambda key, images: (gate.wait(60), runner(key, images))[1]
    try:
        # warmup captured the deepest layer's programs: the first
        # block5_conv1 request captures its bucket-1 graph
        assert post(body(0))[0] == "miss"
        before = counts()
        miss = post(body(1))
        after_miss = counts()
        assert miss[0] == "miss" and np.subtract(after_miss, before).tolist() == [1, 4, 4]
        assert post(body(1)) == ("hit", miss[1]) and counts() == after_miss
        gate.clear()
        coalesced = service.metrics.counter("cache_coalesced_total")
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(post, body(2)) for _ in range(4)]
            t_end = time.perf_counter() + 60
            while service.metrics.counter("cache_coalesced_total") < coalesced + 3:
                assert time.perf_counter() < t_end
                time.sleep(0.01)
            assert counts() == after_miss  # the flight's row waits at the gate
            gate.set()
            answers = [f.result() for f in futs]
        assert sorted(a[0] for a in answers) == ["coalesced"] * 3 + ["miss"]
        assert len({a[1] for a in answers}) == 1
        assert np.subtract(counts(), after_miss).tolist() == [1, 4, 4]  # the leader's row alone
        assert service.batch_sizes[-1] == 1
    finally:
        gate.set()
        server.server_close()
        service.close()


# --- the int8 execution tier: K5 and quality=int8 (ops/cuda_q8.py) -------------


# (N, H, W, Cin, Cout, kernel, strides, padding, misaligned x): the vector
# paths (Cin and Cout multiples of 16), the byte paths (Cin 3 and 5, Cout 8
# and 40, a misaligned input), strides, VALID, 1x1, ragged rows and a
# full-width VGG16 site
Q8_CASES = [
    (2, 9, 11, 3, 8, 3, (1, 1), "SAME", False),
    (2, 17, 15, 16, 40, 3, (2, 2), "SAME", False),
    (3, 9, 8, 5, 24, 3, (1, 2), "VALID", False),
    (2, 6, 6, 64, 64, 1, (1, 1), "VALID", False),
    (2, 7, 5, 32, 48, 3, (1, 1), "SAME", True),
    (8, 14, 14, 512, 512, 3, (1, 1), "SAME", False),
]


@pytest.mark.parametrize("n,h,w,cin,cout,k,strides,padding,misaligned", Q8_CASES,
                         ids=lambda c: str(c).replace(" ", ""))
def test_conv_q8_kernel_is_bit_exact(dev, n, h, w, cin, cout, k, strides, padding, misaligned):
    from deconv_api_tpu_torch.ops import conv, cuda_q8

    g = torch.Generator(device=dev).manual_seed(3)
    for extreme in (False, True):
        x = torch.randint(-127, 128, (n, h, w, cin), generator=g, device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, k, cin, cout), generator=g, device=dev, dtype=torch.int8)
        if extreme:  # every product at +-127^2: the widest sums
            x, wq = torch.where(x < 0, -127, 127).to(torch.int8), torch.where(wq < 0, -127, 127).to(torch.int8)
        if misaligned:
            x = _misaligned(x)
        before = cuda_q8.launches["conv_q8"]
        got = cuda_q8.conv2d_q8(x, wq, strides=strides, padding=padding)
        assert cuda_q8.launches["conv_q8"] == before + 1
        assert torch.equal(got, conv.conv2d_q8_plain(x, wq, strides=strides, padding=padding))
        assert torch.equal(got, ops.conv2d_q8(x, wq, strides=strides, padding=padding))


@pytest.mark.parametrize("b,din,dout", [(3, 75, 40), (20, 1024, 1000), (8, 25088, 4096)])
def test_dense_q8_kernel_is_bit_exact(dev, b, din, dout):
    from deconv_api_tpu_torch.ops import cuda_q8, linear

    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randint(-127, 128, (b, din), generator=g, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (din, dout), generator=g, device=dev, dtype=torch.int8)
    assert torch.equal(cuda_q8.dense_q8(x, wq), linear.dense_q8_plain(x, wq))


def test_the_q8_wrapper_raises_on_card_tensors_it_does_not_take(dev):
    from deconv_api_tpu_torch.ops import cuda_q8

    x = torch.zeros((1, 4, 4, 4), dtype=torch.int8, device=dev)
    w = torch.zeros((3, 3, 4, 4), dtype=torch.int8, device=dev)
    with pytest.raises(TypeError, match="int8"):
        cuda_q8.conv2d_q8(x.float(), w)
    with pytest.raises(ValueError, match="groups"):
        cuda_q8.conv2d_q8(x, w[:, :, :2], feature_group_count=2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_q8.conv2d_q8(x.permute(0, 2, 1, 3), w)
    with pytest.raises(ValueError, match="input channels"):
        cuda_q8.conv2d_q8(x, w[:, :, :2].contiguous())


# The fused int8 step (ops/q8.py on K5) against its plain version on the
# same card tensors.  (rows, H, W, Cin, Cout, strides, padding, activation):
# the 11 VGG16 convs of batch 8 up to block5_conv1, the strided and VALID
# geometries chip_smoke.py checks, a ragged Cout, small Cin; H is None for a
# dense layer (Cin -> Cout): fc1 of VGG16, a ragged one, and a softmax head.
VGG16_Q8_CONVS = [(224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128), (56, 128, 256), (56, 256, 256),
                  (56, 256, 256), (28, 256, 512), (28, 512, 512), (28, 512, 512), (14, 512, 512)]
STEP_CASES = [(8, hw, hw, cin, cout, (1, 1), "SAME", "relu") for hw, cin, cout in VGG16_Q8_CONVS] + [
    (2, 15, 17, 16, 40, (2, 2), "SAME", "linear"),
    (3, 9, 8, 5, 24, (1, 2), "VALID", "relu6"),
    (3, 9, 11, 32, 70, (1, 1), "SAME", "relu"),
    (3, 9, 11, 32, 70, (1, 1), "SAME", "linear"),
    (3, 9, 11, 32, 70, (1, 1), "SAME", "relu6"),
    (2, 33, 20, 3, 16, (1, 1), "SAME", "relu"),
    (8, None, None, 25088, 4096, None, None, "relu"),
    (3, None, None, 1000, 40, None, None, "linear"),
    (5, None, None, 256, 100, None, None, "softmax"),
]


def _step_inputs(dev, rows, h, w, cin, cout, seed):
    """Float input (row 1 all zeros: amax 0, scale 1.0), its per-row scales,
    a quantized K-major kernel and a float bias, made on the card."""
    from deconv_api_tpu_torch.ops import q8

    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (rows, cin) if h is None else (rows, h, w, cin)
    x = torch.randn(shape, generator=g, device=dev) * 3
    x[1] = 0
    kernel = (cin, cout) if h is None else (3, 3, cin, cout)
    wf = torch.randn(kernel, generator=g, device=dev) * (2.0 / (9 * cin)) ** 0.5
    wq, sw = q8.quantize_weight(wf)
    b = torch.randn((cout,), generator=g, device=dev) * 0.1
    b[0] = 1e9  # folds past 2^30: clipped
    return x, q8.q8_scale(q8.row_amax(x)), wq, sw, b


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: "-".join(map(str, c)).replace(" ", ""))
def test_the_fused_int8_step_is_its_plain_version_bit_for_bit(dev, case):
    """The step on the card (the input quantizer, then K5 with the fold,
    relu and dequantize in its epilogue) gives its plain version's float32
    bits; one launch of each."""
    from deconv_api_tpu_torch.ops import cuda_q8, q8

    rows, h, w, cin, cout, strides, padding, act = case
    x, sx, wq, sw, b = _step_inputs(dev, rows, h, w, cin, cout, seed=cin + cout)
    before = dict(cuda_q8.launches)
    if h is None:
        got = q8.dense_q8_step(x, sx, wq, sw, b, act)
        want = q8.dense_q8_step_plain(x, sx, wq, sw, b, act)
    else:
        got = q8.conv2d_q8_step(x, sx, wq, sw, b, act, strides, padding)
        want = q8.conv2d_q8_step_plain(x, sx, wq, sw, b, act, strides, padding)
    assert cuda_q8.launches["conv_q8"] == before["conv_q8"] + 1
    assert cuda_q8.launches["quantize_q8"] == before["quantize_q8"] + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("shape,misaligned", [((8, 56, 56, 128), False), ((3, 7, 5, 3), False),
                                              ((4, 7, 16), True), ((2, 25088), False)],
                         ids=lambda c: str(c).replace(" ", ""))
def test_the_quantizers_are_clamp_round_of_the_division(dev, shape, misaligned):
    """The input quantizer is ``clamp(round(x / sx))`` per row: halves to
    even (x = (k + 0.5) sx), clipped at +-127, a zero row at scale 1; the
    weight quantizer the same at one scale, written K-major."""
    from deconv_api_tpu_torch.ops import cuda_q8, q8

    g = torch.Generator(device=dev).manual_seed(len(shape))
    x = torch.randn(shape, generator=g, device=dev) * 60
    sx = q8.q8_scale(q8.row_amax(x)) * 0.5  # half the range: the widest values clip
    x[0].view(-1)[:64] = (torch.arange(64, device=dev) - 32 + 0.5) * sx[0]
    x[-1] = 0
    sx[-1] = 1.0
    if misaligned:
        x = _misaligned(x)
    want = torch.clamp(torch.round(x / sx.reshape(-1, *[1] * (x.dim() - 1))), -127, 127).to(torch.int8)
    before = cuda_q8.launches["quantize_q8"]
    got = cuda_q8.quantize_rows(x, sx)
    assert cuda_q8.launches["quantize_q8"] == before + 1
    assert torch.equal(got, want) and torch.equal(got.cpu(), q8.quantize_rows_plain(x.cpu(), sx.cpu()))
    w = torch.randn((*shape[1:], 24) if len(shape) == 4 else (shape[-1], 24), generator=g, device=dev)
    sw = q8.q8_scale(q8.row_amax(w.reshape(1, -1))[0])
    assert torch.equal(cuda_q8.quantize_weight(w, sw), q8.quantize_weight_plain(w, sw))


def test_the_step_wrappers_raise_on_card_tensors_they_do_not_take(dev):
    from deconv_api_tpu_torch.ops import cuda_q8

    q = torch.zeros((2, 4, 4, 16), dtype=torch.int8, device=dev)
    w = torch.zeros((8, 3, 3, 16), dtype=torch.int8, device=dev)
    b, s = torch.zeros(8, device=dev), torch.ones(2, device=dev)
    with pytest.raises(TypeError, match="int8"):
        cuda_q8.conv2d_q8_fused(q.float(), w, b, s, relu=True)
    with pytest.raises(TypeError, match="float32"):
        cuda_q8.conv2d_q8_fused(q, w, b.double(), s, relu=True)
    with pytest.raises(ValueError, match="do not fit"):
        cuda_q8.conv2d_q8_fused(q, w, b[:4], s, relu=True)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_q8.conv2d_q8_fused(q.permute(0, 2, 1, 3), w, b, s, relu=True)
    with pytest.raises(ValueError, match="input channels"):
        cuda_q8.conv2d_q8_fused(q, w[..., :8].contiguous(), b, s, relu=True)
    with pytest.raises(ValueError, match="inputs"):
        cuda_q8.dense_q8_fused(q.reshape(2, -1), torch.zeros((8, 100), dtype=torch.int8, device=dev), b, s,
                               relu=False)
    with pytest.raises(ValueError, match="scales"):
        cuda_q8.quantize_rows(q.float(), s[:1])
    with pytest.raises(TypeError, match="float32"):
        cuda_q8.quantize_weight(w.permute(1, 2, 3, 0).contiguous(), s[:1])
    with pytest.raises(ValueError, match="one scale"):
        cuda_q8.quantize_weight(torch.zeros((3, 3, 16, 8), device=dev), s)


def test_the_int8_forward_on_the_card_is_its_cpu_run_bit_for_bit(dev):
    """The int8 walk is exact integer contractions and IEEE elementwise
    float32 ops (a division, a rounding, a product): vgg_tiny's int8
    forward to fc1, dynamic and calibrated, gives the card the CPU's
    switches and outputs bit for bit; the visualizer then the same
    channels, and grids at 40 dB (the bf16 backward runs through cuDNN on
    the card)."""
    from deconv_api_tpu_torch.engine.crosscheck import psnr_db
    from deconv_api_tpu_torch.engine.deconv import _forward_chain
    from deconv_api_tpu_torch.models.spec import entry_chain
    from deconv_api_tpu_torch.serving.codec import stitch_grid

    params = init_params(VGG_TINY_SPEC, torch.Generator().manual_seed(7), torch.device("cpu"))
    cparams = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    x = torch.randn((3, 32, 32, 3), generator=torch.Generator().manual_seed(8)) * 50
    entries = entry_chain(VGG_TINY_SPEC.truncated("fc1"))
    for quant in ("dynamic", (("block1_conv1", 150.0), ("block2_conv1", 40.0), ("fc1", 9.0))):
        sw_cpu, sw_card = {}, {}
        cpu = _forward_chain(entries, params, x, sw_cpu, quant)
        card = _forward_chain(entries, cparams, x.to(dev), sw_card, quant)
        for a, b in zip(cpu, card):
            assert torch.equal(_bits(a), _bits(b.cpu()))
        for name in sw_cpu:
            assert torch.equal(sw_cpu[name][0], sw_card[name][0].cpu())
        vis = {d: get_visualizer(VGG_TINY_SPEC, "block3_conv1", 4, "all", True, "bfloat16", device=d, quant=quant)
               for d in ("cpu", "cuda")}
        r_cpu = vis["cpu"](params, x)["block3_conv1"]
        r_card = vis["cuda"](cparams, x.to(dev))["block3_conv1"]
        assert torch.equal(r_cpu["indices"], r_card["indices"].cpu())
        g_cpu, g_card = stitch_grid(r_cpu["images"], r_cpu["valid"]), stitch_grid(r_card["images"], r_card["valid"])
        for a, b in zip(g_cpu.numpy(), g_card.cpu().numpy()):
            assert psnr_db(a, b) >= 40.0


def test_each_tier_captures_its_own_graph_and_int8_holds_k5(dev):
    """The captured programs of full, bf16, dynamic and calibrated int8 at
    one bucket: four graphs; the int8 ones hold one K5 per conv (5 to
    block3_conv1) and K1 at each pool; each replay equals its eager run."""
    bundle = _tiny_bundle(dev)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(9)) * 50
    settings = dict(bug_compat=True, backward_dtype="bfloat16", post="grid")
    tiers = {"full": {}, "bf16": {"dtype": torch.bfloat16}, "dynamic": {"quant": "dynamic"},
             "calibrated": {"quant": (("block1_conv1", 150.0), ("block3_conv1", 20.0))}}
    for name, tier in tiers.items():
        prog = bundle.program("block3_conv1", "all", 4, 2, **settings, **tier)
        eager = bundle.batched_visualizer("block3_conv1", "all", 4, quant=tier.get("quant"), **settings)
        assert prog.kernels.get("conv_q8", 0) == (5 if "quant" in tier else 0), name
        assert prog.kernels.get("quantize_q8", 0) == prog.kernels.get("quantize_w_q8", 0) == prog.kernels.get(
            "conv_q8", 0), name
        assert prog.kernels["pool_argmax"] == 2
        with bundle.programs.replaying():
            _same_tree(prog(x), eager(bundle.params, x.to(tier.get("dtype", torch.float32))))
    assert len(bundle.programs) == 4


def test_quality_and_qos_on_the_served_routes_on_the_card(dev):
    """A vgg_tiny server on the card with ``--qos``: ``quality=bogus`` is a
    422, bf16 and int8 run their own graphs (K5 five times per int8 replay
    and per warm-up run of its capture), a bulk tenant's bare request is
    served int8, and its repeat is a hit that replays nothing."""
    import base64
    import json
    import urllib.error
    import urllib.parse
    import urllib.request

    import cv2
    import numpy as np

    from deconv_api_tpu_torch.config import ServerConfig
    from deconv_api_tpu_torch.engine.capture import WARMUP_RUNS
    from deconv_api_tpu_torch.serving.app import DeconvHTTPServer, DeconvService

    img = (np.random.default_rng(11).random((40, 48, 3)) * 255).astype(np.uint8)
    uri = "data:image/png;base64," + base64.b64encode(cv2.imencode(".png", img)[1].tobytes()).decode()

    def post(fields, headers=None):
        data = urllib.parse.urlencode({"file": uri, "layer": "block3_conv1", **fields}).encode()
        try:
            with urllib.request.urlopen(urllib.request.Request(url, data=data, headers=headers or {}),
                                        timeout=120) as r:
                return r.status, r.headers["x-cache"], json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("x-cache"), json.loads(e.read())

    tenants = '{"bulk1": {"class": "bulk"}, "inter": {"class": "interactive"}}'
    service = DeconvService(_tiny_bundle(dev), ServerConfig(model="vgg_tiny", max_batch=2, qos=True, tenants=tenants))
    service.start()
    service.warmup()
    server = DeconvHTTPServer(service, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}/"
    try:
        assert post({"quality": "bogus"})[0] == 422
        full = post({}, {"x-tenant": "inter"})
        bf16 = post({"quality": "bf16"}, {"x-tenant": "inter"})
        ops.reset_launch_counts()
        bulk = post({}, {"x-tenant": "bulk1"})
        # the int8 graph's capture (two eager warm-up runs) and one replay
        counts = (ops.graph_counts["captures"], ops.graph_counts["replays"], ops.launch_counts()["conv_q8"])
        assert counts == (1, 1, 5 * (1 + WARMUP_RUNS))
        again = post({}, {"x-tenant": "bulk1"})
        explicit = post({"quality": "int8"}, {"x-tenant": "inter"})
        assert (ops.graph_counts["captures"], ops.graph_counts["replays"], ops.launch_counts()["conv_q8"]) == counts
        assert [r[:2] for r in (full, bf16, bulk, again, explicit)] == [
            (200, "miss"), (200, "miss"), (200, "miss"), (200, "hit"), (200, "hit")]
        assert bulk[2] == again[2] == explicit[2] and len({full[2], bf16[2], bulk[2]}) == 3
        assert service.metrics.counter("quant_int8_batches_total") == 1
        assert service.metrics.counter("quant_bf16_batches_total") == 1
    finally:
        server.server_close()
        service.close()


# --- the warm boot: the kernel libraries from the store (serving/aot.py) --------


def test_the_four_libraries_load_from_a_filled_store_without_nvcc(dev, tmp_path, monkeypatch):
    """A store filled from the real build, then a fresh resolver on it that
    may not build (and writes its libraries elsewhere): four hits, no miss,
    and a kernel launched from each loaded library equals its plain
    version (K1, K2 and K5 bit for bit, K3 within 1e-5 fp32 and 2^-6 bf16
    of the output's largest magnitude)."""
    from deconv_api_tpu_torch.ops import _build, cuda_q8, q8
    from deconv_api_tpu_torch.serving.aot import ArtifactStore, KernelResolver
    from deconv_api_tpu_torch.serving.metrics import Metrics

    filled = KernelResolver(ArtifactStore(str(tmp_path / "aot")))
    filled.resolve(_build.KERNELS)
    assert filled.store.entry_count == 4 and set(filled.outcomes.values()) == {"miss"}
    m = Metrics("deconv")
    fresh = KernelResolver(ArtifactStore(str(tmp_path / "aot"), metrics=m), metrics=m,
                           build=lambda names, force=False: pytest.fail(f"nvcc ran for {names}"),
                           library_path=lambda name: tmp_path / "lib" / f"{name}.so")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "resolver", fresh)
    monkeypatch.setattr(cuda_pool, "_entries", {})
    monkeypatch.setattr(cuda_q8, "_lib", None)
    fresh.resolve(_build.KERNELS)
    assert (m.counter("aot_cache_hits_total"), m.counter("aot_cache_misses_total")) == (4, 0)
    assert {n: lib._name for n, lib in fresh.loaded.items()} == {
        n: str(tmp_path / "lib" / f"{n}.so") for n in _build.KERNELS}

    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((2, 28, 28, 64), generator=g, device=dev)
    got, want = cuda_pool.pool_argmax(x), pool.maxpool_argmax_plain(x, (2, 2))
    assert torch.equal(got[1], want[1]) and torch.equal(_bits(got[0]), _bits(want[0]))
    y, idx = torch.randn((8, 14, 14, 64), generator=g, device=dev), got[1]
    assert torch.equal(_bits(cuda_pool.unpool_argmax(y, idx, (2, 2), None, True, 1)),
                       _bits(pool.unpool_argmax_plain(y, idx, (2, 2), None, True, 1)))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-6)):
        w = torch.randn((3, 3, 64, 64), generator=g, device=dev).to(dtype)
        got3 = cuda_deconv.fused_unpool_conv(y.to(dtype), idx, w, (2, 2), True).float()
        want3 = cuda_deconv.fused_plain(y.to(dtype), idx, w, (2, 2), True).float()
        assert float((got3 - want3).abs().max()) <= tol * float(want3.abs().max())
    xs, sx, wq, sw, b = _step_inputs(dev, 8, 28, 28, 256, 512, seed=12)
    assert torch.equal(_bits(q8.conv2d_q8_step(xs, sx, wq, sw, b, "relu", (1, 1), "SAME")),
                       _bits(q8.conv2d_q8_step_plain(xs, sx, wq, sw, b, "relu", (1, 1), "SAME")))
    assert {n: _build._libs[n] for n in _build.KERNELS} == fresh.loaded


# ------------------------------------------------------------ training


def _train_case(name: str):
    """(model, CPU params, input size, classes): vgg_tiny at 32x32, or
    MobileNet v1 at 64x64 with a 10-way head (its BatchNorm leaves train)."""
    from deconv_api_tpu_torch.models import mobilenet_v1

    gen = torch.Generator().manual_seed(0)
    if name == "vgg_tiny":
        return VGG_TINY_SPEC, init_params(VGG_TINY_SPEC, gen), 32, 100
    fwd = mobilenet_v1.mobilenet_v1_forward
    return (lambda p, x: fwd(p, x, logits=True)[0]), mobilenet_v1.mobilenet_v1_init(gen, num_classes=10), 64, 10


@pytest.mark.parametrize("name", ["vgg_tiny", "mobilenet_v1"])
def test_one_train_step_on_the_card_matches_the_cpu(dev, name):
    """The same numpy batch and params through one step on the card and
    on the CPU: the loss within 1e-5 relative, each gradient leaf within
    1e-4 of its largest magnitude, the params after the step within 2 lr
    (Adam's first step is about lr sign(g)); no hand-written kernel runs."""
    import numpy as np
    import torch.nn.functional as F

    from deconv_api_tpu_torch.train import step

    model, params, size, classes = _train_case(name)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    y = rng.integers(0, classes, 4)
    lr = 1e-3

    def run(device):
        init_fn, _ = step.make_train_step(model, device, lr)
        state = init_fn(params)
        loss = F.cross_entropy(step._as_apply_fn(model)(state.params, torch.from_numpy(x).to(device)),
                               torch.from_numpy(y).to(device))
        grads = torch.autograd.grad(loss, step.leaves(state.params))
        step.adamw(state.params, grads, state.opt_state, lr)
        return loss.item(), [g.cpu() for g in grads], [p.detach().cpu() for p in step.leaves(state.params)]

    cpu = run("cpu")
    ops.reset_launch_counts()
    card = run(dev)
    assert not any(ops.launch_counts().values())
    assert abs(card[0] - cpu[0]) <= 1e-5 * abs(cpu[0])
    for g, h in zip(card[1], cpu[1]):
        assert float((g - h).abs().max()) <= 1e-4 * float(h.abs().max())
    for p, q in zip(card[2], cpu[2]):
        assert float((p - q).abs().max()) <= 2 * lr


def test_resume_on_the_card_is_bit_exact(dev, tmp_path):
    """Stopped at step 2 of 4 and resumed, under the train command's cuDNN
    settings: the uninterrupted run's params, bit for bit."""
    from deconv_api_tpu_torch.train import loop

    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        common = dict(batch=4, lr=1e-3, seed=3, device="cuda")
        params = init_params(VGG_TINY_SPEC, torch.Generator().manual_seed(0))
        straight = loop.train_synthetic(VGG_TINY_SPEC, params, steps=4, **common)
        ck = str(tmp_path / "run")
        loop.train_synthetic(VGG_TINY_SPEC, params, steps=2, save_dir=ck, save_every=2, **common)
        resumed = loop.train_synthetic(VGG_TINY_SPEC, params, steps=4, save_dir=ck, save_every=2, resume=True,
                                       **common)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    assert resumed["resumed_from"] == 2 and resumed["final_loss"] == straight["final_loss"]
    for (k, a), b in zip(_flat_items(resumed["params"]), (b for _, b in _flat_items(straight["params"]))):
        assert a.device.type == "cuda" and torch.equal(a, b), k


def _flat_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v
