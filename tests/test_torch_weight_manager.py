"""The port's weight manager (deconv_api_tpu_torch/serving/weight_manager.py)
against the JAX package's: quantize/dequantize bit for bit, the residency
bookkeeping step by step through the same sequences, the coalesced cold
checkout on threads, and vgg_tiny served at the bf16 and int8 tiers against
the JAX package's quantized programs at its own PSNR floors."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deconv_api_tpu.models.tiny import VGG_TINY_SPEC as J_TINY_SPEC, vgg_tiny_init
from deconv_api_tpu.serving.metrics import Metrics as JMetrics
from deconv_api_tpu.serving.models import spec_bundle as j_spec_bundle
from deconv_api_tpu.serving.weight_manager import WeightManager as JWeightManager
from deconv_api_tpu.serving.weight_manager import dequantize_params as j_dequantize
from deconv_api_tpu.serving.weight_manager import quantize_params as j_quantize
from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
from deconv_api_tpu_torch.models.weights import params_from_jax
from deconv_api_tpu_torch.serving.app import DeconvService
from deconv_api_tpu_torch.serving.metrics import Metrics
from deconv_api_tpu_torch.serving.models import ModelBundle
from deconv_api_tpu_torch.serving.weight_manager import (
    WeightManager,
    dequantize_params,
    quantize_params,
    tree_nbytes,
)
from tests.test_weight_manager import _fake_builders as _j_fake_builders

LAYER = "block2_conv2"
# tests/test_weight_manager.py:test_output_psnr_bounds_vgg_tiny's floors
OUTPUT_PSNR_FLOORS = {"bf16": 38.0, "int8": 20.0}
WEIGHT_FAMILIES = ("weight_page_ins_total", "weight_page_outs_total", "weight_page_bytes_total",
                   "weight_budget_overcommit_total", "weight_evict_inflight_total")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny_params():
    return jax.tree_util.tree_map(np.asarray, vgg_tiny_init(jax.random.key(1, impl="rbg"))[1])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) and "__q8__" not in v:
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _bits(a) -> np.ndarray:
    """The bytes of an array or tensor, as unsigned integers of its width."""
    a = a.numpy() if isinstance(a, torch.Tensor) and a.dtype != torch.bfloat16 else a
    if isinstance(a, torch.Tensor):  # bfloat16 has no numpy dtype
        return a.reshape(-1).view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(a)
    return a.reshape(-1).view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


# --- quantize / dequantize ---------------------------------------------------


@pytest.mark.parametrize("wd", ["bf16", "int8"])
def test_quantize_and_dequantize_are_bit_equal_to_jax(tiny_params, wd):
    """vgg_tiny's params: the stored form's bf16 bits, int8 values and
    scales, and the dequantized f32 tree, bit for bit."""
    want = j_quantize(tiny_params, wd)
    got = quantize_params(params_from_jax(tiny_params), wd)
    want_leaves, got_leaves = dict(_leaves(want)), dict(_leaves(got))
    assert want_leaves.keys() == got_leaves.keys()
    for path, w in want_leaves.items():
        g = got_leaves[path]
        if isinstance(w, dict):  # an int8 kernel
            assert set(g) == {"__q8__", "__q8_scale__"} and g["__q8__"].dtype == torch.int8
            np.testing.assert_array_equal(g["__q8__"].numpy(), w["__q8__"], err_msg=path)
            assert g["__q8_scale__"].dtype == torch.float32
            np.testing.assert_array_equal(_bits(g["__q8_scale__"]), _bits(np.float32(w["__q8_scale__"])))
        else:
            assert np.asarray(w).shape == tuple(g.shape), path
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=path)
    deq_want = jax.tree_util.tree_map(np.asarray, j_dequantize(want))
    deq_got = dequantize_params(got)
    for (pw, w), (pg, g) in zip(_leaves(deq_want), _leaves(deq_got)):
        assert pw == pg and g.dtype == torch.float32
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=pw)


def test_quantize_edge_cases_match_jax():
    """An all-zero kernel keeps scale 1 and comes back zero, ties round to
    even, the widest value maps onto +-127, and an unknown tier fails."""
    tree = {"zero": np.zeros((4, 4), np.float32),
            "ties": np.array([[127.0, -127.0, 0.5, 1.5], [2.5, -0.5, -1.5, 63.5]], np.float32),
            "bias": np.array([1e-30, -3.0], np.float32)}
    for wd in ("bf16", "int8"):
        want, got = j_quantize(tree, wd), quantize_params(params_from_jax(tree), wd)
        for (pw, w), (pg, g) in zip(_leaves(want), _leaves(got)):
            if isinstance(w, dict):
                np.testing.assert_array_equal(g["__q8__"].numpy(), w["__q8__"], err_msg=pw)
                assert float(g["__q8_scale__"]) == float(w["__q8_scale__"])
            else:
                np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=pw)
        assert tree_nbytes(got) == sum(np.asarray(v).nbytes for v in jax.tree_util.tree_leaves(want))
    assert float(quantize_params(params_from_jax(tree), "int8")["zero"]["__q8_scale__"]) == 1.0
    with pytest.raises(ValueError, match="weight_dtype"):
        quantize_params({}, "fp4")


# --- the manager, step by step against the JAX package's ----------------------


class _FakeBundle:
    """The port's side of ``tests/test_weight_manager.py:_fake_builders``:
    the same params as CPU tensors, and the bundle's paging surface."""

    def __init__(self, name, leaf_kb=4):
        self.name = name
        self.device = torch.device("cpu")
        rng = np.random.default_rng(0)
        kernel = rng.normal(size=(leaf_kb * 256,)).astype(np.float32).reshape(-1, 16)
        self.params = {"l1": {"kernel": torch.from_numpy(kernel), "bias": torch.zeros(16)}}
        self.weight_dtype, self.managed, self.stored = "f32", False, None
        self.paged_out = 0

    def page_out(self):
        self.stored = None
        self.paged_out += 1


def _fake_builders(*names):
    return {n: (lambda n=n: _FakeBundle(n)) for n in names}


SIZE = 4096 + 64  # one fake model's f32 bytes
# (names, dtype, steps): a step is ("out", m) checkout, ("in", m) release,
# ("budget", n), ("unpin",) (everything may evict), ("enforce",), or
# ("fail", m): a checkout whose transfer raises
CASES = {
    "inert": (("ma",), "f32", [("out", "ma"), ("in", "ma")]),
    "lru_under_budget": (("ma", "mb", "mc"), "f32", [
        ("out", "ma"), ("in", "ma"), ("budget", 2 * SIZE + 64), ("unpin",),
        ("out", "mb"), ("in", "mb"), ("out", "mc"), ("in", "mc")]),
    "touch_refreshes_lru": (("ma", "mb", "mc"), "f32", [
        ("unpin",), ("out", "ma"), ("in", "ma"), ("budget", 2 * SIZE + 64), ("out", "mb"), ("in", "mb"),
        ("out", "ma"), ("in", "ma"), ("out", "mc"), ("in", "mc")]),
    "pinned_never_evicted": (("ma", "mb", "mc"), "f32", [
        ("out", "ma"), ("in", "ma"), ("budget", SIZE + 64), ("out", "mb"), ("in", "mb"),
        ("out", "mc"), ("in", "mc")]),
    "inflight_never_evicted": (("ma", "mb", "mc"), "f32", [
        ("unpin",), ("out", "mb"), ("budget", SIZE + 64), ("out", "mc"), ("in", "mc"),
        ("in", "mb"), ("out", "ma"), ("in", "ma")]),
    "two_pins_one_model": (("ma", "mb", "mc"), "f32", [
        ("unpin",), ("budget", SIZE + 64), ("out", "mb"), ("out", "mb"), ("in", "mb"),
        ("out", "mc"), ("in", "mc"), ("in", "mb"), ("out", "ma"), ("in", "ma")]),
    "failed_page_in_then_retry": (("ma", "mb"), "f32", [
        ("fail", "mb"), ("out", "mb"), ("in", "mb")]),
    "enforce_lowered_budget": (("ma", "mb", "mc"), "f32", [
        ("out", "ma"), ("in", "ma"), ("out", "mb"), ("in", "mb"), ("out", "mc"), ("in", "mc"),
        ("budget", SIZE + 64), ("enforce",), ("unpin",), ("enforce",)]),
    "bf16_tier": (("ma", "mb", "mc"), "bf16", [
        ("budget", SIZE + 64), ("out", "ma"), ("in", "ma"), ("out", "mb"), ("in", "mb"),
        ("out", "mc"), ("in", "mc")]),
    "int8_tier_single_model": (("ma",), "int8", [("out", "ma"), ("in", "ma"), ("out", "ma"), ("in", "ma")]),
}


def _state(m, metrics):
    return {
        "snapshot": m.snapshot(), "ready_block": m.ready_block(), "resident": m.resident_models(),
        "counts": (m.page_ins, m.page_outs, m.page_in_bytes, m.overcommits),
        "metrics": {f: metrics.counter(f) for f in WEIGHT_FAMILIES},
    }


@pytest.mark.parametrize("case", list(CASES))
def test_manager_matches_jax_step_by_step(case, monkeypatch):
    """The JAX package's manager cases (LRU under the budget, touch refresh,
    pinned never evicted, in-flight never evicted, a failed page-in that
    lets the next checkout through, a lowered budget enforced, the weight
    tiers) through both managers: snapshot, ready_block, counts, metrics
    and LRU order equal after every step."""
    names, dtype, steps = CASES[case]
    jm_metrics, pm_metrics = JMetrics(), Metrics()
    jm = JWeightManager(_j_fake_builders(*names), names[0], weight_dtype=dtype, metrics=jm_metrics)
    pm = WeightManager(_fake_builders(*names), names[0], weight_dtype=dtype, metrics=pm_metrics)
    assert _state(pm, pm_metrics) == _state(jm, jm_metrics)
    for i, step in enumerate(steps):
        op = step[0]
        if op == "out":
            jt, _ = jm.checkout(step[1])
            pt, _ = pm.checkout(step[1])
            assert tree_nbytes(pt) == sum(np.asarray(v).nbytes for v in jax.tree_util.tree_leaves(jt))
            if pm.managed:
                assert pm.peek_bundle(step[1]).stored is pt
        elif op == "in":
            jm.release(step[1])
            pm.release(step[1])
        elif op == "budget":
            jm.budget_bytes = pm.budget_bytes = step[1]
        elif op == "unpin":
            jm.pinned = pm.pinned = ()
        elif op == "enforce":
            assert pm.enforce_budget() == jm.enforce_budget()
        elif op == "fail":
            for m in (jm, pm):
                def boom(tree, where):
                    raise RuntimeError("transfer died")

                monkeypatch.setattr(m, "_place", boom)
                with pytest.raises(RuntimeError, match="transfer died"):
                    m.checkout(step[1])
                monkeypatch.undo()
        assert _state(pm, pm_metrics) == _state(jm, jm_metrics), (case, i, step)
    # a page-out dropped what the model held, and nothing in flight was evicted
    for name in names:
        b = pm.peek_bundle(name)
        if b is not None and pm.managed:
            assert (b.stored is None) == (name not in pm.resident_models())
    assert pm_metrics.counter("weight_evict_inflight_total") == 0


def test_manager_boot_errors_match_jax():
    for kwargs, match in (({"pinned": ("ghost",)}, "pinned"), ({"weight_dtype": "fp4"}, "weight_dtype")):
        with pytest.raises(ValueError, match=match) as want:
            JWeightManager(_j_fake_builders("ma", "mb"), "ma", **kwargs)
        with pytest.raises(ValueError, match=match) as got:
            WeightManager(_fake_builders("ma", "mb"), "ma", **kwargs)
        assert str(got.value) == str(want.value)
    with pytest.raises(errors.UnknownModel) as got:
        WeightManager(_fake_builders("ma", "mb"), "ma").bundle("nope")
    assert str(got.value) == "unknown or unserved model 'nope'; serving: ['ma', 'mb']"


def test_inert_checkout_is_the_params_themselves():
    m = WeightManager(_fake_builders("ma"), "ma")
    b = m.bundle("ma")
    tree, page_s = m.checkout("ma")
    assert not m.managed and not b.managed and tree is b.params and page_s == 0.0 and m.page_ins == 0


# --- threads ------------------------------------------------------------------


def test_cold_checkout_coalesces_one_transfer(monkeypatch):
    """8 concurrent checkouts of one cold model: one transfer, one tree."""
    m = WeightManager(_fake_builders("ma", "mb"), "ma")
    calls, place = [], m._place

    def slow_place(tree, device):
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return place(tree, device)

    monkeypatch.setattr(m, "_place", slow_place)
    results = []

    def worker():
        tree, _ = m.checkout("mb")
        results.append(tree)
        m.release("mb")

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert len(calls) == 1 and len(results) == 8
    assert all(r is results[0] for r in results) and m.page_ins == 1 and m.inflight_pins("mb") == 0


def test_failed_leader_hands_the_page_in_to_a_waiter(monkeypatch):
    """The leader's transfer fails while 3 others wait: it raises, one
    waiter leads a second transfer, and the other two share its tree."""
    m = WeightManager(_fake_builders("ma", "mb"), "ma")
    calls, place = [], m._place

    def flaky_place(tree, device):
        calls.append(1)
        time.sleep(0.05)
        if len(calls) == 1:
            raise RuntimeError("transfer died")
        return place(tree, device)

    monkeypatch.setattr(m, "_place", flaky_place)
    results, failures = [], []

    def worker():
        try:
            results.append(m.checkout("mb")[0])
            m.release("mb")
        except RuntimeError as e:
            failures.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
        time.sleep(0.005)
    for t in threads:
        t.join(10)
    assert len(failures) == 1 and len(results) == 3 and len(calls) == 2
    assert all(r is results[0] for r in results) and m.page_ins == 1


# --- the weight tiers served ----------------------------------------------------


@pytest.mark.parametrize("wd", ["bf16", "int8"])
def test_tier_grids_match_jax_quantized_program(tiny_params, wd):
    """vgg_tiny at ``weight_dtype`` through the port's service against the
    JAX package's quantized serving program on the same images: equal
    channels, grids at the JAX package's output PSNR floor, and the card's
    resident bytes those of the stored tier."""
    params = params_from_jax(tiny_params)
    registry = {"vgg_tiny": lambda: ModelBundle(VGG_TINY_SPEC, params_from_jax(tiny_params), torch.device("cpu"))}
    service = DeconvService(cfg=ServerConfig(model="vgg_tiny", weight_dtype=wd), registry=registry)
    xs = np.random.default_rng(0).normal(0, 50, (2, 32, 32, 3)).astype(np.float32)
    got = service.visualize_batch(LAYER, xs)
    jbundle = j_spec_bundle(J_TINY_SPEC, tiny_params)
    jbundle.weight_dtype = wd
    fn = jbundle.batched_visualizer(LAYER, "all", 4, True, "bfloat16", post="grid")
    want = jax.tree_util.tree_map(np.asarray, fn(j_quantize(tiny_params, wd), jnp.asarray(xs))[LAYER])
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for g, w in zip(got["grid"], want["grid"]):
        mse = np.mean((g.astype(np.float64) - w.astype(np.float64)) ** 2)
        assert mse == 0 or 10 * np.log10(255.0**2 / mse) >= OUTPUT_PSNR_FLOORS[wd]
    snap = service.weights.snapshot()
    assert snap["managed"] and snap["lanes"]["0"]["resident"] == ["vgg_tiny"]
    assert snap["lanes"]["0"]["bytes"] == tree_nbytes(quantize_params(params, wd)) < tree_nbytes(params) * 0.6
