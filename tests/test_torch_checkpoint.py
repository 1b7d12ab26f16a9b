"""The port's checkpoints (``utils/checkpoint.py``), its training loop's
resume and guardrails (``train/loop.py``), the ``train`` command and
``serve --weights <checkpoint dir>`` on the CPU, port only.

Resumption is bit-exact: a run stopped at step 2 of 4 and resumed ends
with the uninterrupted run's params, bit for bit.  The held-out accuracy
rises on the learnable synthetic data (the JAX package's
``tests/test_train_cli.py::test_heldout_eval_improves``, on vgg_tiny)."""

import json
import os

import numpy as np
import pytest
import torch

from deconv_api_tpu_torch.__main__ import main
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.models import VGG_TINY_SPEC, init_params, mobilenet_v1
from deconv_api_tpu_torch.models.weights import flat_arrays, params_from_jax, save_npz, tree_map
from deconv_api_tpu_torch.serving import codec
from deconv_api_tpu_torch.serving import models as serving_models
from deconv_api_tpu_torch.serving.app import DeconvService
from deconv_api_tpu_torch.train import loop, step
from deconv_api_tpu_torch.utils import checkpoint
from tests.torch_dag_families import numpy_params

QUIET = dict(warmup_all_buckets=False, warmup_dream=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tiny(seed: int = 0) -> dict:
    return init_params(VGG_TINY_SPEC, torch.Generator().manual_seed(seed))


def _equal(a: dict, b: dict) -> bool:
    """The same keys, dtypes and bits, leaf for leaf."""
    if list(a) != list(b):
        return False
    return all(_equal(a[k], b[k]) if isinstance(a[k], dict) else
               a[k].dtype == b[k].dtype and torch.equal(a[k].detach().cpu(), b[k].detach().cpu()) for k in a)


# ------------------------------------------------------------ checkpoints


def test_a_checkpoint_round_trips_dtypes_and_shapes(tmp_path):
    params = {"a": {"w": torch.randn(3, 4), "b": torch.zeros(4, dtype=torch.bfloat16)},
              "c": {"d": {"gamma": torch.arange(5, dtype=torch.float64)}}}
    path = str(tmp_path / "ck")
    checkpoint.save_params(path, params, model="m", step=7)
    assert sorted(os.listdir(path)) == ["checkpoint.json", "params.npz"]
    manifest = checkpoint.read_manifest(path)
    assert (manifest["format"], manifest["kind"], manifest["model"], manifest["step"]) == (
        checkpoint.FORMAT, "params", "m", 7)
    like = tree_map(lambda t: torch.empty_like(t), params)
    back = checkpoint.restore_params(path, like)
    assert _equal(back, params)
    # dtype and device come from the like tree
    like32 = tree_map(lambda t: torch.empty(t.shape), params)
    assert {t.dtype for t in step.leaves(checkpoint.restore_params(path, like32))} == {torch.float32}
    bad = tree_map(lambda t: torch.empty(t.shape), params)
    bad["a"]["w"] = torch.empty(4, 3)
    with pytest.raises(ValueError, match=r"a/w: checkpoint shape \(3, 4\) != model shape \(4, 3\)"):
        checkpoint.restore_params(path, bad)
    del bad["c"]
    with pytest.raises(ValueError, match=r"missing \[\].*unexpected \['c/d/gamma'\]"):
        checkpoint.restore_params(path, bad)


def test_a_save_replaces_the_directory_as_a_whole(tmp_path, monkeypatch):
    path = str(tmp_path / "ck")
    checkpoint.save_params(path, {"l": {"w": torch.ones(2)}}, step=1)
    with open(os.path.join(path, "stray"), "w") as f:
        f.write("left by someone")
    checkpoint.save_params(path, {"l": {"w": torch.full((2,), 2.0)}}, step=2)
    assert sorted(os.listdir(path)) == ["checkpoint.json", "params.npz"]
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    # a kill between the two renames: the previous checkpoint is still read
    renames = []

    def dying_rename(src, dst):
        renames.append((src, dst))
        if len(renames) == 2:
            raise KeyboardInterrupt
        os.replace(src, dst)

    monkeypatch.setattr(checkpoint.os, "rename", dying_rename)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_params(path, {"l": {"w": torch.full((2,), 3.0)}}, step=3)
    monkeypatch.undo()
    assert not os.path.exists(path) and checkpoint.is_checkpoint(path)
    assert checkpoint.read_manifest(path)["step"] == 2
    assert checkpoint.restore_params(path, {"l": {"w": torch.empty(2)}})["l"]["w"].tolist() == [2.0, 2.0]
    checkpoint.save_params(path, {"l": {"w": torch.full((2,), 4.0)}}, step=4)
    assert sorted(os.listdir(tmp_path)) == ["ck"] and checkpoint.read_manifest(path)["step"] == 4


def test_a_train_state_round_trips_bit_for_bit(tmp_path):
    init_fn, step_fn = step.make_train_step(VGG_TINY_SPEC, "cpu", 1e-3)
    state = init_fn(_tiny())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32))
    state, _ = step_fn(state, x, torch.tensor([3, 9]))
    path = str(tmp_path / "run.state")
    checkpoint.save_train_state(path, state, model="vgg_tiny")
    assert checkpoint.read_manifest(path)["kind"] == "train_state"
    back = checkpoint.restore_train_state(path, init_fn(_tiny(1)))
    assert (back.step, back.opt_state.count) == (1, 1)
    for a, b in ((back.params, state.params), (back.opt_state.mu, state.opt_state.mu),
                 (back.opt_state.nu, state.opt_state.nu)):
        assert _equal(a, b)
    # its params serve as a params checkpoint too
    assert _equal(checkpoint.restore_params(path, _tiny()), state.params)
    checkpoint.save_params(str(tmp_path / "p"), state.params)
    with pytest.raises(ValueError, match="not a training state"):
        checkpoint.restore_train_state(str(tmp_path / "p"), state)


# ------------------------------------------------------------ the loop


def test_resume_is_bit_exact(tmp_path):
    common = dict(batch=4, lr=1e-3, mesh_shape=(1,), seed=3, device="cpu")
    straight = loop.train_synthetic(VGG_TINY_SPEC, _tiny(), steps=4, **common)
    ck = str(tmp_path / "run")
    first = loop.train_synthetic(VGG_TINY_SPEC, _tiny(), steps=2, save_dir=ck, save_every=2, **common)
    assert first["resumed_from"] == 0
    assert sorted(os.listdir(tmp_path)) == ["run", "run.state", "run.state.meta.json"]
    with open(tmp_path / "run.state.meta.json") as f:
        assert json.load(f) == {"model": "vgg_tiny", "seed": 3, "lr": 1e-3, "batch": 4, "mesh": [1, 1]}
    resumed = loop.train_synthetic(VGG_TINY_SPEC, _tiny(), steps=4, save_dir=ck, save_every=2, resume=True,
                                   **common)
    assert resumed["resumed_from"] == 2
    assert resumed["final_loss"] == straight["final_loss"]
    assert _equal(resumed["params"], straight["params"])
    assert _equal(checkpoint.restore_params(ck, _tiny()), straight["params"])
    assert checkpoint.read_manifest(ck)["step"] == 4


def test_the_guardrails_raise_the_jax_loops_messages(tmp_path):
    common = dict(batch=4, lr=1e-3, device="cpu")
    ck = str(tmp_path / "run")
    loop.train_synthetic(VGG_TINY_SPEC, _tiny(), steps=2, save_dir=ck, save_every=2, **common)
    with pytest.raises(ValueError, match="config mismatch.*'lr': \\(0.001, 0.0005\\)"):
        loop.train_synthetic(VGG_TINY_SPEC, _tiny(), steps=4, save_dir=ck, save_every=2, resume=True,
                             **{**common, "lr": 5e-4})
    with pytest.raises(ValueError, match="nothing to resume"):
        loop.train_synthetic(VGG_TINY_SPEC, _tiny(), steps=2, save_dir=ck, resume=True, **common)
    with pytest.raises(ValueError, match="need --save"):
        loop.train_synthetic(VGG_TINY_SPEC, _tiny(), steps=2, save_every=2, **common)
    with pytest.raises(FileNotFoundError, match="no checkpoint at"):
        loop.train_synthetic(VGG_TINY_SPEC, _tiny(), steps=2, save_dir=str(tmp_path / "none"), resume=True,
                             **common)
    nan = _tiny()
    nan["predictions"]["b"][0] = float("nan")
    with pytest.raises(RuntimeError, match="non-finite loss nan at step 0"):
        loop.train_synthetic(VGG_TINY_SPEC, nan, steps=2, **common)
    with pytest.raises(ValueError, match="num_classes"):
        loop.train_synthetic(None, {}, steps=1, device="cpu")
    with pytest.raises(ValueError, match="parallel slice"):
        loop.train_synthetic(VGG_TINY_SPEC, _tiny(), steps=1, mesh_shape=(4, 2), **common)


def test_without_a_card_training_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: training runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.train_synthetic(VGG_TINY_SPEC, _tiny(), steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["train", "--model", "vgg_tiny", "--steps", "1"])


def test_heldout_eval_improves():
    """40 steps at batch 32: held-out loss falls by 40% and accuracy beats
    chance by half again, as the JAX package's test asks of its loop."""
    r = loop.train_synthetic(VGG_TINY_SPEC, _tiny(), steps=40, batch=32, lr=1e-3, device="cpu")
    chance = 1.0 / VGG_TINY_SPEC.layers[-1].filters
    assert r["eval_loss"] < 0.6 * r["eval_loss_initial"], (r["eval_loss_initial"], r["eval_loss"])
    assert r["eval_accuracy"] >= 1.5 * chance, r["eval_accuracy"]


# ------------------------------------------------------- CLI and serving


def _summary(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_then_serve_the_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ckpt")
    assert main(["train", "--device", "cpu", "--model", "vgg_tiny", "--steps", "2", "--lr", "1e-3",
                 "--save", ck]) == 0
    out = _summary(capsys)
    assert sorted(out) == sorted(["model", "steps", "batch", "mesh", "final_loss", "resumed_from",
                                  "eval_loss_initial", "eval_loss", "eval_accuracy_initial", "eval_accuracy",
                                  "checkpoint"])
    assert (out["model"], out["steps"], out["mesh"], out["checkpoint"]) == ("vgg_tiny", 2, [1, 1], ck)
    assert np.isfinite(out["final_loss"])
    assert checkpoint.read_manifest(ck)["model"] == "vgg_tiny"
    served = DeconvService(cfg=ServerConfig(model="vgg_tiny", weights_path=ck, **QUIET), device="cpu")
    init = DeconvService(cfg=ServerConfig(model="vgg_tiny", **QUIET), device="cpu")
    try:
        assert _equal(served.bundle.params, checkpoint.restore_params(ck, init.bundle.params))
        assert not _equal(served.bundle.params, init.bundle.params)
        x = np.random.default_rng(1).normal(0, 40, (32, 32, 3)).astype(np.float32)
        grid = served.visualize_batch("block3_conv1", x[None])["grid"][0]
        assert grid.shape == (64, 64, 3) and grid.dtype == np.uint8
        assert not np.array_equal(grid, init.visualize_batch("block3_conv1", x[None])["grid"][0])
        assert codec.encode_data_url(grid).startswith("data:image/")
    finally:
        served.close()
        init.close()
    # a checkpoint of another model is a boot error
    with pytest.raises(ValueError, match="holds model 'vgg_tiny', not 'vgg16'"):
        DeconvService(cfg=ServerConfig(model="vgg16", weights_path=ck, **QUIET), device="cpu")


def test_train_resumes_through_the_cli(tmp_path, capsys):
    ck = str(tmp_path / "ckpt")
    argv = ["train", "--device", "cpu", "--model", "vgg_tiny", "--batch", "2", "--save", ck]
    assert main([*argv, "--steps", "3"]) == 0
    straight = checkpoint.restore_params(ck, _tiny())
    assert main([*argv, "--steps", "2", "--save-every", "2"]) == 0
    assert main([*argv, "--steps", "3", "--save-every", "2", "--resume"]) == 0
    assert _summary(capsys)["resumed_from"] == 2
    assert _equal(checkpoint.restore_params(ck, _tiny()), straight)


def test_train_refuses_a_mesh_of_several_devices(capsys):
    with pytest.raises(ValueError, match="parallel slice"):
        main(["train", "--device", "cpu", "--model", "vgg_tiny", "--steps", "1", "--mesh", "4,2"])


def test_train_a_dag_family_through_the_cli(tmp_path, capsys, monkeypatch):
    """MobileNet v1 with a 10-way head at 64x64 (``tests/torch_dag_families.py``):
    the command reads the class count from a forward on the meta device and
    the input size from the bundle; its BatchNorm leaves train."""
    tree = numpy_params("mobilenet_v1")
    monkeypatch.setitem(serving_models.REGISTRY, "mobilenet_v1_small", serving_models._dag_bundle(
        "mobilenet_v1_small", mobilenet_v1, lambda gen, device: tree_map(lambda t: t.to(device), params_from_jax(tree)),
        mobilenet_v1.mobilenet_v1_forward, 64, codec.preprocess_tf))
    ck = str(tmp_path / "dag")
    assert main(["train", "--device", "cpu", "--model", "mobilenet_v1_small", "--steps", "1", "--batch", "2",
                 "--save", ck]) == 0
    out = _summary(capsys)
    assert (out["model"], out["steps"]) == ("mobilenet_v1_small", 1) and np.isfinite(out["final_loss"])
    trained = flat_arrays(checkpoint.restore_params(ck, params_from_jax(tree)))
    assert trained["predictions/w"].shape == (1024, 10)
    for leaf in ("conv1/gamma", "conv1/mean", "conv1/var", "conv_pw_13/beta"):
        assert not np.array_equal(trained[leaf], tree[leaf.split("/")[0]][leaf.split("/")[1]]), leaf


def test_a_directory_of_neither_format_is_refused_at_boot(tmp_path):
    (tmp_path / "checkpoint").mkdir()  # what orbax leaves, say
    save_npz(_tiny(), str(tmp_path / "other_model.npz"))
    with pytest.raises(ValueError, match="orbax checkpoint format.*restore_params.*save_params"):
        DeconvService(cfg=ServerConfig(model="vgg_tiny", weights_path=str(tmp_path), **QUIET), device="cpu")
