"""The port stands alone: importing it (and everything chip_smoke.py imports)
loads neither jax nor the JAX package, nor h5py (read only to load an h5
file), no module of it imports them, its kernel modules import on a
machine without nvcc or triton, and without a card every entry point
raises unless it is given ``device="cpu"`` (the doctor's ``backend``
check fails)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "deconv_api_tpu_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _run(code: str, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_port_imports_without_jax_nvcc_or_triton():
    """One subprocess with no nvcc on its PATH: importing the port and what
    chip_smoke.py imports loads no jax, no JAX package and no triton; the
    kernel build says clearly that nvcc is missing."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import deconv_api_tpu_torch, deconv_api_tpu_torch.__main__\n"
        "import deconv_api_tpu_torch.ops, deconv_api_tpu_torch.engine\n"
        "import deconv_api_tpu_torch.serving.app, deconv_api_tpu_torch.models.weights\n"
        "import deconv_api_tpu_torch.config, deconv_api_tpu_torch.utils.quantize\n"
        "import deconv_api_tpu_torch.serving.metrics, deconv_api_tpu_torch.serving.weight_manager\n"
        "import deconv_api_tpu_torch.engine.autodeconv, deconv_api_tpu_torch.models.apply\n"
        "from deconv_api_tpu_torch.models import blocks, resnet50, inception_v3, mobilenet_v1, mobilenet_v2, vgg19\n"
        "from deconv_api_tpu_torch.ops import _build, cuda_pool, cuda_deconv, cuda_q8\n"
        "from deconv_api_tpu_torch.engine import quant\n"
        "from deconv_api_tpu_torch.utils import slog\n"
        "from deconv_api_tpu_torch.serving import batcher, codec_pool, faults, http, trace\n"
        "from deconv_api_tpu_torch.serving import alerts, cache, durable, tsdb, qos, jobs, aot, autoscale\n"
        "from deconv_api_tpu_torch.models import dag_weights\n"
        "from deconv_api_tpu_torch.utils import doctor, tracing\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'deconv_api_tpu' or m.startswith('deconv_api_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules and 'h5py' not in sys.modules\n"
        "try:\n"
        "    _build.nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('clean; no nvcc:', e)\n"
    )
    out = _run(code, {"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent"})
    assert out.returncode == 0 and "clean; no nvcc" in out.stdout, out.stderr


PIPELINE_MODULES = ("utils/slog.py", "serving/faults.py", "serving/trace.py", "serving/codec_pool.py",
                    "serving/http.py", "serving/batcher.py", "serving/durable.py", "serving/cache.py",
                    "serving/tsdb.py", "serving/alerts.py", "serving/qos.py", "engine/quant.py", "ops/cuda_q8.py",
                    "models/dag_weights.py", "utils/doctor.py", "utils/tracing.py", "serving/aot.py",
                    "serving/autoscale.py")


def test_the_request_pipeline_modules_are_the_ports_own():
    """The port keeps its own copies of the JAX package's jax-free serving
    modules: each exists in the port and is checked below."""
    sources = set(_port_sources())
    assert all(PORT / rel in sources for rel in PIPELINE_MODULES)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    def banned(name: str) -> bool:
        top = name.split(".")[0]
        return top in ("jax", "jaxlib", "deconv_api_tpu")

    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(banned(n) for n in names), f"{path.name}:{node.lineno} imports {names}"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_h5py_is_imported_only_inside_a_function(path):
    tree = ast.parse(path.read_text())
    for node in tree.body:  # the module's own statements, not function bodies
        for sub in ast.walk(node) if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) else ():
            if isinstance(sub, ast.Import):
                assert "h5py" not in [a.name for a in sub.names], f"{path.name}:{sub.lineno}"


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from deconv_api_tpu_torch.__main__ import main
    from deconv_api_tpu_torch.config import ServerConfig
    from deconv_api_tpu_torch.serving.app import DeconvService
    from deconv_api_tpu_torch._device import resolve_device
    from deconv_api_tpu_torch.engine.autodeconv import autodeconv_visualizer
    from deconv_api_tpu_torch.engine.deconv import get_visualizer
    from deconv_api_tpu_torch.engine.deepdream import deepdream_batch
    from deconv_api_tpu_torch.models.resnet50 import resnet50_forward
    from deconv_api_tpu_torch.models.tiny import VGG_TINY_SPEC
    from deconv_api_tpu_torch.serving.models import build_bundle

    for call in (
        lambda: resolve_device(),
        lambda: get_visualizer(VGG_TINY_SPEC, "fc1"),
        lambda: autodeconv_visualizer(resnet50_forward, "conv1_relu"),
        lambda: deepdream_batch(resnet50_forward, {}, torch.zeros((1, 8, 8, 3)), layers=("conv1_relu",)),
        lambda: build_bundle("vgg_tiny"),
        lambda: build_bundle("resnet50"),
        lambda: main(["serve", "--model", "vgg_tiny", "--port", "0"]),
        lambda: main(["serve", "--model", "mobilenet_v1", "--port", "0"]),
        lambda: main(["serve", "--model", "vgg_tiny", "--serve-models", "vgg_tiny,mobilenet_v2", "--port", "0"]),
        lambda: DeconvService(cfg=ServerConfig(model="vgg_tiny", serve_models="all", weight_dtype="int8")),
        lambda: DeconvService(cfg=ServerConfig(model="vgg_tiny", qos=True, quality_default="int8")),
        lambda: get_visualizer(VGG_TINY_SPEC, "fc1", quant="dynamic"),
        lambda: main(["visualize", "--image", "in.png", "--layer", "block3_conv1", "--model", "vgg_tiny"]),
        lambda: main(["dream", "--image", "in.png", "--model", "vgg_tiny"]),
        lambda: main(["calibrate", "--model", "vgg_tiny", "--out", "calib"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu").type == "cpu"
    assert build_bundle("vgg_tiny", "cpu").device.type == "cpu"
    assert DeconvService(cfg=ServerConfig(model="vgg_tiny"), device="cpu").bundle.device.type == "cpu"
    get_visualizer(VGG_TINY_SPEC, "fc1", device="cpu")
    autodeconv_visualizer(resnet50_forward, "conv1_relu", device="cpu")


def test_the_doctor_without_a_card_fails_its_backend_check(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from deconv_api_tpu_torch.utils.doctor import run_doctor

    assert run_doctor(["backend"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert '"ok": false' in lines[0] and "CUDA is not available" in lines[0]
    assert lines[-1] == '{"check": "overall", "ok": false}'
