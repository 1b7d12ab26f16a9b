"""Environment diagnostics: ``python -m deconv_api_tpu_torch doctor``
(counterpart of ``deconv_api_tpu/utils/doctor.py``).

Every probe runs in a child process under a hard timeout, so a wedged
driver or a hung build cannot hang the doctor itself.  Probes run on the
card (``cuda``) unless given ``device="cpu"``; without a card the
``backend`` probe fails, and there is no fallback.

Checks:
  backend   the device, one 128x128 product on it (liveness), its name
            and the number of cards
  rtt       the median time to fetch an already computed scalar from the
            device: the host<->device round trip a fetch pays
  build     the kernel build directory (``ops/_build.py``) is writable and,
            on the card, the four kernel libraries build and load
  selftest  a tiny two-conv, one-pool spec visualized through the engine;
            on the card through K1 (the pool's argmax) and K2 (the
            unpool), whose launches it reports

Output: one JSON object per check, then ``{"check": "overall", "ok"}``;
exit 0 only when every check passes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

_CHILD_TIMEOUT_S = 120.0
# the repository root, so the child imports this package wherever it runs
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run_child(code: str, timeout_s: float = _CHILD_TIMEOUT_S) -> dict:
    """Run probe code in a subprocess; its last JSON line of stdout wins."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH", "")) if p)
    t0 = time.monotonic()
    try:
        proc = subprocess.run([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"probe hung past {timeout_s:.0f}s (wedged device or build?)"}
    wall = time.monotonic() - t0
    for line in reversed(proc.stdout.decode(errors="replace").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                out = json.loads(line)
            except json.JSONDecodeError:
                continue
            out.setdefault("wall_s", round(wall, 1))
            return out
    return {"ok": False, "error": f"probe rc={proc.returncode}",
            "stderr_tail": proc.stderr.decode(errors="replace")[-400:]}


def _prelude(device: str | None) -> str:
    """The child's first lines: torch and the resolved device ``d`` (the
    card unless ``device`` is ``"cpu"``; without a card this raises)."""
    return ("import json, torch\n"
            "from deconv_api_tpu_torch._device import resolve_device\n"
            f"d = resolve_device({device!r})\n")


def check_backend(device: str | None = None) -> dict:
    return _run_child(
        _prelude(device)
        + "x = float((torch.ones((128, 128), device=d) @ torch.ones((128, 128), device=d)).sum())\n"
        "cuda = d.type == 'cuda'\n"
        "print(json.dumps({'ok': x == 128.0 * 128 * 128, 'device': str(d), 'platform': d.type,\n"
        "                  'name': torch.cuda.get_device_name(0) if cuda else 'cpu',\n"
        "                  'n_devices': torch.cuda.device_count() if cuda else 1}))\n"
    )


def check_rtt(device: str | None = None) -> dict:
    """Median time to fetch an ALREADY computed scalar: the host<->device
    latency alone, which decides what a per-leaf fetch or a sync costs."""
    return _run_child(
        _prelude(device)
        + "import statistics, time\n"
        "vals = [torch.full((), float(i), device=d) + 1.0 for i in range(6)]\n"
        "if d.type == 'cuda':\n"
        "    torch.cuda.synchronize()\n"
        "ts = []\n"
        "for v in vals[1:]:\n"
        "    t0 = time.perf_counter()\n"
        "    v.item()\n"
        "    ts.append((time.perf_counter() - t0) * 1e3)\n"
        "print(json.dumps({'ok': True, 'fetch_rtt_ms_p50': round(statistics.median(ts), 4),\n"
        "                  'hint': 'the pipelined dispatch overlaps this with the next batch'}))\n"
    )


def check_build(device: str | None = None) -> dict:
    """The kernel build directory is writable; on the card the four kernel
    libraries build (``nvcc``, or the cached library) and load."""
    return _run_child(
        _prelude(device)
        + "import ctypes, os, tempfile\n"
        "from deconv_api_tpu_torch.ops import _build\n"
        "path = str(_build.BUILD_DIR)\n"
        "try:\n"
        "    os.makedirs(path, exist_ok=True)\n"
        "    with tempfile.NamedTemporaryFile(dir=path):\n"
        "        pass\n"
        "    writable = True\n"
        "except OSError:\n"
        "    writable = False\n"
        "out = {'dir': path, 'writable': writable}\n"
        "if d.type == 'cuda' and writable:\n"
        "    out['built_s'] = {k: round(v, 1) for k, v in _build.build().items()}\n"
        "    for name in _build.KERNELS:\n"
        "        ctypes.CDLL(str(_build.library_path(name)))\n"
        "    out['loaded'] = list(_build.KERNELS)\n"
        "elif d.type != 'cuda':\n"
        "    out['loaded'] = 'not needed: the cpu runs the plain versions'\n"
        "print(json.dumps({'ok': writable, **out}))\n",
        timeout_s=600.0,
    )


def check_selftest(device: str | None = None) -> dict:
    """The JAX doctor's tiny spec (two 4-filter convs around one pool) at
    8x8, top 2, visualized through the engine; on the card K1 and K2 must
    have launched."""
    return _run_child(
        _prelude(device)
        + "from deconv_api_tpu_torch import ops\n"
        "from deconv_api_tpu_torch.engine import get_visualizer\n"
        "from deconv_api_tpu_torch.models.spec import Layer, ModelSpec, init_params\n"
        "spec = ModelSpec(name='doc', input_shape=(8, 8, 3), layers=(\n"
        "    Layer('input_1', 'input'),\n"
        "    Layer('c1', 'conv', activation='relu', filters=4),\n"
        "    Layer('p1', 'pool'),\n"
        "    Layer('c2', 'conv', activation='relu', filters=4),\n"
        "))\n"
        "params = init_params(spec, torch.Generator(device=d).manual_seed(0), d)\n"
        "fn = get_visualizer(spec, 'c2', 2, 'all', True, device=d)\n"
        "ops.reset_launch_counts()\n"
        "img = fn.body(params, torch.ones((1, 8, 8, 3), device=d))['c2']['images']\n"
        "launches = {k: v for k, v in ops.launch_counts().items() if v}\n"
        "ok = tuple(img.shape) == (1, 2, 8, 8, 3) and bool(torch.isfinite(img).all())\n"
        "if d.type == 'cuda':\n"
        "    ok = ok and launches.get('pool_argmax', 0) > 0 and launches.get('unpool_argmax', 0) > 0\n"
        "print(json.dumps({'ok': ok, 'out_shape': list(img.shape), 'launches': launches}))\n",
        timeout_s=300.0,
    )


CHECKS = {
    "backend": check_backend,
    "rtt": check_rtt,
    "build": check_build,
    "selftest": check_selftest,
}


def run_doctor(checks: list[str] | None = None, device: str | None = None) -> int:
    """Run ``checks`` (default all) on ``device``, one JSON line each and
    the overall verdict last; 0 when every check passed, else 1."""
    all_ok = True
    for name in checks or list(CHECKS):
        result = {"check": name, **CHECKS[name](device)}
        all_ok = all_ok and bool(result.get("ok"))
        print(json.dumps(result), flush=True)
    print(json.dumps({"check": "overall", "ok": all_ok}), flush=True)
    return 0 if all_ok else 1
