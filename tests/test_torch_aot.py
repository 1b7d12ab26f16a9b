"""The warm boot (``deconv_api_tpu_torch/serving/aot.py``) on the CPU: the
port's ``ArtifactStore`` against the JAX package's (the same files for the
same key and payload, each package reading the other's, the same budget
sweep, corrupt, torn and future-version entries, an injected read error),
the ``KernelResolver`` with an injected build function in place of
``nvcc`` (a miss builds and stores, a second resolver hits and never
builds, a payload that does not load is invalidated and rebuilt, the key
follows the source, the flags and the versions, ``ops/_build.load``
through the seam), and the ``aot`` blocks of a CPU vgg_tiny server."""

from __future__ import annotations

import os
from pathlib import Path

import pytest
import torch

from deconv_api_tpu.serving import aot as j_aot
from deconv_api_tpu.serving import faults as j_faults
from deconv_api_tpu.serving.metrics import Metrics as JMetrics
from deconv_api_tpu_torch import __main__ as cli
from deconv_api_tpu_torch.config import ServerConfig
from deconv_api_tpu_torch.ops import _build
from deconv_api_tpu_torch.serving import aot, durable, faults
from deconv_api_tpu_torch.serving.aot import ArtifactStore, KernelResolver
from deconv_api_tpu_torch.serving.app import DeconvService
from deconv_api_tpu_torch.serving.metrics import Metrics

PACKAGES = {"port": (aot, Metrics, faults), "jax": (j_aot, JMetrics, j_faults)}
KEY = "0123456789abcdef" * 2
COUNTERS = ("hits", "misses", "stores", "corrupt", "errors", "sweeps")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _counts(metrics) -> dict:
    return {c: metrics.counter(f"aot_cache_{c}_total") for c in COUNTERS}


def _stores(tmp_path, **kw) -> dict:
    out = {}
    for name, (mod, metrics_cls, _f) in PACKAGES.items():
        m = metrics_cls("deconv")
        out[name] = (mod.ArtifactStore(str(tmp_path / name), metrics=m, **kw), m)
    return out


# ------------------------------------------------------------- the store


def test_a_stored_file_is_the_jax_packages_and_each_reads_the_others(tmp_path):
    stores = _stores(tmp_path)
    payload = bytes(range(256)) * 7
    for store, _m in stores.values():
        assert store.put(KEY, payload)
    files = {n: (tmp_path / n / f"{KEY}.aot").read_bytes() for n in stores}
    assert files["port"] == files["jax"] == durable.frame("aot.store", 1, payload)
    assert aot.artifact_digest({"b": 1, "a": [1, 2]}) == j_aot.artifact_digest({"a": [1, 2], "b": 1})
    # each package's store opened on the other's directory: the entry is
    # counted at boot and read back
    crossed = {"port": aot.ArtifactStore(str(tmp_path / "jax")), "jax": j_aot.ArtifactStore(str(tmp_path / "port"))}
    for store in crossed.values():
        assert (store.entry_count, store.resident_bytes) == (1, len(files["port"]))
        assert store.get(KEY) == payload
    for name, (store, m) in stores.items():
        assert (store.entry_count, m.snapshot()["gauges"]["aot_store_entries"]) == (1, 1), name
        assert _counts(m)["stores"] == 1
    assert not aot.ArtifactStore(str(tmp_path / "port")).put("NOT-HEX", b"x")


def _sweep(mod, metrics_cls, root: Path) -> tuple:
    m = metrics_cls("deconv")
    frame_len = len(mod.durable.frame("aot.store", 1, b"x" * 100))
    store = mod.ArtifactStore(str(root), max_bytes=3 * frame_len, metrics=m)
    order = []
    for i in range(6):
        key = f"{i:02x}" * 8
        assert store.put(key, bytes([i]) * 100)
        os.utime(root / f"{key}.aot", (1000.0 + i, 1000.0 + i))  # a fixed mtime order
        if i == 3:
            os.utime(root / f"{'01' * 8}.aot", (2000.0, 2000.0))  # a later read of entry 1
        order.append(sorted(p.name for p in root.glob("*.aot")))
    assert not store.put("ff" * 8, b"y" * (4 * frame_len))  # larger than the whole budget
    return order, store.entry_count, store.resident_bytes, _counts(m)["sweeps"]


def test_the_byte_budget_sweeps_as_jax(tmp_path):
    port = _sweep(aot, Metrics, tmp_path / "port")
    assert port == _sweep(j_aot, JMetrics, tmp_path / "jax")
    assert port[1] == 3 and port[3] == 3
    assert f"{'01' * 8}.aot" in port[0][-1]  # the recently read entry survived


@pytest.mark.parametrize("defect", ["torn_header", "short_body", "digest", "future_version", "eio_read"])
def test_a_defective_entry_reads_as_a_miss_as_in_jax(tmp_path, defect):
    stores = _stores(tmp_path)
    outcome = {}
    for name, (store, m) in stores.items():
        mod, _mc, faults_mod = PACKAGES[name]
        store.put(KEY, b"p" * 64)
        path = tmp_path / name / f"{KEY}.aot"
        raw = path.read_bytes()
        registry = None
        if defect == "torn_header":
            path.write_bytes(raw[:20])
        elif defect == "short_body":
            path.write_bytes(raw[:-5])
        elif defect == "digest":
            path.write_bytes(raw[:-1] + b"q")
        elif defect == "future_version":
            path.write_bytes(mod.durable.frame("aot.store", 99, b"p" * 64))
        else:
            registry = faults_mod.FaultRegistry(metrics=m)
            registry.arm_string("fs.eio_read=p1@aot.store")
            faults_mod.install(registry)
        try:
            got = store.get(KEY)
        finally:
            if registry is not None:
                faults_mod.uninstall(registry)
        outcome[name] = (got, path.exists(), _counts(m)["corrupt"], store.entry_count)
    assert outcome["port"] == outcome["jax"]
    kept = defect in ("future_version", "eio_read")  # left in place, not counted corrupt
    assert outcome["port"] == (None, kept, 0 if kept else 1, 1 if kept else 0)


# ------------------------------------------------------------ the resolver

KERNELS = ("pool_argmax", "unpool_argmax", "fused_unpool_conv", "conv_q8")
MACHINE = {"nvcc": "Cuda compilation tools, release 12.4, V12.4.131", "capability": [9, 0],
           "torch": "2.5.1", "cuda": "12.4"}


class _Toolchain:
    """The resolver's build, load and machine identity, injected: ``build``
    writes each library's file (its name and source) as nvcc would, and
    skips one that exists unless forced, as ``ops/_build.build`` does;
    ``load`` refuses a file that is not such a library."""

    def __init__(self, root: Path, sources=None, machine=None):
        self.root = root
        self.sources = dict(sources or {k: f"// {k} v1".encode() for k in KERNELS})
        self.machine = dict(machine or MACHINE)
        self.builds: list[list[str]] = []

    def path(self, name: str) -> Path:
        return self.root / "build" / f"{name}.so"

    def build(self, names, force=False) -> dict:
        names = [n for n in names if force or not self.path(n).exists()]
        self.builds.append(names)
        for name in names:
            self.path(name).parent.mkdir(parents=True, exist_ok=True)
            self.path(name).write_bytes(b"ELF:" + self.sources[name])
        return {name: 0.5 for name in names}

    @staticmethod
    def load(path: Path):
        data = Path(path).read_bytes()
        if not data.startswith(b"ELF:"):
            raise OSError(f"{path}: invalid ELF header")
        return ("lib", data)

    def resolver(self, store_root: Path, **kw) -> tuple[KernelResolver, Metrics]:
        m = Metrics("deconv")
        store = ArtifactStore(str(store_root), metrics=m, **kw)
        return KernelResolver(store, metrics=m, build=self.build, library_path=self.path,
                              source=self.sources.__getitem__, load=self.load,
                              toolchain=lambda: dict(self.machine)), m


def test_a_miss_builds_and_stores_and_a_second_resolver_only_loads(tmp_path):
    first = _Toolchain(tmp_path / "host1")
    resolver, m = first.resolver(tmp_path / "store")
    libs = resolver.resolve(KERNELS)
    assert first.builds == [list(KERNELS)]  # one build of all four, together
    assert {k: v[1] for k, v in libs.items()} == {k: b"ELF:" + first.sources[k] for k in KERNELS}
    assert _counts(m) == {"hits": 0, "misses": 4, "stores": 4, "corrupt": 0, "errors": 0, "sweeps": 0}
    assert resolver.outcomes == dict.fromkeys(KERNELS, "miss") and resolver.build_seconds == dict.fromkeys(KERNELS, 0.5)
    assert resolver.library("conv_q8") is libs["conv_q8"] and _counts(m)["misses"] == 4  # resolved once
    # a fresh checkout (no build directory) on the same store
    second = _Toolchain(tmp_path / "host2")
    again, m2 = second.resolver(tmp_path / "store")
    libs2 = again.resolve(KERNELS)
    assert second.builds == [] and libs2 == libs
    assert _counts(m2) == {"hits": 4, "misses": 0, "stores": 0, "corrupt": 0, "errors": 0, "sweeps": 0}
    assert all(second.path(k).read_bytes() == first.path(k).read_bytes() for k in KERNELS)
    assert again.store.entry_count == 4 and not list((tmp_path / "host2" / "build").glob("*.tmp"))


def test_a_stored_library_that_does_not_load_is_invalidated_and_rebuilt(tmp_path):
    tools = _Toolchain(tmp_path / "host1")
    resolver, _ = tools.resolver(tmp_path / "store")
    resolver.resolve(KERNELS)
    key = resolver.key("unpool_argmax")
    # a digest-valid frame around bytes that are no library
    (tmp_path / "store" / f"{key}.aot").write_bytes(durable.frame("aot.store", 1, b"garbage"))
    fresh = _Toolchain(tmp_path / "host2")
    again, m = fresh.resolver(tmp_path / "store")
    libs = again.resolve(KERNELS)
    assert fresh.builds == [["unpool_argmax"]] and libs["unpool_argmax"][1].startswith(b"ELF:")
    assert _counts(m) == {"hits": 3, "misses": 1, "stores": 1, "corrupt": 1, "errors": 0, "sweeps": 0}
    assert again.outcomes["unpool_argmax"] == "miss"
    # a torn entry is deleted by the store itself: also one corrupt, one miss
    (tmp_path / "store" / f"{key}.aot").write_bytes(b'{"format": "aot.st')
    third = _Toolchain(tmp_path / "host3")
    once_more, m3 = third.resolver(tmp_path / "store")
    once_more.resolve(KERNELS)
    assert third.builds == [["unpool_argmax"]]
    assert (_counts(m3)["corrupt"], _counts(m3)["misses"], _counts(m3)["hits"]) == (1, 1, 3)


def test_a_library_already_in_the_build_directory_is_rebuilt_before_it_is_stored(tmp_path):
    # an earlier build in this checkout, maybe by another toolchain: the
    # store's key names this machine's build, so the old file is not it
    tools = _Toolchain(tmp_path / "host")
    tools.path("pool_argmax").parent.mkdir(parents=True)
    tools.path("pool_argmax").write_bytes(b"ELF:an older toolchain's build")
    resolver, m = tools.resolver(tmp_path / "store")
    libs = resolver.resolve(KERNELS)
    assert tools.builds == [list(KERNELS)] and resolver.build_seconds == dict.fromkeys(KERNELS, 0.5)
    assert libs["pool_argmax"][1] == b"ELF:" + tools.sources["pool_argmax"]
    stored = durable.unframe((tmp_path / "store" / f"{resolver.key('pool_argmax')}.aot").read_bytes(),
                             "aot.store", 1)[1]
    assert stored == b"ELF:" + tools.sources["pool_argmax"] and _counts(m)["stores"] == 4


def test_a_failed_build_raises_and_stores_nothing(tmp_path):
    tools = _Toolchain(tmp_path / "host")

    def broken(names, force=False):
        raise RuntimeError("nvcc failed for conv_q8")

    tools.build = broken
    resolver, m = tools.resolver(tmp_path / "store")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        resolver.resolve(["conv_q8"])
    assert resolver.store.entry_count == 0 and _counts(m)["misses"] == 1 and "conv_q8" not in resolver.loaded


@pytest.mark.parametrize("change", ["source", "flags", "nvcc", "capability", "torch", "cuda", "none"])
def test_the_key_follows_what_decides_the_bytes(tmp_path, monkeypatch, change):
    base = _Toolchain(tmp_path)
    key = base.resolver(tmp_path / "store")[0].key("pool_argmax")
    other = _Toolchain(tmp_path)
    if change == "source":
        other.sources["pool_argmax"] += b" "
    elif change == "flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    elif change == "capability":
        other.machine["capability"] = [8, 0]
    elif change != "none":
        other.machine[change] += "+1"
    moved = other.resolver(tmp_path / "store")[0].key("pool_argmax")
    assert (moved == key) == (change == "none")
    assert base.resolver(tmp_path / "store")[0].key("unpool_argmax") != key


def test_build_load_takes_its_library_from_the_resolver(tmp_path, monkeypatch):
    class Lib:
        entry = type("Fn", (), {})()

    tools = _Toolchain(tmp_path)
    tools.load = lambda path: Lib()
    resolver, m = tools.resolver(tmp_path / "store")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "resolver", resolver)
    monkeypatch.setattr(_build, "build", lambda names=(): pytest.fail("nvcc ran beside the resolver"))
    lib = _build.load("pool_argmax", {"entry": []})
    assert lib is resolver.loaded["pool_argmax"] and lib.entry.argtypes == [] and _counts(m)["misses"] == 1
    assert _build.load("pool_argmax", {}) is lib and tools.builds == [["pool_argmax"]]


# -------------------------------------------------------------- the server


def test_a_cpu_server_with_an_aot_dir_reports_its_store(tmp_path):
    args = cli._parser().parse_args(["serve", "--model", "vgg_tiny", "--device", "cpu", "--aot-dir",
                                     str(tmp_path / "aot"), "--aot-bytes", "1000000"])
    cfg = cli.server_config(args)
    assert (cfg.aot_dir, cfg.aot_bytes) == (str(tmp_path / "aot"), 1000000)
    cfg.warmup_all_buckets = cfg.warmup_dream = False
    service = DeconvService(cfg=cfg, device="cpu")
    plain = DeconvService(cfg=ServerConfig(model="vgg_tiny", warmup_all_buckets=False, warmup_dream=False),
                          device="cpu")
    try:
        assert _build.resolver is service.aot
        service.start()
        service.warmup()  # the CPU resolves no kernel library
        assert service.aot.loaded == {}
        config = service.config()
        assert (config["aot_dir"], config["aot_bytes"], config["aot_active"]) == (True, 1000000, True)
        assert config["aot"] == {"entries": 0, "resident_bytes": 0, "hits": 0, "misses": 0, "stores": 0,
                                 "corrupt": 0}
        body, status = service.readyz()
        assert status == 200 and body["aot"] == {"entries": 0, "hits": 0, "misses": 0}
        assert body["durability"]["surfaces"]["aot.store"]["degraded"] is False
        text = service.metrics_text()
        assert "deconv_aot_store_entries 0" in text and "deconv_aot_store_resident_bytes 0" in text
        default = plain.config()
        assert (default["aot_dir"], default["aot_active"]) == (False, False) and "aot" not in default
        assert "aot" not in plain.readyz()[0]
    finally:
        service.close()
        plain.close()
    assert _build.resolver is None
