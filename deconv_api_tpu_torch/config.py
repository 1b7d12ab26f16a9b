"""The server's configuration (counterpart of ``deconv_api_tpu/config.py``),
holding only the fields the port honours, with the JAX package's names and
defaults.  ``DeconvService`` validates it at boot with the JAX package's
messages."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ServerConfig:
    model: str = "vgg16"
    # batching dispatcher (fixes the reference's 1-concurrency)
    max_batch: int = 8
    batch_window_ms: float = 3.0
    # Low-channel backward-tail packing of the sequential engine: 'off'
    # (default) | 'auto' (pack the C<=64 tail when top_k > 1) | 'forced'
    # (whole certified C<=128 tail) | an explicit channel threshold.  DAG
    # models and dreams leave it inert.  Output bytes are identical on/off.
    lowc_kpack: str = "off"  # 'off' | 'auto' | 'forced' | '<channels>'
    # --- multi-model serving (serving/weight_manager.py) ---
    # The set of registry models THIS process serves per-request
    # (``model=`` form field / ``x-model`` header): '' = only `model`
    # (the classic single-model server: the manager stays inert and the
    # hot path is unchanged), 'all' = the whole registry, or a comma list.
    # `model` is always included and stays the default when a request
    # names nothing.
    serve_models: str = ""
    # Models paged onto the card and warmed (captured) at BOOT, never
    # evicted: '' = just `model`.  Everything else served is ON-DEMAND:
    # its first request pays the page-in (and first-use captures) inside
    # its own latency, visible as a weight_page_in stage.
    pinned_models: str = ""
    # Device-memory byte budget for resident model weights (the stored
    # form's bytes).  0 = unlimited (nothing is ever paged out).  When the
    # working set exceeds it, the least-recently-used unpinned model with
    # no in-flight batches is paged out; if every resident model is pinned
    # or in flight the budget overshoots LOUDLY
    # (weight_budget_overcommit_total) instead of failing requests.
    hbm_budget_bytes: int = 0
    # Stored weight precision of the device copies: 'f32' (exact, the
    # default), 'bf16' (half the bytes; cast-on-use), 'int8' (per-tensor
    # symmetric kernels, about a quarter of the kernel bytes, f32
    # dequant-on-use).  Quantized tiers trade bounded fidelity (PSNR
    # floors) for more resident models per budget.
    weight_dtype: str = "f32"
