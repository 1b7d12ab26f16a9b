"""A DAG program on the card held against the same program on the CPU.

The DAG path runs no hand-written kernel, so its card-side check is the
engine itself run twice: once on ``cuda`` and once with ``device="cpu"``,
with the same params.  ``chip_smoke.py`` runs it at full width and
``tests/test_torch_cuda.py`` at a small input; the CPU tests against the JAX
package use ``ranking_separated`` as their precondition.
"""

from __future__ import annotations

import numpy as np
import torch

from deconv_api_tpu_torch.engine.autodeconv import autodeconv_visualizer, backproject
from deconv_api_tpu_torch.models.blocks import DECONV_RULES
from deconv_api_tpu_torch.models.weights import tree_map
from deconv_api_tpu_torch.serving import codec

GAP_REL = 1e-4  # top-K+1 sums closer than this share of the largest may reorder
MIN_PSNR_DB = 65.0  # stitched 2x2 grids
MAX_REL_ERR = 1e-4  # projections, of the reference's largest magnitude


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of two uint8 images; ``inf`` where they are equal."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def ranking_separated(act: torch.Tensor, k: int) -> list[bool]:
    """Per image: whether the K+1 largest positive channel sums of ``act``
    (B, *S, C), the reference run's, differ pairwise by more than GAP_REL of
    the largest, or tie exactly (channels saturated at ReLU6's cap; both
    runs put the lower channel first), so that no fp32 rounding can reorder
    the top K."""
    sums = act.double().flatten(1, -2).sum(1)
    out = []
    for row in sums:
        top = torch.sort(row[row > 0], descending=True).values[: k + 1]
        gaps = top[:-1] - top[1:]
        out.append(not bool(((gaps > 0) & (gaps <= GAP_REL * row.max())).any()))
    return out


def card_vs_cpu(bundle, layer: str, x: torch.Tensor, top_k: int = 4) -> dict:
    """``x`` (B, H, W, 3) through ``bundle``'s DAG program at ``layer`` on the
    card (TF32 off, as ``resolve_device`` leaves it) and on the CPU.  Every image is held to
    the CPU's: the CPU's channels projected on the card within MAX_REL_ERR
    and at >= MIN_PSNR_DB as grids.  The card's own selection equals the
    CPU's on every image whose CPU ranking is separated, and its grid is at
    >= MIN_PSNR_DB where it does.  Raises AssertionError otherwise."""
    cpu_params = tree_map(lambda t: t.cpu(), bundle.params)
    cpu = autodeconv_visualizer(bundle.forward_fn, layer, top_k, device="cpu")(cpu_params, x)[layer]
    card = autodeconv_visualizer(bundle.forward_fn, layer, top_k, device="cuda")(bundle.params, x)[layer]
    card = {k: v.cpu() for k, v in card.items()}
    xc = x.detach().to("cuda").requires_grad_(True)
    with torch.enable_grad():
        act = bundle.forward_fn(bundle.params, xc, rules=DECONV_RULES)[1][layer]
        forced = backproject(act, xc, cpu["indices"].to(act.device), "all", retain_graph=False).cpu()
    with torch.no_grad():
        sep = ranking_separated(bundle.forward_fn(cpu_params, x, rules=DECONV_RULES)[1][layer], top_k)
    want = codec.stitch_grid(cpu["images"], cpu["valid"]).numpy()
    forced_psnr = [psnr_db(a, b) for a, b in zip(codec.stitch_grid(forced, cpu["valid"]).numpy(), want)]
    own_psnr = [psnr_db(a, b) for a, b in zip(codec.stitch_grid(card["images"], card["valid"]).numpy(), want)]
    same = [bool(torch.equal(card["indices"][b], cpu["indices"][b]) and torch.equal(card["valid"][b], cpu["valid"][b]))
            for b in range(len(sep))]
    scale = float(cpu["images"].abs().max())
    out = {"layer": layer, "images": len(sep), "separated": sep, "indices_equal": same,
           "grid_psnr_db": [p if np.isfinite(p) else "identical" for p in forced_psnr],
           "own_grid_psnr_db": [p if np.isfinite(p) else "identical" for p in own_psnr],
           "max_abs_err": float((forced - cpu["images"]).abs().max()),
           "rel_err": float((forced - cpu["images"]).abs().max()) / scale if scale else float("inf"),
           "finite": bool(torch.isfinite(card["images"]).all() and torch.isfinite(forced).all())}
    bad = [b for b in range(len(sep))
           if forced_psnr[b] < MIN_PSNR_DB or (sep[b] and not same[b]) or (same[b] and own_psnr[b] < MIN_PSNR_DB)]
    if not out["finite"] or not out["rel_err"] <= MAX_REL_ERR or bad:
        raise AssertionError(f"{bundle.name} card vs CPU at {layer}, images {bad}: {out}")
    return out
