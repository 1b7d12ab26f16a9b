"""A DAG program or a dream on the card held against the same on the CPU.

The DAG path and DeepDream run no hand-written kernel, so their card-side
check is the engine itself run twice: once on ``cuda`` and once with
``device="cpu"``, with the same params.  ``chip_smoke.py`` runs it at full
width and ``tests/test_torch_cuda.py`` at a small input; the CPU tests
against the JAX package use ``ranking_separated`` as their precondition.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from deconv_api_tpu_torch.engine.autodeconv import autodeconv_visualizer, backproject
from deconv_api_tpu_torch.engine.deepdream import _pyramid_step, deepdream_batch, make_octave_runner, octave_shapes
from deconv_api_tpu_torch.models.blocks import DECONV_RULES
from deconv_api_tpu_torch.models.weights import tree_map
from deconv_api_tpu_torch.serving import codec
from deconv_api_tpu_torch.serving.app import DREAM_DEFAULTS

GAP_REL = 1e-4  # top-K+1 sums closer than this share of the largest may reorder
MIN_PSNR_DB = 65.0  # stitched 2x2 grids
MAX_REL_ERR = 1e-4  # projections, of the reference's largest magnitude
# dreams: the image, of the reference's largest magnitude; the uint8 images
# (BASELINE's parity bar) and a step's update, signal over error power; the loss
DREAM_MAX_REL_ERR = 1e-3
DREAM_MIN_PSNR_DB = 40.0
DREAM_LOSS_REL_ERR = 1e-3


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
    card (its captured program; TF32 off, as ``resolve_device`` leaves it)
    and on the CPU.  Every image is held to
    the CPU's: the CPU's channels projected on the card within MAX_REL_ERR
    and at >= MIN_PSNR_DB as grids.  The card's own selection equals the
    CPU's on every image whose CPU ranking is separated, and its grid is at
    >= MIN_PSNR_DB where it does.  Raises AssertionError otherwise."""
    cpu_params = tree_map(lambda t: t.cpu(), bundle.params)
    cpu = autodeconv_visualizer(bundle.forward_fn, layer, top_k, device="cpu")(cpu_params, x)[layer]
    prog = bundle.program(layer, "all", top_k, len(x))  # the card's captured program
    with bundle.programs.replaying():
        card = {k: v.to("cpu", copy=True) for k, v in prog(x)[layer].items()}
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


def dream_card_vs_cpu(bundle, x: torch.Tensor, *, octaves: int = DREAM_DEFAULTS["octaves"]) -> dict:
    """A dream of ``x`` (B, H, W, 3, preprocessed) through ``bundle`` (its
    dream layers, the route's steps and lr) on the card and on the CPU with
    the same params.  Raises AssertionError when a bar is missed.

    The float32 dream's gradient is discontinuous in its input: where a
    pre-activation lies within rounding of a ReLU kink, or two pooled values
    within rounding of each other, two correct float32 runs route the
    gradient differently, and that step moves a few pixels by up to some
    percent of its largest move.  Later steps part the two dreams further,
    as far as two CPU dreams whose inputs differ by one ulp.  So:

    - ``float32_stepwise`` walks the card's float32 dream one step at a
      time through the captured programs ``deepdream_batch`` replays (each
      rung's pyramid step, then one replay of its ascent step at a time),
      and runs every step on the CPU from the card's input, in float32 and
      in float64.  Held at every step: the
      uint8 image at >= DREAM_MIN_PSNR_DB and the loss within
      DREAM_LOSS_REL_ERR.  Held at each image's median step: the step's
      update (lr times the normalised gradient) at >= DREAM_MIN_PSNR_DB of
      signal over error power; a fault in the backward moves every step, a
      kink a few.
      Reported: the image's largest error against the CPU's float32 step
      and, for both sides, against the float64 step, with the steps past
      DREAM_MAX_REL_ERR: kinks put either side there.
    - ``float64`` runs the whole dream in float64 on both sides, rounding
      far from every kink: image within DREAM_MAX_REL_ERR of the CPU's
      largest magnitude, uint8 at >= DREAM_MIN_PSNR_DB, loss within
      DREAM_LOSS_REL_ERR.
    - ``float32_free`` reports, without a bar, the whole float32 dream on
      the card against the CPU's, and the CPU's from the input one ulp up
      against it."""
    layers = tuple(bundle.dream_layers)
    kw = dict(layers=layers, steps_per_octave=DREAM_DEFAULTS["steps"], num_octaves=octaves,
              lr=DREAM_DEFAULTS["lr"], min_size=bundle.min_dream_size)
    fwd = bundle.dream_forward(layers)
    params = {dev: tree_map(lambda t: t.to(dev), bundle.params) for dev in ("cpu", "cuda")}
    out = {"layers": list(layers), "images": len(x), "steps": kw["steps_per_octave"], "octaves": octaves,
           "lr": kw["lr"]}
    out["float32_stepwise"] = r = _stepwise(bundle, fwd, params, x, octaves)
    if not (r["finite"] and _psnr_ok(r["min_psnr_db"]) and r["loss_rel_err"] <= DREAM_LOSS_REL_ERR
            and _psnr_ok(r["median_update_snr_db"])):
        raise AssertionError(f"{bundle.name} float32 dream steps, card vs CPU: {out}")

    f64 = {dev: tree_map(lambda t: t.double(), p) for dev, p in params.items()}
    out["float64"] = r = _compare(
        bundle, *(_timed_dream(fwd, f64[dev], x, dev, torch.float64, kw) for dev in ("cuda", "cpu")))
    if not (r["finite"] and r["rel_err"] <= DREAM_MAX_REL_ERR and _psnr_ok(r["min_psnr_db"])
            and r["loss_rel_err"] <= DREAM_LOSS_REL_ERR):
        raise AssertionError(f"{bundle.name} float64 dream, card vs CPU: {out}")

    cpu = _timed_dream(fwd, params["cpu"], x, "cpu", torch.float32, kw)
    nudged = _timed_dream(fwd, params["cpu"], torch.nextafter(x, torch.tensor(float("inf"))), "cpu", torch.float32, kw)
    out["float32_free"] = {
        "card_vs_cpu": _compare(bundle, _timed_dream(fwd, params["cuda"], x, "cuda", torch.float32, kw), cpu),
        "cpu_one_ulp_vs_cpu": _compare(bundle, nudged, cpu),
    }
    return out


def _stepwise(bundle, fwd, params, x: torch.Tensor, octaves: int) -> dict:
    """The card's float32 dream of ``x`` one step at a time through its
    captured programs (``ModelBundle.dream_program``), each step run on the
    CPU too from the card's input, in float32 and in float64 (see
    ``dream_card_vs_cpu``)."""
    lr = DREAM_DEFAULTS["lr"]
    step_cpu = make_octave_runner(fwd, bundle.dream_layers, 1, lr)
    p64 = tree_map(lambda t: t.double(), params["cpu"])
    shapes = octave_shapes(*x.shape[1:3], octaves, 1.4, bundle.min_dream_size)
    rungs = bundle.dream_program(bundle.dream_layers, shapes, len(x))
    base = x.to("cuda")
    rel = {"card_vs_cpu": [], "cpu_vs_float64": [], "card_vs_float64": []}
    psnr, loss_rel, snr = [], [], []

    def record(got, want32, want64):
        rel["card_vs_cpu"].append(_rel(got, want32))
        rel["cpu_vs_float64"].append(_rel(want32, want64))
        rel["card_vs_float64"].append(_rel(got, want64))
        psnr.extend(psnr_db(bundle.unpreprocess(a.numpy()), bundle.unpreprocess(b.numpy())) for a, b in zip(got, want32))

    t0 = time.perf_counter()
    card = None
    with bundle.dream_programs.replaying():
        for i, (hw, (pyramid, step)) in enumerate(zip(shapes, rungs)):
            prev = shapes[i - 1] if i else None
            x_in = None if card is None else card.cpu()
            start = pyramid(base) if card is None else pyramid(card, base)
            record(start.cpu(), *(_pyramid_step(None if x_in is None else x_in.to(dt), x.to(dt), hw, prev)
                                  for dt in (torch.float32, torch.float64)))
            step.load(start)
            step.static[1].fill_(lr)
            card = step.static[0]
            for _ in range(DREAM_DEFAULTS["steps"]):
                x_in = card.cpu()
                card_l = step.replay().cpu()
                (want32, cpu_l), (want64, _) = step_cpu(params["cpu"], x_in), step_cpu(p64, x_in.double())
                got = card.cpu()
                record(got, want32, want64)
                loss_rel.append(float(((card_l - cpu_l).abs() / cpu_l.abs()).max()))
                moved, want = (got.double() - x_in.double()).flatten(1), (want32.double() - x_in.double()).flatten(1)
                snr.append(10 * torch.log10(want.square().sum(1) / (moved - want).square().sum(1)))
        finite = bool(torch.isfinite(card).all())
    over = {k: sum(v > DREAM_MAX_REL_ERR for v in vals) for k, vals in rel.items()}
    snr = torch.stack(snr)  # (steps, B)
    return {"compared": len(psnr) // len(x), "rel_err": {k: max(v) for k, v in rel.items()},
            "steps_over_rel_bar": over, "min_psnr_db": _db(min(psnr)), "loss_rel_err": max(loss_rel),
            "min_update_snr_db": _db(float(snr.min())),
            "median_update_snr_db": _db(float(snr.median(0).values.min())),
            "finite": finite, "seconds": time.perf_counter() - t0}


def _timed_dream(fwd, params, x, dev, dtype, kw):
    t0 = time.perf_counter()
    img, loss = deepdream_batch(fwd, params, x, device=dev, dtype=dtype, **kw)
    return img.cpu(), loss.cpu(), time.perf_counter() - t0


def _compare(bundle, got, want) -> dict:
    """Two whole dreams, (image, loss, seconds) each, the second the
    reference."""
    (gx, gl, gs), (wx, wl, ws) = got, want
    psnr = [psnr_db(bundle.unpreprocess(a.float().numpy()), bundle.unpreprocess(b.float().numpy()))
            for a, b in zip(gx, wx)]
    return {"rel_err": _rel(gx, wx), "min_psnr_db": _db(min(psnr)),
            "loss_rel_err": float(((gl - wl).abs() / wl.abs()).max()), "loss": [float(v) for v in wl],
            "seconds": [gs, ws], "finite": bool(torch.isfinite(gx).all() and torch.isfinite(gl).all())}


def _db(p: float) -> float | str:
    return p if np.isfinite(p) else "identical"


def _psnr_ok(p: float | str) -> bool:
    return p == "identical" or p >= DREAM_MIN_PSNR_DB


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over b's largest magnitude."""
    scale = float(b.abs().max())
    return float((a.double() - b.double()).abs().max()) / scale if scale else float("inf")
