"""The quality debug trails: port of perf/r12_quality_debug.py and
perf/r12b_grads.py.

Both run arm A of the quality harness (`quality.arm_trainer("A", ...)`:
the static recipe with its plain init, the mover stripped, k_cap 2^17) on
`quality.build_scene_info`'s oracle with 17 cameras from numpy seed 7, at
two resolutions, to tell a stalled training from a broken evaluation:

- `probe(h, w, iters)` (r12): the ground truth's mean and max, render
  statistics of the first held-out view at init (mean, max, alpha
  coverage, dropped, the padded and raw needs against k_pad and k_cap, the
  view's PSNR), then `iters` Trainer steps with the training loss and l1,
  the held-out PSNR and SSIM, the active Gaussians and the capacities at
  iterations 1-3 and every EVERY, and the render statistics again every
  2 x EVERY;
- `grads(h, w)` (r12b): on the first training view at init, the loss
  0.8 l1 + 0.2 (1 - SSIM) and, for means, sh_dc, the opacity logit and the
  log-scales, the rms, the max |g| and the share of nonzero entries of its
  gradient, and the rendered and ground-truth means of the image's four
  quadrants.

Each returns its readings (and prints them as JSON lines); on the card a
probe's Trainer steps launch K1-K3 (and K4 while the sat-cull gate is on),
counted in its "launches".

Run on the card:  python -m vegs_torch.perf.quality_debug
(r12's probe(64, 128, 200) and probe(128, 256, 300), then r12b's grads at
both sizes)
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from . import quality

SCENE_SEED, N_CAMS = 7, 17
EVERY = 50
PROBES = ((64, 128, 200), (128, 256, 300))  # r12:76-77
SIZES = ((64, 128), (128, 256))             # r12b:67-68


@functools.lru_cache(maxsize=None)
def scene_info(h: int, w: int):
    """r12:32-33 / r12b:33-34: the oracle scene at h x w (ray-traced once
    a size: the probes only read it), the mover stripped."""
    info, _, _ = quality.build_scene_info(
        np.random.default_rng(SCENE_SEED), h=h, w=w, n_cams=N_CAMS)
    return quality.strip_boxes(info)


def debug_trainer(h: int, w: int, device=None):
    """r12:34-36 / r12b:35-37: arm A's Trainer on `scene_info(h, w)`.
    Returns (Trainer, the scene info)."""
    info_s = scene_info(h, w)
    return quality.arm_trainer("A", info_s, device=device), info_s


def render_stats(tr) -> dict:
    """r12:41-56: the first held-out view rendered from the field."""
    from ..render import render

    cam = tr.scene.getTestCameras()[0]
    cfg = tr.raster_cfg
    with torch.no_grad():
        out = render(cam.device_params(tr.device), tr.state.field, bg=tr.bg,
                     config=cfg._replace(forward_only=True))
    rgb = out.rgb.float().cpu().numpy()
    alpha = out.alpha.float().cpu().numpy()
    gt = np.asarray(cam.original_image, np.float32)
    mse = float(((rgb - gt) ** 2).mean())
    return {"mean": float(rgb.mean()), "max": float(rgb.max()),
            "alpha_cov": float((alpha > 0.5).mean()),
            "dropped": int(out.num_dropped), "needed": int(out.num_needed),
            "k_pad": cfg.k_pad or cfg.k_cap,
            "needed_raw": int(out.num_needed_raw), "k_cap": cfg.k_cap,
            "psnr1": -10 * float(np.log10(mse + 1e-12))}


def _emit(log, **kw):
    log(json.dumps(kw))


def probe(h: int, w: int, iters: int = 300, device=None,
          log=print) -> dict:
    """r12's probe at h x w (see the module note)."""
    dev = resolve_device(device)
    tr, info = debug_trainer(h, w, dev)
    gt0 = np.asarray(info.test_cameras[0].image)
    res = {"size": f"{h}x{w}", "gt_mean": float(gt0.mean()),
           "gt_max": float(gt0.max()), "stats": {"init": render_stats(tr)},
           "trend": []}
    _emit(log, probe="r12", size=res["size"], gt_mean=res["gt_mean"],
          gt_max=res["gt_max"], init=res["stats"]["init"])
    launch0 = quality._launches()
    t0 = time.perf_counter()
    for it in range(1, iters + 1):
        m = tr.train_iteration(it)
        if it <= 3 or it % EVERY == 0:
            e = tr.evaluate(with_boxes=True, with_ssim=True)
            row = {"it": it, "loss": float(m["loss"]), "l1": float(m["l1"]),
                   "ndrop": int(m.get("num_dropped", 0)), "psnr": e["psnr"],
                   "ssim": e["ssim"],
                   "n": int(tr.state.field.num_active()),
                   "k_cap": tr.raster_cfg.k_cap, "k_pad": tr.raster_cfg.k_pad,
                   "s": time.perf_counter() - t0}
            if not np.isfinite(row["loss"]):
                raise FloatingPointError(f"r12 {h}x{w} it {it}: {row}")
            res["trend"].append(row)
            _emit(log, probe="r12", size=res["size"], **row)
            if it % (2 * EVERY) == 0:
                res["stats"][f"it{it}"] = render_stats(tr)
                _emit(log, probe="r12", size=res["size"],
                      stats=f"it{it}", **res["stats"][f"it{it}"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    now = quality._launches()
    res["launches"] = {k: now[k] - launch0[k] for k in now}
    res["seconds"] = time.perf_counter() - t0
    return res


def grads(h: int, w: int, device=None, log=print) -> dict:
    """r12b's probe at h x w (see the module note); the gradients
    themselves are under "arrays" (numpy; not printed)."""
    from ..losses.photometric import l1_loss, ssim
    from ..render import render

    dev = resolve_device(device)
    tr, _ = debug_trainer(h, w, dev)
    cam = tr.scene.getTrainCameras()[0]
    gt = torch.from_numpy(np.asarray(cam.original_image, np.float32)).to(dev)
    field = tr.state.field
    leaves = {"means": field.means, "sh_dc": field.sh_dc,
              "logit_op": field.opacity_logit, "log_scales": field.log_scales}
    out = render(cam.device_params(dev), field, bg=tr.bg, config=tr.raster_cfg)
    loss = 0.8 * l1_loss(out.rgb, gt) + 0.2 * (1.0 - ssim(out.rgb, gt))
    gs = torch.autograd.grad(loss, list(leaves.values()))
    res = {"size": f"{h}x{w}", "loss": float(loss.detach()), "grads": {},
           "quads": {}}
    res["arrays"] = {n: g.detach().cpu().numpy() for n, g in zip(leaves, gs)}
    for name, g in zip(leaves, gs):
        g = g.detach().double()
        res["grads"][name] = {
            "rms": float(g.square().mean().sqrt()), "max": float(g.abs().max()),
            "nonzero": float((g.abs() > 0).double().mean())}
    rgb = out.rgb.detach().float().cpu().numpy()
    gtn = gt.cpu().numpy()
    hh, ww = rgb.shape[1] // 2, rgb.shape[2] // 2
    for qy in (0, 1):
        for qx in (0, 1):
            sl = np.s_[:, qy * hh:(qy + 1) * hh, qx * ww:(qx + 1) * ww]
            res["quads"][f"{qy},{qx}"] = {"render": float(rgb[sl].mean()),
                                          "gt": float(gtn[sl].mean())}
    _emit(log, probe="r12b", **{k: v for k, v in res.items() if k != "arrays"})
    return res


def main(argv=None) -> int:
    for h, w, iters in PROBES:
        probe(h, w, iters)
    for h, w in SIZES:
        grads(h, w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
