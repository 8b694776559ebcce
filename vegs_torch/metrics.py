"""Offline evaluation over saved renders (port of vegs_tpu/metrics.py).

Walks `{model_path}/test/{method}/renders` against `gt`, computes SSIM and
PSNR (and LPIPS when the VGG and LPIPS weights are on disk, see
`losses.lpips`), and writes results.json and per_view.json beside them in
the reference's format. Images are read with PIL on the host and scored on
`device` (default: the card).

    python -m vegs_torch.metrics -m MODEL_PATH [MODEL_PATH ...]
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from . import resolve_device
from .losses import lpips as lpips_mod
from .losses import psnr as psnr_fn, ssim as ssim_fn


def _read_image(path) -> np.ndarray:
    """[3, H, W] float32 in [0, 1] (alpha dropped)."""
    from PIL import Image

    img = np.asarray(Image.open(path), np.float32) / 255.0
    return img[..., :3].transpose(2, 0, 1)


def evaluate_dirs(renders_dir, gt_dir, use_lpips: bool | None = None,
                  device=None) -> dict:
    """Per-view and mean SSIM, PSNR (and LPIPS) of two directories of
    images with the same names."""
    dev = resolve_device(device)
    render_files = sorted(os.listdir(renders_dir))
    use_lpips = lpips_mod.lpips_available() if use_lpips is None else use_lpips
    lp_model = lp_lins = None
    if use_lpips:
        lp_model, lp_lins = lpips_mod.load_default(device=dev)

    per_view = {"SSIM": {}, "PSNR": {}, "LPIPS": {}}
    with torch.inference_mode():
        for fname in render_files:
            r = torch.from_numpy(_read_image(Path(renders_dir) / fname)).to(dev)
            g = torch.from_numpy(_read_image(Path(gt_dir) / fname)).to(dev)
            per_view["SSIM"][fname] = float(ssim_fn(r, g))
            per_view["PSNR"][fname] = float(psnr_fn(r, g))
            if use_lpips:
                per_view["LPIPS"][fname] = float(
                    lpips_mod.lpips(lp_model, lp_lins, r, g))

    means = {
        k: float(np.mean(list(v.values()))) for k, v in per_view.items() if v
    }
    return {"means": means, "per_view": per_view}


def evaluate(model_paths: list[str], device=None) -> dict:
    """Walk `{model}/test/{method}/` of each model and write results.json
    and per_view.json into the model's directory."""
    full_results = {}
    for model_path in model_paths:
        test_dir = Path(model_path) / "test"
        full = {}
        per_view_out = {}
        for method in sorted(os.listdir(test_dir)) if test_dir.exists() else []:
            mdir = test_dir / method
            res = evaluate_dirs(mdir / "renders", mdir / "gt", device=device)
            full[method] = res["means"]
            per_view_out[method] = res["per_view"]
        with open(Path(model_path) / "results.json", "w") as f:
            json.dump(full, f, indent=True)
        with open(Path(model_path) / "per_view.json", "w") as f:
            json.dump(per_view_out, f, indent=True)
        full_results[model_path] = full
    return full_results


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--model_paths", "-m", nargs="+", required=True)
    args = ap.parse_args(argv)
    print(json.dumps(evaluate(args.model_paths), indent=2))


if __name__ == "__main__":
    main()
