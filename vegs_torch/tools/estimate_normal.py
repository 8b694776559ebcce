"""Monocular surface-normal estimation over KITTI-360 sequences (port of
vegs_tpu/tools/estimate_normal.py).

Per image: square crops slid along the frame (or one full-resize pass)
through the DPT normal model, blended with Hann weights, renormalized and
flipped in x and y into the repo's convention (x-left, y-up, z-backward);
saved as `{frame}_norm.npy` ([3, H, W]) with a visualization PNG under
`data_2d_normal_omnidata_{mode}/{seq}/image_0{cam}/`, where the KITTI-360
reader looks for them. The crops of one frame go through the model as one
batch, under `torch.inference_mode()`.

    python -m vegs_torch.tools.estimate_normal --kitti_root ROOT \
        --seqs 2013_05_28_drive_0009_sync --checkpoint omnidata_dpt_normal_v2.ckpt

runs on the card; `NormalEstimator(..., device="cpu")` on the CPU.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..priors.dpt import (DPTConfig, dpt_from_state, init_dpt,
                          load_omnidata_checkpoint)


class NormalEstimator:
    """The DPT normal model on `device` (default: the card): from a port
    state dict, an omnidata checkpoint, or a random init from seed 0."""

    def __init__(self, cfg: DPTConfig = DPTConfig(), state_dict=None,
                 checkpoint: str | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if state_dict is None and checkpoint:
            state_dict, unmapped = load_omnidata_checkpoint(checkpoint, cfg)
            if unmapped:
                print(f"[estimate_normal] {len(unmapped)} checkpoint tensors "
                      f"not used: {unmapped[:4]}")
        if state_dict is not None:
            self.model = dpt_from_state(state_dict, cfg, self.device)
        else:
            g = torch.Generator(device=self.device).manual_seed(0)
            self.model = init_dpt(g, cfg).eval()

    def infer_batch(self, crops: list) -> list:
        """[h, w, 3] images in [0, 1] -> [h, w, 3] normals each, resized
        through the model's square input size with OpenCV; one batch."""
        import cv2

        s = self.cfg.image_size
        x = np.stack([cv2.resize(c, (s, s), interpolation=cv2.INTER_AREA)
                      for c in crops])
        x = torch.from_numpy((x - 0.5) / 0.5).permute(0, 3, 1, 2)
        with torch.inference_mode():
            n = self.model(x.to(self.device, torch.float32))
        n = n.permute(0, 2, 3, 1).cpu().numpy()
        return [cv2.resize(ni, (c.shape[1], c.shape[0]),
                           interpolation=cv2.INTER_LINEAR)
                for ni, c in zip(n, crops)]

    def infer_square(self, img_rgb01: np.ndarray) -> np.ndarray:
        """[H, W, 3] -> [H, W, 3] normals of one crop."""
        return self.infer_batch([img_rgb01])[0]

    def infer_sliding(self, img_rgb01: np.ndarray, overlap: float = 0.5
                      ) -> np.ndarray:
        """A wide image -> square crops of its height slid across it (the
        last flush with the right edge), blended by Hann weights."""
        h, w, _ = img_rgb01.shape
        side = h
        step = max(int(side * (1 - overlap)), 1)
        acc = np.zeros((h, w, 3), np.float64)
        wsum = np.zeros((h, w, 1), np.float64)
        win = np.hanning(side)[None, :, None] + 1e-3
        xs = list(range(0, max(w - side, 0) + 1, step))
        if xs and xs[-1] != w - side:
            xs.append(w - side)
        xs = xs or [0]
        normals = self.infer_batch([img_rgb01[:, x0:x0 + side] for x0 in xs])
        for x0, n in zip(xs, normals):
            acc[:, x0:x0 + side] += n * win[:, :n.shape[1]]
            wsum[:, x0:x0 + side] += win[:, :n.shape[1]]
        n = acc / np.maximum(wsum, 1e-8)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        return (n / np.maximum(norm, 1e-8)).astype(np.float32)

    @staticmethod
    def to_repo_convention(n: np.ndarray) -> np.ndarray:
        """Flip x and y into x-left, y-up, z-backward."""
        out = n.copy()
        out[..., 0] *= -1
        out[..., 1] *= -1
        return out


def estimate_sequence(kitti_root, seq, estimator: NormalEstimator,
                      cam_ids=(0, 1), mode: str = "all",
                      sliding: bool = True, limit: int | None = None) -> int:
    """Walk a sequence writing `{frame}_norm.npy` and viz PNGs; returns the
    number of images."""
    from PIL import Image

    count = 0
    for cam_id in cam_ids:
        img_dir = (Path(kitti_root) / "data_2d_raw" / seq /
                   f"image_{cam_id:02d}" / "data_rect")
        out_dir = (Path(kitti_root) / f"data_2d_normal_omnidata_{mode}" / seq /
                   f"image_{cam_id:02d}")
        os.makedirs(out_dir, exist_ok=True)
        files = sorted(img_dir.glob("*.png"))
        if limit:
            files = files[:limit]
        for f in files:
            img = np.asarray(Image.open(f), np.float32) / 255.0
            n = (estimator.infer_sliding(img) if sliding
                 else estimator.infer_square(img))
            n = estimator.to_repo_convention(n)
            np.save(out_dir / f"{f.stem}_norm.npy", n.transpose(2, 0, 1))
            viz = ((n * 0.5 + 0.5) * 255).astype(np.uint8)
            Image.fromarray(viz).save(out_dir / f"{f.stem}_norm_viz.png")
            count += 1
    return count


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser("estimate_normal")
    ap.add_argument("--kitti_root", required=True)
    ap.add_argument("--seqs", nargs="+", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--mode", default="all")
    args = ap.parse_args(argv)
    est = NormalEstimator(checkpoint=args.checkpoint)
    for seq in args.seqs:
        n = estimate_sequence(args.kitti_root, seq, est, mode=args.mode)
        print(f"{seq}: {n} images")


if __name__ == "__main__":
    main()
