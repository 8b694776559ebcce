"""Per-segment LoRA fine-tuning from the command line (port of
vegs_tpu/tools/lora_train.py).

Walks every (seq, start, end) segment -- from a segment list in the
reference's format or from explicit flags -- fine-tunes one LoRA on that
segment's preprocessed crops (300 steps of batch 1 x grad-accum 4, lr 1e-4
cosine; `diffusion.lora.train_lora`) and saves `lora_weights.pkl` into
`{out_dir}/{seq}/{start}_{end}/`, the layout `train.main` resolves for the
guidance window (with an alias under the plain-integer frame names). The
SD base weights load once; each segment starts again from the fresh LoRA
leaves.

    python -m vegs_torch.tools.lora_train --checkpoint_dir SD21 \
        --data_root lora/data/kitti360 --seq 2013_05_28_drive_0009_sync \
        --start_frame 3972 --end_frame 4258

runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch


def parse_segments_file(path: str) -> list[tuple[str, str, str]]:
    """The reference's `*_num_vehicles.txt` lines `.../{seq}/{start}_{end}.{ext}`
    -> (seq, start, end) with the frames as 10-digit strings; seq is the
    directory holding the frames token."""
    segments = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(".")[0].split("/")
            start, end = parts[-1].split("_")
            segments.append((parts[-2], str(int(start)).zfill(10),
                             str(int(end)).zfill(10)))
    return segments


def load_segment_images(data_dir: str, size: int = 512) -> np.ndarray:
    """A segment's preprocessed square crops (`lora_preprocess`'s output, in
    its metadata.jsonl's order, else the PNGs and JPGs sorted) as [B, 3, H,
    W] float32 in [0, 1]."""
    from PIL import Image

    d = Path(data_dir)
    metas = d / "metadata.jsonl"
    if metas.exists():
        with open(metas) as f:
            files = [d / json.loads(line)["file_name"] for line in f]
    else:
        files = sorted(d.glob("*.png")) + sorted(d.glob("*.jpg"))
    if not files:
        raise FileNotFoundError(f"no training crops in {data_dir}")
    imgs = []
    for p in files:
        img = Image.open(p).convert("RGB")
        if img.size != (size, size):
            img = img.resize((size, size))
        imgs.append(np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0)
    return np.stack(imgs)


def train_segment(models, images, out_dir: str, *, steps: int, seed: int,
                  batch_size: int = 1, grad_accum: int = 4,
                  lr: float = 1e-4, on_step=None) -> list[float]:
    """Fine-tune `models.unet`'s LoRA leaves in place on `images` and save
    them to `{out_dir}/lora_weights.pkl`; returns the step losses."""
    from ..diffusion.lora import save_lora_weights, train_lora

    unet, losses = train_lora(
        models, images, steps=steps, batch_size=batch_size,
        grad_accum=grad_accum, lr=lr, seed=seed, on_step=on_step)
    save_lora_weights(unet, os.path.join(out_dir, "lora_weights.pkl"))
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Train one LoRA per KITTI-360 segment")
    ap.add_argument("--checkpoint_dir", required=True,
                    help="local SD-2.1 diffusers checkpoint tree")
    ap.add_argument("--data_root", required=True,
                    help="preprocessed crops root: {data_root}/{seq}/{start}_{end}/")
    ap.add_argument("--out_dir", default="lora/models/kitti360")
    ap.add_argument("--segments_file", default=None,
                    help="reference-format segment list (*_num_vehicles.txt)")
    ap.add_argument("--seq", default=None)
    ap.add_argument("--start_frame", type=int, default=None)
    ap.add_argument("--end_frame", type=int, default=None)
    ap.add_argument("--prompt", default="a photography of a suburban street")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--grad_accum", type=int, default=4)
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=1337)
    args = ap.parse_args(argv)

    if args.segments_file:
        segments = parse_segments_file(args.segments_file)
    else:
        if not (args.seq and args.start_frame is not None
                and args.end_frame is not None):
            ap.error("need --segments_file or --seq/--start_frame/--end_frame")
        segments = [(args.seq, str(args.start_frame).zfill(10),
                     str(args.end_frame).zfill(10))]

    from ..diffusion import weights
    from ..diffusion.lora import is_lora_path

    # base weights load once; each segment restarts from the fresh leaves
    models = weights.load_sd_checkpoint(args.checkpoint_dir, prompt=args.prompt,
                                        lora_dir="init")
    fresh = {n: p.detach().clone() for n, p in models.unet.named_parameters()
             if is_lora_path(n)}
    for seq, start, end in segments:
        seg = f"{start}_{end}"
        data_dir = os.path.join(args.data_root, seq, seg)
        out_dir = os.path.join(args.out_dir, seq, seg)
        alias = os.path.join(args.out_dir, seq, f"{int(start)}_{int(end)}")
        print(f"[lora] segment {seq}/{seg} <- {data_dir}")
        images = load_segment_images(data_dir)
        with torch.no_grad():
            for n, p in models.unet.named_parameters():
                if n in fresh:
                    p.copy_(fresh[n])
        losses = train_segment(
            models, images, out_dir, steps=args.steps, seed=args.seed,
            batch_size=args.batch_size, grad_accum=args.grad_accum,
            lr=args.learning_rate)
        if os.path.abspath(alias) != os.path.abspath(out_dir):
            os.makedirs(alias, exist_ok=True)
            shutil.copyfile(os.path.join(out_dir, "lora_weights.pkl"),
                            os.path.join(alias, "lora_weights.pkl"))
        print(f"[lora] {seq}/{seg}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"saved to {out_dir}")


if __name__ == "__main__":
    main()
