"""LoRA training-data preparation for KITTI-360 segments (port of
vegs_tpu/tools/lora_preprocess.py).

Per segment: `n_images` random square crops (a side between half and all
of the frame's height, at a random place in a random frame of camera 0),
resized to `size`, written as PNGs with a Hugging Face datasets
`metadata.jsonl` holding the fixed caption. The draws come from numpy's
`default_rng(seed)` in the JAX tool's order, so the same seed writes the
same crops.

    python -m vegs_torch.tools.lora_preprocess --kitti_root ROOT \
        --start_frame 3972 --end_frame 4258 --out_dir lora/data/...
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

DEFAULT_CAPTION = "a photography of a suburban street"


def preprocess_segment(kitti_root, seq, start_frame, end_frame, out_dir,
                       n_images: int = 100, size: int = 512,
                       caption: str = DEFAULT_CAPTION, seed: int = 0) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    image_dir = Path(kitti_root) / "data_2d_raw" / seq / "image_00" / "data_rect"
    frames = sorted(
        int(p.stem) for p in image_dir.glob("*.png")
        if int(start_frame) <= int(p.stem) < int(end_frame)
    )
    out = Path(out_dir)
    os.makedirs(out, exist_ok=True)
    meta_lines = []
    for i in range(n_images):
        frame = int(rng.choice(frames))
        img = Image.open(image_dir / f"{frame:010d}.png")
        w, h = img.size
        side = int(rng.integers(h // 2, h + 1))
        x = int(rng.integers(0, w - side + 1))
        y = int(rng.integers(0, h - side + 1))
        crop = img.crop((x, y, x + side, y + side)).resize((size, size))
        name = f"{i:05d}.png"
        crop.save(out / name)
        meta_lines.append(json.dumps({"file_name": name, "text": caption}))
    (out / "metadata.jsonl").write_text("\n".join(meta_lines) + "\n")
    return str(out)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser("lora_preprocess")
    ap.add_argument("--kitti_root", required=True)
    ap.add_argument("--seq", default="2013_05_28_drive_0009_sync")
    ap.add_argument("--start_frame", type=int, required=True)
    ap.add_argument("--end_frame", type=int, required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--n_images", type=int, default=100)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    print(preprocess_segment(args.kitti_root, args.seq, args.start_frame,
                             args.end_frame, args.out_dir, args.n_images,
                             args.size))


if __name__ == "__main__":
    main()
