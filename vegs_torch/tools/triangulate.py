"""Known-pose COLMAP triangulation for KITTI-360 segments (port of
vegs_tpu/tools/triangulate.py).

Per segment: COLMAP-format cameras.txt/images.txt from the known KITTI-360
poses of camera 0, binary masks that keep only the static semantic
classes, the COLMAP CLI chain (feature_extractor -> exhaustive_matcher ->
point_triangulator -> model_converter), then a statistical outlier filter
of the triangulated cloud, stored where the KITTI-360 reader looks for it
(`data_3d_colmap{type}/train/{seq}/static/{start}_{end}/points3D.ply`).
Host-side only: numpy, PIL, scipy and a `colmap` binary.

    python -m vegs_torch.tools.triangulate --kitti_root ROOT \
        --start_frame 3972 --end_frame 4258 --colmap_bin colmap
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import numpy as np

from ..scene import colmap_loader, dataset_readers, kitti360_loader

# KITTI-360 semantic ids kept as static scene
STATIC_SEMANTIC_IDS = (
    7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 6, 9, 10, 14, 15, 16, 18, 35,
    36, 37, 38, 39, 40,
)


def write_known_pose_model(out_dir, cam, frames, seq, image_dir) -> None:
    """cameras.txt, images.txt and an empty points3D.txt with known poses."""
    os.makedirs(out_dir, exist_ok=True)
    cameras = {1: colmap_loader.ColmapCamera(
        1, "PINHOLE", cam.width, cam.height,
        np.array([cam.K[0, 0], cam.K[1, 1], cam.K[0, 2], cam.K[1, 2]]))}
    images = {}
    for i, frame in enumerate(frames, start=1):
        w2c = np.linalg.inv(cam.cam2world[frame])
        qvec = colmap_loader.rotmat2qvec(w2c[:3, :3])
        images[i] = colmap_loader.ColmapImage(
            i, qvec, w2c[:3, 3], 1, f"{int(frame):010d}.png",
            np.zeros((0, 2)), np.zeros(0, np.int64))
    colmap_loader.write_cameras_text(cameras, Path(out_dir) / "cameras.txt")
    colmap_loader.write_images_text(images, Path(out_dir) / "images.txt")
    (Path(out_dir) / "points3D.txt").write_text("")


def write_semantic_masks(mask_dir, semantic_dir, frames,
                         ok_ids=STATIC_SEMANTIC_IDS) -> None:
    """Binary masks (255 on static-class pixels) from KITTI-360's
    data_2d_semantics label images; frames without labels are skipped."""
    from PIL import Image

    os.makedirs(mask_dir, exist_ok=True)
    for frame in frames:
        name = f"{int(frame):010d}.png"
        sem_path = Path(semantic_dir) / name
        if not sem_path.exists():
            continue
        sem = np.asarray(Image.open(sem_path))
        mask = np.isin(sem, np.asarray(ok_ids)).astype(np.uint8) * 255
        Image.fromarray(mask).save(Path(mask_dir) / (name + ".png"))


def run_colmap_chain(image_dir, mask_dir, sparse_in, out_dir,
                     colmap_bin: str = "colmap") -> None:
    """feature_extractor -> exhaustive_matcher -> point_triangulator ->
    model_converter (to points3D.ply in `out_dir`)."""
    db = Path(out_dir) / "database.db"
    os.makedirs(out_dir, exist_ok=True)
    steps = [
        [colmap_bin, "feature_extractor", "--database_path", str(db),
         "--image_path", str(image_dir), "--ImageReader.mask_path",
         str(mask_dir), "--ImageReader.camera_model", "PINHOLE"],
        [colmap_bin, "exhaustive_matcher", "--database_path", str(db)],
        [colmap_bin, "point_triangulator", "--database_path", str(db),
         "--image_path", str(image_dir), "--input_path", str(sparse_in),
         "--output_path", str(out_dir)],
        [colmap_bin, "model_converter", "--input_path", str(out_dir),
         "--output_path", str(Path(out_dir) / "points3D.ply"),
         "--output_type", "PLY"],
    ]
    for cmd in steps:
        subprocess.run(cmd, check=True)


def statistical_outlier_filter(points, colors, nb_neighbors: int = 20,
                               std_ratio: float = 2.0):
    """Drop points whose mean distance to their `nb_neighbors` nearest
    neighbours lies more than `std_ratio` standard deviations above the
    mean of those distances (open3d's remove_statistical_outlier)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    d, _ = tree.query(points, k=nb_neighbors + 1, workers=-1)
    mean_d = d[:, 1:].mean(axis=1)
    keep = mean_d <= mean_d.mean() + std_ratio * mean_d.std()
    return points[keep], colors[keep]


def triangulate_segment(kitti_root, seq, start_frame, end_frame,
                        colmap_bin: str = "colmap",
                        colmap_data_type: str = "_processed",
                        workdir: str | None = None) -> str:
    """The whole tool; returns the written PLY's path."""
    cam = kitti360_loader.CameraPerspective(str(kitti_root), seq, cam_id=0)
    frames = [f for f in cam.frames.tolist()
              if int(start_frame) <= f < int(end_frame)]
    seg = f"{int(start_frame):010d}_{int(end_frame):010d}"
    image_dir = Path(kitti_root) / "data_2d_raw" / seq / "image_00" / "data_rect"
    semantic_dir = (Path(kitti_root) / "data_2d_semantics" / "train" / seq /
                    "image_00" / "semantic")
    out_root = (Path(kitti_root) / f"data_3d_colmap{colmap_data_type}" /
                "train" / seq / "static" / seg)
    work = Path(workdir or (out_root / "work"))

    sparse_in = work / "known"
    write_known_pose_model(sparse_in, cam, frames, seq, image_dir)
    mask_dir = work / "masks"
    write_semantic_masks(mask_dir, semantic_dir, frames)
    tri_out = work / "triangulated"
    run_colmap_chain(image_dir, mask_dir, sparse_in, tri_out, colmap_bin)

    pcd = dataset_readers.fetchPly(tri_out / "points3D.ply",
                                   return_normals=False)
    pts, cols = statistical_outlier_filter(pcd.points, pcd.colors)
    os.makedirs(out_root, exist_ok=True)
    out_ply = out_root / "points3D.ply"
    dataset_readers.storePly(out_ply, pts, np.uint8(cols * 255))
    return str(out_ply)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser("triangulate")
    ap.add_argument("--kitti_root", required=True)
    ap.add_argument("--seq", default="2013_05_28_drive_0009_sync")
    ap.add_argument("--start_frame", type=int, required=True)
    ap.add_argument("--end_frame", type=int, required=True)
    ap.add_argument("--colmap_bin", default="colmap")
    args = ap.parse_args(argv)
    print(triangulate_segment(args.kitti_root, args.seq, args.start_frame,
                              args.end_frame, args.colmap_bin))


if __name__ == "__main__":
    main()
