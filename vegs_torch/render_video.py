"""Offline rendering of interpolated camera trajectories and of single
augmented views (port of vegs_tpu/render_video.py).

`render_novelview_image` renders one augmented view of a scene with the
frame's boxes at their annotated poses, `render_novelview_rotaxis` the
covariance-axis picture of that view (the training report's two images).
`render_frames` renders every interpolated camera at each fixed
extrapolation trajectory and returns the frames; `render_set` does that and
writes one mp4 per trajectory (OpenCV, imported only there). The
box-pose interpolation of `render_frames` (a scene with boxes) and the
command-line entry point are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from . import geometry
from .ops.rasterize import RasterizeConfig
from .render import BoxInstance, render, render_all
from .scene import Scene, box_matrix
from .scene.cameras import Camera, make_camera_like_input_camera

# Fixed extrapolation trajectories rendered for every frame
# (zrot +-60, xrot -10 with rise).
DEFAULT_AUG_PARAMS = (
    {"add_zrot_val": 0.0, "add_xrot_val": 0.0, "add_tz": 0.0},
    {"add_zrot_val": 60.0, "add_xrot_val": 0.0, "add_tz": 0.0},
    {"add_zrot_val": -60.0, "add_xrot_val": 0.0, "add_tz": 0.0},
    {"add_zrot_val": 0.0, "add_xrot_val": -10.0, "add_tz": 0.5},
)


def _f32(x: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def interpolate_cameras(cams: Sequence[Camera], n_interp: int = 4) -> list[Camera]:
    """SLERP rotation + lerp translation between consecutive cameras. The
    quaternion maths runs in float32, as the JAX package runs it."""
    out = []
    for a, b in zip(cams[:-1], cams[1:]):
        c2w_a = np.linalg.inv(geometry.world_to_view(a.R, a.T))
        c2w_b = np.linalg.inv(geometry.world_to_view(b.R, b.T))
        qa = geometry.rotmat_to_quat(_f32(c2w_a[:3, :3]))
        qb = geometry.rotmat_to_quat(_f32(c2w_b[:3, :3]))
        for k in range(n_interp):
            t = k / n_interp
            q = geometry.quat_slerp(qa, qb, t)
            R_c2w = geometry.quat_to_rotmat(q).numpy()
            tr = (1 - t) * c2w_a[:3, 3] + t * c2w_b[:3, 3]
            c2w = np.eye(4)
            c2w[:3, :3] = R_c2w
            c2w[:3, 3] = tr
            w2c = np.linalg.inv(c2w)
            out.append(dataclasses.replace(
                a, R=w2c[:3, :3].T.copy(), T=w2c[:3, 3].copy(),
                image=None, normal=None,
            ))
    out.append(cams[-1])
    return out


def _render_view(scene: Scene, cam_aug: Camera, boxes: dict,
                 raster_cfg: RasterizeConfig, bg):
    """The scene's field and the boxes of `boxes` ({instance: box-to-world
    matrix or annotation}) that have a field, at their annotated poses."""
    dev = scene.gaussians.means.device
    instances = [
        BoxInstance(field=scene.box_gaussians[i],
                    box2world=_f32(box_matrix(m)).to(dev))
        for i, m in boxes.items() if i in scene.box_gaussians]
    if instances:
        out, _ = render_all(cam_aug, scene.gaussians, instances, bg=bg,
                            config=raster_cfg)
        return out
    return render(cam_aug, scene.gaussians, bg=bg, config=raster_cfg)


def render_novelview_image(scene: Scene, cam: Camera, boxes: dict,
                           raster_cfg: RasterizeConfig, bg, aug) -> np.ndarray:
    """One frame at an augmented view, with `boxes`: [H, W, 3] float32 in
    [0, 1]."""
    cam_aug = make_camera_like_input_camera(cam, **aug)
    out = _render_view(scene, cam_aug, boxes, raster_cfg, bg)
    return torch.clamp(out.rgb.detach(), 0, 1).permute(1, 2, 0).cpu().numpy()


def render_novelview_rotaxis(scene: Scene, cam: Camera, boxes: dict,
                             raster_cfg: RasterizeConfig, bg, aug,
                             idx_best: str = "min_scale",
                             normal_gt=None) -> np.ndarray:
    """Covariance-axis picture at an augmented view: per pixel, of the
    composited covariance rotation's columns in camera space, the one with
    the smallest composited scale (`min_scale`, the flattened axis) or the
    one best aligned with the [3, H, W] `normal_gt` (`gt_like`), shaded
    like a normal image ((1 - n) / 2). Returns uint8 [H, W, 3]."""
    cam_aug = make_camera_like_input_camera(cam, **aug)
    out = _render_view(scene, cam_aug, boxes, raster_cfg, bg)
    h, w = out.cov_quat.shape[1:]
    quats = out.cov_quat.detach().reshape(4, -1).T             # [npix, 4]
    scales = out.cov_scale.detach().reshape(3, -1).T           # [npix, 3]
    rot = geometry.quat_to_rotmat(geometry.quat_normalize(quats))
    # cam.R is the transposed world-to-camera rotation (c2w); the columns of
    # R_w2c @ rot are the covariance axes in camera space
    r_w2c = _f32(cam_aug.R.T).to(quats.device)
    axes_cam = torch.einsum("ij,njk->nik", r_w2c, rot)         # [npix, 3, 3]
    if idx_best == "min_scale":
        best = torch.argmin(scales, dim=1)
    elif idx_best == "gt_like":
        if normal_gt is None:
            raise ValueError("gt_like needs a [3, H, W] normal map")
        ngt = _f32(normal_gt).to(quats.device).reshape(3, -1).T
        best = torch.argmax(torch.einsum("ni,nik->nk", ngt, axes_cam), dim=1)
    else:
        raise ValueError(f"unknown idx_best: {idx_best}")
    n_best = torch.gather(axes_cam, 2,
                          best[:, None, None].expand(-1, 3, 1))[..., 0]
    img = torch.clamp((-n_best + 1.0) * 0.5, 0.0, 1.0).T.reshape(3, h, w)
    return (img.permute(1, 2, 0).cpu().numpy() * 255).astype(np.uint8)


def save_video(frames: Sequence[np.ndarray], path, fps: int = 10) -> None:
    """mp4 writer."""
    import cv2

    h, w = frames[0].shape[:2]
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    writer = cv2.VideoWriter(
        str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(cv2.cvtColor((f * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
    writer.release()


def video_name(aug: dict) -> str:
    return f"zrot{aug['add_zrot_val']:+.0f}_xrot{aug['add_xrot_val']:+.0f}.mp4"


def render_frames(scene: Scene, n_interp: int = 4,
                  aug_params=DEFAULT_AUG_PARAMS,
                  raster_cfg: RasterizeConfig = RasterizeConfig(),
                  white_background: bool = False,
                  max_frames: Optional[int] = None) -> dict:
    """Render the interpolated train trajectory at each augmentation.

    Returns {video name: [frame [H, W, 3] float32, ...]}."""
    if scene.train_bboxes:
        raise NotImplementedError("the box-pose interpolation is not ported "
                                  "yet")
    raster_cfg = raster_cfg._replace(forward_only=True)  # inference only
    bg = torch.tensor([1.0] * 3 if white_background else [0.0] * 3,
                      device=scene.device)
    train_cams = sorted(scene.getTrainCameras(), key=lambda c: (c.frame, c.colmap_id))
    cams_left = [c for c in train_cams if getattr(c, "cam_idx", 0) == 0] or train_cams
    cams = interpolate_cameras(cams_left, n_interp)
    if max_frames:
        cams = cams[:max_frames]
    out = {}
    with torch.inference_mode():
        for aug in aug_params:
            out[video_name(aug)] = [
                render_novelview_image(scene, cam, {}, raster_cfg, bg, aug)
                for cam in cams]
    return out


def render_set(scene: Scene, out_dir, n_interp: int = 4,
               aug_params=DEFAULT_AUG_PARAMS, fps: int = 10,
               raster_cfg: RasterizeConfig = RasterizeConfig(),
               white_background: bool = False,
               max_frames: Optional[int] = None) -> dict:
    """Render interpolated trajectories to one mp4 per augmentation."""
    frames = render_frames(scene, n_interp, aug_params, raster_cfg,
                           white_background, max_frames)
    outputs = {}
    for name, fr in frames.items():
        path = Path(out_dir) / name
        save_video(fr, path, fps)
        outputs[name] = str(path)
    return outputs
