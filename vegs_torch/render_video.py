"""Offline rendering of interpolated camera trajectories and of single
augmented views (port of vegs_tpu/render_video.py).

`render_novelview_image` renders one augmented view of a scene with the
frame's boxes at their annotated poses, `render_novelview_rotaxis` the
covariance-axis picture of that view (the training report's two images).
`render_frames` renders every interpolated camera at each fixed
extrapolation trajectory, with the boxes at their interpolated poses
(SLERP of the rotation, lerp of scale and translation between annotated
frames), and returns the frames; `render_set` does that and writes one mp4
per trajectory (OpenCV, imported only there); `render_sets` loads a
trained model directory first.

    python -m vegs_torch.render_video --source_path ROOT --model_path MODEL \
        --data_type kitti360 --start_frame 3972 --end_frame 4258 --k_cap N

(the training CLI's flags) renders on the card into MODEL/videos.
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
from .utils import trace

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


def interpolate_box2world(m_a: np.ndarray, m_b: np.ndarray,
                          t: float) -> np.ndarray:
    """SLERP the rotation, lerp the scale and translation of two
    box-to-world matrices (float32, as the JAX package computes)."""
    Ra, Sa, Ta = geometry.decompose_T_to_RS(_f32(m_a))
    Rb, Sb, Tb = geometry.decompose_T_to_RS(_f32(m_b))
    q = geometry.quat_slerp(geometry.rotmat_to_quat(Ra),
                            geometry.rotmat_to_quat(Rb), t)
    R = geometry.quat_to_rotmat(q)
    S = (1 - t) * Sa + t * Sb
    T = (1 - t) * Ta + t * Tb
    return geometry.compose_T(R, S, T).numpy()


def interpolate_bboxes(bboxes: dict, frames: Sequence[int], n_interp: int = 4):
    """{frame: {instance: box-to-world matrix or annotation}} -> one
    {instance: matrix} per interpolated camera: the instances annotated in
    both frames interpolated, those only in the first kept where they
    are."""
    out = []
    frames = list(frames)
    for fa, fb in zip(frames[:-1], frames[1:]):
        a = bboxes.get(fa, {})
        b = bboxes.get(fb, {})
        for k in range(n_interp):
            t = k / n_interp
            cur = {inst: interpolate_box2world(box_matrix(a[inst]),
                                               box_matrix(b[inst]), t)
                   for inst in set(a) & set(b)}
            cur.update({inst: box_matrix(a[inst]) for inst in set(a) - set(b)})
            out.append(cur)
    out.append({i: box_matrix(bx)
                for i, bx in bboxes.get(frames[-1], {}).items()})
    return out


def _render_view(scene: Scene, cam_aug: Camera, boxes: dict,
                 raster_cfg: RasterizeConfig, bg):
    """The scene's field and the boxes of `boxes` ({instance: box-to-world
    matrix or annotation}) that have a field, at their annotated poses."""
    with trace.span("video.frame"):
        dev = scene.gaussians.means.device
        held = [(i, m) for i, m in boxes.items() if i in scene.box_gaussians]
        if held:
            with trace.span("boxes.copy", sync=True):  # one copy, [B, 4, 4]
                b2w = _f32(np.stack([box_matrix(m) for _, m in held])).to(dev)
            instances = [BoxInstance(field=scene.box_gaussians[i],
                                     box2world=b2w[j])
                         for j, (i, _) in enumerate(held)]
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
    with trace.span("video.copyout", sync=True):
        rgb = torch.clamp(out.rgb.detach(), 0, 1).permute(1, 2, 0).cpu()
    return rgb.numpy()


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
    """Render the interpolated train trajectory, with the boxes at their
    interpolated poses, at each augmentation.

    Returns {video name: [frame [H, W, 3] float32, ...]}."""
    raster_cfg = raster_cfg._replace(forward_only=True)  # inference only
    bg = torch.tensor([1.0] * 3 if white_background else [0.0] * 3,
                      device=scene.device)
    train_cams = sorted(scene.getTrainCameras(), key=lambda c: (c.frame, c.colmap_id))
    cams_left = [c for c in train_cams if getattr(c, "cam_idx", 0) == 0] or train_cams
    cams = interpolate_cameras(cams_left, n_interp)
    if scene.train_bboxes:
        timeline = interpolate_bboxes(scene.train_bboxes,
                                      [c.frame for c in cams_left], n_interp)
    else:
        timeline = [{} for _ in cams]
    if max_frames:
        cams, timeline = cams[:max_frames], timeline[:max_frames]
    out = {}
    with torch.inference_mode():
        for aug in aug_params:
            out[video_name(aug)] = [
                render_novelview_image(scene, cam, boxes, raster_cfg, bg, aug)
                for cam, boxes in zip(cams, timeline)]
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


def render_sets(cfg, load_iteration: int = -1, out_subdir: str = "videos",
                device=None, **kwargs) -> dict:
    """Load the trained model of `cfg` (a `VegsConfig`) at
    `load_iteration` (-1: the last saved) on `device` (default: the card)
    and render its videos into `{model_path}/{out_subdir}`; `kwargs` go to
    `render_set`."""
    scene = Scene(cfg.model, cfg.data, cfg.box, load_iteration=load_iteration,
                  shuffle=False, device=device)
    out_dir = Path(cfg.model.model_path) / out_subdir
    return render_set(scene, out_dir,
                      white_background=cfg.model.white_background, **kwargs)


def main(argv=None) -> dict:
    """The command line: the training CLI's flags; the rasterizer's backend,
    `--k_cap` and `--clamp_radius` as given there."""
    from .config import parse_config

    cfg = parse_config(argv)
    raster_cfg = RasterizeConfig(backend=cfg.pipeline.backend,
                                 k_cap=cfg.pipeline.k_cap,
                                 clamp_radius=cfg.pipeline.clamp_radius)
    out = render_sets(cfg, raster_cfg=raster_cfg)
    print(out)
    return out


if __name__ == "__main__":
    main()
