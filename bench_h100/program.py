"""The system under test, `vegs_torch`, as a cell drives it: its kernels
built, its field, scene and trainer made from the benchmark's inputs, its
tile-instance capacities sized. The traffic loops (`loops`) call its
entry points; the plain reference never imports it."""

from __future__ import annotations

import numpy as np
import torch

from . import inputs as inp


def build_kernels(device) -> dict:
    """nvcc-build the program's CUDA kernels into its checkout's build
    directory (a cache: a later run in the checkout finds them built)."""
    if torch.device(device).type != "cuda":
        return {"built": [], "seconds": 0.0}
    from vegs_torch import kernels

    out = kernels.build_all()
    return {"built": out["built"], "seconds": out["seconds"]}


def make_field(f: inp.FieldInputs):
    """The program's field from the raw inputs, padded to a multiple of
    4096 rows (the program's capacity bucket) with invalid rows."""
    from vegs_torch.gaussians import GaussianField, round_capacity

    n = f.means.shape[0]
    cap = round_capacity(n)

    def pad(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=torch.float32,
                         device=x.device)
        out[:n] = x
        return out

    valid = torch.zeros(cap, dtype=torch.bool, device=f.means.device)
    valid[:n] = True
    return GaussianField(means=pad(f.means), quats=pad(f.quats),
                         log_scales=pad(f.log_scales),
                         sh_dc=pad(f.sh_dc),
                         sh_rest=pad(f.sh_rest),
                         opacity_logit=pad(f.opacity_logit), valid=valid)


def make_scene(cfg: dict, poses: list, field, device, box_fields=None,
               box_poses=None):
    """A program `Scene` holding `field`, one camera per pose (no images
    yet: the caller sets each camera's `image` and `normal`), the box
    fields ({instance: field}) and their poses ({frame: {instance: box to
    world}})."""
    from vegs_torch.config import ModelParams
    from vegs_torch.scene import Scene
    from vegs_torch.scene.dataset_readers import (BasicPointCloud, CameraInfo,
                                                  SceneInfo, getNerfppNorm)

    k = inp.intrinsics(cfg)
    infos = [CameraInfo(uid=i, R=p.r_w2c.T.copy(), T=-p.r_w2c @ p.center,
                        FovY=cfg["fovy"], FovX=cfg["fovx"], image=None,
                        image_path="", image_name=f"f{p.frame:03d}_{p.eye}",
                        width=cfg["width"], height=cfg["height"], K=k,
                        frame=p.frame, cam_idx=p.eye)
             for i, p in enumerate(poses)]
    # the Scene seeds a field from this cloud; the benchmark's replaces it
    seed_cloud = BasicPointCloud(points=np.zeros((4, 3), np.float32),
                                 colors=np.zeros((4, 3), np.float32))
    info = SceneInfo(point_cloud=seed_cloud, train_cameras=infos,
                     test_cameras=[], nerf_normalization=getNerfppNorm(infos),
                     ply_path="")
    scene = Scene(ModelParams(), scene_info=info, load_iteration=None,
                  shuffle=False, device=device)
    scene.gaussians = field
    scene.box_gaussians = dict(box_fields or {})
    scene.train_bboxes = dict(box_poses or {})
    scene.instances_info = sorted(scene.box_gaussians)
    return scene


def raster_config(cfg: dict, **kw):
    from vegs_torch.ops.rasterize import RasterizeConfig

    th, tw = cfg["tile"]
    return RasterizeConfig(tile_h=th, tile_w=tw, payload_dtype=cfg["aux_dtype"],
                           sat_cull=cfg["sat_cull"], **kw)


def size_capacities(cfg: dict, field, views, margin: float, probe_cap: int,
                    boxes_of=None):
    """The raster config with k_cap and k_pad at `margin` times the largest
    need of `views` (CameraParams), each rendered by the program at
    `probe_cap`; with `boxes_of` (view index -> the frame's
    `BoxInstance`s) the boxes are rendered with the field. Returns
    (config, need_raw, need_pad)."""
    from vegs_torch.render import render, render_all

    probe = raster_config(cfg, k_cap=probe_cap, k_pad=probe_cap,
                          forward_only=True)
    need_raw = need_pad = 0
    with torch.inference_mode():
        for i, v in enumerate(views):
            if boxes_of is None:
                out = render(v, field, config=probe)
            else:
                out, _ = render_all(v, field, boxes_of(i), config=probe)
            if int(out.num_dropped):
                raise RuntimeError(f"probe capacity {probe_cap} < need "
                                   f"{int(out.num_needed_raw)}")
            need_raw = max(need_raw, int(out.num_needed_raw))
            need_pad = max(need_pad, int(out.num_needed))

    def r512(v):
        return (int(v) + 511) // 512 * 512

    return (raster_config(cfg, k_cap=r512(need_raw * margin),
                          k_pad=r512(need_pad * margin)), need_raw, need_pad)

