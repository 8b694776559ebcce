"""The seeded inputs of a cell: the Gaussian field, the camera poses and
the prior's normal maps, made from `--seed` on the device in a few large
calls. Plain PyTorch; both the program and the plain reference
(`bench_h100.reference`) take their inputs from here and from nowhere else.

The field is placed as the reference's recorded mid-training scene is sized
(a configuration's `gaussians`): depth uniform in the configuration's
`depth_range`, x and y filling the frustum of a camera at the origin that
looks along +z (`fovx`, `fovy`) -- or, with a `street` entry, on a road
plane at `ground_y` (y points down) between two facades `half_width` to
either side and `facade_height` tall, the share `road_share` on the road,
each point `jitter` off its surface -- random rotations, scales uniform
in `scale_range`, opacities in `opacity_range`, SH degree 3 with a DC in
`dc_range` and the higher bands N(0, `rest_std`). The cameras are a street
arc of `frames` stereo frames (`stereo_baseline` apart) moving 2.5 m along
+z with a slight yaw, as a forward-driving KITTI-360 rig sees a street.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

SEED_MOD = 1 << 62


class FieldInputs(NamedTuple):
    """Raw (pre-activation) per-Gaussian parameters, n rows each."""

    means: torch.Tensor          # [n, 3]
    quats: torch.Tensor          # [n, 4] (w, x, y, z), unnormalized
    log_scales: torch.Tensor     # [n, 3]
    sh_dc: torch.Tensor          # [n, 1, 3]
    sh_rest: torch.Tensor        # [n, 15, 3]
    opacity_logit: torch.Tensor  # [n, 1]


class Pose(NamedTuple):
    """One view: world-to-camera rotation and the camera centre (float64),
    its frame and which eye of the stereo pair it is."""

    r_w2c: np.ndarray  # [3, 3]
    center: np.ndarray  # [3]
    frame: int
    eye: int


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """The generator of one input stream of a run (0: the field, 1: the
    normal maps, 2: the traffic's orders)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7919 + stream) % SEED_MOD)
    return g


def synthetic_field(cfg: dict, seed: int, device) -> FieldInputs:
    """The configuration's seeded field on `device` (float32)."""
    g = generator(seed, device, 0)
    n = int(cfg["gaussians"])
    u = torch.rand((n, 10), generator=g, device=device, dtype=torch.float32)
    w = torch.randn((n, 49), generator=g, device=device, dtype=torch.float32)
    z0, z1 = cfg["depth_range"]
    z = z0 + (z1 - z0) * u[:, 0]
    tx = math.tan(cfg["fovx"] * 0.5)
    ty = math.tan(cfg["fovy"] * 0.5)
    x = z * tx * (1.9 * u[:, 1] - 0.95)
    y = z * ty * (1.9 * u[:, 2] - 0.95)
    if "street" in cfg:  # on the surfaces of a street: road and facades
        st = cfg["street"]
        v = torch.rand((n, 2), generator=g, device=device, dtype=torch.float32)
        hw, gy = st["half_width"], st["ground_y"]
        road = v[:, 0] < st["road_share"]
        side = torch.where(u[:, 1] < 0.5, -hw, hw)
        x = torch.where(road, hw * (2 * u[:, 1] - 1), side)
        y = torch.where(road, torch.full_like(z, gy),
                        gy - st["facade_height"] * u[:, 2])
        jitter = st["jitter"] * (2 * v[:, 1] - 1)
        y = y + torch.where(road, jitter, torch.zeros_like(z))
        x = x + torch.where(road, torch.zeros_like(z), jitter)
    s0, s1 = cfg["scale_range"]
    o0, o1 = cfg["opacity_range"]
    d0, d1 = cfg["dc_range"]
    op = o0 + (o1 - o0) * u[:, 6:7]
    return FieldInputs(
        means=torch.stack([x, y, z], dim=1),
        quats=w[:, 0:4].contiguous(),
        log_scales=torch.log(s0 + (s1 - s0) * u[:, 3:6]),
        sh_dc=(d0 + (d1 - d0) * u[:, 7:10])[:, None, :].contiguous(),
        sh_rest=(cfg["rest_std"] * w[:, 4:49]).reshape(n, 15, 3),
        opacity_logit=torch.log(op / (1.0 - op)),
    )


def box_fields(cfg: dict, seed: int, device) -> list:
    """One canonical field per vehicle (`vehicles` of them): `box_points`
    Gaussians on the faces of the unit box [-0.5, 0.5]^3 (noise 0.02),
    scales uniform in `box_scale_range` (box units), opacities in
    `opacity_range`, SH as the static field's."""
    g = generator(seed, device, 4)
    v, n = int(cfg["vehicles"]), int(cfg["box_points"])
    u = torch.rand((v, n, 11), generator=g, device=device)
    w = torch.randn((v, n, 52), generator=g, device=device)
    face = torch.randint(0, 6, (v, n), generator=g, device=device)
    pts = u[..., 0:3] - 0.5
    axis = face % 3
    side = (face // 3).float() - 0.5
    pts = pts.scatter(2, axis[..., None], side[..., None])
    pts = torch.clamp(pts + 0.02 * w[..., 49:52], -0.49, 0.49)
    s0, s1 = cfg["box_scale_range"]
    o0, o1 = cfg["opacity_range"]
    d0, d1 = cfg["dc_range"]
    op = o0 + (o1 - o0) * u[..., 6:7]
    return [FieldInputs(
        means=pts[i].contiguous(), quats=w[i, :, 0:4].contiguous(),
        log_scales=torch.log(s0 + (s1 - s0) * u[i, :, 3:6]),
        sh_dc=(d0 + (d1 - d0) * u[i, :, 7:10])[:, None, :].contiguous(),
        sh_rest=(cfg["rest_std"] * w[i, :, 4:49]).reshape(n, 15, 3),
        opacity_logit=torch.log(op[i] / (1.0 - op[i]))) for i in range(v)]


def box_poses(cfg: dict) -> dict:
    """{frame: {instance: [4, 4] box-to-world}}: each vehicle a box of
    `car_size` (length, height, width; y points down) at its depth, yaw and
    lateral place (`box_depths`, `box_yaws`, `box_lateral`: a share of the
    half-width at its depth, or of the street's lanes, on its road),
    driving `box_speed` metres along x a frame."""
    tx = math.tan(cfg["fovx"] * 0.5)
    st = cfg.get("street")
    out = {f: {} for f in range(int(cfg["frames"]))}
    for j, (z, yaw, lat) in enumerate(zip(cfg["box_depths"], cfg["box_yaws"],
                                          cfg["box_lateral"])):
        c, s = np.cos(yaw), np.sin(yaw)
        r = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        for f in out:
            m = np.eye(4)
            m[:3, :3] = r @ np.diag(cfg["car_size"])
            if st:
                x = lat * (st["half_width"] - cfg["car_size"][2])
                y = st["ground_y"] - cfg["car_size"][1] / 2
            else:
                x, y = lat * tx * z, 0.05 * z
            m[:3, 3] = (x + cfg["box_speed"] * f, y, z)
            out[f][cfg["first_instance"] + j] = m
    return out


def street_poses(cfg: dict) -> list[Pose]:
    """The configuration's camera arc: `frames` frames, each with its left
    (eye 0) and right (eye 1) camera `stereo_baseline` apart."""
    n = int(cfg["frames"])
    base = float(cfg["stereo_baseline"])
    out = []
    for i in range(n):
        zc = -2.5 + 2.5 * i / max(n - 1, 1)
        yaw = 0.12 * np.sin(2 * np.pi * i / max(n, 1))
        cy, sy = np.cos(yaw), np.sin(yaw)
        r = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
        c0 = np.array([0.25 * np.sin(i * 1.7), 0.0, zc])
        for eye, dx in enumerate((-base / 2, base / 2)):
            out.append(Pose(r, c0 + r[0] * dx, i, eye))
    return out


def intrinsics(cfg: dict) -> np.ndarray:
    """[3, 3] pixel intrinsics of every camera (principal point centred)."""
    h, w = cfg["height"], cfg["width"]
    fx = w / (2.0 * np.tan(cfg["fovx"] / 2))
    fy = h / (2.0 * np.tan(cfg["fovy"] / 2))
    return np.array([[fx, 0.0, w / 2], [0.0, fy, h / 2], [0.0, 0.0, 1.0]])


def normal_maps(cfg: dict, seed: int, count: int, device) -> torch.Tensor:
    """[count, 3, H, W] smooth camera-space unit normal maps (a tilted plane
    with seeded low-frequency ripples), one per view, float32."""
    g = generator(seed, device, 1)
    h, w = cfg["height"], cfg["width"]
    p = torch.rand((count, 3), generator=g, device=device, dtype=torch.float32)
    fx = (0.5 + 1.5 * p[:, 0])[:, None, None]
    fy = (0.5 + 1.5 * p[:, 1])[:, None, None]
    ph = (6.3 * p[:, 2])[:, None, None]
    y = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    x = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    nx = 0.3 * torch.sin(2 * math.pi * fx * x / w + ph)
    ny = -0.8 + 0.2 * torch.cos(2 * math.pi * fy * y / h)
    nx, ny = torch.broadcast_tensors(nx, ny)
    n = torch.stack([nx, ny, -torch.ones_like(nx)], dim=1)
    return n / torch.linalg.norm(n, dim=1, keepdim=True)


def permutation(seed: int, count: int, device) -> list[int]:
    """A seeded order of `count` items (the training views' order)."""
    g = generator(seed, device, 2)
    return torch.randperm(count, generator=g, device=device).tolist()


def draw(seed: int, count: int, strata: int, size: int, device) -> list[int]:
    """`count` seeded indices into `strata` consecutive blocks of `size`,
    as many from each block (the frames to check, per augmentation)."""
    g = generator(seed, device, 3)
    per = max(1, count // strata)
    return sorted(s * size + int(i) for s in range(strata)
                  for i in torch.randperm(size, generator=g,
                                          device=device)[:per].tolist())
