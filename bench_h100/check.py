"""What decides `correct`: the plain reference run on the cell's own
inputs, after the window has closed and the program's state is freed, and
the numbers compared against each limit.

  train -- the reference follows the run's first `checked_steps` steps
           from the seeded field, on the same views: each step's loss, the
           first step's gradient norm of each leaf (the program's read
           from its Adam moments after that step), each leaf's change after
           the checked steps, and the densification statistics then.
           Numbers: `loss_gap`, the largest relative gap of a step's loss;
           `grad_gap` and `change_gap`, the worst leaf's gap of norms over
           the larger of that leaf's reference norm and the median leaf's
           (a leaf whose reference gradient is under a thousandth of the
           median leaf's is left out of the change); `stats_gap`, the same
           over the statistics' accumulated gradient norm and view count.
  serve -- the reference renders the frames drawn from the seed (among the
           trajectory's first loop) at the same cameras, augmentations
           and field. Numbers: `tile_gap`, the largest over those frames of
           the mean absolute pixel gap of a 16x16 block (a block rendered
           wrong, where the largest single pixel's gap swings with the depth
           order of two Gaussians whose float32 depths round apart), and
           `mean_abs`, the largest over those frames of the mean absolute
           pixel gap.

`lowp` runs the reference in the control's precision (`raster`).
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from . import inputs as inp
from .reference import boxes as rb, cameras as rc, raster, train as rt


def _leaves(f: inp.FieldInputs) -> dict:
    return {k: getattr(f, k).double() for k in rt.LEAVES}


def _views(cfg: dict, poses: list) -> list:
    k = inp.intrinsics(cfg)
    return [rc.view(rc.c2w_of(p.r_w2c, p.center), k, cfg["height"],
                    cfg["width"]) for p in poses]


def _norm(x) -> float:
    if isinstance(x, list):
        return float(torch.sqrt(sum((t.double() ** 2).sum() for t in x)))
    return float(torch.linalg.norm(x))


def reference_fields(cfg: dict, seed: int, dev, views: list, normals) -> tuple:
    """(static leaves, {vehicle: leaves}) of the configuration, float64,
    after the normal-prior init where the configuration takes it."""
    p = _leaves(inp.synthetic_field(cfg, seed, dev))
    if cfg.get("normal_init"):
        nws = [rt.world_normal(normals[i], views[i][1]) for i in range(len(views))]
        p = rb.normal_init(p, [v for v, _ in views], nws)
        del nws
    bx = {}
    if cfg.get("vehicles"):
        insts = sorted(inp.box_poses(cfg)[0])
        bx = {i: _leaves(f) for i, f in zip(insts, inp.box_fields(cfg, seed, dev))}
    return p, bx


def _offset(p: dict, dc: float) -> dict:
    return dict(p, sh_dc=p["sh_dc"] + dc)


def reference_train(cfg: dict, tr: dict, seed: int, dev, lowp=False) -> dict:
    poses = inp.street_poses(cfg)
    views = _views(cfg, poses)
    extent = rc.scene_extent([p.center for p in poses])
    order = inp.permutation(seed, len(poses), dev)[:tr["checked_steps"]]
    normals = inp.normal_maps(cfg, seed, len(poses), dev)
    p, bx = reference_fields(cfg, seed, dev, [(v, q.r_w2c) for v, q in
                                              zip(views, poses)], normals)
    box_poses = inp.box_poses(cfg) if bx else {}

    def arrays(pp, bb, frame):
        parts = [raster.arrays(pp)]
        for i, m in sorted(box_poses.get(frame, {}).items()):
            b2w = torch.as_tensor(m, dtype=torch.float64, device=dev)
            parts.append(rb.to_world(raster.arrays(bb[i]), b2w))
        return {k: torch.cat([a[k] for a in parts]) for k in parts[0]}

    gts = []
    with torch.no_grad():
        for v in order:
            pr = raster.project_arrays(arrays(p, bx, poses[v].frame), views[v], 3)
            img = raster.rasterize(pr, views[v].height, views[v].width,
                                   aux_dtype=cfg["aux_dtype"], lowp=lowp)
            gts.append(torch.clamp(img.rgb, 0, 1))
    dc = cfg["sh_dc_offset"]
    st = rt.State(_offset(p, dc), {i: _offset(b, dc) for i, b in bx.items()})
    del p, bx
    p0 = {k: v.clone() for k, v in st.field.p.items()}
    b0 = {i: {k: v.clone() for k, v in a.p.items()} for i, a in st.boxes.items()}
    out = {"loss": [], "pairs": []}
    for i, v in enumerate(order):
        nw = rt.world_normal(normals[v], poses[v].r_w2c)
        frame = poses[v].frame
        loss, grads, pairs = rt.step(
            st, views[v], gts[i], nw, extent, cfg["aux_dtype"], lowp, frame,
            dict(sorted(box_poses.get(frame, {}).items())))
        out["loss"].append(loss)
        out["pairs"].append(pairs)
        if i == 0:
            out["grad"] = {k: _norm(g) for k, g in grads.items()}
        del grads
    ch = {k: _norm(st.field.p[k] - p0[k]) for k in rt.LEAVES}
    if st.boxes:
        for k in rt.LEAVES:
            ch["box." + k] = _norm([a.p[k] - b0[i][k] for i, a in st.boxes.items()])
        ident = rb.identity_delta(dev)
        for k in ident:
            ch["delta." + k] = _norm([a.p[k] - ident[k] for a in st.deltas.values()])
    out["change"] = ch
    out["stats"] = {"accum": float(torch.linalg.norm(st.accum)),
                    "denom": float(torch.linalg.norm(st.denom))}
    return out


def serve_views(cfg: dict, tr: dict) -> tuple:
    """The reference's serve trajectory in the program's frame order
    (augmentation-major): (augmentation, camera to world, {vehicle: box to
    world}) each, and the intrinsics."""
    left = sorted((p for p in inp.street_poses(cfg) if p.eye == 0),
                  key=lambda p: p.frame)
    traj = rc.interpolate([rc.c2w_of(p.r_w2c, p.center) for p in left],
                          tr["n_interp"])
    boxes = (rb.interpolate_poses(inp.box_poses(cfg), [p.frame for p in left],
                                  tr["n_interp"]) if cfg.get("vehicles")
             else [{} for _ in traj])
    return ([(a, c, b) for a in tr["augmentations"] for c, b in zip(traj, boxes)],
            inp.intrinsics(cfg))


def reference_serve(cfg: dict, tr: dict, seed: int, frames, dev,
                    lowp=False) -> dict:
    """{frame index: [H, W, 3] float32 pixels in [0, 1]} and the pairs."""
    traj, k = serve_views(cfg, tr)
    poses = inp.street_poses(cfg)
    normals = (inp.normal_maps(cfg, seed, len(poses), dev)
               if cfg.get("normal_init") else None)
    p, bx = reference_fields(cfg, seed, dev, [(v, q.r_w2c) for v, q in
                                              zip(_views(cfg, poses), poses)],
                             normals)
    del normals
    out, pairs = {}, []
    with torch.no_grad():
        static = raster.arrays(p)
        for i in frames:
            a, c2w, bposes = traj[i]
            v = rc.view(rc.augment(c2w, **a), k, cfg["height"], cfg["width"])
            parts = [static] + [
                rb.to_world(raster.arrays(bx[j]),
                            torch.as_tensor(m, dtype=torch.float64, device=dev))
                for j, m in sorted(bposes.items())]
            arr = {key: torch.cat([x[key] for x in parts]) for key in static}
            img = raster.rasterize(raster.project_arrays(arr, v, 3), v.height,
                                   v.width, (0.0, 0.0, 0.0), cfg["aux_dtype"], lowp)
            out[i] = torch.clamp(img.rgb, 0, 1).permute(1, 2, 0).cpu().numpy()
            pairs.append(img.pairs)
    return {"frames": out, "pairs": pairs}


def leaf_gap(prog: dict, ref: dict, skip=()) -> float:
    """The worst leaf's |norm_prog - norm_ref| over max(norm_ref, the
    median leaf's norm_ref); infinite where a norm is not finite."""
    med = statistics.median(ref.values())
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300)
            for k in ref if k not in skip]
    return max(gaps) if np.isfinite(gaps).all() else float("inf")


def leaf_table(prog: dict, ref: dict) -> dict:
    """{leaf: [program, reference]} of the first gradient's and the
    change's norms, for the run's record."""
    return {f"{part}.{k}": [prog[part][k], ref[part][k]]
            for part in ("grad", "change") for k in ref[part]}


def train_numbers(prog: dict, ref: dict) -> dict:
    med = statistics.median(ref["grad"].values())
    still = [k for k, v in ref["grad"].items() if v < 1e-3 * med]
    return {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(prog["loss"], ref["loss"])),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
        "change_gap": leaf_gap(prog["change"], ref["change"], skip=still),
        "stats_gap": leaf_gap(prog["stats"], ref["stats"]),
    }


def tile_means(d: np.ndarray, tile: int = 16) -> np.ndarray:
    """The mean of [H, W, C] over each tile x tile block (edge blocks over
    the pixels they hold)."""
    h, w, c = d.shape
    hp, wp = -(-h // tile) * tile, -(-w // tile) * tile
    padded = np.full((hp, wp, c), np.nan)
    padded[:h, :w] = d
    return np.nanmean(padded.reshape(hp // tile, tile, wp // tile, tile, c),
                      axis=(1, 3, 4))


def serve_numbers(prog: dict, ref: dict) -> dict:
    tile = mean = 0.0
    for i, r in ref.items():
        d = np.abs(np.asarray(prog[i], np.float64) - r)
        tile = max(tile, float(tile_means(d).max()))
        mean = max(mean, float(d.mean()))
    return {"tile_gap": tile, "mean_abs": mean}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, checks


def mean_pairs(pairs: list) -> dict:
    return {k: float(np.mean([p[k] for p in pairs])) for k in pairs[0]}
