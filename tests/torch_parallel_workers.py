"""Rank bodies for the port's multi-process tests (tests/test_torch_parallel*.py).

Every function here runs in a rank that `vegs_torch.parallel.launch.spawn`
started: it imports torch and the port, never JAX (the test files compute
the JAX side in the parent and hand both sides numpy arrays through a file
of `torch.save`). Each returns numpy results, which `spawn` gives back in
rank order. This module is not collected by pytest (its name does not
start with test_).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from vegs_torch import convert, optim
from vegs_torch.gaussians import DensifyStats
from vegs_torch.ops.rasterize import RasterizeConfig, rasterize
from vegs_torch.parallel import comm as C
from vegs_torch.parallel.gauss_sharded import (make_gauss_mesh,
                                               make_gauss_sharded_rasterize,
                                               shard_field_arrays)
from vegs_torch.parallel.mesh import make_grid_mesh, make_mesh
from vegs_torch.parallel.tile_sharded import (make_tile_mesh,
                                              make_tile_sharded_rasterize)


def load(path) -> dict:
    return torch.load(path, weights_only=False)


def camera(d: dict):
    return convert.camera_params_from_numpy(
        d["viewmatrix"], d["projmatrix"], d["campos"], d["tan_fovx"],
        d["tan_fovy"], d["height"], d["width"], device="cpu")


def tensors(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def npy(t):
    return t.detach().cpu().numpy()


# -- collectives, closed forms ---------------------------------------------------
def collectives(rank: int) -> dict:
    world = dist.get_world_size()
    comm = make_mesh().comm()
    r = float(rank)
    out = {
        "psum": npy(C.psum(torch.tensor([r, 1.0]), comm)),
        "psum_mean": npy(C.psum_mean(torch.tensor([r]), comm)),
        "pmax": npy(C.pmax(torch.tensor([-r, r], dtype=torch.int32), comm)),
        "broadcast": npy(C.broadcast(torch.tensor([r + 5.0]), comm, src=1)),
        "tree": {k: npy(v) for k, v in C.psum_tree(
            {"a": torch.full((2, 2), r), "b": torch.tensor(3.0),
             "c": torch.tensor([rank], dtype=torch.int32)}, comm).items()},
        "transport": comm.transport("cpu"),
    }
    # all_gather: x_r = (r+1) * [1, 2, 3]; loss = sum(w * gathered) with
    # the same w on every rank -> dL/dx_r = world * w[r-th slice]
    x = (torch.arange(1.0, 4.0) * (r + 1)).reshape(3, 1).requires_grad_(True)
    g = C.all_gather(x, comm, dim=0)
    w = torch.arange(1.0, 3.0 * world + 1).reshape(-1, 1)
    (w * g).sum().backward()
    out["gather"], out["gather_grad"] = npy(g), npy(x.grad)
    # all_to_all: row block d of x_r goes to rank d; rows carry 10 r + d
    y = torch.tensor([[10 * r + d] for d in range(world)],
                     requires_grad=True)
    z = C.all_to_all(y, comm)
    (z * torch.arange(1.0, world + 1).reshape(-1, 1) * (r + 1)).sum().backward()
    out["a2a"], out["a2a_grad"] = npy(z), npy(y.grad)
    # the 2 x (world / 2) grid's groups
    if world == 4:
        m = make_grid_mesh(("data", "shard"), (2, 2))
        out["grid"] = {a: (m.comm(a).ranks, m.index(a),
                           npy(C.psum(torch.tensor([r]), m.comm(a))))
                       for a in ("data", "shard")}
    return out


# -- sharded renders ------------------------------------------------------------
def renders(rank: int, path: str) -> dict:
    """The gauss- and tile-sharded renders against the port's `rasterize`
    (equal to the bit), the tile-sharded gradient of mean(rgb^2), and the
    exchange's drops with a small k_exch."""
    inp = load(path)
    world = dist.get_world_size()
    cam = camera(inp["cam"])
    arrs = tensors(*inp["gaussians"])
    valid = torch.ones(arrs[0].shape[0], dtype=torch.bool)
    bg = torch.tensor(inp["bg"])
    cfg = RasterizeConfig(k_cap=inp["k_cap"])
    ref = rasterize(*arrs, cam, bg=bg, config=cfg)
    out = {"ref": {k: npy(getattr(ref, k)) for k in ("rgb", "depth",
                                                      "alpha")}}
    if world > 1:
        gm = make_gauss_mesh(world)
        rgb, depth, alpha = make_gauss_sharded_rasterize(gm, cam, cfg)(
            *shard_field_arrays(gm, *arrs, valid), bg)
        out["gauss"] = {"rgb": npy(rgb), "depth": npy(depth),
                        "alpha": npy(alpha)}
    tm = make_tile_mesh(world)
    shards = shard_field_arrays(tm, *arrs, valid)
    means = shards[0].clone().requires_grad_(True)
    rgb, depth, alpha, dropped = make_tile_sharded_rasterize(tm, cam, cfg)(
        means, *shards[1:], bg)
    out["tile"] = {"rgb": npy(rgb), "depth": npy(depth), "alpha": npy(alpha),
                   "dropped": int(dropped)}
    (rgb ** 2).mean().backward()
    # every rank takes the loss of the whole image: D copies come back
    out["tile_grad"] = npy(means.grad) / world
    m_ref = arrs[0].clone().requires_grad_(True)
    (rasterize(m_ref, *arrs[1:], cam, bg=bg, config=cfg).rgb ** 2
     ).mean().backward()
    out["ref_grad"] = npy(shard_field_arrays(tm, m_ref.grad)[0])
    if "drop_case" in inp:
        dc = inp["drop_case"]
        arrs2 = tensors(*dc["gaussians"])
        valid2 = torch.ones(arrs2[0].shape[0], dtype=torch.bool)
        cam2 = camera(dc["cam"])
        rgb, _, _, dropped = make_tile_sharded_rasterize(
            tm, cam2, RasterizeConfig(k_cap=dc["k_cap"]),
            k_exch=dc["k_exch"])(*shard_field_arrays(tm, *arrs2, valid2),
                                 torch.zeros(3))
        out["drop_case"] = {"dropped": int(dropped),
                            "finite": bool(torch.isfinite(rgb).all())}
    return out


def fail_on_rank_one(rank: int) -> None:
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()


# -- data-parallel steps and the Trainer -----------------------------------------
def scene_info(readers, seed=0, n_pts=150, n_cams=6):
    """The toy scene of tests/test_torch_train.py (150 points, 5 train + 1
    test cameras at 48x64), through either package's readers."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32) * 0.8
    cols = rng.uniform(0.2, 0.8, (n_pts, 3)).astype(np.float32)
    pcd = readers.BasicPointCloud(pts, cols)
    cams = readers.generateRandomCameras(n_cams, camera_distance=4.0,
                                         width=64, height=48)
    return readers.SceneInfo(
        point_cloud=pcd, train_cameras=cams[:-1], test_cameras=cams[-1:],
        nerf_normalization=readers.getNerfppNorm(cams, pcd), ply_path="")


def field_numpy(f) -> dict:
    return convert.field_to_numpy(f)


def adam_numpy(o) -> dict:
    return {m: {k: npy(v) for k, v in o[m].items()} for m in ("mu", "nu")}


def stats_numpy(st) -> dict:
    return {k: npy(getattr(st, k)) for k in convert.STATS_KEYS}


def replicated_checksums(comm, tensors_) -> np.ndarray:
    """Every rank's checksum of `tensors_`, all-gathered: [D, 2]."""
    return npy(C.all_gather(C.checksum(tensors_)[None], comm))


def state_tensors(field, opt) -> list:
    return ([getattr(field, k) for k in optim.PARAM_LEAVES]
            + [opt[m][k] for m in ("mu", "nu") for k in optim.PARAM_LEAVES])


def dp_steps(rank: int, path: str) -> dict:
    from vegs_torch.boxmodel import BoxDeltas
    from vegs_torch.config import ModelParams, VegsConfig
    from vegs_torch.scene import Scene, dataset_readers
    from vegs_torch.train import BoxStep, TrainState, Trainer, train_step

    inp = load(path)
    comm = make_mesh().comm()
    out = {}

    # (a) the static DP step: train_step with this rank's camera
    a = inp["dp"]
    field = convert.field_from_numpy(a["field"], device="cpu")
    state = TrainState(field=field, opt=optim.adam_init(field),
                       stats=DensifyStats.zeros(field.capacity, "cpu"), step=0)
    cfg = VegsConfig()
    raster = RasterizeConfig(k_cap=a["k_cap"], payload_dtype="f32")
    state, m, _ = train_step(
        state, camera(a["cams"][rank]), torch.from_numpy(a["gt"][rank]),
        torch.from_numpy(a["normal"][rank]), 1.0, 3, torch.tensor(a["bg"]),
        opt_cfg=cfg.opt, raster_cfg=raster, spatial_scale=4.0, comm=comm)
    out["dp"] = {"field": field_numpy(state.field),
                 "opt": adam_numpy(state.opt),
                 "stats": stats_numpy(state.stats), "step": state.step,
                 "loss": float(m["loss"]), "l1": float(m["l1"]),
                 "checksums": replicated_checksums(
                     comm, state_tensors(state.field, state.opt))}

    # (b) the full-model step, data parallel, with box slots
    b = inp["box"]
    field = convert.field_from_numpy(b["field"], device="cpu")
    state = TrainState(field=field, opt=optim.adam_init(field),
                       stats=DensifyStats.zeros(field.capacity, "cpu"), step=0)
    steps = []
    for i, bf in enumerate(b["box_fields"]):
        bfield = convert.field_from_numpy(bf, device="cpu")
        d = BoxDeltas.identity("cpu")
        steps.append(BoxStep(
            field=bfield, opt=optim.adam_init(bfield),
            stats=DensifyStats.zeros(bfield.capacity, "cpu"),
            box2world=torch.from_numpy(b["b2w"][rank, i]), deltas=d,
            delta_opt=optim.adam_init(d.as_dict()),
            active=bool(b["active"][rank, i])))
    state, m, stepped = train_step(
        state, camera(b["cams"][rank]), torch.from_numpy(b["gt"][rank]),
        torch.from_numpy(b["normal"][rank]), float(b["normal_valid"][rank]),
        3, torch.tensor(b["bg"]), opt_cfg=cfg.opt,
        raster_cfg=RasterizeConfig(k_cap=b["k_cap"], payload_dtype="f32"),
        spatial_scale=4.0, boxes=steps, box_cfg=cfg.box, comm=comm)
    out["box"] = {
        "field": field_numpy(state.field), "opt": adam_numpy(state.opt),
        "stats": stats_numpy(state.stats),
        "boxes": [{"field": field_numpy(s.field), "opt": adam_numpy(s.opt),
                   "stats": stats_numpy(s.stats),
                   "deltas": {k: npy(v) for k, v in s.deltas.as_dict().items()}}
                  for s in stepped],
        "metrics": {k: float(v) for k, v in m.items()}}

    # (c) Trainer(dp_devices=2): 4 iterations, a densify event at the 4th
    c = inp["trainer"]

    def trainer(**kw):
        tcfg = convert.config_from_dict(c["cfg"])
        sc = Scene(ModelParams(), scene_info=scene_info(dataset_readers),
                   shuffle=False, device="cpu")
        for cam, img in zip(sc.train_cameras + sc.test_cameras, c["images"]):
            cam.image = img
        tr = Trainer(tcfg, sc, raster_cfg=RasterizeConfig(k_cap=c["k_cap"]),
                     device="cpu", **kw)
        tr.state = convert.train_state_from_numpy(c["state"], device="cpu")
        sc.gaussians = tr.state.field
        return tr, sc

    tr, _ = trainer(dp_devices=comm.size)
    losses = []
    for it in range(1, 5):
        if it == 4:
            tr.cfg.opt.densify_grad_threshold = c["threshold"]
        losses.append(tr.train_iteration(it)["loss"])
    out["trainer"] = {
        "losses": losses, "state": convert.train_state_to_numpy(tr.state),
        "extent": tr.spatial_scale,
        "checksums": replicated_checksums(
            comm, state_tensors(tr.state.field, tr.state.opt)
            + [getattr(tr.state.stats, k) for k in convert.STATS_KEYS])}

    # (d) an explicit camera, repeated over the ranks, against the
    # single-device step on the same state
    tr_dp, sc = trainer(dp_devices=comm.size)
    tr_1, sc1 = trainer()
    m_dp = tr_dp.train_iteration(1, camera=sc.train_cameras[0])
    m_1 = tr_1.train_iteration(1, camera=sc1.train_cameras[0])
    out["explicit"] = {
        "dp": convert.train_state_to_numpy(tr_dp.state),
        "single": convert.train_state_to_numpy(tr_1.state),
        "loss": (m_dp["loss"], m_1["loss"])}
    return out


# -- the fully sharded trainer ---------------------------------------------------
def _sharded_start(mesh, f_np):
    from vegs_torch.parallel.tp_trainer import shard_train_state

    field = convert.field_from_numpy(f_np, device="cpu")
    return shard_train_state(mesh, field, optim.adam_init(field),
                             DensifyStats.zeros(field.capacity, "cpu"))


def _block(field, opt, stats) -> dict:
    return {"field": field_numpy(field), "opt": adam_numpy(opt),
            "stats": stats_numpy(stats)}


def tp_steps(rank: int, path: str) -> dict:
    """The TP step, tp_densify_and_prune and the TP-full step with boxes on
    a 1-D shard mesh; each returns this rank's row blocks."""
    from vegs_torch.boxmodel import BoxDeltas
    from vegs_torch.config import VegsConfig
    from vegs_torch.parallel.tp_trainer import (make_tp_full_train_step,
                                                make_tp_train_step,
                                                shard_field, shard_train_state,
                                                tp_densify_and_prune)

    inp = load(path)
    mesh = make_tile_mesh(dist.get_world_size())
    cfg = VegsConfig()
    out = {}

    a = inp["tp"]
    raster = RasterizeConfig(k_cap=a["k_cap"], payload_dtype="f32")
    cam = camera(a["cam"])
    f, o, s = _sharded_start(mesh, a["field"])
    step = make_tp_train_step(mesh, cfg.opt, raster, 4.0, cam,
                              use_normal_loss=True)
    f, o, s, n, m = step(f, o, s, 0, cam, torch.from_numpy(a["gt"]),
                         torch.from_numpy(a["normal"]), 3,
                         torch.tensor(a["bg"]))
    out["tp"] = {**_block(f, o, s),
                 "metrics": {k: float(v) for k, v in m.items()}}

    d = inp["densify"]
    field = convert.field_from_numpy(d["field"], device="cpu")
    stats = DensifyStats(*[torch.from_numpy(d["stats"][k])
                           for k in convert.STATS_KEYS])
    sf, so, ss = shard_train_state(mesh, field, optim.adam_init(field), stats)
    g = torch.Generator().manual_seed(5)
    nf, _, _, n_total = tp_densify_and_prune(mesh, sf, so, ss, g, **d["kw"])
    out["densify"] = {"n": n_total, "capacity": nf.capacity,
                      "means": npy(nf.means), "valid": npy(nf.valid)}

    b = inp["full"]
    f, o, s = _sharded_start(mesh, b["field"])
    bfields, bopts, bstats = [], [], []
    for bf in b["box_fields"]:
        full = convert.field_from_numpy(bf, device="cpu")
        c = mesh.comm()
        part = shard_field(full, c.index, c.size)
        bfields.append(part)
        bopts.append(optim.adam_init(part))
        bstats.append(DensifyStats.zeros(part.capacity, "cpu"))
    S = len(bfields)
    ident = BoxDeltas.identity("cpu")
    deltas = BoxDeltas(**{k: v.expand(S, -1).clone()
                          for k, v in ident.as_dict().items()})
    step = make_tp_full_train_step(
        mesh, cfg.opt, raster, 4.0, cam, use_normal_loss=True,
        n_box_slots=S, box_lr_mult=cfg.opt.box_lr_mult,
        boxmodel_lr=cfg.box.boxmodel_lr,
        boxmodel_lambda_reg=cfg.box.boxmodel_lambda_reg)
    res = step(f, o, s, 0, bfields, bopts, bstats, deltas,
               optim.adam_init(deltas.as_dict()),
               torch.from_numpy(b["b2w"]), torch.from_numpy(b["active"]),
               cam, torch.from_numpy(a["gt"]), torch.from_numpy(a["normal"]),
               1.0, 3, torch.tensor(a["bg"]))
    f, o, s, _, bf2, bo2, bs2, dl2, _, m = res
    out["full"] = {**_block(f, o, s),
                   "boxes": [_block(*x) for x in zip(bf2, bo2, bs2)],
                   "deltas": {k: npy(v) for k, v in dl2.as_dict().items()},
                   "metrics": {k: float(v) for k, v in m.items()}}
    return out


def dptp_step(rank: int, path: str) -> dict:
    """The (data 2, shard 2) hybrid step; this rank's row blocks."""
    from vegs_torch.config import VegsConfig
    from vegs_torch.parallel.sharded_step import stack_camera_batch
    from vegs_torch.parallel.tp_trainer import (make_dp_mesh_2d,
                                                make_dp_tp_train_step)

    inp = load(path)
    mesh = make_dp_mesh_2d(2, 2)
    cams = [camera(c) for c in inp["cams"]]
    f, o, s = _sharded_start(mesh, inp["field"])
    step = make_dp_tp_train_step(
        mesh, VegsConfig().opt,
        RasterizeConfig(k_cap=inp["k_cap"], payload_dtype="f32"), 4.0,
        cams[0])
    f, o, s, _, m = step(f, o, s, 0, stack_camera_batch(cams),
                         torch.from_numpy(inp["gt"]),
                         torch.from_numpy(inp["normal"]), 3,
                         torch.tensor(inp["bg"]))
    return {**_block(f, o, s), "data": mesh.index("data"),
            "shard": mesh.index("shard"),
            "metrics": {k: float(v) for k, v in m.items()}}


# -- on the card -------------------------------------------------------------
def gpu_sharded(rank: int, backend: str) -> dict:
    """On the card, at 128x512 with 50k Gaussians: the gauss- and
    tile-sharded renders against `rasterize` (with its sat cull), and one
    TP step's Adam first moments on this rank's rows against one
    single-device step's (relative L2 per leaf). `backend` "nccl": rank r
    on card r; "gloo": every rank on card 0 (gloo-host)."""
    from vegs_torch.config import VegsConfig
    from vegs_torch.gaussians import GaussianField
    from vegs_torch.ops.rasterize import stage
    from vegs_torch.parallel.tp_trainer import (make_tp_train_step,
                                                shard_train_state)
    from vegs_torch.perf.refscale import origin_camera, random_gaussians
    from vegs_torch.render import field_arrays
    from vegs_torch.train import TrainState, train_step

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    world = dist.get_world_size()
    rng = np.random.default_rng(0)
    means, quats, scales, opac, shs = random_gaussians(
        rng, 50_000, (1.5, 10.0), 3.0, (0.03, 0.3), (0.3, 0.95))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    field = GaussianField(
        means=t(means), quats=t(quats), log_scales=t(np.log(scales)),
        sh_dc=t(shs[:, :1]), sh_rest=t(shs[:, 1:]),
        opacity_logit=t(np.log(opac / (1 - opac))[:, None]),
        valid=torch.ones(50_000, dtype=torch.bool, device=dev))
    cam = origin_camera(128, 512, 1.0, 0.3, dev)
    a = field_arrays(field, 3)
    probe = RasterizeConfig(k_cap=1 << 21, k_pad=1 << 21, forward_only=True)
    with torch.no_grad():
        st = stage(*a[:5], cam, valid=a.valid,
                   config=probe._replace(sat_cull=True))
        st_off = stage(*a[:5], cam, valid=a.valid,
                       config=probe._replace(sat_cull=False))
    r512 = lambda v: (int(v * 1.05) + 511) // 512 * 512
    cfg = RasterizeConfig(k_cap=r512(int(st.rb.total) * world),
                          k_pad=r512(int(st.binned.tile_starts[-1])))
    with torch.no_grad():
        ref = rasterize(*a[:5], cam, valid=a.valid,
                        config=cfg._replace(forward_only=True, sat_cull=True))
        gm, tm = make_gauss_mesh(world), make_tile_mesh(world)
        rcfg = cfg._replace(k_pad=r512(int(st_off.binned.tile_starts[-1])))
        g = make_gauss_sharded_rasterize(gm, cam, rcfg)(
            *shard_field_arrays(gm, *a), torch.zeros(3, device=dev))
        tr = make_tile_sharded_rasterize(tm, cam, rcfg)(
            *shard_field_arrays(tm, *a), torch.zeros(3, device=dev))
    names = ("rgb", "depth", "alpha")
    out = {"sat_cull": st.sat_counts is not None,
           "gauss": [bool(torch.equal(x, getattr(ref, k)))
                     for k, x in zip(names, g)],
           "tile": [bool(torch.equal(x, getattr(ref, k)))
                    for k, x in zip(names, tr[:3])],
           "tile_dropped": int(tr[3]),
           "transport": tm.comm().transport(dev)}

    cfg_t = VegsConfig()
    gt = torch.clamp(ref.rgb.detach() * 0.8 + 0.1, 0, 1)
    nm = torch.zeros_like(gt)
    bg = torch.zeros(3, device=dev)
    clone = lambda: GaussianField(valid=field.valid.clone(), **{
        k: getattr(field, k).detach().clone() for k in optim.PARAM_LEAVES})
    one = clone()
    s1 = TrainState(field=one, opt=optim.adam_init(one),
                    stats=DensifyStats.zeros(one.capacity, dev), step=0)
    s1, m1, _ = train_step(s1, cam, gt, nm, 0.0, 3, bg, opt_cfg=cfg_t.opt,
                           raster_cfg=cfg, spatial_scale=5.0)
    f, o, s = shard_train_state(tm, clone(), optim.adam_init(field),
                                DensifyStats.zeros(field.capacity, dev))
    tp = make_tp_train_step(tm, cfg_t.opt, cfg, 5.0, cam)
    f, o, s, _, m = tp(f, o, s, 0, cam, gt, nm, 3, bg)
    n = f.capacity
    rows = slice(tm.comm().index * n, (tm.comm().index + 1) * n)

    def gap(a_, b_):
        return float((a_.double() - b_.double()).norm()
                     / b_.double().norm().clamp(min=1e-300))

    out["tp_mu_gap"] = max(gap(o["mu"][k], s1.opt["mu"][k][rows])
                           for k in optim.PARAM_LEAVES)
    out["tp_loss"], out["loss"] = float(m["loss"]), float(m1["loss"])
    out["tp_dropped"] = int(m["num_dropped"])
    out["denom_equal"] = bool(torch.equal(s.denom, s1.stats.denom[rows]))
    return out


def tp_full_extras(rank: int, path: str) -> dict:
    """The TP-full step with a box, the guidance term (the tiny diffusion
    stack, draws fixed) and the perceptual term (VGG16, seed 0) on a
    2-rank shard axis, and the single-device `train_step` with the same
    terms on the whole field in this rank: Adam's first moments of this
    rank's static rows and of the residual, both ways."""
    from vegs_torch.boxmodel import BoxDeltas
    from vegs_torch.config import VegsConfig
    from vegs_torch.diffusion.pipeline import DiffusionModels
    from vegs_torch.losses import vgg as vgg_lib
    from vegs_torch.losses.sd_guidance import SDGuidance
    from vegs_torch.parallel.tp_trainer import (make_tp_full_train_step,
                                                shard_field)
    from vegs_torch.train import (BoxStep, GuidedView, Perceptual, TrainState,
                                  train_step)

    inp = load(path)
    mesh = make_tile_mesh(dist.get_world_size())
    c = mesh.comm()
    cfg = VegsConfig()
    raster = RasterizeConfig(k_cap=inp["k_cap"], payload_dtype="f32")
    cam, aug = camera(inp["cam"]), camera(inp["aug_cam"])
    gt, nm = torch.from_numpy(inp["gt"]), torch.from_numpy(inp["normal"])
    bg = torch.tensor(inp["bg"])
    g = torch.Generator().manual_seed(0)
    guidance = SDGuidance(DiffusionModels.tiny(g), guidance_mode="sds",
                          start_iter=0, max_iters=30, max_step=50)
    vgg = vgg_lib.init_params(torch.Generator().manual_seed(0))
    vgg.requires_grad_(False)
    h = aug.height
    draws = guidance.draw(guidance.latent_shape(torch.empty(3, h, h)), 0,
                          torch.Generator().manual_seed(1))
    guided = GuidedView(guidance, aug, inp["crop_start"], draws=draws)
    lam = 0.5

    field = convert.field_from_numpy(inp["field"], device="cpu")
    bfull = convert.field_from_numpy(inp["box_field"], device="cpu")
    b2w = torch.from_numpy(inp["b2w"])

    # the single-device step on the whole field
    f1 = shard_field(field, 0, 1)
    b1 = shard_field(bfull, 0, 1)
    d1 = BoxDeltas.identity("cpu")
    s1 = TrainState(field=f1, opt=optim.adam_init(f1),
                    stats=DensifyStats.zeros(f1.capacity, "cpu"), step=0)
    s1, m1, boxes1 = train_step(
        s1, cam, gt, nm, 1.0, 3, bg, opt_cfg=cfg.opt, raster_cfg=raster,
        spatial_scale=4.0, boxes=[BoxStep(
            field=b1, opt=optim.adam_init(b1),
            stats=DensifyStats.zeros(b1.capacity, "cpu"), box2world=b2w,
            deltas=d1, delta_opt=optim.adam_init(d1.as_dict()))],
        box_cfg=cfg.box, guidance=guided, perceptual=Perceptual(vgg, lam))

    # the TP-full step on this rank's rows
    fs = shard_field(field, c.index, c.size)
    bs = shard_field(bfull, c.index, c.size)
    ident = BoxDeltas.identity("cpu")
    deltas = BoxDeltas(**{k: v[None].clone()
                          for k, v in ident.as_dict().items()})
    step = make_tp_full_train_step(
        mesh, cfg.opt, raster, 4.0, cam, use_normal_loss=True,
        n_box_slots=1, box_lr_mult=cfg.opt.box_lr_mult,
        boxmodel_lr=cfg.box.boxmodel_lr,
        boxmodel_lambda_reg=cfg.box.boxmodel_lambda_reg, guidance=guidance,
        aug_cam=aug, perceptual_lam=lam)
    res = step(fs, optim.adam_init(fs), DensifyStats.zeros(fs.capacity, "cpu"),
               0, [bs], [optim.adam_init(bs)],
               [DensifyStats.zeros(bs.capacity, "cpu")], deltas,
               optim.adam_init(deltas.as_dict()), b2w[None],
               torch.tensor([True]), cam, gt, nm, 1.0, 3, bg,
               extras={"guided": guided, "vgg": vgg})
    fo, m = res[1], res[-1]
    n = fs.capacity
    rows = slice(c.index * n, (c.index + 1) * n)
    return {"tp_mu": {k: npy(v) for k, v in fo["mu"].items()},
            "one_mu": {k: npy(v[rows]) for k, v in s1.opt["mu"].items()},
            "tp_deltas": {k: npy(v[0]) for k, v in res[7].as_dict().items()},
            "one_deltas": {k: npy(v) for k, v in
                           boxes1[0].deltas.as_dict().items()},
            "tp_metrics": {k: float(v) for k, v in m.items()},
            "one_metrics": {k: float(v) for k, v in m1.items()}}


# -- the TP quality harness ------------------------------------------------------
def tp_state_blocks(mesh, scene, spec, last) -> dict:
    """`quality_tp.run_tp`'s `after` hook: this rank's row blocks of the
    field, its Adam first moments and the box field, and the replicated
    residual of every frame, as numpy."""
    return {"field": field_numpy(last["field"]),
            "mu": {k: npy(v) for k, v in last["opt"]["mu"].items()},
            "box_field": field_numpy(last["bfield"]),
            "deltas": {f: {k: npy(v[0]) for k, v in d.as_dict().items()}
                       for f, (d, _) in last["deltas_by_frame"].items()}}
