"""The general traffic generator. A traffic file (`traffic/<mix>.json`)
names its `kind` and its parameters; each kind is one closed loop over the
program's entry:

  train -- `Trainer.train_iteration` from `first_iteration`, one view a
           step in a seeded order of the configuration's views, the
           program's densification every `densification_interval`
           iterations. Set-up renders each view's ground truth from the
           field, then offsets the field's SH DC by the configuration's
           `sh_dc_offset` (the field to train back), and takes the first
           `warmup_steps` steps: the first `checked_steps` of them are the
           ones the reference follows.
  serve -- `render_video.render_frames`' frames one at a time: the left
           cameras' trajectory interpolated `n_interp` times between
           frames at each of the `augmentations` in turn, each frame
           rendered as `render_frames` renders it (forward only, under
           inference mode, the body of `render_novelview_image`) and its
           pixels brought to the host; set-up renders `warmup_frames`
           frames.

Both size the program's tile-instance capacities by a probe (at the
configuration's `probe_cap`) over every view they will render, at
`k_cap_margin` times the largest need. A step or
frame fails when it drops instances or its loss or pixels are not finite.
The window closes at the first step or frame that ends `seconds` after it
opened. With `trace`, more run under the profiler tracing the device
(`trace_units` steps holding no densification, on the checked steps'
views in turn; the checked frames again),
then `trace_host_units` more tracing the host too, for the names of the
idle gaps."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import inputs as inp, profile, program


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _peak_reset(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(dev) -> int:
    if torch.device(dev).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def _free(dev):
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def _open_window(dev) -> int:
    """Free what set-up left, keep the collector off the objects that live
    through the window (`gc.freeze`), synchronize, and reset the device's
    peak; returns set-up's peak."""
    _free(dev)
    gc.freeze()
    _sync(dev)
    peak = _peak(dev)
    _peak_reset(dev)
    return peak


def _spread_ms(seconds: list) -> dict:
    """Median, 90th percentile and largest of per-unit host times, in ms."""
    ms = sorted(1e3 * t for t in seconds)
    return {"median": ms[len(ms) // 2], "p90": ms[int(0.9 * (len(ms) - 1))],
            "max": ms[-1]}


def _norms(tensors: dict, n: int) -> dict:
    return {k: float(torch.linalg.norm(v[:n].double())) for k, v in tensors.items()}


LEAVES = ("means", "quats", "log_scales", "sh_dc", "sh_rest", "opacity_logit")


def _boxes(cfg: dict, seed: int, dev) -> tuple:
    """(box fields {instance: field}, poses {frame: {instance: matrix}}) of
    a configuration with vehicles; ({}, {}) without."""
    if not cfg.get("vehicles"):
        return {}, {}
    poses = inp.box_poses(cfg)
    insts = sorted(poses[0])
    return ({i: program.make_field(b) for i, b in
             zip(insts, inp.box_fields(cfg, seed, dev))}, poses)


def _box_instances(fields: dict, poses: dict, dev) -> list:
    from vegs_torch.render import BoxInstance

    return [BoxInstance(fields[i], torch.tensor(m, dtype=torch.float32,
                                                device=dev))
            for i, m in sorted(poses.items()) if i in fields]


def train(cfg: dict, tr: dict, seed: int, seconds: float, trace: bool, dev,
          t_start: float) -> dict:
    from vegs_torch.config import VegsConfig
    from vegs_torch.render import render, render_all
    from vegs_torch.train import Trainer

    program.build_kernels(dev)
    f_in = inp.synthetic_field(cfg, seed, dev)
    n = f_in.means.shape[0]
    poses = inp.street_poses(cfg)
    field = program.make_field(f_in)
    del f_in
    box_fields, box_poses = _boxes(cfg, seed, dev)
    scene = program.make_scene(cfg, poses, field, dev, box_fields, box_poses)
    cams = scene.getTrainCameras()
    views = [c.device_params(dev) for c in cams]
    normals = inp.normal_maps(cfg, seed, len(cams), dev)
    for c, nm in zip(cams, normals):
        c.normal = nm.cpu().numpy()
    del normals
    vcfg = VegsConfig()
    vcfg.opt.densification_interval = tr["densification_interval"]
    trainer = Trainer(vcfg, scene, raster_cfg=program.raster_config(cfg),
                      device=dev)
    if cfg.get("normal_init"):
        trainer.init_from_normals()

    def boxes_of(i):
        return _box_instances(box_fields, box_poses[cams[i].frame], dev)

    rcfg, need_raw, need_pad = program.size_capacities(
        cfg, field, views, tr["k_cap_margin"], cfg["probe_cap"],
        boxes_of if box_fields else None)
    with torch.inference_mode():
        fwd = rcfg._replace(forward_only=True)
        for i, (c, v) in enumerate(zip(cams, views)):
            if box_fields:
                out, _ = render_all(v, field, boxes_of(i), config=fwd)
            else:
                out = render(v, field, config=fwd)
            if int(out.num_dropped):
                raise RuntimeError("a ground-truth render dropped instances")
            c.image = torch.clamp(out.rgb, 0, 1).cpu().numpy()
    del out
    trainer.raster_cfg = rcfg
    with torch.no_grad():
        for f in [field, *box_fields.values()]:
            f.sh_dc += cfg["sh_dc_offset"]
    order = inp.permutation(seed, len(cams), dev)
    it0 = tr["first_iteration"]
    b1 = 0.9
    insts = sorted(box_fields)

    def step(k, view=None):
        view = order[k % len(cams)] if view is None else view
        return trainer.train_iteration(it0 + k, camera=cams[view])

    def state():
        """The program's leaves now: the static field's (its first n rows),
        the box fields' and the frames' residuals' (each leaf over all)."""
        out = {k: getattr(trainer.state.field, k).detach()[:n].clone()
               for k in LEAVES}
        for k in LEAVES if insts else ():
            out["box." + k] = [getattr(trainer.box_fields[i], k).detach().clone()
                               for i in insts]
        return out

    def change(p0, p1) -> dict:
        out = {}
        for k, v in p0.items():
            pairs = zip(v, p1[k]) if isinstance(v, list) else [(v, p1[k])]
            out[k] = float(torch.sqrt(sum(((b - a).double() ** 2).sum()
                                          for a, b in pairs)))
        return out

    p0 = state()
    checked = {"loss": [], "views": order[:tr["checked_steps"]]}
    for k in range(tr["warmup_steps"]):
        m = step(k)
        if k < tr["checked_steps"]:
            checked["loss"].append(m["loss"])
        if k == 0:
            mu = trainer.state.opt["mu"]
            g = {key: float(torch.linalg.norm(mu[key][:n].double())) / (1 - b1)
                 for key in LEAVES}
            if insts:
                for key in LEAVES:
                    g["box." + key] = float(torch.sqrt(sum(
                        (trainer.box_opts[i]["mu"][key].double() ** 2).sum()
                        for i in insts))) / (1 - b1)
                frame = cams[order[0]].frame
                for key in ("delta_r", "delta_s", "delta_t"):
                    g["delta." + key] = float(torch.sqrt(sum(
                        (trainer.frame_delta_opts[(frame, i)].mu[key].double()
                         ** 2).sum() for i in insts))) / (1 - b1)
            checked["grad"] = g
        if k == tr["checked_steps"] - 1:
            now = state()
            checked["nonfinite"] = sum(
                int((~torch.isfinite(t)).sum()) for v in now.values()
                for t in (v if isinstance(v, list) else [v]))
            ch = change(p0, now)
            if insts:
                for key in ("delta_r", "delta_s", "delta_t"):
                    ident = {"delta_r": torch.tensor([1.0, 0, 0, 0], device=dev),
                             "delta_s": torch.ones(3, device=dev),
                             "delta_t": torch.zeros(3, device=dev)}[key]
                    ch["delta." + key] = float(torch.sqrt(sum(
                        ((getattr(d, key) - ident).double() ** 2).sum()
                        for d in trainer.frame_deltas.values())))
            checked["change"] = ch
            st = trainer.state.stats
            checked["stats"] = _norms({"accum": st.xyz_gradient_accum,
                                       "denom": st.denom}, n)
            del p0
    setup_peak = _open_window(dev)
    setup_s = time.perf_counter() - t_start

    k = tr["warmup_steps"]
    attempted = failed = 0
    times, densify_ms = [], []
    t0 = t1 = time.perf_counter()
    while True:
        m = step(k)
        t2 = time.perf_counter()
        attempted += 1
        if (it0 + k) % tr["densification_interval"] == 0:
            densify_ms.append(1e3 * (t2 - t1))
        else:
            times.append(t2 - t1)
        failed += int(m["num_dropped"] > 0 or not np.isfinite(m["loss"]))
        k += 1
        t1 = t2
        if t2 - t0 >= seconds:
            break
    _sync(dev)
    elapsed = time.perf_counter() - t0
    peak = _peak(dev)
    res = {"kind": "train", "setup_s": setup_s, "attempted": attempted,
           "failed": failed, "elapsed_s": elapsed, "window_peak": peak,
           "step_ms": _spread_ms(times), "densify_ms": densify_ms,
           "k_cap": rcfg.k_cap, "k_pad": rcfg.k_pad,
           "need_raw": need_raw, "need_pad": need_pad, "n": n,
           "checked": checked, "capacity": int(trainer.state.field.capacity)}
    if trace:
        units, host_units = tr["trace_units"], tr["trace_host_units"]
        every = tr["densification_interval"]
        while any((it0 + k + i) % every == 0 for i in range(units + host_units)):
            step(k)  # the traced steps hold no densification
            k += 1
        seen = checked["views"]  # the views whose pairs the reference counts
        res["trace"] = profile.record(
            lambda: [step(k + i, seen[i % len(seen)]) for i in range(units)], dev)
        res["host_trace"] = profile.record(
            lambda: [step(k + units + i) for i in range(host_units)], dev,
            host=True)
        res["trace_units"] = units
    res["program_peak"] = max(setup_peak, _peak(dev))
    del trainer, scene, field, cams, views
    _free(dev)
    return res


def serve(cfg: dict, tr: dict, seed: int, seconds: float, trace: bool, dev,
          t_start: float) -> dict:
    from vegs_torch import render_video
    from vegs_torch.scene.cameras import make_camera_like_input_camera

    program.build_kernels(dev)
    f_in = inp.synthetic_field(cfg, seed, dev)
    n = f_in.means.shape[0]
    poses = inp.street_poses(cfg)
    field = program.make_field(f_in)
    del f_in
    box_fields, box_poses = _boxes(cfg, seed, dev)
    scene = program.make_scene(cfg, poses, field, dev, box_fields, box_poses)
    if cfg.get("normal_init"):
        from vegs_torch.priors import norminit

        cams = scene.getTrainCameras()
        for c, nm in zip(cams, inp.normal_maps(cfg, seed, len(cams), dev)):
            c.normal = nm.cpu().numpy()
        norminit.initialize_gaussians_with_window_normals(field, cams)
    left = sorted((c for c, p in zip(scene.getTrainCameras(), poses)
                   if p.eye == 0), key=lambda c: c.frame)
    traj = render_video.interpolate_cameras(left, tr["n_interp"])
    timeline = (render_video.interpolate_bboxes(
        box_poses, [c.frame for c in left], tr["n_interp"]) if box_fields
        else [{} for _ in traj])
    augs = tr["augmentations"]
    frames = [(a, c, b) for a in augs for c, b in zip(traj, timeline)]
    views = [make_camera_like_input_camera(c, **a).device_params(dev)
             for a, c, _ in frames]
    rcfg, need_raw, need_pad = program.size_capacities(
        cfg, field, views, tr["k_cap_margin"], cfg["probe_cap"],
        (lambda i: _box_instances(box_fields, frames[i][2], dev))
        if box_fields else None)
    rcfg = rcfg._replace(forward_only=True)  # as render_frames sets it
    del views
    bg = torch.zeros(3, device=dev)

    def frame(i):
        """render_novelview_image's body, under render_frames' inference
        mode: the frame's pixels on the host and its dropped instances."""
        a, c, b = frames[i % len(frames)]
        with torch.inference_mode():
            out = render_video._render_view(
                scene, make_camera_like_input_camera(c, **a), b, rcfg, bg)
            img = torch.clamp(out.rgb.detach(), 0, 1).permute(1, 2, 0).cpu().numpy()
        return img, int(out.num_dropped)

    sample = inp.draw(seed, tr["checked_frames"], len(augs), len(traj), dev)
    kept = {}
    for i in range(tr["warmup_frames"]):
        frame(i * len(traj))
    setup_peak = _open_window(dev)
    setup_s = time.perf_counter() - t_start

    lat, bad = [], 0
    i = 0
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        img, dropped = frame(i)
        t2 = time.perf_counter()
        lat.append(t2 - t1)
        if i < len(frames) and i in sample:
            kept[i] = img
        bad += int(dropped > 0 or not np.isfinite(img).all())
        i += 1
        if t2 - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    peak = _peak(dev)
    for j in sample:  # sampled frames the window did not reach
        if j not in kept:
            kept[j] = frame(j)[0]
    res = {"kind": "serve", "setup_s": setup_s, "attempted": len(lat),
           "failed": bad, "elapsed_s": elapsed, "latencies_s": lat,
           "window_peak": peak, "frame_ms": _spread_ms(lat),
           "k_cap": rcfg.k_cap, "k_pad": rcfg.k_pad, "need_raw": need_raw,
           "need_pad": need_pad, "n": n, "frames_per_loop": len(frames),
           "checked": {"frames": kept}}
    if trace:  # the checked frames, whose pairs the reference counts
        res["trace"] = profile.record(lambda: [frame(j) for j in sample], dev)
        res["host_trace"] = profile.record(
            lambda: [frame(i + j) for j in range(tr["trace_host_units"])],
            dev, host=True)
        res["trace_units"] = len(sample)
    res["program_peak"] = max(setup_peak, _peak(dev))
    del scene, field, box_fields, traj, frames
    _free(dev)
    return res


KINDS = {"train": train, "serve": serve}
