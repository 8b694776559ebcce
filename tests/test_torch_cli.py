"""The port's training CLI (`vegs_torch.train.main`, `config.parse_config`)
against vegs_tpu's.

  * `parse_config` gives the JAX config on the same argv: defaults, flags
    of every group and type, unknown flags passed over (parse_known_args),
    and a `--config` JSON whose values a flag overrides only when it
    differs from the field's default. `cfg_args.json` written by either
    package loads in the other.
  * `main` on the toy KITTI-360 root of tests/test_torch_loaders.py (one
    vehicle box; 4 frames of 48x64 stereo; --eval, 6 iterations, a
    checkpoint at 3, a report at 6, --data_parallel 1, k_cap 8192,
    densification off) against the JAX `main` on the same flags (the JAX
    one on its dense backend, the port on its tile path: the plain
    versions of K1-K4): the same metrics.jsonl keys, the report's PSNR
    within 1e-3 dB, and every column of the final static and instance
    PLYs of iteration 6 within 1e-4 (float32 sums in another order through
    the normal init and six Adam steps; measured: 1.2e-5 at most, on the
    box's colour and opacity). The JAX run takes ~90 s of this file, half
    of it the report's eager renders.
  * The port resumed from the checkpoint at 3 (--start_checkpoint 3)
    restores every leaf of the checkpoint to the bit and reaches 6.
  * What `main` refuses instead of skipping: a multi-host run without all
    of --coordinator_address, --num_processes and --process_id, and no
    card without device="cpu". (--data_parallel 2 runs since the parallel
    slice: tests/test_torch_parallel_cli.py.)
    (A set VEGS_SD_CHECKPOINT now builds diffusion guidance:
    tests/test_torch_guidance.py.)
  * The JAX report cannot render a KITTI-360 frame with boxes
    (render_video.py:108 takes np.asarray of a Bbox3D record: TypeError),
    so the toy root leaves the test camera's frame without one; the
    port's report renders such a frame (ROADMAP Queue 3).
"""

import dataclasses
import json
import os
import random
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_loaders import (CAR, N_FRAMES, SEQ, START,
                                      toy_kitti360_root)
from vegs_torch import config as tconfig, train as ttrain
from vegs_torch.scene import ply_io
from vegs_tpu import config as jconfig

PLY_ATOL = 1e-4
ITERS = 6


@pytest.fixture(autouse=True)
def _keep_stdout(monkeypatch):
    """`main` wraps sys.stdout with timestamps (safe_state), as the JAX
    CLI does; put the test's stdout back afterwards."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.delenv("VEGS_SD_CHECKPOINT", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


ARGVS = [
    [],
    ["--source_path", "/data/k360", "--model_path", "out", "--eval",
     "--sh_degree", "2", "--k_cap", "4096", "--position_lr_init", "3e-5",
     "--seq", "2013_05_28_drive_0000_sync", "--start_frame", "10",
     "--exclude_colmap", "--boxmodel_lr", "0.01", "--prompts", "a road",
     "--lora_checkpoint_iter", "5", "--perceptual_loss",
     "--test_iterations", "7", "--unknown_flag", "3"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_config_matches_jax(argv):
    t = tconfig.parse_config(argv)
    j = jconfig.parse_config(argv)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_config_file_and_cfg_args_cross_load(tmp_path):
    base = jconfig.VegsConfig()
    base.opt.iterations = 123
    base.model.sh_degree = 1
    base.data.seq = "from_json"
    (tmp_path / "base.json").write_text(base.to_json())
    # --sh_degree 3 equals the default: the JSON's 1 stays; the others win
    argv = ["--config", str(tmp_path / "base.json"), "--sh_degree", "3",
            "--iterations", "50", "--eval"]
    t = tconfig.parse_config(argv)
    j = jconfig.parse_config(argv)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.model.sh_degree, t.opt.iterations, t.data.seq, t.model.eval) \
        == (1, 50, "from_json", True)
    t.save(tmp_path / "port_cfg_args.json")
    j.save(tmp_path / "jax_cfg_args.json")
    assert (dataclasses.asdict(jconfig.VegsConfig.load(
        tmp_path / "port_cfg_args.json")) == dataclasses.asdict(
        tconfig.VegsConfig.load(tmp_path / "jax_cfg_args.json"))
        == dataclasses.asdict(t))


def _argv(root, model_path, *extra):
    return ["--source_path", root, "--model_path", str(model_path),
            "--data_type", "kitti360", "--seq", SEQ,
            "--start_frame", str(START), "--end_frame", str(START + N_FRAMES),
            "--eval", "--iterations_override", str(ITERS),
            "--checkpoint_iterations", "3", "--test_iterations", str(ITERS),
            "--densify_from_iter", "100", "--data_parallel", "1",
            "--k_cap", "8192", *extra]


def _ply(path):
    v = ply_io.read_ply(path)["vertex"]
    return {n: np.asarray(v[n]) for n in v.dtype.names}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port Trainer, port model dir, JAX model dir, root, the restored
    checkpoint check of the resumed run)."""
    from vegs_tpu.train import main as jmain

    base = tmp_path_factory.mktemp("cli")
    root = toy_kitti360_root(base / "root")
    cwd = os.getcwd()
    os.chdir(base)   # the readers' .cache/ goes here
    stdout = sys.stdout
    try:
        tr = ttrain.main(_argv(root, base / "port"), device="cpu")
        sys.stdout = stdout
        jmain(_argv(root, base / "jax", "--backend", "dense"))
        sys.stdout = stdout

        restored = {}
        load = ttrain.Trainer.load_checkpoint

        def checked_load(self, it):
            load(self, it)
            saved = torch.load(self.checkpoint_path(it), map_location="cpu",
                               weights_only=True)
            restored["equal"] = _trees_equal(self._checkpoint_tree(), saved)
            restored["step"] = self.state.step

        ttrain.Trainer.load_checkpoint = checked_load
        try:
            shutil.copytree(base / "port" / "checkpoints",
                            base / "port_b" / "checkpoints")
            tr_b = ttrain.main(_argv(root, base / "port_b",
                                     "--start_checkpoint", "3"), device="cpu")
        finally:
            ttrain.Trainer.load_checkpoint = load
        sys.stdout = stdout
    finally:
        sys.stdout = stdout
        os.chdir(cwd)
    return tr, tr_b, base, root, restored


def _trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_trees_equal(a[k], b[k]) for k in a))
    return a.dtype == b.dtype and torch.equal(a, b)


def test_main_matches_jax_main(runs):
    tr, _, base, _, _ = runs
    assert tr.state.step == ITERS
    pm = [json.loads(x) for x in (base / "port" / "metrics.jsonl").open()]
    jm = [json.loads(x) for x in (base / "jax" / "metrics.jsonl").open()]
    assert [sorted(r) for r in pm] == [sorted(r) for r in jm]
    assert pm[0]["step"] == jm[0]["step"] == ITERS
    np.testing.assert_allclose(pm[0]["test_psnr"], jm[0]["test_psnr"],
                               rtol=0, atol=1e-3)
    for d in ("port", "jax"):
        assert sorted(p.name for p in (base / d / "results"
                                       / f"iter_{ITERS}").iterdir()) == \
            sorted([f"aug_{i}.png" for i in range(4)]
                   + [f"rotaxis_{i}.png" for i in range(4)])
    rel = [Path("point_cloud") / f"iteration_{ITERS}" / "point_cloud.ply",
           Path(f"instance_{CAR}") / "point_cloud" / f"iteration_{ITERS}"
           / "point_cloud.ply"]
    for r in rel:
        p, j = _ply(base / "port" / r), _ply(base / "jax" / r)
        assert sorted(p) == sorted(j) and len(p["x"]) == len(j["x"])
        for col in j:
            np.testing.assert_allclose(p[col], j[col], rtol=0, atol=PLY_ATOL,
                                       err_msg=f"{r} {col}")
    # cfg_args.json of the port's run loads in both packages
    for pkg in (tconfig, jconfig):
        cfg = pkg.VegsConfig.load(base / "port" / "cfg_args.json")
        assert cfg.model.source_path == tr.cfg.model.source_path
        assert cfg.data.start_frame == START


def test_resumed_main_restores_the_checkpoint_and_reaches_the_end(runs):
    _, tr_b, base, _, restored = runs
    assert restored == {"equal": True, "step": 3}
    assert tr_b.state.step == ITERS
    pm = [json.loads(x) for x in (base / "port_b" / "metrics.jsonl").open()]
    assert [r["step"] for r in pm] == [ITERS]
    assert (base / "port_b" / "point_cloud" / f"iteration_{ITERS}"
            / "point_cloud.ply").exists()
    for f in [tr_b.state.field, *tr_b.box_fields.values()]:
        assert torch.isfinite(f.means).all()


def test_main_refuses_what_is_not_ported(tmp_path, monkeypatch):
    argv = _argv(str(tmp_path / "nowhere"), tmp_path / "m")
    # nothing tells a program of a cluster: a multi-host rank needs all
    # three flags
    with pytest.raises(ValueError, match="--process_id"):
        ttrain.main(argv + ["--coordinator_address", "localhost:1"],
                    device="cpu")
    with pytest.raises(ValueError, match="--coordinator_address"):
        ttrain.main(argv + ["--num_processes", "2", "--process_id", "0"],
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.main(argv)


def test_report_renders_a_kitti360_frame_with_boxes(runs):
    """The port renders the augmented views and covariance axes of a frame
    whose boxes are Bbox3D records; the JAX function raises on them."""
    from vegs_torch.ops.rasterize import RasterizeConfig
    from vegs_torch.render_video import (DEFAULT_AUG_PARAMS,
                                         render_novelview_image,
                                         render_novelview_rotaxis)
    from vegs_tpu.ops.rasterize import RasterizeConfig as JRaster
    from vegs_tpu.render_video import render_novelview_image as jrender
    from vegs_tpu.scene import Scene as JScene

    tr, _, base, root, _ = runs
    cam = next(c for c in tr.scene.train_cameras
               if tr.scene.train_bboxes.get(c.frame))
    boxes = tr.scene.train_bboxes[cam.frame]
    assert type(boxes[CAR]).__name__ == "Bbox3D"
    cfg = RasterizeConfig(k_cap=8192, forward_only=True)
    with torch.no_grad():
        img = render_novelview_image(tr.scene, cam, boxes, cfg, tr.bg,
                                     DEFAULT_AUG_PARAMS[1])
        ax = render_novelview_rotaxis(tr.scene, cam, boxes, cfg, tr.bg,
                                      DEFAULT_AUG_PARAMS[1])
        plain = render_novelview_image(tr.scene, cam, {}, cfg, tr.bg,
                                       DEFAULT_AUG_PARAMS[1])
    assert img.shape == (48, 64, 3) and ax.shape == (48, 64, 3)
    assert ax.dtype == np.uint8 and np.isfinite(img).all()
    assert not np.array_equal(img, plain)        # the box is in the view

    cwd = os.getcwd()
    os.chdir(base)
    try:
        cfg_j = jconfig.parse_config(_argv(root, base / "jax"))
        js = JScene(cfg_j.model, cfg_j.data, cfg_j.box, shuffle=False)
    finally:
        os.chdir(cwd)
    jcam = next(c for c in js.train_cameras if js.train_bboxes.get(c.frame))
    with pytest.raises(TypeError, match="Bbox3D"):
        jrender(js, jcam, js.train_bboxes[jcam.frame], JRaster(k_cap=8192),
                np.zeros(3, np.float32), DEFAULT_AUG_PARAMS[1])


@pytest.fixture(scope="module")
def toy_scenes(tmp_path_factory):
    """The port's and the JAX Scene of the toy root from the same config
    and seed (the same cameras and seeded fields,
    tests/test_torch_loaders.py), and the frame's box matrices of the first
    train camera whose frame has the vehicle."""
    from vegs_torch.scene import Scene as TScene, box_matrix
    from vegs_tpu.scene import Scene as JScene

    base = tmp_path_factory.mktemp("scenes")
    root = toy_kitti360_root(base / "root")
    argv = _argv(root, base / "model")
    cwd = os.getcwd()
    os.chdir(base)
    try:
        random.seed(7)
        t = tconfig.parse_config(argv)
        ts = TScene(t.model, t.data, t.box, device="cpu")
        random.seed(7)
        j = jconfig.parse_config(argv)
        js = JScene(j.model, j.data, j.box)
    finally:
        os.chdir(cwd)
    i = next(i for i, c in enumerate(ts.train_cameras)
             if ts.train_bboxes.get(c.frame))
    cam = ts.train_cameras[i]
    boxes = {k: box_matrix(b) for k, b in ts.train_bboxes[cam.frame].items()}
    return ts, js, i, boxes


@pytest.mark.parametrize("ai", range(4))
def test_novelview_with_boxes_matches_jax(toy_scenes, ai):
    """`render_novelview_image` and `render_novelview_rotaxis` with the
    frame's box matrices against the JAX functions given the same matrices,
    at each of the report's extrapolations, the vehicle covering over a
    hundred pixels of each view. Image: |d| <= 1e-5 (float32 sums in
    another order; measured: 1.9e-6 at most). Rotaxis: uint8 within 1 on
    99.9% of the pixels (a pixel whose two smallest composited scales
    nearly tie may pick the other axis; measured: equal everywhere)."""
    import jax.numpy as jnp

    from vegs_torch import render_video as tvideo
    from vegs_torch.ops.rasterize import RasterizeConfig
    from vegs_tpu import render_video as jvideo
    from vegs_tpu.ops.rasterize import RasterizeConfig as JRaster

    ts, js, i, boxes = toy_scenes
    aug = tvideo.DEFAULT_AUG_PARAMS[ai]
    tcfg = RasterizeConfig(k_cap=8192, forward_only=True)
    jcfg = JRaster(k_cap=8192, forward_only=True)
    tcam, jcam = ts.train_cameras[i], js.train_cameras[i]
    with torch.no_grad():
        got = tvideo.render_novelview_image(ts, tcam, boxes, tcfg,
                                            torch.zeros(3), aug)
        got_ax = tvideo.render_novelview_rotaxis(ts, tcam, boxes, tcfg,
                                                 torch.zeros(3), aug)
        plain = tvideo.render_novelview_image(ts, tcam, {}, tcfg,
                                              torch.zeros(3), aug)
    ref = jvideo.render_novelview_image(js, jcam, boxes, jcfg, jnp.zeros(3),
                                        aug)
    ref_ax = jvideo.render_novelview_rotaxis(js, jcam, boxes, jcfg,
                                             jnp.zeros(3), aug)
    assert got.shape == ref.shape == (48, 64, 3)
    assert (np.abs(got - plain).max(-1) > 1e-3).sum() > 100   # the box
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got_ax.dtype == ref_ax.dtype == np.uint8
    dax = np.abs(got_ax.astype(int) - ref_ax.astype(int)).max(-1)
    assert (dax <= 1).mean() >= 0.999, int((dax > 1).sum())


@pytest.mark.parametrize("eval_", [False, True])
def test_augment_camera_matches_jax(toy_scenes, eval_):
    """`augment_camera` (the random train form and the fixed eval form)
    against the JAX function on the same camera and the same rng draws:
    the drawn angles and rise equal, the camera's K, R, T, FoV and size
    equal to the bit."""
    from vegs_torch.config import SDRegularizationParams as TSD
    from vegs_torch.scene.cameras import augment_camera as taug
    from vegs_tpu.config import SDRegularizationParams as JSD
    from vegs_tpu.scene.cameras import augment_camera as jaug

    ts, js, i, _ = toy_scenes
    for seed in range(3):
        t = taug(ts.train_cameras[i], TSD(), np.random.default_rng(seed),
                 eval=eval_)
        j = jaug(js.train_cameras[i], JSD(), np.random.default_rng(seed),
                 eval=eval_)
        assert t[1:] == j[1:]
        tc, jc = t[0], j[0]
        for k in ("K", "R", "T", "FoVx", "FoVy", "image_width",
                  "image_height"):
            np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k),
                                          err_msg=k)
        assert tc.image_height == TSD().sd_image_size
