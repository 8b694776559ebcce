"""The rest of the port's video renderer (`vegs_torch.render_video`: the
box-pose interpolation, boxes in `render_set`, `render_sets`) against
vegs_tpu's, at toy scale (the toy KITTI-360 root of
tests/test_torch_loaders.py: 48x64 stereo, one vehicle box annotated from
the second frame on).

  * `interpolate_box2world` and `interpolate_bboxes` against the JAX
    functions: within 1e-6 (both in float32: decomposition, SLERP and
    lerp in another order);
  * `render_set`'s frames before encoding (each package's `save_video`
    captured) against JAX's on the same scene (the same cameras and
    seeded fields, tests/test_torch_loaders.py): within 1e-4 on >= 99.9% of
    the values and 2e-2 everywhere, the render tolerance of
    tests/test_torch_render.py; the vehicle changes the frames;
  * `render_sets` on a saved model directory writes mp4s that read back
    with OpenCV at the expected frame count; without a card and without
    `device="cpu"` the command line refuses to run.
"""

import os
import random

import numpy as np
import pytest
import torch

from tests.test_torch_cli import _argv
from tests.test_torch_loaders import toy_kitti360_root
from vegs_torch import config as tconfig, render_video as tvideo
from vegs_torch.ops.rasterize import RasterizeConfig as TRaster
from vegs_torch.scene import Scene as TScene
from vegs_tpu import config as jconfig, geometry as jgeom
from vegs_tpu import render_video as jvideo
from vegs_tpu.ops.rasterize import RasterizeConfig as JRaster
from vegs_tpu.scene import Scene as JScene

AUGS = (tvideo.DEFAULT_AUG_PARAMS[0], tvideo.DEFAULT_AUG_PARAMS[1])


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The port's and the JAX Scene of the toy root (the same seeds)."""
    base = tmp_path_factory.mktemp("video")
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
    return ts, js, t, base


def box(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    m = np.eye(4)
    m[:3, :3] = (np.asarray(jgeom.quat_to_rotmat(q.astype(np.float32)))
                 * rng.uniform(0.5, 3.0, 3))
    m[:3, 3] = rng.normal(size=3) * 5
    return m


@pytest.mark.parametrize("t", [0.0, 0.3, 0.5, 0.75, 1.0])
def test_interpolate_box2world_matches_jax(t):
    a, b = box(1), box(2)
    got = tvideo.interpolate_box2world(a, b, t)
    want = jvideo.interpolate_box2world(a, b, t)
    assert got.dtype == np.float32 and got.shape == (4, 4)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_interpolate_bboxes_matches_jax(scenes):
    ts, js, _, _ = scenes
    frames = sorted({c.frame for c in ts.train_cameras})
    # the toy root's records (Bbox3D), and plain matrices with an instance
    # that leaves after the first frame
    extra = {frames[0]: {5: box(3), 6: box(4)}, frames[1]: {5: box(5)}}
    for bboxes, fr in ((ts.train_bboxes, frames), (extra, frames[:2])):
        got = tvideo.interpolate_bboxes(bboxes, fr, n_interp=3)
        want = jvideo.interpolate_bboxes(bboxes, fr, n_interp=3)
        assert len(got) == len(want) == 3 * (len(fr) - 1) + 1
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in g:
                np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=1e-6,
                                           rtol=1e-6)
    assert any(ts.train_bboxes.values())


def captured_frames(module, monkeypatch, fn):
    frames = {}
    monkeypatch.setattr(module, "save_video",
                        lambda fr, path, fps=10: frames.__setitem__(
                            os.path.basename(str(path)),
                            [np.asarray(f) for f in fr]))
    fn()
    return frames


def test_render_set_frames_match_jax(scenes, tmp_path, monkeypatch):
    ts, js, _, _ = scenes
    kw = dict(n_interp=2, aug_params=AUGS, max_frames=4)
    got = captured_frames(tvideo, monkeypatch, lambda: tvideo.render_set(
        ts, tmp_path / "t", raster_cfg=TRaster(k_cap=8192), **kw))
    want = captured_frames(jvideo, monkeypatch, lambda: jvideo.render_set(
        js, tmp_path / "j", raster_cfg=JRaster(k_cap=8192), **kw))
    assert list(got) == list(want) == [tvideo.video_name(a) for a in AUGS]
    for name in got:
        g, w = np.stack(got[name]), np.stack(want[name])
        assert g.shape == w.shape == (4, 48, 64, 3)
        d = np.abs(g - w)
        assert (d <= 1e-4).mean() >= 0.999 and d.max() <= 2e-2, d.max()
    # the vehicle is in the interpolated frames
    bboxes, ts.train_bboxes = ts.train_bboxes, {}
    try:
        plain = captured_frames(tvideo, monkeypatch, lambda: tvideo.render_set(
            ts, tmp_path / "p", raster_cfg=TRaster(k_cap=8192), **kw))
    finally:
        ts.train_bboxes = bboxes
    name = tvideo.video_name(AUGS[0])
    diff = np.abs(np.stack(plain[name]) - np.stack(got[name])).max(-1)
    assert (diff > 1e-3).sum() > 50


def test_render_sets_writes_readable_videos(scenes):
    import cv2

    ts, _, cfg, base = scenes
    ts.save(4)
    cwd = os.getcwd()
    os.chdir(base)
    try:
        out = tvideo.render_sets(cfg, device="cpu", n_interp=2,
                                 aug_params=AUGS, max_frames=3,
                                 raster_cfg=TRaster(k_cap=8192))
    finally:
        os.chdir(cwd)
    assert sorted(out) == sorted(tvideo.video_name(a) for a in AUGS)
    for path in out.values():
        assert os.path.dirname(path) == str(base / "model" / "videos")
        cap = cv2.VideoCapture(path)
        n = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            assert frame.shape == (48, 64, 3)
            n += 1
        cap.release()
        assert n == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tvideo.main(_argv(str(base / "root"), base / "model"))
