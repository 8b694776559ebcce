"""The port's render slice end to end against vegs_tpu.

A trained-field PLY written by the JAX package loads through the port; the
numpy weight bridge round-trips; and the JAX `render_novelview_image`
(Pallas blend in interpret mode) and the port's (plain versions of the
kernels on the CPU) agree on all four default trajectories of a 2-camera
scene at 32x128, with f32 and the default bf16 aux payload. Tolerance: rgb
within 1e-4 on >= 99.9% of the values (float32 rounding of the same
maths in another order; a rare stop flip or a one-ulp bf16 rounding of a
color moves a few pixels more) and within 2e-2 everywhere.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vegs_tpu import gaussians as jgauss
from vegs_tpu import render_video as jvideo
from vegs_tpu.config import ModelParams
from vegs_tpu.ops.rasterize import RasterizeConfig as JConfig
from vegs_tpu.scene import Scene as JScene, dataset_readers as jreaders
from vegs_tpu.scene import save_gaussian_ply as jsave
from vegs_tpu.utils.synthetic import street_camera_infos as jstreet

import vegs_torch
from vegs_torch import convert, render_video as tvideo
from vegs_torch.gaussians import from_ply_arrays, to_ply_arrays
from vegs_torch.ops.rasterize import RasterizeConfig as TConfig, rasterize
from vegs_torch.render import render
from vegs_torch.scene import Scene as TScene, dataset_readers as treaders
from vegs_torch.scene import load_gaussian_ply
from vegs_torch.utils.synthetic import street_camera_infos as tstreet

H, W = 32, 128
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_field(seed=0, n=1200):
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 14.0, n)
    xyz = np.stack([rng.uniform(-0.7, 0.7, n) * z,
                    rng.uniform(-0.35, 0.35, n) * z, z], 1).astype(np.float32)
    f_dc = rng.uniform(-1.0, 1.5, (n, 3)).astype(np.float32)
    f_rest = rng.normal(0, 0.12, (n, 45)).astype(np.float32)
    opac = rng.normal(0.5, 1.5, n).astype(np.float32)
    scale = np.log(rng.uniform(0.03, 0.4, (n, 3))).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    return jgauss.from_ply_arrays(xyz, f_dc, f_rest, opac, scale, rot)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    model = tmp_path_factory.mktemp("model")
    jsave(model / "point_cloud" / "iteration_7" / "point_cloud.ply",
          _jax_field())

    def info(readers, cams):
        return readers.SceneInfo(
            point_cloud=None, train_cameras=cams, test_cameras=[],
            nerf_normalization=readers.getNerfppNorm(cams), ply_path="")

    js = JScene(ModelParams(model_path=str(model)),
                scene_info=info(jreaders, jstreet(2, H, W, render_gt=False)),
                load_iteration=-1, shuffle=False)
    ts = TScene(model, info(treaders, tstreet(2, H, W)), load_iteration=-1,
                shuffle=False, device="cpu")
    return js, ts


def test_ply_from_jax_loads_through_port(scenes):
    js, ts = scenes
    assert ts.loaded_iter == js.loaded_iter == 7
    for name in convert.FIELD_KEYS:
        np.testing.assert_array_equal(getattr(ts.gaussians, name).detach().numpy(),
                                      np.asarray(getattr(js.gaussians, name)),
                                      err_msg=name)
    for name in ("scales", "opacities", "rotations", "features"):
        np.testing.assert_allclose(
            getattr(ts.gaussians, name)().detach().numpy(),
            np.asarray(getattr(js.gaussians, name)()), rtol=1e-6, atol=1e-7,
            err_msg=name)


def test_field_from_numpy_round_trip(scenes, tmp_path):
    js, _ = scenes
    arrays = {k: np.asarray(getattr(js.gaussians, k)) for k in convert.FIELD_KEYS}
    field = convert.field_from_numpy(arrays, device="cpu")
    back = convert.field_to_numpy(field)
    for k in convert.FIELD_KEYS:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    # and through the port's own PLY writer and reader
    path = tmp_path / "f.ply"
    from vegs_torch.scene import save_gaussian_ply

    save_gaussian_ply(path, field)
    again = load_gaussian_ply(path, device="cpu")
    for k in convert.FIELD_KEYS:
        np.testing.assert_array_equal(getattr(again, k).detach().numpy(),
                                      arrays[k], err_msg=k)


def test_cameras_match(scenes):
    js, ts = scenes
    jc = jvideo.interpolate_cameras(js.getTrainCameras(), 2)
    tc = tvideo.interpolate_cameras(ts.getTrainCameras(), 2)
    assert len(jc) == len(tc) == 3
    for a, b in zip(jc, tc):
        for name in ("world_view_transform", "full_proj_transform",
                     "camera_center"):
            np.testing.assert_allclose(getattr(b, name), getattr(a, name),
                                       rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("payload_dtype", ["f32", "bf16"])
def test_render_novelview_image_matches_jax(scenes, payload_dtype):
    js, ts = scenes
    jcfg = JConfig(k_cap=8192, payload_dtype=payload_dtype, forward_only=True)
    tcfg = TConfig(k_cap=8192, payload_dtype=payload_dtype, forward_only=True)
    jcam = jvideo.interpolate_cameras(js.getTrainCameras(), 2)[1]
    tcam = tvideo.interpolate_cameras(ts.getTrainCameras(), 2)[1]
    for aug in tvideo.DEFAULT_AUG_PARAMS:
        ref = jvideo.render_novelview_image(js, jcam, {}, jcfg,
                                            jnp.zeros(3), aug)
        got = tvideo.render_novelview_image(ts, tcam, {}, tcfg,
                                            torch.zeros(3), aug)
        assert got.shape == ref.shape == (H, W, 3)
        d = np.abs(got - ref)
        assert (d <= 1e-4).mean() >= 0.999, (aug, int((d > 1e-4).sum()))
        assert d.max() <= 2e-2, (aug, float(d.max()))
        assert ref.mean() > 0.05  # the view sees the field
    from vegs_torch.scene.cameras import make_camera_like_input_camera

    out = render(make_camera_like_input_camera(tcam, **aug), ts.gaussians,
                 config=tcfg)
    assert int(out.num_dropped) == 0


def test_render_frames_shapes(scenes):
    _, ts = scenes
    frames = tvideo.render_frames(ts, n_interp=2, max_frames=2,
                                  raster_cfg=TConfig(k_cap=8192))
    assert list(frames) == [tvideo.video_name(a) for a in tvideo.DEFAULT_AUG_PARAMS]
    for fr in frames.values():
        assert len(fr) == 2
        for f in fr:
            assert f.shape == (H, W, 3) and np.isfinite(f).all()
            assert f.min() >= 0 and f.max() <= 1


def test_backward_not_ported_yet(scenes):
    """The backward is ported now: a render with forward_only=False gives
    the same image as the forward-only render, and gradients reach the
    field's parameters and the means2d tap."""
    _, ts = scenes
    cam = ts.getTrainCameras()[0]
    field = ts.gaussians
    tap = torch.zeros((field.capacity, 2), requires_grad=True)
    out = render(cam, field, config=TConfig(k_cap=8192), means2d_offset=tap)
    with torch.no_grad():
        ref = render(cam, field, config=TConfig(k_cap=8192, forward_only=True))
    assert torch.equal(out.rgb.detach(), ref.rgb)
    out.rgb.square().mean().backward()
    for name in ("means", "quats", "log_scales", "sh_dc", "opacity_logit"):
        g = getattr(field, name).grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0, name
    assert tap.grad.abs().sum() > 0
    field.zero_grad(set_to_none=True)


def test_port_imports_neither_jax_nor_vegs_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vegs_torch\n"
        "for m in pkgutil.walk_packages(vegs_torch.__path__, 'vegs_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vegs_tpu')]\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(m for m in sys.modules if m.startswith('vegs_torch'))))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = set(res.stdout.strip().splitlines()[-1].split())
    assert len(loaded) >= 25
    for m in ("train", "optim", "densify", "config", "losses.photometric",
              "losses.normal_guidance", "ops.segreduce", "ops.blend_cuda",
              "ops.rasterize", "scene.dataset_readers"):
        assert f"vegs_torch.{m}" in loaded, m


def test_default_device_raises_without_a_card(monkeypatch, scenes):
    _, ts = scenes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vegs_torch.resolve_device()
    with pytest.raises(RuntimeError):
        ts.getTrainCameras()[0].device_params()
    with pytest.raises(RuntimeError):
        convert.field_from_numpy(convert.field_to_numpy(ts.gaussians))
    ply = to_ply_arrays(ts.gaussians)
    with pytest.raises(RuntimeError):
        from_ply_arrays(ply["xyz"], ply["f_dc"], ply["f_rest"],
                        ply["opacities"], ply["scale"], ply["rotation"])
    assert from_ply_arrays(ply["xyz"], ply["f_dc"], ply["f_rest"],
                           ply["opacities"], ply["scale"], ply["rotation"],
                           device="cpu").means.device.type == "cpu"
    assert vegs_torch.resolve_device("cpu").type == "cpu"


def test_rasterize_options(scenes):
    """The dense spec backend agrees with the tile path on the CPU and
    refuses card tensors; a blend chunk the kernel lacks is refused."""
    _, ts = scenes
    cam = ts.getTrainCameras()[0]
    cfg = TConfig(k_cap=8192, payload_dtype="f32", forward_only=True)
    with torch.no_grad():
        tiles = render(cam, ts.gaussians, config=cfg)
        dense = render(cam, ts.gaussians, config=cfg._replace(backend="dense"))
    for name in ("rgb", "depth", "alpha"):
        np.testing.assert_allclose(getattr(dense, name).numpy(),
                                   getattr(tiles, name).numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    meta = [torch.zeros(s, device="meta") for s in ((4, 3), (4, 4), (4, 3), (4,))]
    with pytest.raises(ValueError, match="dense"):
        rasterize(*meta, None, cam.device_params("cpu"),
                  colors_precomp=torch.zeros((4, 3), device="meta"),
                  config=cfg._replace(backend="dense"))
    with pytest.raises(ValueError, match="blend_chunk"):
        render(cam, ts.gaussians, config=cfg._replace(blend_chunk=128))
