"""The port's lazy image and normal-map loading (`vegs_torch.scene.cameras`)
against vegs_tpu's, on PNGs written by PIL and .npy normal maps.

  * `_load_image` equals the JAX package's exactly on 8-bit gray, RGB and
    RGBA PNGs (PIL's writer picks each row's filter), at the file's size,
    at a requested size equal to it, and resized with PIL's LANCZOS.
  * On a palette PNG the JAX `_load_image` takes the palette indices as
    gray levels (np.asarray of a mode-P image); the port expands the
    palette to RGB (ROADMAP Queue 3).
  * `_load_normal` equals the JAX package's exactly for a [3, h, w] and an
    [h, w, 3] map on disk, at the camera's size and resized by OpenCV.
  * `Camera.original_image`, `original_normal` and `world_normal()`, read
    lazily from disk, equal the JAX Camera's.
"""

import numpy as np
import pytest
from PIL import Image

from vegs_tpu.scene import cameras as jcams
from vegs_torch.scene import cameras as tcams

H, W = 30, 44


def _smooth_image(rng, h, w, c):
    """Gradients, stripes and noise, so that PIL's writer uses several
    filter types."""
    y, x = np.mgrid[0:h, 0:w]
    chans = [(x * 0.7 + y * 0.3) % 256, 128 + 100 * np.sin(x / 9.0),
             rng.integers(0, 256, (h, w)), (y * 2.0) % 256]
    img = np.stack(chans[:c], -1).astype(np.uint8)
    img[: h // 4] = rng.integers(0, 256, (h // 4, w, c))
    return img


@pytest.mark.parametrize("size", [None, (W, H), (33, 21)])
@pytest.mark.parametrize("mode,c", [("L", 1), ("RGB", 3), ("RGBA", 4)])
def test_load_image_matches_jax(tmp_path, mode, c, size):
    img = _smooth_image(np.random.default_rng(c), H, W, c)
    p = tmp_path / "frame.png"
    Image.fromarray(img[..., 0] if c == 1 else img).save(p)
    assert Image.open(p).mode == mode
    got = tcams._load_image(str(p), size)
    np.testing.assert_array_equal(got, jcams._load_image(str(p), size))
    assert got.shape == (3,) + ((H, W) if size is None else size[::-1])
    if size is None:
        want = img[..., :1].repeat(3, -1) if c == 1 else img[..., :3]
        np.testing.assert_array_equal(got, want.transpose(2, 0, 1) / np.float32(255))


def test_palette_load_image_expands_where_jax_reads_indices(tmp_path):
    rgb = _smooth_image(np.random.default_rng(7), 20, 24, 3)
    pal = Image.fromarray(rgb).quantize(200)
    p = tmp_path / "pal.png"
    pal.save(p)
    want = np.asarray(pal.convert("RGB"), np.float32).transpose(2, 0, 1) / 255
    np.testing.assert_array_equal(tcams._load_image(str(p)), want)
    idx = np.asarray(pal, np.float32) / 255
    np.testing.assert_array_equal(jcams._load_image(str(p)),
                                  np.repeat(idx[None], 3, 0))


@pytest.mark.parametrize("size", [(W, H), (22, 15)])
@pytest.mark.parametrize("layout", ["chw", "hwc"])
def test_load_normal_matches_jax(tmp_path, layout, size):
    n = np.random.default_rng(6).normal(size=(3, H, W)).astype(np.float32)
    p = tmp_path / "frame_norm.npy"
    np.save(p, n if layout == "chw" else n.transpose(1, 2, 0))
    got = tcams._load_normal(str(p), size)
    np.testing.assert_array_equal(got, jcams._load_normal(str(p), size))
    assert got.shape == (3, size[1], size[0])


def test_camera_reads_lazily_like_jax(tmp_path):
    rng = np.random.default_rng(8)
    p = tmp_path / "frame.png"
    Image.fromarray(_smooth_image(rng, H, W, 3)).save(p)
    npath = tmp_path / "frame_norm.npy"
    np.save(npath, rng.normal(size=(3, H, W)).astype(np.float32))
    kw = dict(colmap_id=0, R=np.eye(3), T=np.zeros(3), FoVx=1.0, FoVy=0.8,
              K=np.array([[40.0, 0, 22], [0, 40.0, 15], [0, 0, 1]]),
              image_path=str(p), normal_path=str(npath), image_width=W,
              image_height=H)
    tc, jc = tcams.Camera(**kw), jcams.Camera(**kw)
    np.testing.assert_array_equal(tc.original_image, jc.original_image)
    np.testing.assert_array_equal(tc.original_normal, jc.original_normal)
    np.testing.assert_array_equal(tc.world_normal(), jc.world_normal())
