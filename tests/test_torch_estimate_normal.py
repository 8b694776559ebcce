"""The port's normal estimator tool (`vegs_torch.tools.estimate_normal`)
against vegs_tpu's.

Both estimators get the same weights: the tiny DPT from a synthesized
omnidata checkpoint (`tests/test_torch_dpt.lively_state`) through each
package's converter, the port's with the ignore readout (what JAX
computes). Images are seeded numpy, 64x192 (three 64-pixel crop positions
and two between them).

Tolerance: `infer_square`'s and `infer_sliding`'s normals within 1e-3 of
JAX's. The two DPTs differ by float32 summation order (the bound of
tests/test_torch_dpt.py); OpenCV's resizes are the same calls in both
tools, and the sliding blend renormalizes each pixel's weighted sum, which
divides that difference by the sum's length (readings here ~1e-4). The
written `.npy` files within the same bound; their visualization PNGs
within one grey level (a float32 difference crosses a rounding boundary);
`to_repo_convention` exact. The port's crops in one batch against one at a
time: within 1e-3 as well.
"""

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_dpt import lively_state
from tests.test_torch_loaders import SEQ, START, toy_kitti360_root
from vegs_torch.priors import dpt as tdpt
from vegs_torch.scene import dataset_readers as tread
from vegs_torch.tools import estimate_normal as test_
from vegs_tpu.priors import dpt as jdpt
from vegs_tpu.tools import estimate_normal as jest

TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def estimators():
    state = lively_state(21)
    jparams, _ = jdpt.convert_omnidata_state(state, jdpt.DPTConfig.tiny())
    tstate, _ = tdpt.convert_omnidata_state(
        state, tdpt.DPTConfig.tiny(readout="ignore"))
    j = jest.NormalEstimator(jdpt.DPTConfig.tiny(),
                             params=jax.tree.map(np.asarray, jparams))
    t = test_.NormalEstimator(tdpt.DPTConfig.tiny(readout="ignore"),
                              state_dict=tstate, device="cpu")
    return j, t


def image(seed, h=64, w=192):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def test_infer_square(estimators):
    j, t = estimators
    img = image(1)[:, :64]
    want, got = j.infer_square(img), t.infer_square(img)
    assert got.shape == want.shape == (64, 64, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_infer_sliding_and_convention(estimators):
    j, t = estimators
    img = image(2)
    want, got = j.infer_sliding(img), t.infer_sliding(img)
    assert got.shape == (64, 192, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(t.to_repo_convention(got),
                                  j.to_repo_convention(got))
    # the crops in one batch give what one crop at a time gives, within the
    # same bound (oneDNN sums a batch of 3 in another order than a batch of
    # 1: 8.5e-5 read here)
    crops = [img[:, x0:x0 + 64] for x0 in (0, 32, 64, 96, 128)]
    for a, b in zip(t.infer_batch(crops), (t.infer_square(c) for c in crops)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def test_estimate_sequence_writes_where_the_reader_reads(estimators,
                                                          tmp_path):
    j, t = estimators
    roots = {}
    for name, est in (("jax", j), ("port", t)):
        root = toy_kitti360_root(tmp_path / name)
        n = (jest if name == "jax" else test_).estimate_sequence(
            root, SEQ, est, limit=2)
        assert n == 4
        roots[name] = root
    infos = tread.readKITTI360Cameras(roots["port"], SEQ, START, START + 2)
    assert len(infos) == 4
    for info in infos:
        got = np.load(info.normal_path)
        want = np.load(info.normal_path.replace(roots["port"], roots["jax"]))
        assert got.shape == (3, 48, 64)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0,
                                   atol=1e-5)
        viz = info.normal_path.replace("_norm.npy", "_norm_viz.png")
        a = np.asarray(Image.open(viz), np.int16)
        b = np.asarray(Image.open(viz.replace(roots["port"], roots["jax"])),
                       np.int16)
        assert np.abs(a - b).max() <= 1
        cam = tread.camera_from_info(info)
        np.testing.assert_array_equal(cam.original_normal, got)
