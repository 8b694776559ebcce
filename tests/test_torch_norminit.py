"""The normal-prior covariance init of the port (`vegs_torch.priors`, and
the geometry it needs) against vegs_tpu's, on the CPU.

  * `normal_to_rot`: the first column is the normal, the matrix a rotation
    (1e-5), and it equals the JAX one within 1e-6 -- except normals within
    1e-4 of the helper-axis switch at |n_x| = 0.9, where float differences
    may pick the other helper axis (their count is printed; the first
    column must still agree). `sh_basis` equals `eval_sh`'s contraction and
    the JAX basis (1e-5); `mark_visible` equals the JAX test.
  * The port's counterparts of tests/test_norminit.py:13 and :45.
  * Whole init against the JAX package's on ray-traced normal maps of the
    synthetic street (3 cameras at 48x96, ~3,200 Gaussians): the
    accumulator's sums within 1e-4 of their size and the counts equal. The
    eigenvectors are defined only up to sign (both flip w >= 0) and not at
    all where the two largest eigenvalues coincide: rotations are compared
    by the first column's |dot| >= 1 - 1e-5 on the Gaussians whose top
    eigengap exceeds 1e-3 of the largest eigenvalue; the others are
    counted, printed and left out. Scales equal. `Trainer.init_from_normals`
    gives the same field and returns the count. `principal_eigenvector`
    (the port's repeated squaring) against numpy's float64 `eigh` under the
    same rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.utils import make_camera
from vegs_tpu import gaussians as jgauss, geometry as jgeo, sh as jsh
from vegs_tpu.ops.projection import mark_visible as jmark
from vegs_tpu.priors import norminit as jnorm
from vegs_torch import convert, gaussians as tgauss, geometry as tgeo, sh as tsh
from vegs_torch.ops.projection import mark_visible as tmark
from vegs_torch.priors import norminit as tnorm

EIGENGAP = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tcam(cam):
    return convert.camera_params_from_numpy(
        cam.viewmatrix, cam.projmatrix, cam.campos, cam.tan_fovx,
        cam.tan_fovy, cam.height, cam.width, device="cpu")


def test_normal_to_rot_first_column_and_parity():
    rng = np.random.default_rng(0)
    n = rng.normal(size=(4000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:8, 0] = 0.9  # on the switch itself
    R = tgeo.normal_to_rot(torch.from_numpy(n)).numpy()
    np.testing.assert_allclose(R[..., :, 0], n / np.linalg.norm(
        n, axis=1, keepdims=True), atol=1e-5)
    eye = np.einsum("nij,nkj->nik", R, R)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-4)
    ref = np.asarray(jgeo.normal_to_rot(jnp.asarray(n)))
    nx = np.abs(n[:, 0]) / np.linalg.norm(n, axis=1)
    edge = np.abs(nx - 0.9) < 1e-4
    print(f"normal_to_rot: {int(edge.sum())} normals at the |n_x| = 0.9 "
          "switch left out")
    np.testing.assert_allclose(R[~edge], ref[~edge], atol=1e-6)
    np.testing.assert_allclose(R[edge][..., 0], ref[edge][..., 0], atol=1e-6)


def test_sh_basis_matches_eval_and_jax():
    rng = np.random.default_rng(1)
    coeffs = rng.normal(size=(10, 3, 16)).astype(np.float32)
    dirs = rng.normal(size=(10, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d = torch.from_numpy(dirs)
    for deg in range(4):
        k = (deg + 1) ** 2
        c = torch.from_numpy(coeffs[..., :k])
        basis = tsh.sh_basis(deg, d)
        np.testing.assert_allclose(
            torch.einsum("nck,nk->nc", c, basis).numpy(),
            tsh.eval_sh(deg, c, d).numpy(), atol=1e-5)
        np.testing.assert_allclose(
            basis.numpy(), np.asarray(jsh.sh_basis(deg, jnp.asarray(dirs))),
            atol=1e-5)
    with pytest.raises(ValueError):
        tsh.sh_basis(4, d)


def test_mark_visible():
    cam = _tcam(make_camera())
    pts = torch.tensor([[0, 0, 5.0], [0, 0, -5.0], [0, 0, 0.1]])
    assert tmark(pts, cam.viewmatrix, cam.projmatrix).tolist() == [
        True, False, False]
    rng = np.random.default_rng(2)
    p = rng.normal(0, 3, (500, 3)).astype(np.float32)
    jc = make_camera(R=jgeo.quat_to_rotmat(jnp.asarray([0.9, 0.1, 0.3, 0.0])),
                     t=np.array([0.2, 0.0, 1.0]))
    tc = _tcam(jc)
    np.testing.assert_array_equal(
        tmark(torch.from_numpy(p), tc.viewmatrix, tc.projmatrix).numpy(),
        np.asarray(jmark(jnp.asarray(p), jc.viewmatrix, jc.projmatrix)))


def test_norminit_aligns_first_axis():
    """The port's counterpart of tests/test_norminit.py:13."""
    rng = np.random.default_rng(0)
    n = 40
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-0.8, 0.8, n),
                    np.full(n, 5.0)], 1).astype(np.float32)
    field = tgauss.create_from_points(pts, np.full((n, 3), 0.5), capacity=64,
                                      device="cpu")
    h, w = 64, 128
    cam = _tcam(make_camera(height=h, width=w))
    normal = torch.zeros((3, h, w))
    normal[2] = -1.0
    acc = tnorm.NormalAccumulator.zeros(field.capacity, "cpu")
    acc = tnorm.accumulate_camera_normals(acc, field, cam, normal)
    count = acc.count.numpy()
    assert count[:n].sum() > 0 and count[n:].sum() == 0
    out = tnorm.finalize_normal_init(field, acc)
    R = tgeo.quat_to_rotmat(out.quats[:n]).detach().numpy()
    seen = count[:n] > 0
    dots = np.abs(R[seen, :, 0] @ np.array([0, 0, -1.0]))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)
    s = np.exp(out.log_scales[:n].detach().numpy()[seen])
    np.testing.assert_allclose(s[:, 0], 1e-5, rtol=1e-4)
    np.testing.assert_allclose(s[:, 1:], 1e-1, rtol=1e-4)


def test_norminit_consistency_vote():
    """The port's counterpart of tests/test_norminit.py:45."""
    n = 4
    pts = np.stack([np.linspace(-0.5, 0.5, n), np.zeros(n), np.full(n, 5.0)],
                   1).astype(np.float32)
    field = tgauss.create_from_points(pts, np.full((n, 3), 0.5), capacity=8,
                                      device="cpu")
    h, w = 32, 128
    cam = _tcam(make_camera(height=h, width=w))
    nz = torch.zeros((3, h, w))
    nz[2] = -1.0
    nx = torch.zeros((3, h, w))
    nx[0] = 1.0
    acc = tnorm.NormalAccumulator.zeros(field.capacity, "cpu")
    for nm in (nx, nz, nz):
        tnorm.accumulate_camera_normals(acc, field, cam, nm)
    out = tnorm.finalize_normal_init(field, acc)
    R = tgeo.quat_to_rotmat(out.quats[:n]).detach().numpy()
    assert (np.abs(R[:, 2, 0]) > np.abs(R[:, 0, 0])).all()


def _street_field_and_cameras(readers, gauss, syn, **kw):
    rng = np.random.default_rng(3)
    infos = syn.street_camera_infos(3, 48, 96, fovx=1.2, fovy=0.6,
                                    render_normal=True, **kw)
    pts, cols = syn.sample_scene_points(rng, n_ground=1200, n_box=400,
                                        n_sky=400)
    field = gauss(pts, cols)
    return field, [readers.camera_from_info(i, preload=True) for i in infos]


def test_window_normals_init_matches_jax():
    from vegs_tpu.scene import dataset_readers as jreaders
    from vegs_tpu.utils import synthetic as jsyn
    from vegs_torch.config import VegsConfig
    from vegs_torch.scene import Scene, dataset_readers as treaders
    from vegs_torch.train import Trainer
    from vegs_torch.utils import synthetic as tsyn

    jf, jcams = _street_field_and_cameras(jreaders, jgauss.create_from_points,
                                          jsyn)
    tf, tcams = _street_field_and_cameras(
        treaders, lambda p, c: tgauss.create_from_points(p, c, device="cpu"),
        tsyn, render_gt=True)
    assert tf.capacity == jf.capacity
    jacc = jnorm.NormalAccumulator.zeros(jf.capacity)
    for c in jcams:
        jacc = jnorm.accumulate_camera_normals(
            jacc, jf, c.device_params(), jnp.asarray(c.world_normal()))
    tacc = tnorm.accumulate_cameras(tf, tcams)
    count = tacc.count.numpy()
    np.testing.assert_array_equal(count, np.asarray(jacc.count))
    M, jM = tacc.M.numpy(), np.asarray(jacc.M)
    np.testing.assert_allclose(M, jM, rtol=0,
                               atol=1e-4 * max(1.0, float(count.max())))
    assert (count > 0).sum() > 500

    want = jnorm.finalize_normal_init(jf, jacc)
    got = tnorm.initialize_gaussians_with_window_normals(tf, tcams)
    has = count > 0
    ev = np.linalg.eigvalsh(jM[has].astype(np.float64))
    gap = (ev[:, -1] - ev[:, -2]) / np.maximum(ev[:, -1], 1e-30)
    ok = gap > EIGENGAP
    print(f"norminit: {int((~ok).sum())} of {int(has.sum())} Gaussians with "
          f"top eigengap <= {EIGENGAP} left out")
    assert ok.mean() > 0.9
    Rt = tgeo.quat_to_rotmat(got.quats.detach()).numpy()[has][ok]
    Rj = np.asarray(jgeo.quat_to_rotmat(want.quats))[has][ok]
    dots = np.abs(np.einsum("ni,ni->n", Rt[:, :, 0], Rj[:, :, 0]))
    assert dots.min() >= 1 - 1e-5, dots.min()
    np.testing.assert_array_equal(got.log_scales.detach().numpy()[~has],
                                  np.asarray(want.log_scales)[~has])
    np.testing.assert_allclose(got.log_scales.detach().numpy()[has],
                               np.asarray(want.log_scales)[has], rtol=1e-6)

    # the Trainer's entry: the same field, the count returned
    tf2, tcams2 = _street_field_and_cameras(
        treaders, lambda p, c: tgauss.create_from_points(p, c, device="cpu"),
        tsyn, render_gt=True)

    class _Scene:  # what the Trainer reads of a Scene
        gaussians = tf2
        cameras_extent = 1.0
        box_gaussians = {}
        train_bboxes = test_bboxes = {}

        def getTrainCameras(self):
            return tcams2

    tr = Trainer(VegsConfig(), _Scene(), device="cpu")
    assert tr.init_from_normals() == int(has.sum())
    np.testing.assert_array_equal(tr.state.field.quats.detach().numpy(),
                                  got.quats.detach().numpy())


def test_principal_eigenvector_matches_eigh():
    """`principal_eigenvector` (repeated squaring) against numpy's float64
    `eigh` on sums of 1-6 quaternion outer products, as the accumulator
    holds them: |dot| >= 1 - 1e-5 where the top eigengap exceeds 1e-3 of
    the largest eigenvalue (the rest, printed, have no defined answer)."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(5000, 6, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k = rng.integers(1, 7, 5000)
    w = (np.arange(6)[None] < k[:, None]) * rng.uniform(0.2, 1.0, (5000, 6))
    M = np.einsum("bk,bki,bkj->bij", w, q, q).astype(np.float32)
    got = tnorm.principal_eigenvector(torch.from_numpy(M)).numpy()
    ev, vec = np.linalg.eigh(M.astype(np.float64))
    ok = (ev[:, -1] - ev[:, -2]) / ev[:, -1] > EIGENGAP
    print(f"principal_eigenvector: {int((~ok).sum())} of 5000 left out")
    assert ok.mean() > 0.9
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    dots = np.abs(np.einsum("bi,bi->b", got[ok], vec[ok, :, -1]))
    assert dots.min() >= 1 - 1e-5, dots.min()
