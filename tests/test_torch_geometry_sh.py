"""vegs_torch.sh / vegs_torch.geometry against vegs_tpu on the same inputs.

Inputs come from a numpy seed and go to both packages as numpy arrays.
Tolerance rtol 1e-6, atol 1e-6: both sides evaluate the same float32
expressions, so only operation-order rounding (a few ulps) may differ; the
numpy camera-matrix helpers are copies and must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vegs_tpu import geometry as jgeo, sh as jsh
from vegs_torch import geometry as tgeo, sh as tsh

RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), rtol=rtol, atol=atol)


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[0] = 0.0  # zero-padded slot
    q[1] = [1, 0, 0, 0]
    return q


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh(degree):
    rng = np.random.default_rng(degree)
    k = (degree + 1) ** 2
    sh = rng.normal(size=(50, 3, k)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _close(tsh.eval_sh(degree, torch.from_numpy(sh), torch.from_numpy(d)),
           jsh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(d)))
    rgb = rng.uniform(size=(10, 3)).astype(np.float32)
    _close(tsh.rgb_to_sh(torch.from_numpy(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))
    _close(tsh.sh_to_rgb(torch.from_numpy(rgb)), jsh.sh_to_rgb(jnp.asarray(rgb)))
    assert tsh.num_sh_coeffs(degree) == jsh.num_sh_coeffs(degree)


@pytest.mark.parametrize("name", ["quat_normalize", "quat_standardize",
                                  "quat_conjugate", "quat_to_rotmat",
                                  "quat_multiply", "rotmat_to_quat",
                                  "quat_slerp"])
def test_quaternion_suite(name):
    rng = np.random.default_rng(1)
    a, b = _quats(rng), _quats(rng)
    ta, tb, ja, jb = (torch.from_numpy(a), torch.from_numpy(b),
                      jnp.asarray(a), jnp.asarray(b))
    if name == "quat_multiply":
        _close(tgeo.quat_multiply(ta, tb), jgeo.quat_multiply(ja, jb))
    elif name == "rotmat_to_quat":
        m = np.array(jgeo.quat_to_rotmat(ja))
        _close(tgeo.rotmat_to_quat(torch.from_numpy(m)),
               jgeo.rotmat_to_quat(jnp.asarray(m)))
    elif name == "quat_slerp":
        for t in (0.0, 0.3, 1.0):
            _close(tgeo.quat_slerp(ta[2:], tb[2:], t),
                   jgeo.quat_slerp(ja[2:], jb[2:], t), rtol=1e-5, atol=1e-5)
        # near-identical quaternions take the lerp branch
        _close(tgeo.quat_slerp(ta[2:], ta[2:], 0.5),
               jgeo.quat_slerp(ja[2:], ja[2:], 0.5))
    else:
        _close(getattr(tgeo, name)(ta), getattr(jgeo, name)(ja))


def test_covariance_forms():
    rng = np.random.default_rng(2)
    q = _quats(rng)
    s = rng.uniform(0.01, 0.5, (64, 3)).astype(np.float32)
    tq, ts, jq, js = (torch.from_numpy(q), torch.from_numpy(s),
                      jnp.asarray(q), jnp.asarray(s))
    _close(tgeo.cov6_from_scaling_rotation(ts, tq, 1.3),
           jgeo.cov6_from_scaling_rotation(js, jq, 1.3))
    full_t = tgeo.covariance_from_scaling_rotation(ts, tq)
    _close(full_t, jgeo.covariance_from_scaling_rotation(js, jq))
    _close(tgeo.strip_symmetric(full_t),
           jgeo.strip_symmetric(jgeo.covariance_from_scaling_rotation(js, jq)))
    six = tgeo.strip_symmetric(full_t)
    _close(tgeo.unstrip_symmetric(six), jgeo.unstrip_symmetric(six.numpy()))


def test_decompose_compose_transform():
    rng = np.random.default_rng(3)
    R = np.array(jgeo.quat_to_rotmat(jnp.asarray(_quats(rng, 5)[2:])))
    S = rng.uniform(0.5, 3.0, (3, 3)).astype(np.float32)
    t = rng.normal(size=(3, 3)).astype(np.float32)
    T_t = tgeo.compose_T(torch.from_numpy(R), torch.from_numpy(S),
                         torch.from_numpy(t))
    T_j = jgeo.compose_T(jnp.asarray(R), jnp.asarray(S), jnp.asarray(t))
    _close(T_t, T_j)
    for a, b in zip(tgeo.decompose_T_to_RS(T_t), jgeo.decompose_T_to_RS(T_j)):
        _close(a, b)


def test_camera_matrices_are_copies():
    rng = np.random.default_rng(4)
    R = np.asarray(jgeo.quat_to_rotmat(jnp.asarray(_quats(rng, 3)[2])))
    t = rng.normal(size=3)
    for kw in ({}, {"translate": [0.5, -1.0, 2.0], "scale": 1.7}):
        np.testing.assert_array_equal(tgeo.world_to_view(R, t, **kw),
                                      jgeo.world_to_view(R, t, **kw))
    np.testing.assert_array_equal(
        tgeo.projection_matrix(0.01, 100.0, 1.2, 0.7, 0.1, -0.05),
        jgeo.projection_matrix(0.01, 100.0, 1.2, 0.7, 0.1, -0.05))
    args = (0.01, 100.0, 1.2, 0.4, 600.0, 610.0, 700.5, 190.2, 1408, 376)
    np.testing.assert_array_equal(tgeo.projection_matrix_from_K(*args),
                                  jgeo.projection_matrix_from_K(*args))
    assert tgeo.fov_to_focal(1.2, 1408) == jgeo.fov_to_focal(1.2, 1408)
    assert tgeo.focal_to_fov(600.0, 1408) == jgeo.focal_to_fov(600.0, 1408)


def test_cam_normal_to_world_normal():
    rng = np.random.default_rng(5)
    n = rng.normal(size=(6, 7, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R = (q * np.sign(np.linalg.det(q))).astype(np.float32)  # a rotation
    _close(tgeo.cam_normal_to_world_normal(torch.from_numpy(n),
                                           torch.from_numpy(R)),
           jgeo.cam_normal_to_world_normal(jnp.asarray(n), jnp.asarray(R)))
