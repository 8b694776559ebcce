"""Learned priors (port of vegs_tpu/priors): the normal-guided covariance
init, and the DPT normal estimator in `priors.dpt` (imported on its own:
the init does not need it)."""

from .norminit import (  # noqa: F401
    NormalAccumulator,
    accumulate_cameras,
    accumulate_camera_normals,
    finalize_normal_init,
    initialize_gaussians_with_window_normals,
    normal_map_to_quats,
)
