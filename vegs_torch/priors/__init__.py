"""Learned-prior initialization (port of vegs_tpu/priors; the normal-guided
covariance init; the DPT normal estimator is not ported yet)."""

from .norminit import (  # noqa: F401
    NormalAccumulator,
    accumulate_cameras,
    accumulate_camera_normals,
    finalize_normal_init,
    initialize_gaussians_with_window_normals,
    normal_map_to_quats,
)
