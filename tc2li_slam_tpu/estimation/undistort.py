"""Scan motion compensation (de-skew) to the scan-end pose.

Replaces ``ImuProcess::UndistortPcl`` (``IMU_Processing.cpp:160-277``): the
reference forward-propagates the ESEKF through the scan's IMU samples saving a
pose list, then walks the points backwards compensating each to the scan-end
frame. Here ``esekf.predict`` already emits the per-sample pose trajectory;
compensation is a batched searchsorted + SE3 interpolation over all points at
once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geom import lie
from ..numerics import f32_highest


@jax.jit
@f32_highest
def undistort(
    points_l: jax.Array,   # [M, 3] raw points in LiDAR frame
    t_points: jax.Array,   # [M] per-point time within scan [s]
    t_samples: jax.Array,  # [N] IMU sample times (ascending; pad with +inf)
    R_traj: jax.Array,     # [N, 3, 3] body pose after each sample
    p_traj: jax.Array,     # [N, 3]
    R_LI: jax.Array,       # [3, 3] body-from-lidar extrinsic
    t_LI: jax.Array,       # [3]
) -> jax.Array:
    """Returns points in the LiDAR frame at scan end (last valid sample)."""
    N = t_samples.shape[0]
    finite = jnp.isfinite(t_samples)
    last = jnp.maximum(jnp.sum(finite.astype(jnp.int32)) - 1, 0)
    R_end = R_traj[last]
    p_end = p_traj[last]

    # Segment for each point: pose interpolated between samples i-1 and i.
    idx = jnp.clip(jnp.searchsorted(t_samples, t_points), 1, N - 1)
    idx = jnp.minimum(idx, last)
    t0 = t_samples[idx - 1]
    t1 = t_samples[idx]
    alpha = jnp.clip((t_points - t0) / jnp.maximum(t1 - t0, 1e-9), 0.0, 1.0)

    T0 = lie.se3(R_traj[idx - 1], p_traj[idx - 1])
    T1 = lie.se3(R_traj[idx], p_traj[idx])
    T_p = lie.se3_interpolate(T0, T1, alpha)

    # lidar -> body -> world at t_p -> body at end -> lidar at end
    p_b = points_l @ R_LI.T + t_LI
    p_w = jnp.einsum("mij,mj->mi", lie.rotation(T_p), p_b) + lie.translation(T_p)
    p_bend = (p_w - p_end) @ R_end
    return (p_bend - t_LI) @ R_LI
