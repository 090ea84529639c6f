"""Residual/Jacobian providers for the factor-graph optimizer.

Replaces the g2o edge types the reference uses
(``OptimizableTypes.cpp``: EdgeSE3ProjectXYZ{,OnlyPose}; ``G2oTypes.cc``:
EdgeMono/EdgeStereo, EdgeInertial, EdgeGyroRW/AccRW, EdgePriorPoseImu) with
batched pure functions: each returns residuals and analytic Jacobians for a
whole observation set at once.

Conventions
-----------
- Visual problems parameterize T_cw (world->camera) with a LEFT-multiplicative
  tangent update ``T <- exp(δ) T``, δ = (rho, phi). For a camera point
  ``Xc = T_cw Xw``: dXc/dδ = [I | -hat(Xc)].
- Inertial problems parameterize the body pose T_wb with RIGHT-multiplicative
  update (``R <- R Exp(φ)``, ``p <- p + R δp`` — matching the reference's
  ``VertexPose``/ImuCamPose update, G2oTypes.cc) plus velocity/bias vectors.
- Residuals are weighted by per-observation information (inverse sigma^2 of
  the keypoint's octave) and a Huber robust kernel at the same thresholds as
  the reference (sqrt(5.991) mono, sqrt(7.815) stereo).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom import camera as cam_mod, lie
from ..numerics import f32_highest

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2: jax.Array, delta2: float) -> jax.Array:
    """rho'(chi2) for the Huber kernel with threshold delta (squared)."""
    return jnp.where(chi2 <= delta2, 1.0, jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)))


# ---------------------------------------------------------------------------
# Reprojection (T_cw parameterization)
# ---------------------------------------------------------------------------

class ReprojResult(NamedTuple):
    r: jax.Array        # [O, D] residuals (D = 2 mono, 3 stereo)
    J_pose: jax.Array   # [O, D, 6]
    J_lm: jax.Array     # [O, D, 3]
    chi2: jax.Array     # [O] information-weighted squared error
    depth_ok: jax.Array  # [O] positive-depth gate


@f32_highest
def reproj_residuals(
    cam: cam_mod.Pinhole,
    T_cw: jax.Array,     # [O, 4, 4] pose per observation (gathered)
    X_w: jax.Array,      # [O, 3] landmark per observation (gathered)
    uv_obs: jax.Array,   # [O, 3] (u, v, u_r); u_r < 0 => mono observation
    inv_sigma2: jax.Array,  # [O]
    stereo: jax.Array,   # [O] bool
) -> ReprojResult:
    """Mono + stereo reprojection residuals with analytic Jacobians.

    Mono rows use only the first 2 residual components (third zeroed);
    matches EdgeSE3ProjectXYZ / EdgeStereoSE3ProjectXYZ up to the residual
    sign (we use predicted - observed).
    """
    Xc = lie.se3_apply(T_cw, X_w)                  # [O, 3]
    pred = cam_mod.project_stereo(cam, Xc)         # [O, 3]
    r = pred - uv_obs
    r = jnp.where(stereo[:, None], r, r.at[:, 2].set(0.0))

    Jproj = cam_mod.project_stereo_jac(cam, Xc)    # [O, 3, 3]
    Jproj = jnp.where(stereo[:, None, None], Jproj, Jproj.at[:, 2, :].set(0.0))
    # dXc/dδ = [I | -hat(Xc)]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), Xc.shape[:-1] + (3, 3))
    dX_dpose = jnp.concatenate([eye, -lie.hat(Xc)], axis=-1)  # [O, 3, 6]
    J_pose = Jproj @ dX_dpose
    J_lm = Jproj @ lie.rotation(T_cw)

    dim = jnp.where(stereo, 3.0, 2.0)
    del dim
    chi2 = inv_sigma2 * jnp.sum(r * r, axis=-1)
    depth_ok = Xc[..., 2] > 0.05
    return ReprojResult(r, J_pose, J_lm, chi2, depth_ok)


# ---------------------------------------------------------------------------
# IMU preintegration factor (T_wb parameterization)
# ---------------------------------------------------------------------------

class ImuFactorResult(NamedTuple):
    r: jax.Array      # [9] (er, ev, ep)
    # Jacobians w.r.t. (φ1, δp1, v1, bg, ba, φ2, δp2, v2) stacked as a dict
    J1_pose: jax.Array  # [9, 6] w.r.t. (φ1, δp1)
    J1_vel: jax.Array   # [9, 3]
    J_bg: jax.Array     # [9, 3]
    J_ba: jax.Array     # [9, 3]
    J2_pose: jax.Array  # [9, 6]
    J2_vel: jax.Array   # [9, 3]
    info: jax.Array     # [9, 9] information (inverse preintegration cov)


@f32_highest
def imu_residual(
    R1: jax.Array, p1: jax.Array, v1: jax.Array,
    R2: jax.Array, p2: jax.Array, v2: jax.Array,
    bg: jax.Array, ba: jax.Array,
    dR_c: jax.Array,   # bias-corrected preintegrated deltas
    dV_c: jax.Array,
    dP_c: jax.Array,
    JRg: jax.Array,    # bias jacobians (from the preintegration)
    JVg: jax.Array, JVa: jax.Array, JPg: jax.Array, JPa: jax.Array,
    dt: jax.Array,
    C9_inv: jax.Array,  # [9, 9] information of (dR, dV, dP)
    gravity: jax.Array,
) -> ImuFactorResult:
    """EdgeInertial residual (G2oTypes.cc:505h ``EdgeInertial::computeError``):

        er = Log(dR_c^T R1^T R2)
        ev = R1^T (v2 - v1 - g dt) - dV_c
        ep = R1^T (p2 - p1 - v1 dt - 0.5 g dt^2) - dP_c
    """
    eR = dR_c.T @ R1.T @ R2
    er = lie.so3_log(eR)
    ev = R1.T @ (v2 - v1 - gravity * dt) - dV_c
    ep = R1.T @ (p2 - p1 - v1 * dt - 0.5 * gravity * dt * dt) - dP_c
    r = jnp.concatenate([er, ev, ep])

    invJr = lie.so3_right_jacobian_inv(er)
    z3 = jnp.zeros((3, 3), R1.dtype)

    # w.r.t. φ1 (right perturbation R1 <- R1 Exp(φ1)):
    der_dphi1 = -invJr @ (R2.T @ R1)
    dev_dphi1 = lie.hat(R1.T @ (v2 - v1 - gravity * dt))
    dep_dphi1 = lie.hat(R1.T @ (p2 - p1 - v1 * dt - 0.5 * gravity * dt * dt))
    # w.r.t. δp1 (p1 <- p1 + R1 δp1, reference VertexPose update)
    dep_dp1 = -jnp.eye(3, dtype=R1.dtype)
    J1_pose = jnp.block([[der_dphi1, z3], [dev_dphi1, z3], [dep_dphi1, dep_dp1]])

    dev_dv1 = -R1.T
    dep_dv1 = -R1.T * dt
    J1_vel = jnp.concatenate([z3, dev_dv1, dep_dv1], axis=0)

    # w.r.t. bias (through the bias-corrected deltas); the inner Jr(JRg db)
    # factor is ~I between relinearizations, as in the reference.
    der_dbg = -invJr @ eR.T @ JRg
    dev_dbg = -JVg
    dev_dba = -JVa
    dep_dbg = -JPg
    dep_dba = -JPa
    J_bg = jnp.concatenate([der_dbg, dev_dbg, dep_dbg], axis=0)
    J_ba = jnp.concatenate([z3, dev_dba, dep_dba], axis=0)

    # w.r.t. φ2 / δp2
    der_dphi2 = invJr
    dep_dp2 = R1.T @ R2
    J2_pose = jnp.block([[der_dphi2, z3], [z3, z3], [z3, dep_dp2]])
    dev_dv2 = R1.T
    J2_vel = jnp.concatenate([z3, dev_dv2, z3], axis=0)

    return ImuFactorResult(r, J1_pose, J1_vel, J_bg, J_ba, J2_pose, J2_vel, C9_inv)


def bias_rw_residual(bg1, ba1, bg2, ba2, info_g, info_a):
    """EdgeGyroRW / EdgeAccRW: random-walk residual between consecutive KFs."""
    return bg2 - bg1, ba2 - ba1, info_g, info_a
