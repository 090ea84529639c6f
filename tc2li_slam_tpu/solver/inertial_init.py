"""Visual-inertial initialization: gravity / scale / bias estimation.

Batched replacement for the reference's three-stage IMU initialization
(``LocalMapping::InitializeIMU``, LocalMapping.cc:1184-1445):

1. ``estimate_gravity_direction`` — closed-form gravity bootstrap from the
   preintegrated velocity deltas (LocalMapping.cc:1242-1269: dirG =
   -sum R_wb_i dV_i, rotated onto -z).
2. ``inertial_optimization`` — the ``Optimizer::InertialOptimization``
   (Optimizer.cc:2169,2359) problem: keyframe poses FIXED, estimate gravity
   direction (2-dof tangent), log-scale, one shared gyro/accel bias, and
   per-KF velocities from the IMU preintegration factors (``EdgeInertialGS``
   residuals, G2oTypes.h:558) with bias priors. Solved as damped Gauss-Newton
   with exact autodiff Jacobians (the problem is tiny: 9 + 3K unknowns).
3. ``apply_scaled_rotation`` — ``Map::ApplyScaledRotation`` (Map.cc:126h):
   gravity-align + rescale every pose / landmark / velocity, leaving
   reprojection residuals invariant.

``FullInertialBA`` (Optimizer.cc:394) is covered by running
``inertial_ba.lvi_ba`` over the full keyframe set after this bootstrap (the
system layer wires that up).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom import lie
from ..numerics import f32_highest
from .lm import precond_solve

G_MAG = 9.81
_G_I = jnp.asarray([0.0, 0.0, -G_MAG])  # canonical gravity (z down)


@f32_highest
def estimate_gravity_direction(
    R_wb: jax.Array,   # [K, 3, 3] body rotations at KFs
    dV: jax.Array,     # [K-1, 3] preintegrated velocity deltas (factor i: i->i+1)
    valid: jax.Array,  # [K-1]
) -> jax.Array:
    """Initial R_wg such that gravity_w ~ R_wg @ (0, 0, -9.81).

    While the platform's mean acceleration is ~0, sum_i R_i dV_i ~ -g * T —
    the reference's bootstrap (LocalMapping.cc:1242-1269).
    """
    contrib = jnp.einsum("kij,kj->ki", R_wb[:-1], dV)
    dirG = -jnp.sum(contrib * valid[:, None], axis=0)
    dirG = dirG / jnp.maximum(jnp.linalg.norm(dirG), 1e-9)
    gI = jnp.asarray([0.0, 0.0, -1.0])
    v = jnp.cross(gI, dirG)
    nv = jnp.linalg.norm(v)
    cosg = jnp.clip(jnp.dot(gI, dirG), -1.0, 1.0)
    ang = jnp.arccos(cosg)
    axis = jnp.where(nv > 1e-9, v / jnp.maximum(nv, 1e-9), jnp.asarray([1.0, 0.0, 0.0]))
    return lie.so3_exp(axis * ang)


@f32_highest
def gravity_to_rwg(g_w: jax.Array) -> jax.Array:
    """R_wg with g_w ~ R_wg @ (0, 0, -9.81) — wraps a known gravity vector
    (e.g. the ESEKF static-init estimate) as the optimization's frame."""
    dirG = g_w / jnp.maximum(jnp.linalg.norm(g_w), 1e-9)
    gI = jnp.asarray([0.0, 0.0, -1.0])
    v = jnp.cross(gI, dirG)
    nv = jnp.linalg.norm(v)
    cosg = jnp.clip(jnp.dot(gI, dirG), -1.0, 1.0)
    ang = jnp.arccos(cosg)
    axis = jnp.where(nv > 1e-9, v / jnp.maximum(nv, 1e-9),
                     jnp.asarray([1.0, 0.0, 0.0]))
    return lie.so3_exp(axis * ang)


class InertialInitResult(NamedTuple):
    R_wg: jax.Array    # [3, 3] gravity direction (g_w = R_wg @ (0,0,-9.81))
    scale: jax.Array   # scalar
    bg: jax.Array      # [3] shared gyro bias
    ba: jax.Array      # [3] shared accel bias
    vel: jax.Array     # [K, 3] per-KF velocities (world)
    cost: jax.Array


@partial(jax.jit, static_argnames=("iters", "fix_scale", "fix_gravity"))
@f32_highest
def inertial_optimization(
    T_wb: jax.Array,    # [K, 4, 4] fixed body poses
    dR: jax.Array,      # [K-1, 3, 3] preintegrated deltas (factor i: i->i+1)
    dV: jax.Array,      # [K-1, 3]
    dP: jax.Array,      # [K-1, 3]
    JRg: jax.Array,     # [K-1, 3, 3] bias jacobians
    JVg: jax.Array, JVa: jax.Array, JPg: jax.Array, JPa: jax.Array,
    dt: jax.Array,      # [K-1]
    C_inv: jax.Array,   # [K-1, 9, 9]
    bg_lin: jax.Array,  # [K-1, 3] linearization biases of each factor
    ba_lin: jax.Array,  # [K-1, 3]
    valid: jax.Array,   # [K-1]
    R_wg0: jax.Array,   # [3, 3] initial gravity direction
    vel0: jax.Array,    # [K, 3] initial velocities
    prior_g: float = 1e2,
    prior_a: float = 1e6,
    fix_scale: bool = True,
    fix_gravity: bool = False,
    iters: int = 20,
) -> InertialInitResult:
    """EdgeInertialGS bundle: gravity dir + (scale) + shared biases + velocities.

    ``fix_gravity`` freezes the gravity tangent at ``R_wg0``: with a LiDAR-
    inertial front end the ESEKF's static-init gravity is more accurate than
    what fixed visual poses can support (their correlated rotation errors
    leak ~1-2 degrees into the gravity estimate), so the system keeps the
    LIO gravity and estimates only biases + velocities here."""
    K = T_wb.shape[0]
    R_wb = T_wb[:, :3, :3]
    p_wb = T_wb[:, :3, 3]
    dtype = T_wb.dtype

    n_x = 9 + 3 * K  # [phi_g(2) pad(1) | log_s | bg(3) ba(3)... layout below]
    # layout: x[0:2] gravity tangent (x, y), x[2] log-scale, x[3:6] bg,
    # x[6:9] ba, x[9:] velocities
    x0 = jnp.zeros(n_x, dtype).at[9:].set(vel0.reshape(-1))

    sqrt_pg = jnp.sqrt(jnp.asarray(prior_g, dtype))
    sqrt_pa = jnp.sqrt(jnp.asarray(prior_a, dtype))

    def residuals(x):
        phi = jnp.asarray([x[0], x[1], 0.0])
        R_wg = R_wg0 @ lie.so3_exp(phi)          # VertexGDir 2-dof update
        g_w = R_wg @ _G_I
        s = 1.0 if fix_scale else jnp.exp(x[2])
        bg = x[3:6]
        ba = x[6:9]
        vel = x[9:].reshape(K, 3)

        def factor(i):
            R1, R2 = R_wb[i], R_wb[i + 1]
            p1, p2 = p_wb[i], p_wb[i + 1]
            v1, v2 = vel[i], vel[i + 1]
            dti = dt[i]
            # exact bias re-correction of the preintegrated deltas
            dR_c = dR[i] @ lie.so3_exp(JRg[i] @ (bg - bg_lin[i]))
            dV_c = dV[i] + JVg[i] @ (bg - bg_lin[i]) + JVa[i] @ (ba - ba_lin[i])
            dP_c = dP[i] + JPg[i] @ (bg - bg_lin[i]) + JPa[i] @ (ba - ba_lin[i])
            er = lie.so3_log(dR_c.T @ R1.T @ R2)
            ev = R1.T @ (s * (v2 - v1) - g_w * dti) - dV_c
            ep = R1.T @ (s * (p2 - p1 - v1 * dti) - 0.5 * g_w * dti * dti) - dP_c
            r9 = jnp.concatenate([er, ev, ep])
            # whiten with the preintegration information (Cholesky of C_inv)
            L = jnp.linalg.cholesky(
                C_inv[i] + 1e-6 * jnp.eye(9, dtype=dtype)
            )
            return (L.T @ r9) * valid[i].astype(dtype)

        r_fac = jax.vmap(factor)(jnp.arange(K - 1)).reshape(-1)
        r_prior = jnp.concatenate([sqrt_pg * bg, sqrt_pa * ba])
        return jnp.concatenate([r_fac, r_prior])

    def gn_step(carry, _):
        x, lam, cost_prev = carry
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)
        H = J.T @ J
        g = J.T @ r
        if fix_scale:
            # freeze the scale coordinate
            H = H.at[2, :].set(0.0).at[:, 2].set(0.0).at[2, 2].set(1.0)
            g = g.at[2].set(0.0)
        if fix_gravity:
            for c in (0, 1):
                H = H.at[c, :].set(0.0).at[:, c].set(0.0).at[c, c].set(1.0)
                g = g.at[c].set(0.0)
        Haug = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(n_x, dtype=dtype)
        # Jacobi-preconditioned: whitened IMU residual Jacobians are O(1e3+)
        # while gravity-tangent columns are O(1) — f32 needs the rescale.
        dx = -precond_solve(Haug, g)
        x_new = x + dx
        cost_new = jnp.sum(residuals(x_new) ** 2)
        accept = cost_new < cost_prev
        x = jnp.where(accept, x_new, x)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        cost = jnp.where(accept, cost_new, cost_prev)
        return (x, lam, cost), None

    cost0 = jnp.sum(residuals(x0) ** 2)
    (x, _, cost), _ = jax.lax.scan(
        gn_step, (x0, jnp.asarray(1e-4, dtype), cost0), None, length=iters
    )

    phi = jnp.asarray([x[0], x[1], 0.0])
    return InertialInitResult(
        R_wg=R_wg0 @ lie.so3_exp(phi),
        scale=jnp.asarray(1.0, dtype) if fix_scale else jnp.exp(x[2]),
        bg=x[3:6],
        ba=x[6:9],
        vel=x[9:].reshape(K, 3),
        cost=cost,
    )


@f32_highest
def apply_scaled_rotation(
    T_cw: jax.Array,   # [K, 4, 4] camera-from-world poses
    lm_pos: jax.Array,  # [L, 3] landmarks (world)
    vel: jax.Array,    # [K, 3] velocities (world)
    R_yw: jax.Array,   # [3, 3] new-world-from-old-world rotation
    scale: jax.Array | float = 1.0,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Gravity-align + rescale the map: x_y = s * R_yw @ x_w.

    Camera poses become R_cy = R_cw R_yw^T, t_cy = s t_cw, which leaves every
    reprojection residual invariant (camera-frame points scale uniformly).
    Mirrors ``Map::ApplyScaledRotation`` (Map.cc:126h).
    """
    s = jnp.asarray(scale, T_cw.dtype)
    R_cw = T_cw[:, :3, :3]
    t_cw = T_cw[:, :3, 3]
    R_cy = jnp.einsum("kij,lj->kil", R_cw, R_yw)  # R_cw @ R_yw^T
    T_new = jnp.tile(jnp.eye(4, dtype=T_cw.dtype), (T_cw.shape[0], 1, 1))
    T_new = T_new.at[:, :3, :3].set(R_cy).at[:, :3, 3].set(s * t_cw)
    lm_new = s * lm_pos @ R_yw.T
    vel_new = s * vel @ R_yw.T
    return T_new, lm_new, vel_new
