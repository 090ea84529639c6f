"""Visual-inertial(-LiDAR) local bundle adjustment over a temporal KF window.

Replaces ``Optimizer::LocalInertialBA`` (Optimizer.cc:1512) and
``OptimizerWithLidar::LocalLVIBA`` (OptimizerWithLidar.cc:489): the temporal
window of the last N keyframes with per-KF state
``[pose(6) | velocity(3) | gyro bias(3) | accel bias(3)]`` = 15 dims,
connected by IMU preintegration factors + bias random-walk factors between
consecutive KFs, mono/stereo reprojection factors to the window landmarks,
and (optionally) the BALM plane eigen-factor over the first ``W_lidar``
poses — injected as a dense cross-pose quadratic exactly like the
reference's ``EdgeLidar::constructQuadraticForm``.

Pose tangent is the library-wide right-multiplicative se3 (rho, phi)
(``T_wb <- T_wb exp(xi)``), so the BALM body-frame chain rule is a single
adjoint transport ``Adj(T_lb)`` per pose (LidarRes::ComputeJandH's role).
Landmarks are Schur-eliminated; the reduced [15P, 15P] system is dense.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom import camera as cam_mod, lie
from ..numerics import f32_highest
from . import balm as balm_mod, factors
from .lm import BAObservations, inv3x3 as lm_inv3x3, \
    precond_solve as lm_precond_solve

D = 15  # per-KF state dim
POSE = slice(0, 6)   # (rho, phi)
VEL = slice(6, 9)
BG = slice(9, 12)
BA_ = slice(12, 15)


class ImuWindowFactors(NamedTuple):
    """Preintegration between consecutive window KFs (i -> i+1), padded."""

    dR: jax.Array     # [P-1, 3, 3]
    dV: jax.Array     # [P-1, 3]
    dP: jax.Array     # [P-1, 3]
    JRg: jax.Array    # [P-1, 3, 3]
    JVg: jax.Array
    JVa: jax.Array
    JPg: jax.Array
    JPa: jax.Array
    dt: jax.Array     # [P-1]
    C_inv: jax.Array  # [P-1, 9, 9] information of (dR, dV, dP)
    bg_lin: jax.Array  # [P-1, 3] linearization gyro bias
    ba_lin: jax.Array  # [P-1, 3]
    info_bg: jax.Array  # [P-1] bias RW information scalars
    info_ba: jax.Array  # [P-1]
    valid: jax.Array  # [P-1]


class InertialState(NamedTuple):
    T_wb: jax.Array   # [P, 4, 4]
    vel: jax.Array    # [P, 3]
    bg: jax.Array     # [P, 3]
    ba: jax.Array     # [P, 3]


@f32_highest
def _apply_delta(s: InertialState, dx: jax.Array) -> InertialState:
    """dx [P, 15] in (rho, phi, v, bg, ba)."""
    return InertialState(
        T_wb=s.T_wb @ lie.se3_exp(dx[:, POSE]),
        vel=s.vel + dx[:, VEL],
        bg=s.bg + dx[:, BG],
        ba=s.ba + dx[:, BA_],
    )


@f32_highest
def _visual_residuals(cam, T_cb, s: InertialState, X_w, obs: BAObservations):
    """Reprojection through body poses: X_c = T_cb * T_bw * X_w."""
    L, K = obs.pose_idx.shape
    pidx = jnp.clip(obs.pose_idx, 0, s.T_wb.shape[0] - 1).reshape(-1)
    T_bw = lie.se3_inverse(s.T_wb)[pidx]
    X_o = jnp.repeat(X_w, K, axis=0)
    X_b = lie.se3_apply(T_bw, X_o)
    R_cb = lie.rotation(T_cb)
    X_c = X_b @ R_cb.T + lie.translation(T_cb)
    pred = cam_mod.project_stereo(cam, X_c)
    uv = obs.uv.reshape(-1, 3)
    stereo = obs.stereo.reshape(-1)
    r = pred - uv
    r = jnp.where(stereo[:, None], r, r.at[:, 2].set(0.0))
    Jproj = cam_mod.project_stereo_jac(cam, X_c)
    Jproj = jnp.where(stereo[:, None, None], Jproj, Jproj.at[:, 2, :].set(0.0))
    # dX_b/d(rho, phi) = [-I | hat(X_b)] (right perturbation of T_wb)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=X_b.dtype), X_b.shape[:-1] + (3, 3))
    dXb = jnp.concatenate([-eye, lie.hat(X_b)], axis=-1)  # [O, 3, 6]
    J_pose = Jproj @ R_cb @ dXb
    J_lm = Jproj @ R_cb @ lie.rotation(T_bw)
    inv_sigma2 = obs.inv_sigma2.reshape(-1)
    chi2 = inv_sigma2 * jnp.sum(r * r, axis=-1)
    depth_ok = X_c[:, 2] > 0.05
    return r, J_pose, J_lm, chi2, depth_ok, pidx


@f32_highest
def _imu_terms(s: InertialState, fac: ImuWindowFactors, gravity):
    """Assemble IMU + bias-RW quadratic terms into [P*D, P*D] dense H, g."""
    P = s.T_wb.shape[0]
    R = lie.rotation(s.T_wb)
    p = lie.translation(s.T_wb)

    def one(i):
        bg = s.bg[i]
        ba = s.ba[i]
        dbg = bg - fac.bg_lin[i]
        dba = ba - fac.ba_lin[i]
        dR_c = fac.dR[i] @ lie.so3_exp(fac.JRg[i] @ dbg)
        dV_c = fac.dV[i] + fac.JVg[i] @ dbg + fac.JVa[i] @ dba
        dP_c = fac.dP[i] + fac.JPg[i] @ dbg + fac.JPa[i] @ dba
        out = factors.imu_residual(
            R[i], p[i], s.vel[i], R[i + 1], p[i + 1], s.vel[i + 1],
            bg, ba, dR_c, dV_c, dP_c,
            fac.JRg[i], fac.JVg[i], fac.JVa[i], fac.JPg[i], fac.JPa[i],
            fac.dt[i], fac.C_inv[i], gravity,
        )
        return out

    idx = jnp.arange(P - 1)
    outs = jax.vmap(one)(idx)

    # Factor state layout: x_i = [rho phi v bg ba]; imu_residual returns pose
    # jacobians w.r.t. (phi, dp_body) — reorder to (rho=dp_body, phi).
    def reorder(Jp):  # [.., 9, 6] (phi, dp) -> (rho, phi)
        return jnp.concatenate([Jp[..., 3:6], Jp[..., 0:3]], axis=-1)

    J1 = jnp.concatenate(
        [reorder(outs.J1_pose), outs.J1_vel, outs.J_bg, outs.J_ba], axis=-1
    )  # [P-1, 9, 15]
    Z93 = jnp.zeros_like(outs.J_bg)
    J2 = jnp.concatenate(
        [reorder(outs.J2_pose), outs.J2_vel, Z93, Z93], axis=-1
    )  # [P-1, 9, 15]

    w = fac.valid.astype(J1.dtype)
    info = outs.info * w[:, None, None]
    IJ1 = jnp.einsum("fij,fjk->fik", info, J1)
    IJ2 = jnp.einsum("fij,fjk->fik", info, J2)
    H11 = jnp.einsum("fji,fjk->fik", J1, IJ1)
    H12 = jnp.einsum("fji,fjk->fik", J1, IJ2)
    H22 = jnp.einsum("fji,fjk->fik", J2, IJ2)
    g1 = jnp.einsum("fji,fj->fi", IJ1, outs.r)
    g2 = jnp.einsum("fji,fj->fi", IJ2, outs.r)

    H = jnp.zeros((P, P, D, D), J1.dtype)
    i1 = idx
    i2 = idx + 1
    H = H.at[i1, i1].add(H11)
    H = H.at[i1, i2].add(H12)
    H = H.at[i2, i1].add(jnp.swapaxes(H12, -1, -2))
    H = H.at[i2, i2].add(H22)
    g = jnp.zeros((P, D), J1.dtype)
    g = g.at[i1].add(g1)
    g = g.at[i2].add(g2)

    # Bias random-walk factors
    rbg = s.bg[1:] - s.bg[:-1]
    rba = s.ba[1:] - s.ba[:-1]
    wg = fac.info_bg * w
    wa = fac.info_ba * w
    eye3 = jnp.eye(3, dtype=J1.dtype)
    Hb = jnp.einsum("f,ij->fij", wg, eye3)
    Ha = jnp.einsum("f,ij->fij", wa, eye3)
    for (sl, Hx, rx, wx) in ((BG, Hb, rbg, wg), (BA_, Ha, rba, wa)):
        H = H.at[i1, i1, sl, sl].add(Hx)
        H = H.at[i2, i2, sl, sl].add(Hx)
        H = H.at[i1, i2, sl, sl].add(-Hx)
        H = H.at[i2, i1, sl, sl].add(-Hx)
        g = g.at[i1, sl].add(-wx[:, None] * rx)
        g = g.at[i2, sl].add(wx[:, None] * rx)

    cost = jnp.sum(jnp.einsum("fi,fij,fj->f", outs.r, info, outs.r))
    cost = cost + jnp.sum(wg * jnp.sum(rbg * rbg, -1)) + jnp.sum(wa * jnp.sum(rba * rba, -1))
    return H, g, cost


class LviBaResult(NamedTuple):
    state: InertialState
    X_w: jax.Array
    cost: jax.Array
    obs_inlier: jax.Array


@partial(jax.jit, static_argnames=("iters", "use_balm", "n_lidar"))
@f32_highest
def lvi_ba(
    cam: cam_mod.Pinhole,
    T_cb: jax.Array,          # [4, 4] camera-from-body extrinsic
    state0: InertialState,    # [P] window states (temporal order)
    X_w0: jax.Array,          # [L, 3]
    obs: BAObservations,
    imu_fac: ImuWindowFactors,
    fixed: jax.Array,         # [P] bool (first KF anchored in the reference)
    valid_lm: jax.Array,      # [L]
    gravity: jax.Array,       # [3]
    balm_clusters=None,       # VoxelClusters over first n_lidar poses
    T_bl: jax.Array | None = None,  # [4, 4] body-from-lidar
    w_lidar: float = 0.01,    # LiDAR.wLBA information weight
    iters: int = 8,
    use_balm: bool = False,
    n_lidar: int = 0,
) -> LviBaResult:
    """LocalLVIBA: temporal-window inertial BA + reprojection + BALM edge."""
    P = state0.T_wb.shape[0]
    L, K = obs.pose_idx.shape
    PD = P * D

    if use_balm:
        Adj_lb = lie.se3_adjoint(lie.se3_inverse(T_bl))  # tangent_b -> tangent_l

    def balm_quad(s: InertialState):
        """BALM quadratic transported to body-pose tangents of first n_lidar."""
        T_wl = s.T_wb[:n_lidar] @ T_bl
        q = balm_mod.quadratic(balm_clusters, T_wl)
        A = jnp.kron(jnp.eye(n_lidar, dtype=q.H.dtype), Adj_lb)  # [6n, 6n]
        Hb = A.T @ q.H @ A * w_lidar
        gb = A.T @ q.g * w_lidar
        return Hb, gb, q.cost * w_lidar

    # Lazy relinearization (is_calc_hess, G2oTypesWithLidar.h:134-138):
    # eigen-Hessian once at the entry state; gradient/cost follow the
    # quadratic model along the accumulated pose tangent (see lm.local_ba).
    if use_balm:
        Hb0, gb0, cb0 = balm_quad(state0)

    def assemble(s: InertialState, X_w, lam, xi):
        r, J_pose, J_lm, chi2, depth_ok, pidx = _visual_residuals(cam, T_cb, s, X_w, obs)
        stereo = obs.stereo.reshape(-1)
        thresh = jnp.where(stereo, factors.CHI2_STEREO, factors.CHI2_MONO)
        w_hub = factors.huber_weight(chi2, thresh)
        active = obs.valid.reshape(-1) & depth_ok
        w = obs.inv_sigma2.reshape(-1) * w_hub * active.astype(r.dtype)

        Jpw = J_pose * w[:, None, None]
        Hpp_blk = jnp.einsum("oij,oik->ojk", Jpw, J_pose)   # [O, 6, 6]
        gp_blk = jnp.einsum("oij,oi->oj", Jpw, r)

        # one-hot pose-slot contraction instead of scatter-add (see
        # lm.local_ba)
        oh = (jnp.clip(obs.pose_idx, 0, P - 1).reshape(-1)[:, None]
              == jnp.arange(P)[None, :]).astype(r.dtype)     # [O, P]
        Hpp = jnp.einsum("op,ojk->pjk", oh, Hpp_blk)         # [P, 6, 6]
        gp6 = jnp.einsum("op,oj->pj", oh, gp_blk)            # [P, 6]
        H = jnp.zeros((P, P, D, D), r.dtype)
        H = H.at[jnp.arange(P), jnp.arange(P), POSE, POSE].add(Hpp)
        g = jnp.zeros((P, D), r.dtype)
        g = g.at[:, POSE].add(gp6)

        Hi, gi, _ = _imu_terms(s, imu_fac, gravity)
        H = H + Hi
        g = g + gi

        Hll_blk = jnp.einsum("oij,oik->ojk", J_lm * w[:, None, None], J_lm)
        gl_blk = jnp.einsum("oij,oi->oj", J_lm * w[:, None, None], r)
        Hll = jnp.sum(Hll_blk.reshape(L, K, 3, 3), axis=1)
        gl = jnp.sum(gl_blk.reshape(L, K, 3), axis=1)
        B6 = jnp.einsum("oij,oik->ojk", Jpw, J_lm).reshape(L, K, 6, 3)

        lmw = valid_lm.astype(r.dtype)
        Hll_d = Hll + lam * jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(Hll)) + 1e-6 * jnp.eye(3, dtype=r.dtype)
        Hll_inv = lm_inv3x3(Hll_d) * lmw[:, None, None]

        ohk = oh.reshape(L, K, P)
        BHinv6 = jnp.einsum("lkij,ljm->lkim", B6, Hll_inv)   # [L, K, 6, 3]
        U = jnp.einsum("lkp,lkim->lpim", ohk, BHinv6)        # [L, P, 6, 3]
        V = jnp.einsum("lkp,lkjm->lpjm", ohk, B6)            # [L, P, 6, 3]
        corr_pq = jnp.einsum("lpim,lqjm->pqij", U, V)        # [P, P, 6, 6]
        H = H.at[:, :, POSE, POSE].add(-corr_pq)
        gcorr = jnp.einsum("lpim,lm->pi", U, gl)             # [P, 6]
        g = g.at[:, POSE].add(-gcorr)

        free = (~fixed).astype(r.dtype)
        H = H * free[:, None, None, None] * free[None, :, None, None]
        Hd = H.transpose(0, 2, 1, 3).reshape(PD, PD)
        free_d = jnp.repeat(free, D)
        if use_balm:
            gb = gb0 + Hb0 @ xi.reshape(-1)
            # scatter the 6n_lidar BALM block into full pose coords
            bidx = (jnp.arange(n_lidar * 6) // 6) * D + (jnp.arange(n_lidar * 6) % 6)
            Hd = Hd.at[bidx[:, None], bidx[None, :]].add(
                Hb0 * free_d[bidx][:, None] * free_d[bidx][None, :]
            )
            g = g.reshape(-1).at[bidx].add(gb * free_d[bidx]).reshape(P, D)
        Hd = Hd + jnp.diag(1.0 - free_d)
        Hd = Hd + lam * jnp.diag(jnp.abs(jnp.diag(Hd))) + 1e-8 * jnp.eye(PD, dtype=r.dtype)
        g = g * free[:, None]

        # Jacobi-preconditioned solve: IMU information (O(1e6+)) and visual
        # information (O(1)) share this f32 system (see lm.precond_solve).
        dx = -lm_precond_solve(Hd, g.reshape(-1)).reshape(P, D)
        dx = dx * free[:, None]

        dp_per_obs = jnp.einsum("lkp,pj->lkj", ohk, dx[:, :6])  # pose part
        Bt_dp = jnp.einsum("lkij,lki->lj", B6, dp_per_obs)
        dl = -jnp.einsum("lij,lj->li", Hll_inv, gl + Bt_dp) * valid_lm[:, None]
        return dx, dl

    def total_cost(s: InertialState, X_w, xi):
        r, _, _, chi2, depth_ok, _ = _visual_residuals(cam, T_cb, s, X_w, obs)
        stereo = obs.stereo.reshape(-1)
        thresh = jnp.where(stereo, factors.CHI2_STEREO, factors.CHI2_MONO)
        w_hub = factors.huber_weight(chi2, thresh)
        active = obs.valid.reshape(-1) & depth_ok
        w = obs.inv_sigma2.reshape(-1) * w_hub * active.astype(r.dtype)
        c = jnp.sum(w * jnp.sum(r * r, axis=-1))
        _, _, ci = _imu_terms(s, imu_fac, gravity)
        c = c + ci
        if use_balm:
            x = xi.reshape(-1)
            c = c + cb0 + gb0 @ x + 0.5 * x @ (Hb0 @ x)
        return c

    def lm_iter(carry, _):
        s, X_w, lam, xi, cost_prev = carry
        dx, dl = assemble(s, X_w, lam, xi)
        s_new = _apply_delta(s, dx)
        X_new = X_w + dl
        xi_new = xi + dx[:n_lidar, :6] if use_balm else xi
        cost_new = total_cost(s_new, X_new, xi_new)
        accept = cost_new < cost_prev
        s = jax.tree.map(lambda a, b: jnp.where(accept, a, b), s_new, s)
        X_w = jnp.where(accept, X_new, X_w)
        xi = jnp.where(accept, xi_new, xi)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        cost = jnp.where(accept, cost_new, cost_prev)
        return (s, X_w, lam, xi, cost), cost

    xi0 = jnp.zeros((max(n_lidar, 1), 6), X_w0.dtype)
    cost0 = total_cost(state0, X_w0, xi0)
    (s, X_w, _, _, cost), _ = jax.lax.scan(
        lm_iter, (state0, X_w0, jnp.asarray(1e-3, X_w0.dtype), xi0, cost0),
        None, length=iters,
    )

    r, _, _, chi2, depth_ok, _ = _visual_residuals(cam, T_cb, s, X_w, obs)
    stereo = obs.stereo.reshape(-1)
    thresh = jnp.where(stereo, factors.CHI2_STEREO, factors.CHI2_MONO)
    inlier = (obs.valid.reshape(-1) & depth_ok & (chi2 <= thresh)).reshape(L, K)
    return LviBaResult(s, X_w, cost, inlier)
