"""Tightly-coupled visual-inertial single-frame pose tracking.

Replaces ``Optimizer::PoseInertialOptimizationLastKeyFrame`` (Optimizer.cc:2469)
and ``...LastFrame`` (Optimizer.cc:2854) + the ``ConstraintPoseImu``
marginalization prior (``Marginalize``, Optimizer.cc:2087): in IMU mode every
frame's pose is optimized against BOTH the visual reprojection factors and the
IMU preintegration factor from the anchor state (last keyframe or last frame),
so tracking holds through visually-starved stretches — the situation tight
visual-inertial coupling exists for.

State per frame: x = [rho, phi, v, bg, ba] (15), right-multiplicative pose
update ``T_wb <- T_wb exp(xi)`` (the same convention as solver/inertial_ba).

Two variants, dispatched exactly like the reference (Tracking.cc:2858-2878):

- ``optimize_last_kf``    — anchor = last KEYFRAME state, held fixed; only the
  frame's 15 dims are free. Used on the first frame(s) after a map update.
- ``optimize_last_frame`` — anchor = previous FRAME, free but constrained by
  its marginalization prior; the joint 30-dim system is solved and the
  previous frame is Schur-marginalized out of the final Hessian to produce
  the next prior (EdgePriorPoseImu + Marginalize semantics).

Both return the frame's GN information matrix at the solution, which becomes
the next frame's ``FramePrior``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom import camera as cam_mod, lie
from ..estimation import imu as imu_est
from ..numerics import f32_highest
from . import factors
from .lm import precond_solve

D = 15
POSE = slice(0, 6)
VEL = slice(6, 9)
BG = slice(9, 12)
BA_ = slice(12, 15)


class FrameVIState(NamedTuple):
    """15-dof frame state in the world/body convention of inertial_ba."""

    T_wb: jax.Array   # [4, 4]
    vel: jax.Array    # [3]
    bg: jax.Array     # [3]
    ba: jax.Array     # [3]


class FramePrior(NamedTuple):
    """ConstraintPoseImu: linearization state + information (G2oTypes
    EdgePriorPoseImu). ``weight`` zeroes the prior when invalid/stale."""

    state: FrameVIState
    H: jax.Array      # [15, 15]
    weight: jax.Array  # [] 0.0 or 1.0

    @staticmethod
    def empty(dtype=jnp.float32):
        return FramePrior(
            state=FrameVIState(jnp.eye(4, dtype=dtype), jnp.zeros(3, dtype),
                               jnp.zeros(3, dtype), jnp.zeros(3, dtype)),
            H=jnp.zeros((D, D), dtype),
            weight=jnp.zeros((), dtype),
        )


@f32_highest
def _apply(s: FrameVIState, dx: jax.Array) -> FrameVIState:
    return FrameVIState(
        T_wb=s.T_wb @ lie.se3_exp(dx[POSE]),
        vel=s.vel + dx[VEL],
        bg=s.bg + dx[BG],
        ba=s.ba + dx[BA_],
    )


@f32_highest
def _prior_terms(s: FrameVIState, prior: FramePrior):
    """EdgePriorPoseImu residual/Jacobian: r = [Log(R_l^T R); R_l^T(p-p_l);
    v-v_l; bg-bg_l; ba-ba_l], J ~ identity up to the rotation-log Jr."""
    R = s.T_wb[:3, :3]
    p = s.T_wb[:3, 3]
    Rl = prior.state.T_wb[:3, :3]
    pl = prior.state.T_wb[:3, 3]
    er = lie.so3_log(Rl.T @ R)
    ep = Rl.T @ (p - pl)
    r = jnp.concatenate([
        er, ep, s.vel - prior.state.vel,
        s.bg - prior.state.bg, s.ba - prior.state.ba,
    ])
    # Jacobian w.r.t. x = [rho, phi, v, bg, ba] (right perturbation):
    # d er/d phi = Jr^{-1}(er); d ep/d rho = Rl^T R; others identity.
    J = jnp.eye(D, dtype=r.dtype)
    J = J.at[0:3, 0:3].set(jnp.zeros((3, 3), r.dtype))
    J = J.at[0:3, 3:6].set(lie.so3_right_jacobian_inv(er))
    J = J.at[3:6, 0:3].set(Rl.T @ R)
    J = J.at[3:6, 3:6].set(jnp.zeros((3, 3), r.dtype))
    # residual layout is [er, ep, ...] but x pose layout is [rho, phi]:
    # rows er depend on phi only, rows ep on rho only — handled above.
    H = prior.H * prior.weight
    Hx = J.T @ H @ J
    gx = J.T @ (H @ r)
    cost = r @ H @ r
    return Hx, gx, cost


@f32_highest
def _visual_terms(cam, T_cb, s: FrameVIState, X_w, uvr, inv_sigma2, stereo,
                  valid, gate: bool):
    """Reprojection quadratic on the single body pose (OnlyPose edges)."""
    T_bw = lie.se3_inverse(s.T_wb)
    X_b = lie.se3_apply(T_bw, X_w)
    R_cb = lie.rotation(T_cb)
    X_c = X_b @ R_cb.T + lie.translation(T_cb)
    pred = cam_mod.project_stereo(cam, X_c)
    r = pred - uvr
    r = jnp.where(stereo[:, None], r, r.at[:, 2].set(0.0))
    Jproj = cam_mod.project_stereo_jac(cam, X_c)
    Jproj = jnp.where(stereo[:, None, None], Jproj, Jproj.at[:, 2, :].set(0.0))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=X_b.dtype), X_b.shape[:-1] + (3, 3))
    dXb = jnp.concatenate([-eye, lie.hat(X_b)], axis=-1)   # [O, 3, 6]
    J_pose = Jproj @ R_cb @ dXb
    chi2 = inv_sigma2 * jnp.sum(r * r, axis=-1)
    depth_ok = X_c[:, 2] > 0.05
    thresh = jnp.where(stereo, factors.CHI2_STEREO, factors.CHI2_MONO)
    active = valid & depth_ok
    if gate:
        active &= chi2 <= thresh
    w = inv_sigma2 * factors.huber_weight(chi2, thresh) * active.astype(r.dtype)
    Jw = J_pose * w[:, None, None]
    H6 = jnp.einsum("oij,oik->jk", Jw, J_pose)
    g6 = jnp.einsum("oij,oi->j", Jw, r)
    cost = jnp.sum(w * jnp.sum(r * r, axis=-1))
    inliers = active & (chi2 <= thresh)
    return H6, g6, cost, inliers


@f32_highest
def _imu_pair_terms(anchor: FrameVIState, s: FrameVIState,
                    pre: imu_est.Preintegrated, gravity,
                    info_bg, info_ba):
    """EdgeInertial + bias-RW quadratic for the (anchor -> frame) pair.

    Returns per-block H/g for the 30-dim [anchor | frame] layout plus cost.
    The preintegration is corrected at the FRAME's bias (the frame owns the
    bias vertices, as in the reference's per-frame optimizers)."""
    R1 = anchor.T_wb[:3, :3]
    p1 = anchor.T_wb[:3, 3]
    R2 = s.T_wb[:3, :3]
    p2 = s.T_wb[:3, 3]
    dbg = s.bg - pre.bg
    dba = s.ba - pre.ba
    dR_c = pre.dR @ lie.so3_exp(pre.JRg @ dbg)
    dV_c = pre.dV + pre.JVg @ dbg + pre.JVa @ dba
    dP_c = pre.dP + pre.JPg @ dbg + pre.JPa @ dba
    C9 = pre.C[:9, :9] + 1e-10 * jnp.eye(9, dtype=R1.dtype)
    C9_inv = jnp.linalg.inv(C9)
    out = factors.imu_residual(
        R1, p1, anchor.vel, R2, p2, s.vel, s.bg, s.ba,
        dR_c, dV_c, dP_c, pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa,
        pre.dt, C9_inv, gravity,
    )

    def reorder(Jp):  # (phi, dp) -> (rho, phi)
        return jnp.concatenate([Jp[..., 3:6], Jp[..., 0:3]], axis=-1)

    Z93 = jnp.zeros((9, 3), R1.dtype)
    # anchor owns no bias dims in this factor (bias belongs to the frame)
    J1 = jnp.concatenate([reorder(out.J1_pose), out.J1_vel, Z93, Z93], axis=-1)
    J2 = jnp.concatenate(
        [reorder(out.J2_pose), out.J2_vel, out.J_bg, out.J_ba], axis=-1)
    IJ1 = out.info @ J1
    IJ2 = out.info @ J2
    H11 = J1.T @ IJ1
    H12 = J1.T @ IJ2
    H22 = J2.T @ IJ2
    g1 = IJ1.T @ out.r
    g2 = IJ2.T @ out.r
    cost = out.r @ out.info @ out.r

    # bias random walk between anchor bias and frame bias (anchor side fixed
    # data — contributes only to the frame diagonal)
    rbg = s.bg - anchor.bg
    rba = s.ba - anchor.ba
    H22 = H22.at[BG, BG].add(info_bg * jnp.eye(3, dtype=R1.dtype))
    H22 = H22.at[BA_, BA_].add(info_ba * jnp.eye(3, dtype=R1.dtype))
    g2 = g2.at[BG].add(info_bg * rbg)
    g2 = g2.at[BA_].add(info_ba * rba)
    cost = cost + info_bg * rbg @ rbg + info_ba * rba @ rba
    return H11, H12, H22, g1, g2, cost


class PoseInertialResult(NamedTuple):
    state: FrameVIState
    prior: FramePrior     # marginalized prior for the NEXT frame
    n_inliers: jax.Array
    inliers: jax.Array    # [O]
    cost: jax.Array


@partial(jax.jit, static_argnames=("rounds", "iters"))
def optimize_last_kf(
    cam: cam_mod.Pinhole,
    T_cb: jax.Array,
    state0: FrameVIState,
    kf_state: FrameVIState,       # FIXED anchor (last keyframe)
    pre: imu_est.Preintegrated,   # keyframe -> frame preintegration
    gravity: jax.Array,
    X_w: jax.Array,               # [O, 3] matched landmarks
    uvr: jax.Array,               # [O, 3]
    inv_sigma2: jax.Array,        # [O]
    stereo: jax.Array,            # [O]
    valid: jax.Array,             # [O]
    info_bg: jax.Array,
    info_ba: jax.Array,
    rounds: int = 2,
    iters: int = 6,
) -> PoseInertialResult:
    """PoseInertialOptimizationLastKeyFrame (Optimizer.cc:2469)."""

    def quad(s, gate):
        Hv, gv, cv, inl = _visual_terms(
            cam, T_cb, s, X_w, uvr, inv_sigma2, stereo, valid, gate)
        _, _, H22, _, g2, ci = _imu_pair_terms(
            kf_state, s, pre, gravity, info_bg, info_ba)
        H = H22.at[POSE, POSE].add(Hv)
        g = g2.at[POSE].add(gv)
        return H, g, cv + ci, inl

    def gn_round(s, gate):
        def it(carry, _):
            s, lam, cost_prev = carry
            H, g, _, _ = quad(s, gate)
            Haug = H + lam * jnp.diag(jnp.diag(H)) + 1e-6 * jnp.eye(D, dtype=g.dtype)
            # Jacobi-preconditioned: IMU information is O(1e6+) vs visual
            # O(1) in the same f32 system (see lm.precond_solve)
            dx = -precond_solve(Haug, g)
            s_new = _apply(s, dx)
            _, _, cost_new, _ = quad(s_new, gate)
            accept = cost_new < cost_prev
            s = jax.tree.map(lambda a, b: jnp.where(accept, a, b), s_new, s)
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            return (s, lam, jnp.where(accept, cost_new, cost_prev)), None

        _, _, c0, _ = quad(s, gate)
        (s, _, cost), _ = jax.lax.scan(
            it, (s, jnp.asarray(1e-2, X_w.dtype), c0), None, length=iters)
        return s, cost

    s = state0
    cost = jnp.asarray(0.0, X_w.dtype)
    for rnd in range(rounds):
        s, cost = gn_round(s, gate=rnd > 0)
    H, _, _, inl = quad(s, True)
    prior = FramePrior(state=s, H=H, weight=jnp.asarray(1.0, X_w.dtype))
    return PoseInertialResult(s, prior, jnp.sum(inl), inl, cost)


@partial(jax.jit, static_argnames=("rounds", "iters"))
@f32_highest
def optimize_last_frame(
    cam: cam_mod.Pinhole,
    T_cb: jax.Array,
    state0: FrameVIState,
    prev_state: FrameVIState,     # previous frame (free, prior-constrained)
    prev_prior: FramePrior,
    pre: imu_est.Preintegrated,   # prev frame -> frame preintegration
    gravity: jax.Array,
    X_w: jax.Array,
    uvr: jax.Array,
    inv_sigma2: jax.Array,
    stereo: jax.Array,
    valid: jax.Array,
    info_bg: jax.Array,
    info_ba: jax.Array,
    rounds: int = 2,
    iters: int = 6,
) -> PoseInertialResult:
    """PoseInertialOptimizationLastFrame (Optimizer.cc:2854): joint 30-dim
    solve over [prev | cur], prior on prev, then prev is Schur-marginalized
    out of the final Hessian (Marginalize, Optimizer.cc:2087) to form the
    next frame's prior."""

    def quad(sp, sc, gate):
        Hv, gv, cv, inl = _visual_terms(
            cam, T_cb, sc, X_w, uvr, inv_sigma2, stereo, valid, gate)
        H11, H12, H22, g1, g2, ci = _imu_pair_terms(
            sp, sc, pre, gravity, info_bg, info_ba)
        Hp, gp, cp = _prior_terms(sp, prev_prior)
        H11 = H11 + Hp
        g1 = g1 + gp
        H22 = H22.at[POSE, POSE].add(Hv)
        g2 = g2.at[POSE].add(gv)
        return H11, H12, H22, g1, g2, cv + ci + cp, inl

    def gn_round(sp, sc, gate):
        def it(carry, _):
            sp, sc, lam, cost_prev = carry
            H11, H12, H22, g1, g2, _, _ = quad(sp, sc, gate)
            H = jnp.block([[H11, H12], [H12.T, H22]])
            g = jnp.concatenate([g1, g2])
            Haug = H + lam * jnp.diag(jnp.diag(H)) + 1e-6 * jnp.eye(2 * D, dtype=g.dtype)
            dx = -precond_solve(Haug, g)
            sp_n = _apply(sp, dx[:D])
            sc_n = _apply(sc, dx[D:])
            *_, cost_new, _ = quad(sp_n, sc_n, gate)
            accept = cost_new < cost_prev
            sp = jax.tree.map(lambda a, b: jnp.where(accept, a, b), sp_n, sp)
            sc = jax.tree.map(lambda a, b: jnp.where(accept, a, b), sc_n, sc)
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            return (sp, sc, lam, jnp.where(accept, cost_new, cost_prev)), None

        *_, c0, _ = quad(sp, sc, gate)
        (sp, sc, _, cost), _ = jax.lax.scan(
            it, (sp, sc, jnp.asarray(1e-2, X_w.dtype), c0), None, length=iters)
        return sp, sc, cost

    sp, sc = prev_state, state0
    cost = jnp.asarray(0.0, X_w.dtype)
    for rnd in range(rounds):
        sp, sc, cost = gn_round(sp, sc, gate=rnd > 0)

    # Marginalize prev out of the joint Hessian: H* = H22 - H21 H11^-1 H12
    H11, H12, H22, _, _, _, inl = quad(sp, sc, True)
    H11_r = H11 + 1e-6 * jnp.eye(D, dtype=H11.dtype)
    Hm = H22 - H12.T @ jnp.linalg.solve(H11_r, H12)
    # guard: keep the prior PSD-ish and bounded
    Hm = 0.5 * (Hm + Hm.T)
    prior = FramePrior(state=sc, H=Hm, weight=jnp.asarray(1.0, X_w.dtype))
    return PoseInertialResult(sc, prior, jnp.sum(inl), inl, cost)
