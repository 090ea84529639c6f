"""Tightly-coupled VI frame tracking (PoseInertialOptimizationLast*).

Reference behavior: Optimizer.cc:2469 (LastKeyFrame), :2854 (LastFrame),
prior via ConstraintPoseImu/Marginalize (:2087), dispatched per-frame at
Tracking.cc:2858-2878. The defining property: with starved visual matches
the IMU preintegration factor holds the pose where visual-only tracking
cannot.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tc2li_slam_tpu.estimation import imu as imu_est
from tc2li_slam_tpu.geom import camera as cam_mod, lie
from tc2li_slam_tpu.solver import lm as lm_mod, pose_inertial as pi

GRAV = jnp.asarray([0.0, 0.0, -9.81])


def _make_scene(rng, n_pts, t_total=0.2, n_imu=20, a_w=(0.6, -0.2, 0.1),
                w_b=(0.05, -0.1, 0.2)):
    """Anchor at identity; constant body rate + world acceleration."""
    cal = imu_est.ImuCalib.create(1.7e-4, 2e-3, 1.9e-5, 3e-3)
    dt = t_total / n_imu
    a_w = np.asarray(a_w)
    w_b = np.asarray(w_b)
    v1 = np.array([1.0, 0.2, -0.1])

    # simulate: R(t) = Exp(w t); measured acc = R^T (a_w - g)
    R = np.eye(3)
    p = np.zeros(3)
    v = v1.copy()
    gyro, acc = [], []
    for _ in range(n_imu):
        gyro.append(w_b)
        acc.append(R.T @ (a_w - np.asarray(GRAV)))
        # integrate GT (midpoint-ish fine at this dt)
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        R = R @ np.asarray(lie.so3_exp(jnp.asarray(w_b * dt)))
    gyro = jnp.asarray(np.stack(gyro), jnp.float32)
    acc = jnp.asarray(np.stack(acc), jnp.float32)
    dts = jnp.full((n_imu,), dt, jnp.float32)

    pre = imu_est.integrate(cal, gyro, acc, dts, jnp.zeros(3), jnp.zeros(3))
    T_wb2 = np.eye(4)
    T_wb2[:3, :3] = R
    T_wb2[:3, 3] = p

    anchor = pi.FrameVIState(jnp.eye(4), jnp.asarray(v1, jnp.float32),
                             jnp.zeros(3), jnp.zeros(3))
    gt = pi.FrameVIState(jnp.asarray(T_wb2, jnp.float32),
                         jnp.asarray(v, jnp.float32),
                         jnp.zeros(3), jnp.zeros(3))

    cam = cam_mod.Pinhole.create(500.0, 500.0, 320.0, 240.0, bf=250.0)
    X = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(6, 20, n_pts)], -1).astype(np.float32)
    # camera = body here (T_cb = I): uv at GT frame pose
    T_cw = np.asarray(lie.se3_inverse(jnp.asarray(T_wb2, jnp.float32)))
    Xc = X @ T_cw[:3, :3].T + T_cw[:3, 3]
    uv = np.array(cam_mod.project_stereo(cam, jnp.asarray(Xc)))
    uv = uv + rng.normal(0, 0.5, uv.shape)
    return cal, cam, anchor, gt, pre, jnp.asarray(X), jnp.asarray(
        uv.astype(np.float32))


def _perturbed(gt, rng, rot=0.02, trans=0.1, dv=0.2):
    xi = np.concatenate([rng.normal(0, trans, 3), rng.normal(0, rot, 3)])
    return pi.FrameVIState(
        T_wb=gt.T_wb @ lie.se3_exp(jnp.asarray(xi, jnp.float32)),
        vel=gt.vel + jnp.asarray(rng.normal(0, dv, 3), jnp.float32),
        bg=jnp.zeros(3), ba=jnp.zeros(3),
    )


def test_last_kf_converges_with_rich_visual():
    rng = np.random.default_rng(0)
    cal, cam, anchor, gt, pre, X, uv = _make_scene(rng, 60)
    s0 = _perturbed(gt, rng)
    res = pi.optimize_last_kf(
        cam, jnp.eye(4), s0, anchor, pre, GRAV, X, uv,
        jnp.ones(X.shape[0]), jnp.ones(X.shape[0], bool),
        jnp.ones(X.shape[0], bool), jnp.float32(1e4), jnp.float32(1e3),
    )
    err_t = float(jnp.linalg.norm(res.state.T_wb[:3, 3] - gt.T_wb[:3, 3]))
    assert err_t < 0.01, err_t
    assert int(res.n_inliers) > 50


def test_starved_visual_held_by_imu():
    """3 noisy points cannot constrain 6 dof — the preintegration must.

    This is the capability the visual-only path lacks:
    pose_only_optimize with the same starved matches diverges or is
    ill-constrained, while the VI solve stays within centimeters."""
    rng = np.random.default_rng(1)
    cal, cam, anchor, gt, pre, X, uv = _make_scene(rng, 3)
    s0 = _perturbed(gt, rng, rot=0.03, trans=0.15, dv=0.3)
    res = pi.optimize_last_kf(
        cam, jnp.eye(4), s0, anchor, pre, GRAV, X, uv,
        jnp.ones(3), jnp.ones(3, bool), jnp.ones(3, bool),
        jnp.float32(1e4), jnp.float32(1e3),
    )
    err_vi = float(jnp.linalg.norm(res.state.T_wb[:3, 3] - gt.T_wb[:3, 3]))
    assert err_vi < 0.05, err_vi

    # visual-only on the same starved problem (from the same init)
    T_cw0 = lie.se3_inverse(s0.T_wb)
    vres = lm_mod.pose_only_optimize(
        cam, T_cw0, X, uv, jnp.ones(3), jnp.ones(3, bool), jnp.ones(3, bool),
    )
    T_v = lie.se3_inverse(vres.T_cw)
    err_v = float(jnp.linalg.norm(T_v[:3, 3] - gt.T_wb[:3, 3]))
    assert err_vi < 0.5 * max(err_v, 1e-9), (err_vi, err_v)


def test_last_frame_prior_chain():
    """LastFrame variant: prev frame constrained only by its prior + IMU;
    the chain tracks two consecutive frames and the marginalized prior
    stays PSD."""
    rng = np.random.default_rng(2)
    cal, cam, anchor, gt, pre, X, uv = _make_scene(rng, 40)
    s0 = _perturbed(gt, rng)
    res1 = pi.optimize_last_kf(
        cam, jnp.eye(4), s0, anchor, pre, GRAV, X, uv,
        jnp.ones(X.shape[0]), jnp.ones(X.shape[0], bool),
        jnp.ones(X.shape[0], bool), jnp.float32(1e4), jnp.float32(1e3),
    )

    # second hop: same motion again from res1's state as anchor-free prev
    cal2, cam2, _, gt2_rel, pre2, X2, _ = _make_scene(rng, 40)
    # GT for frame 2: dead-reckon frame-1 GT through the preintegration
    # (the state the IMU factor is exactly consistent with)
    R2g, p2g, v2g = imu_est.predict_state(
        pre2, gt.T_wb[:3, :3], gt.T_wb[:3, 3], gt.vel,
        jnp.zeros(3), jnp.zeros(3), GRAV)
    T_gt2 = jnp.eye(4).at[:3, :3].set(R2g).at[:3, 3].set(p2g)
    # world-frame landmarks for frame 2, observed at T_gt2
    T_cw2 = lie.se3_inverse(T_gt2)
    X2w = jnp.asarray(np.stack([
        np.random.default_rng(5).uniform(-4, 4, 40),
        np.random.default_rng(6).uniform(-2, 2, 40),
        np.random.default_rng(7).uniform(6, 20, 40)], -1).astype(np.float32))
    Xc2 = lie.se3_apply(T_cw2, X2w)
    uv2 = cam_mod.project_stereo(cam, Xc2)
    ok2 = Xc2[:, 2] > 0.5

    # NOTE pre2 was integrated for the anchor-at-identity scene; its deltas
    # are body-frame so they transfer to frame1's body frame directly.
    s0_2 = pi.FrameVIState(
        T_wb=T_gt2 @ lie.se3_exp(jnp.asarray([0.08, -0.05, 0.04, 0.01, -0.02, 0.015], jnp.float32)),
        vel=res1.state.vel, bg=jnp.zeros(3), ba=jnp.zeros(3))
    # rotate frame-2 GT velocity into world: v2 = v1 + R1 a... reuse gt2_rel
    res2 = pi.optimize_last_frame(
        cam, jnp.eye(4), s0_2, res1.state, res1.prior, pre2, GRAV,
        X2w, uv2, jnp.ones(40), jnp.ones(40, bool), ok2,
        jnp.float32(1e4), jnp.float32(1e3),
    )
    err_t = float(jnp.linalg.norm(res2.state.T_wb[:3, 3] - T_gt2[:3, 3]))
    assert err_t < 0.02, err_t
    # marginalized prior: symmetric, finite, positive-semidefinite-ish
    Hm = np.asarray(res2.prior.H)
    assert np.isfinite(Hm).all()
    assert np.allclose(Hm, Hm.T, atol=1e-3)
    w = np.linalg.eigvalsh(Hm)
    assert w.min() > -1e-2 * max(w.max(), 1.0)
