"""System facade: the per-frame SLAM entry point and host state machine.

Replaces ``System`` + the ``Tracking`` state machine + the LocalMapping and
LiDAR-front-end threads (System.cc, Tracking.cc, LocalMapping.cc,
LidarFrontEnd.cpp) with a single-program pipeline: all numerics are jitted
fixed-shape kernels; the host only sequences them and takes the branchy
decisions (initialization, keyframe policy, loss handling) — mirroring how
the reference's logic partitions naturally.

STEREO_LIDAR mode (camera-pose-driven LiDAR, ``LidarCameraProcess``):

    per frame:  build_frame -> const-velocity predict -> track_frame
                (guided match + pose-only LM) -> voxel-map insert of the
                scan at the optimized pose -> KF decision
    per KF:     store planar LiDAR features -> create stereo landmarks ->
                covisibility-window local BA with the BALM eigen-factor

Trajectory bookkeeping matches the reference: per-frame poses stored
relative to their reference KF and re-composed at save time, so local-BA
pose corrections propagate to the whole trajectory
(Tracking.cc:2393-2411, System::SaveTrajectoryKITTI).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..estimation import esekf, imu as imu_est
from ..geom import camera as cam_mod, lie
from ..ops import bow, pointcloud, voxel_map
from . import (atlas as atlas_mod, config as cfg_mod, culling, imu_mode, lio,
               local_mapping, loop_closing, mapstate, profiling,
               relocalization, tracking, trajectory, triangulation)
from ..solver import inertial_ba


class TrackingState:
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


from functools import partial as _partial  # noqa: E402


@_partial(jax.jit, static_argnames=("use_lidar",))
def _kf_create_kernel(
    m, vmap, kf_id, frame, T_cw, t, feat_lm, cam, th_depth, scale_factors,
    use_lidar: bool,
):
    """The keyframe-creation device chain as ONE program: snapshot the
    frame, gate + allocate stereo landmarks (near-duplicate suppression +
    LiDAR plane-consistency gate), and produce the ref-KF-tracked count.
    Folding this chain into one jit removes ~30 per-op dispatches per
    keyframe event."""
    from ..ops import plane_fit as pf

    m, _slot = mapstate.add_keyframe(
        m, T_cw, t, frame.xy, frame.uvr, frame.level, frame.angle,
        frame.desc, frame.valid, feat_lm,
    )
    pos, normal, dist, want = tracking.stereo_landmark_candidates(
        frame, T_cw, cam, feat_lm, th_depth, scale_factors,
    )
    near = tracking.near_existing_landmark(
        m, frame, T_cw, cam, jnp.float32(4.0), jnp.float32(0.15),
    )
    want = want & ~near
    if use_lidar:
        # tightly-coupled depth verification (see _create_keyframe notes)
        sel_q = jnp.argsort(~want)[:512]
        pos_q = pos[sel_q]
        _, nbrs, nbv = voxel_map.knn(vmap, pos_q, k=5, radius=2)
        nrm, dpl, p_ok = pf.fit_planes(nbrs, nbv, threshold=0.3)
        pd = jnp.abs(pf.point_to_plane(pos_q, nrm, dpl))
        cam_c = lie.translation(lie.se3_inverse(T_cw))
        rng_ = jnp.linalg.norm(pos_q - cam_c, axis=-1)
        tol = jnp.clip(0.06 * rng_, 0.3, 1.0)
        lidar_ok = jnp.zeros(m.F, bool).at[sel_q].set(p_ok & (pd < tol))
        want = want & lidar_ok
    m, _ = mapstate.add_landmarks(
        m, kf_id, jnp.arange(m.F, dtype=jnp.int32),
        pos, frame.desc, normal, dist, want,
    )
    rkt = jnp.sum(m.kf_feat_lm[kf_id] != mapstate.NO_LM)
    return m, rkt, m.n_lm


@_partial(jax.jit, static_argnames=("staged", "lio_cfg"))
def _kf_lidar_kernel(store, vmap, kf_id, src, src_valid, T_cw, T_cl,
                     blind, scan_voxel, lio_cfg, staged: bool):
    """KF LiDAR feature store (BuildLidarFeat4KeyFrame) as ONE program:
    (preprocess + voxel-downsample | reuse the staged world-frame batch) ->
    plane-feature selection against the live voxel map -> compaction."""
    T_wl = lie.se3_inverse(T_cw) @ T_cl
    if staged:
        # already preprocessed + downsampled for the map-insert staging at
        # the same voxel size; world-frame -> LiDAR frame
        ds = lie.se3_apply(lie.se3_inverse(T_wl), src)
        dsv = src_valid
    else:
        keep = pointcloud.preprocess(
            src, jnp.zeros(src.shape[0]), src_valid, blind=blind,
        )
        ds, dsv = pointcloud.voxel_downsample(src, keep, scan_voxel)
    planar = lio.select_plane_features(vmap, ds, dsv, T_wl, lio_cfg)
    # compact the best kf_points planar points to the front
    n = store.points.shape[1]
    order = jnp.argsort(~planar)  # True first
    return store.set_kf(kf_id, ds[order][:n], planar[order][:n])


@_partial(jax.jit, static_argnames=(
    "iters", "use_balm", "n_l", "max_active", "balm_voxel",
    "balm_max_voxels", "balm_min_points", "w_lba"))
def _lvi_kernel(
    m, imu_store, lidar, window_arr, wvalid, fac_valid, filt_bg, filt_ba,
    cam, T_cb, T_bc, T_cl, sigma2, gravity_vis,
    iters: int, use_balm: bool, n_l: int, max_active: int,
    balm_voxel: float, balm_max_voxels: int, balm_min_points: int,
    w_lba: float,
):
    """The whole LVI-BA pass (LocalLVIBA / FullInertialBA dispatch,
    LocalMapping.cc:158-173, Optimizer.cc:394) as ONE program: window
    factor assembly, observation prep + compaction, BALM cluster build,
    the 15-dof inertial solve, and pose/velocity/bias/landmark writeback.
    Un-fused, the prep + writeback chain is ~40 dispatches per event.
    Returns (map', imu_store')."""
    P = window_arr.shape[0]
    sl = window_arr[1:]
    fac = inertial_ba.ImuWindowFactors(
        dR=imu_store.dR[sl], dV=imu_store.dV[sl], dP=imu_store.dP[sl],
        JRg=imu_store.JRg[sl], JVg=imu_store.JVg[sl], JVa=imu_store.JVa[sl],
        JPg=imu_store.JPg[sl], JPa=imu_store.JPa[sl],
        dt=imu_store.dt[sl], C_inv=imu_store.C_inv[sl],
        bg_lin=imu_store.bg_lin[sl], ba_lin=imu_store.ba_lin[sl],
        info_bg=jnp.full((P - 1,), 1e5), info_ba=jnp.full((P - 1,), 1e4),
        valid=fac_valid,
    )
    window_masked = jnp.where(wvalid, window_arr, mapstate.NO_KF)
    win_pos, uvr, inv_s2, stereo, ok = mapstate.landmark_major_obs(
        m, window_masked, sigma2)
    from ..solver.lm import BAObservations
    # compact to the active-landmark budget (see run_local_ba): the
    # 15-dof LVI Schur cross-terms are even bigger than the visual ones
    lm_active_full = jnp.any(ok, axis=1) & m.lm_valid
    sel = jnp.argsort(~lm_active_full)[:max_active].astype(jnp.int32)
    obs = BAObservations(pose_idx=win_pos[sel], uv=uvr[sel],
                         inv_sigma2=inv_s2[sel], stereo=stereo[sel],
                         valid=ok[sel])
    lm_active = lm_active_full[sel]
    T_cw_win = m.kf_T_cw[window_arr]
    T_wb_win = jax.vmap(
        lambda T: lie.se3_inverse(T) @ lie.se3_inverse(T_bc))(T_cw_win)
    # velocity init: optimizer output where available, else a finite
    # difference of keyframe positions (InitializeIMU seeds the same way)
    pos_w = T_wb_win[:, :3, 3]
    dts = jnp.maximum(imu_store.dt[window_arr][1:], 1e-2)
    v_mid = (pos_w[1:] - pos_w[:-1]) / dts[:, None]
    v_fd = jnp.concatenate([v_mid[:1], v_mid], axis=0)
    vel0 = jnp.where(imu_store.vel_opt[window_arr][:, None],
                     imu_store.vel[window_arr], v_fd)
    # per-KF biases (estimated in the window; seeded by the inertial
    # initialization, NOT pinned to the ESEKF values as in round 1)
    bg0 = jnp.where(imu_store.vel_opt[window_arr][:, None],
                    imu_store.bg[window_arr], jnp.tile(filt_bg, (P, 1)))
    ba0 = jnp.where(imu_store.vel_opt[window_arr][:, None],
                    imu_store.ba[window_arr], jnp.tile(filt_ba, (P, 1)))
    # padded slots: identity-anchored finite state, held fixed
    T_wb_win = jnp.where(wvalid[:, None, None], T_wb_win,
                         jnp.eye(4, dtype=T_wb_win.dtype))
    state0 = inertial_ba.InertialState(
        T_wb=T_wb_win, vel=vel0 * wvalid[:, None], bg=bg0, ba=ba0,
    )
    fixed = jnp.zeros(P, bool).at[0].set(True) | ~wvalid
    # BALM plane eigen-factor over the first <= balm_window poses
    # (EdgeLidar in LocalLVIBA, OptimizerWithLidar.cc:697-727)
    balm_kw = {}
    if use_balm:
        from ..solver import balm as balm_mod
        lidx = window_arr[:n_l]
        T_wl_init = jax.vmap(
            lambda T: lie.se3_inverse(T) @ T_cl
        )(jnp.where(wvalid[:n_l, None, None], m.kf_T_cw[lidx],
                    jnp.eye(4, dtype=m.kf_T_cw.dtype)))
        clusters = balm_mod.build_clusters(
            lidar.points[lidx], lidar.valid[lidx] & wvalid[:n_l, None],
            T_wl_init,
            voxel_size=balm_voxel, max_voxels=balm_max_voxels,
            min_points=balm_min_points,
        )
        balm_kw = dict(
            balm_clusters=clusters,
            T_bl=T_bc @ T_cl,               # body-from-lidar
            w_lidar=w_lba,
            use_balm=True, n_lidar=n_l,
        )
    res = inertial_ba.lvi_ba(
        cam, T_cb, state0, m.lm_pos[sel], obs, fac,
        fixed, lm_active, gravity_vis, iters=iters, **balm_kw,
    )
    # write back: T_cw = inv(T_wb @ T_bc); velocities + biases
    T_cw_new = jax.vmap(lambda T: lie.se3_inverse(T @ T_bc))(res.state.T_wb)
    lm_pos_new = m.lm_pos.at[sel].set(
        jnp.where(lm_active[:, None], res.X_w, m.lm_pos[sel])
    )
    w_sc = jnp.where(wvalid, window_arr, m.K)
    m = m._replace(
        kf_T_cw=m.kf_T_cw.at[w_sc].set(T_cw_new, mode="drop"),
        lm_pos=lm_pos_new,
    )
    imu_store = imu_store._replace(
        vel=imu_store.vel.at[w_sc].set(res.state.vel, mode="drop"),
        vel_opt=imu_store.vel_opt.at[w_sc].set(True, mode="drop"),
        bg=imu_store.bg.at[w_sc].set(res.state.bg, mode="drop"),
        ba=imu_store.ba.at[w_sc].set(res.state.ba, mode="drop"),
    )
    return m, imu_store


@_partial(jax.jit, static_argnames=("use_last_frame", "has_prev"))
def _vi_refine_kernel(
    m, imu_store, frame, res_T_cw, res_feat_lm, kf, T_cb, T_bc, cam, sigma2,
    cal, gravity_vis, imu_ring, ring_n, last_window, prev_state, frame_prior,
    vi_vel, last_T_cw, use_last_frame: bool, has_prev: bool,
):
    """The tightly-coupled per-frame VI refinement as ONE program:
    anchor/obs prep + preintegration + Pose-Inertial solve + adoption gate
    (PoseInertialOptimizationLast{KeyFrame,Frame}, Optimizer.cc:2469/2854).

    Returns (T_cw', velocity', vi_vel', frame_prior', prev_vi_state')."""
    from ..solver import pose_inertial as pi_mod

    T_wb_kf = lie.se3_inverse(m.kf_T_cw[kf]) @ T_cb
    anchor = pi_mod.FrameVIState(
        T_wb=T_wb_kf, vel=imu_store.vel[kf],
        bg=imu_store.bg[kf], ba=imu_store.ba[kf],
    )
    # matched landmarks of this frame (track_step's assignment)
    has = res_feat_lm != mapstate.NO_LM
    lm_c = jnp.clip(res_feat_lm, 0, m.L - 1)
    X_w = m.lm_pos[lm_c]
    inv_s2 = 1.0 / sigma2[jnp.clip(frame.level, 0, sigma2.shape[0] - 1)]
    stereo = frame.uvr[:, 2] > 0
    valid = has & frame.valid

    state0 = pi_mod.FrameVIState(
        T_wb=lie.se3_inverse(res_T_cw) @ T_cb,
        vel=vi_vel if has_prev else anchor.vel,
        bg=anchor.bg, ba=anchor.ba,
    )

    def _floor_cov(pre):
        # Same unmodeled-error covariance floor the KF store applies
        # (imu_mode.set_kf): a quiet IMU preintegrates to information
        # ~1e8, far beyond what the anchor state's own accuracy (window
        # LVI-BA velocities, time sync, extrinsics) supports; flooring
        # keeps the per-frame factor honest vs the visual terms.
        C9 = pre.C[:9, :9] + jnp.diag(jnp.concatenate([
            jnp.full(3, imu_mode.SIGMA_ROT_FLOOR ** 2),
            jnp.full(3, imu_mode.SIGMA_VEL_FLOOR ** 2),
            jnp.full(3, imu_mode.SIGMA_POS_FLOOR ** 2),
        ]))
        return pre._replace(C=pre.C.at[:9, :9].set(C9))

    if use_last_frame:
        # preintegration over THIS frame's window only, at the previous
        # frame's bias linearization
        g, a, d = last_window
        pre = _floor_cov(imu_est.integrate(cal, g, a, d,
                                           prev_state.bg, prev_state.ba))
        info_bg = 1.0 / (cal.sigma_gw ** 2 * jnp.maximum(pre.dt, 1e-3))
        info_ba = 1.0 / (cal.sigma_aw ** 2 * jnp.maximum(pre.dt, 1e-3))
        out = pi_mod.optimize_last_frame(
            cam, T_cb, state0, prev_state, frame_prior, pre, gravity_vis,
            X_w, frame.uvr, inv_s2, stereo, valid, info_bg, info_ba,
        )
    else:
        g, a, d = imu_ring
        d = jnp.where(jnp.arange(d.shape[0]) < ring_n, d, 0.0)
        pre = _floor_cov(imu_est.integrate(cal, g, a, d, anchor.bg,
                                           anchor.ba))
        info_bg = 1.0 / (cal.sigma_gw ** 2 * jnp.maximum(pre.dt, 1e-3))
        info_ba = 1.0 / (cal.sigma_aw ** 2 * jnp.maximum(pre.dt, 1e-3))
        out = pi_mod.optimize_last_kf(
            cam, T_cb, state0, anchor, pre, gravity_vis,
            X_w, frame.uvr, inv_s2, stereo, valid, info_bg, info_ba,
        )
    # Adoption gate, fully on device: a degenerate solve (few visual
    # inliers backing the refine, or a non-finite state) must not
    # overwrite the already-accepted visual pose — the reference inspects
    # the optimization's inlier count the same way (Tracking.cc:2874).
    st_ok = jnp.all(jnp.asarray([
        jnp.all(jnp.isfinite(out.state.T_wb)),
        jnp.all(jnp.isfinite(out.state.vel)),
        jnp.all(jnp.isfinite(out.state.bg)),
        jnp.all(jnp.isfinite(out.state.ba)),
    ]))
    good = (out.n_inliers >= 10) & st_ok
    goodf = good.astype(jnp.float32)
    T_cw_ref = lie.se3_inverse(out.state.T_wb @ T_bc)
    T_cw_new = jnp.where(good, T_cw_ref, res_T_cw)
    fallback = pi_mod.FrameVIState(
        T_wb=lie.se3_inverse(res_T_cw) @ T_cb,
        vel=state0.vel, bg=state0.bg, ba=state0.ba,
    )
    adopted = jax.tree_util.tree_map(
        lambda x, y: jnp.where(good, x, y), out.state, fallback)
    velocity = T_cw_new @ lie.se3_inverse(last_T_cw)
    # on failure the prior chain is dropped (weight 0 disables the factor)
    prior = out.prior._replace(weight=out.prior.weight * goodf)
    return T_cw_new, velocity, adopted.vel, prior, adopted


@jax.jit
def _cull_kernel(m, protect, lidar_valid, kf_words, thresh):
    """KeyFrameCulling + dependent-state scrub as ONE program (un-fused,
    the chain paid ~6 dispatch floors per cull event)."""
    m, killed = culling.cull_keyframes(m, protect, thresh=thresh)
    kill_mask = jnp.zeros(m.K, bool).at[jnp.clip(killed, 0, m.K - 1)].set(
        killed >= 0)
    if lidar_valid is not None:
        lidar_valid = lidar_valid & ~kill_mask[:, None]
    if kf_words is not None:
        kf_words = jnp.where(kill_mask[:, None], -1, kf_words)
    return m, killed, lidar_valid, kf_words


@_partial(jax.jit, static_argnames=("max_pairs", "do_triangulate"))
def _mapping_maintain_kernel(
    m, kf_id, neighbors, nb_fuse, cam, sigma2, scale_factors,
    max_pairs: int = 3, do_triangulate: bool = True,
):
    """The mapping pass's maintenance chain as ONE program (MapPointCulling
    -> CreateNewMapPoints -> SearchInNeighbors/Fuse x2 -> landmark stats):
    one dispatch instead of ~6."""
    m = culling.cull_landmarks(m, kf_id)
    if do_triangulate:
        m = triangulation.triangulate_batch(
            m, kf_id, neighbors, cam, sigma2, scale_factors,
            max_pairs=max_pairs)
    m = culling.fuse_into_keyframe(m, kf_id, cam, scale_factors)
    m = jax.lax.cond(
        nb_fuse >= 0,
        lambda mm: culling.fuse_into_keyframe(
            mm, jnp.clip(nb_fuse, 0, m.K - 1), cam, scale_factors),
        lambda mm: mm, m,
    )
    return mapstate.update_landmark_stats(m)


class System:
    """Stereo(+LiDAR) SLAM system (System::TrackStereoLidar equivalent)."""

    def __init__(self, cfg: cfg_mod.SystemConfig,
                 voc: "bow.Vocabulary | None" = None, mesh=None):
        self.cfg = cfg
        self.voc = voc  # place-recognition vocabulary (reloc + loop closing)
        # device mesh: when present, local BA runs through the sharded
        # distributed solver (parallel.dist_ba) instead of the single-chip one
        self.mesh = mesh
        c = cfg.camera
        self.cam = cam_mod.Pinhole.create(c.fx, c.fy, c.cx, c.cy, bf=c.bf,
                                          width=c.width, height=c.height)
        self.scale_factors = jnp.asarray(cfg.orb.scale_factors(), jnp.float32)
        self.sigma2 = jnp.asarray(cfg.orb.sigma2(), jnp.float32)
        t = cfg.tracking
        self.map = mapstate.create(
            max_kf=t.max_kf, max_feats=cfg.orb.n_features,
            max_lm=t.max_lm, max_obs=t.max_obs,
        )
        self.T_cl = jnp.asarray(cfg.lidar.T_cl, jnp.float32)
        self.lidar_enabled = cfg.lidar.enabled
        if self.lidar_enabled:
            self.vmap = voxel_map.create(cfg.lidar.map_capacity, cfg.lidar.map_voxel)
            self.lidar_store = local_mapping.LidarStore.create(
                t.max_kf, cfg.lidar.kf_points
            )
            self.lio_cfg = lio.LioConfig(
                scan_voxel=cfg.lidar.scan_voxel, map_voxel=cfg.lidar.map_voxel,
                plane_thresh=cfg.lidar.plane_thresh, meas_cov=cfg.lidar.meas_cov,
                max_iters=cfg.lidar.max_iters, det_range=cfg.lidar.det_range,
                blind=cfg.lidar.blind, work_cap=cfg.lidar.lio_work_cap,
            )
        else:
            self.vmap = None
            self.lidar_store = None

        self.state = TrackingState.NOT_INITIALIZED
        self.localization_only = False    # ActivateLocalizationMode (System.h)
        self._last_t: float | None = None  # timestamp-jump guard
        self.T_cw = jnp.eye(4)            # current camera pose (world->cam)
        self.velocity = jnp.eye(4)        # T_cw_k @ inv(T_cw_{k-1})
        self.last_T_cw = jnp.eye(4)
        self.ref_kf = -1
        self.n_kf_host = 0                # host mirror of map.n_kf (no sync)
        self.n_lm_host = 0                # async host mirror of map.n_lm
        self._n_lm_dev = None
        self.kf_alive = [True] * t.max_kf  # host mirror of kf_valid
        self.ref_kf_tracked = 0
        self.frames_since_kf = 0
        self.frame_idx = -1
        # atlas multi-map recovery (CreateMapInAtlas, Tracking.cc:2548)
        self.atlas = atlas_mod.Atlas()
        self.map_id = 0
        # trajectory: (timestamp, map_id, ref_kf, T_cur_wrt_ref device
        # array) — relative storage; device arrays only fetched at save time
        self.traj: list[tuple[float, int, int, jax.Array]] = []
        self.n_lost = 0
        if voc is not None:
            self.kf_words = jnp.full(
                (cfg.tracking.max_kf, cfg.orb.n_features), -1, jnp.int32
            )
        self._rng_key = jax.random.PRNGKey(0)
        # REGISTER_TIMES analog: per-stage host timings (profiling.py)
        self.timers = profiling.StageTimer(enabled=cfg.profile)
        # Deferred LocalMapping (the reference runs it on its own thread,
        # LocalMapping.cc:70 — tracking never waits for it): the mapping
        # step for a new keyframe runs on the NEXT frame, after that
        # frame's single host sync, so the keyframe event adds no blocking
        # device round-trips to the frame that created it.
        self._pending_mapping: int | None = None
        self._covis_fetch = None          # prefetched top_covisible arrays
        self._ref_kf_tracked_dev = None   # async ref-KF tracked count
        self._cull_fetch = None           # async culled-slot id
        # staged (points_w, valid) scan batches awaiting the pooled insert
        self._lidar_pending: list = []
        self._last_staged_scan = None     # this frame's staged scan (reused
        #                                   by _store_kf_lidar at KF events)

        # --- IMU_STEREO_LIDAR mode state (LidarInertialProcess + inertial BA)
        self.use_imu = cfg.use_imu
        if self.use_imu:
            self.filt = esekf.init_filter()
            self.imu_noise = esekf.NoiseCfg.create(
                gyr=cfg.imu.noise_gyro * 100.0, acc=cfg.imu.noise_acc * 100.0,
                bg_rw=cfg.imu.gyro_walk, ba_rw=cfg.imu.acc_walk,
            )
            self.imu_cal = imu_est.ImuCalib.create(
                cfg.imu.noise_gyro, cfg.imu.noise_acc,
                cfg.imu.gyro_walk, cfg.imu.acc_walk,
            )
            self.T_bc = jnp.asarray(cfg.imu.T_bc, jnp.float32)
            self.T_cb = lie.se3_inverse(self.T_bc)
            self.imu_store = imu_mode.ImuKfStore.create(cfg.tracking.max_kf)
            self.gravity_vis = jnp.asarray([0.0, 9.81, 0.0])  # set at init
            self._imu_buf: list = []      # (gyro, acc, dts) since last KF
            self._imu_initialized = False
            self._last_filt_Twc = None    # LIO camera pose at previous frame
            # staged visual-inertial initialization (InitializeIMU,
            # LocalMapping.cc:1184-1445): becomes True once the gravity /
            # bias / velocity bundle has been optimized on the keyframe map
            self._vi_initialized = False
            # Refinement ladder (LocalMapping::Run:220-243): after the
            # first init, the reference re-runs InitializeIMU with loosening
            # bias priors + a FullInertialBA at mTinit > 5 s and > 15 s.
            self._vi_stage = 0            # 0 = first init, 1 = 5 s, 2 = 15 s
            self._vi_init_time = None     # timestamp of the first init
            self._has_factor_host = [False] * cfg.tracking.max_kf
            # Tightly-coupled per-frame pose tracking
            # (PoseInertialOptimizationLast{KeyFrame,Frame}, Optimizer.cc:
            # 2469/2854): device ring buffer of IMU samples since the last
            # KF + the marginalization-prior chain (ConstraintPoseImu).
            from ..solver import pose_inertial as pi_mod
            self._pi = pi_mod
            self._imu_ring = None          # (gyro [C,3], acc [C,3], dts [C])
            self._imu_ring_n = 0           # host count of filled slots
            self._imu_ring_overflow = False  # dropped window -> refine holds
            self._frame_prior = None       # FramePrior of the previous frame
            self._prev_vi_state = None
            self._vi_vel = jnp.zeros(3)
            self._imu_bad_dev = None       # async bad-IMU flag (device bool)

    # ------------------------------------------------------------------
    def prefetch(self, img_l, img_r, scan=None, scan_valid=None):
        """Stage the NEXT frame's sensor arrays on device (async H2D).

        ``jax.device_put`` returns at once and the copy runs while the
        CURRENT frame's device work drains, so the host-to-device transfer
        of a stereo pair + scan overlaps compute instead of preceding it.
        Returns a token for ``track``'s ``staged=`` argument. The pipelining
        the reference gets from its sensor-callback threads
        (camera_lidar_inertial.cc:139-145)."""
        bundle = [img_l, img_r] + ([scan] if scan is not None else []) \
            + ([scan_valid] if scan_valid is not None else [])
        dev = jax.device_put(bundle)
        return {"img_l": dev[0], "img_r": dev[1],
                "scan": dev[2] if scan is not None else None,
                "scan_valid": dev[3] if scan_valid is not None else None}

    # ------------------------------------------------------------------
    def _scan_to_device(self, scan):
        """Scans may arrive int16-quantized (x quant meters), half the bytes
        of the host-to-device copy; de-quantize on device."""
        s = jnp.asarray(scan)
        if s.dtype == jnp.int16:
            s = s.astype(jnp.float32) * self.cfg.lidar.scan_quant
        return s

    # ------------------------------------------------------------------
    def track(self, img_l, img_r, t, scan=None, scan_valid=None,
              gyro=None, acc=None, imu_dts=None, imu_trel=None,
              scan_times=None, staged=None) -> np.ndarray:
        """Process one stereo(+LiDAR[+IMU]) frame; returns T_cw [4, 4].

        In IMU mode the full FAST-LIO2 scan step (ESEKF predict + iterated
        point-to-plane update + map insert) runs first and provides the
        motion prediction for visual tracking, replacing the constant
        velocity model (PredictStateIMU's role)."""
        self.frame_idx += 1
        if staged is not None:
            img_l, img_r = staged["img_l"], staged["img_r"]
            if staged.get("scan") is not None:
                scan, scan_valid = staged["scan"], staged["scan_valid"]
        if scan is not None and scan_valid is None:
            # valid-free wire format: the loader zeroes invalid pad slots,
            # which land inside the blind radius and are dropped by the
            # device-side preprocess — an all-ones mask is exact
            scan_valid = jnp.ones(np.shape(scan)[0], bool)
        # Timestamp-jump guard (Tracking.cc:1919-1946): a gap above 1 s (or
        # a time loop-back, LidarFrontEnd.cpp:239-243) means the sensor
        # stream broke — freeze the map into the atlas and restart tracking.
        if self._last_t is not None and self.state != TrackingState.NOT_INITIALIZED:
            dt_frame = float(t) - self._last_t
            if dt_frame > 1.0 or dt_frame < 0.0:
                self._create_map_in_atlas()
                if self.use_imu:
                    self._reset_imu()
        self._last_t = float(t)
        if scan is not None:
            scan = self._scan_to_device(scan)
        with self.timers.stage("frame"):
            if self.use_imu and gyro is not None and scan is not None:
                with self.timers.stage("lio"):
                    self._lio_step(scan, scan_times, scan_valid, gyro, acc,
                                   imu_dts, imu_trel)
            with self.timers.stage("build_frame"):
                frame = tracking.build_frame(
                    jnp.asarray(img_l), jnp.asarray(img_r), self.cam,
                    self.scale_factors,
                    n_features=self.cfg.orb.n_features,
                    n_levels=self.cfg.orb.n_levels,
                )

            if self.state == TrackingState.NOT_INITIALIZED:
                self._stereo_initialization(frame, t, scan, scan_valid)
            else:
                self._track_frame(frame, t, scan, scan_valid)

            self._record_pose(t)
        return self.T_cw

    # ------------------------------------------------------------------
    def _stereo_initialization(self, frame, t, scan, scan_valid):
        """StereoInitialization (Tracking.cc:2430): first KF + stereo points."""
        n_depth = int(jnp.sum(frame.valid & (frame.depth > 0)))
        if n_depth < 100:
            return
        # Map 0 starts at the origin; atlas recovery maps are anchored at the
        # dead-reckoned pose so the exported trajectory stays continuous
        # (the reference restarts sub-maps at the origin instead).
        if self.map_id == 0:
            self.T_cw = jnp.eye(4)
        kf_id = self._create_keyframe(frame, t, scan, scan_valid,
                                      feat_lm=jnp.full((self.map.F,), mapstate.NO_LM, jnp.int32),
                                      run_ba=False)
        self.state = TrackingState.OK
        self.ref_kf = kf_id
        self.ref_kf_tracked = n_depth
        self.velocity = jnp.eye(4)

    # ------------------------------------------------------------------
    def _lio_step(self, scan, scan_times, scan_valid, gyro, acc, dts, trel):
        """Run the LiDAR-inertial odometry scan step and refresh the motion
        prediction from the filter's relative motion."""
        if not self._imu_initialized:
            n_samples = int(np.sum(np.asarray(dts) > 0))
            if n_samples < 3:
                return  # wait for a window with real IMU data (frame 0 is empty)
            # static init: gravity + gyro bias from the first window
            self.filt = esekf.static_init(
                self.filt, jnp.asarray(gyro), jnp.asarray(acc),
                jnp.asarray(dts) > 0,
            )
            # gravity in the visual world (cam0 axes): vis world = body0
            # axes rotated by the camera-body extrinsic
            g_lio = self.filt.x.grav
            self.gravity_vis = lie.rotation(self.T_cb) @ g_lio
            self._imu_initialized = True
        st = scan_times if scan_times is not None else np.zeros(len(scan), np.float32)
        res = lio.lio_scan_step(
            self.filt, self.vmap, jnp.asarray(scan), jnp.asarray(st),
            jnp.asarray(scan_valid), jnp.asarray(gyro), jnp.asarray(acc),
            jnp.asarray(dts), jnp.asarray(trel),
            self.imu_noise, self.lio_cfg,
        )
        self.filt, self.vmap = res.filt, res.map
        self.vmap, _ = lio.maybe_recenter(self.vmap, self.filt.x.pos)
        # Bad-IMU guard (mbBadImu, LocalMapping.cc:144-154): the divergence
        # check runs inside lio_scan_step ON DEVICE (a bad state reverted
        # the filter and suppressed the insert there); the flag rides back
        # asynchronously and the host-side inertial-stack reset fires at
        # this frame's sync point (_drain_async) — no blocking per-frame
        # isfinite/norm fetches on the hot path.
        bad = res.bad
        if self._imu_bad_dev is not None:   # not yet drained (init frames)
            bad = bad | self._imu_bad_dev
        self._async_fetch(bad)
        self._imu_bad_dev = bad
        self._imu_buf.append((np.asarray(gyro), np.asarray(acc), np.asarray(dts)))
        g_dev, a_dev, d_dev = jnp.asarray(gyro), jnp.asarray(acc), jnp.asarray(dts)
        self._last_imu_window = (g_dev, a_dev, d_dev)
        self._imu_ring_append(g_dev, a_dev, d_dev)
        # prediction: relative LIO camera motion composed onto the visual
        # pose. On a bad scan the filter kept its pre-scan state, so the
        # relative motion degenerates to identity — keep the previous
        # velocity instead (const-velocity dead reckoning, all on device).
        T_wb = lie.se3(self.filt.x.R, self.filt.x.pos)
        T_wc_lio = T_wb @ self.T_bc
        if self._last_filt_Twc is not None:
            rel = lie.se3_inverse(T_wc_lio) @ self._last_filt_Twc
            self.velocity = jnp.where(res.bad, self.velocity, rel)
        self._last_filt_Twc = T_wc_lio

    # ------------------------------------------------------------------
    IMU_RING_CAP = 1024

    def _imu_ring_append(self, gyro, acc, dts):
        """Append this frame's IMU window into the since-last-KF device ring
        (padding samples carry dt=0 and are no-ops for the preintegration)."""
        W = gyro.shape[0]
        if self._imu_ring is None:
            C = self.IMU_RING_CAP
            self._imu_ring = (jnp.zeros((C, 3)), jnp.zeros((C, 3)), jnp.zeros(C))
        if self._imu_ring_n + W > self.IMU_RING_CAP:
            # overflow: the since-KF window is no longer contiguous — flag it
            # so the VI frame refine disables itself until the next KF resets
            # the ring (a gapped ring would preintegrate a wrong interval)
            self._imu_ring_overflow = True
            return
        g, a, d = self._imu_ring
        n = self._imu_ring_n
        self._imu_ring = (
            jax.lax.dynamic_update_slice(g, gyro, (n, 0)),
            jax.lax.dynamic_update_slice(a, acc, (n, 0)),
            jax.lax.dynamic_update_slice(d, dts, (n,)),
        )
        self._imu_ring_n += W

    def _imu_ring_reset(self):
        if self._imu_ring is not None:
            g, a, d = self._imu_ring
            self._imu_ring = (g, a, jnp.zeros_like(d))
        self._imu_ring_n = 0
        self._imu_ring_overflow = False

    # ------------------------------------------------------------------
    def _vi_frame_refine(self, res):
        """Per-frame tightly-coupled pose refinement (the reference runs
        PoseInertialOptimizationLastKeyFrame right after a map update and
        ...LastFrame otherwise, Tracking.cc:2858-2878). Adopts the refined
        pose/velocity and chains the marginalization prior; ONE fused
        program per frame (un-fused, the prep chain is ~30 dispatches)."""
        pi_mod = self._pi
        if self._imu_ring is None or self._imu_ring_n == 0:
            return
        if getattr(self, "_imu_ring_overflow", False):
            # a dropped window made the since-KF ring non-contiguous; the
            # last-KF preintegration would span a gapped interval — hold off
            # until the next keyframe resets the ring
            self._frame_prior = None
            return
        use_last_frame = (self.frames_since_kf > 0
                          and self._frame_prior is not None
                          and self._prev_vi_state is not None)
        has_prev = self._prev_vi_state is not None
        dummy_state = pi_mod.FrameVIState(
            jnp.eye(4), jnp.zeros(3), jnp.zeros(3), jnp.zeros(3))
        out = _vi_refine_kernel(
            self.map, self.imu_store, self._last_frame, res.T_cw,
            res.feat_lm, jnp.int32(max(self.ref_kf, 0)), self.T_cb,
            self.T_bc, self.cam, self.sigma2, self.imu_cal,
            self.gravity_vis, self._imu_ring, jnp.int32(self._imu_ring_n),
            self._last_imu_window,
            self._prev_vi_state if has_prev else dummy_state,
            self._frame_prior if self._frame_prior is not None
            else pi_mod.FramePrior.empty(),
            self._vi_vel, self.last_T_cw,
            use_last_frame=use_last_frame, has_prev=has_prev,
        )
        (self.T_cw, self.velocity, self._vi_vel, self._frame_prior,
         self._prev_vi_state) = out

    # ------------------------------------------------------------------
    def _predict_pose_imu(self):
        """PredictStateIMU (Tracking.cc:1825): dead-reckon the frame pose
        from the last keyframe's VI state + the since-KF preintegrated IMU
        window (the preintegration is the only motion source — used when
        visual tracking fails and the LIO prediction is unavailable or
        untrusted)."""
        kf = max(self.ref_kf, 0)
        T_wb_kf = lie.se3_inverse(self.map.kf_T_cw[kf]) @ self.T_cb
        g, a, d = self._imu_ring
        d = jnp.where(jnp.arange(d.shape[0]) < self._imu_ring_n, d, 0.0)
        pre = imu_est.integrate(
            self.imu_cal, g, a, d,
            self.imu_store.bg[kf], self.imu_store.ba[kf],
        )
        R1 = T_wb_kf[:3, :3]
        p1 = T_wb_kf[:3, 3]
        v1 = self.imu_store.vel[kf]
        grav = self.gravity_vis
        # state composition of the EdgeInertial model (factors.imu_residual):
        # R2 = R1 dR; p2 = p1 + v1 dt + 0.5 g dt^2 + R1 dP
        R2 = R1 @ pre.dR
        p2 = p1 + v1 * pre.dt + 0.5 * grav * pre.dt * pre.dt + R1 @ pre.dP
        return lie.se3_inverse(lie.se3(R2, p2) @ self.T_bc)

    # ------------------------------------------------------------------
    def _reset_imu(self):
        """Re-arm the inertial stack after a bad-IMU / stream-break event."""
        if profiling.DEBUG_VI:
            print(f"[vi] RESET at frame {self.frame_idx} t={self._last_t}",
                  flush=True)
        self.filt = esekf.init_filter()
        self._imu_initialized = False
        self._vi_initialized = False
        self._imu_buf = []
        self._last_filt_Twc = None
        self.velocity = jnp.eye(4)
        self._imu_ring_reset()
        self._frame_prior = None
        self._prev_vi_state = None
        self._imu_bad_dev = None
        self._vi_stage = 0
        self._vi_init_time = None

    # ------------------------------------------------------------------
    def activate_localization_mode(self, on: bool = True):
        """Localization-only: track against the frozen map, create no
        keyframes/landmarks (System::ActivateLocalizationMode)."""
        self.localization_only = on

    # ------------------------------------------------------------------
    def _track_frame(self, frame, t, scan, scan_valid):
        T_pred = self.velocity @ self.T_cw
        # Fused 3-pass tracking (motion-model guided + global re-acquisition
        # + refinement, TrackWithMotionModel / TrackReferenceKeyFrame /
        # TrackLocalMap) with on-device best-of selection: ONE host sync per
        # frame, on the inlier count driving the state machine.
        self._rng_key, sub = jax.random.split(self._rng_key)
        with self.timers.stage("track_step"):
            new_map, res, T_new, vel_new = tracking.track_step(
                self.map, frame, self.T_cw, self.velocity, sub, self.cam,
                self.scale_factors, self.sigma2,
                jnp.asarray(self.cfg.tracking.match_radius_narrow, jnp.float32),
            )
            # request the decision scalar early: the copy depends only on
            # track_step's output, so it rides back while the map update
            # below still executes
            try:
                res.n_inliers.copy_to_host_async()
            except (AttributeError, RuntimeError):
                pass

        # Stage the LiDAR scan for the batched map insert BEFORE the host
        # sync, against the un-synced tracked pose (UpdateMap, Tracking.cc:
        # 1603): it needs no host decision, and on the (rare) tracking
        # failure the staged entry is simply dropped. The actual pool insert
        # runs every ``insert_every`` frames (camera_scan_stage docstring).
        staged_scan = None
        if self.lidar_enabled and scan is not None and not self.use_imu:
            with self.timers.stage("lidar_update"):
                staged_scan = lio.camera_scan_stage(
                    scan, jnp.asarray(scan_valid), res.T_cw,
                    self.T_cl, jnp.float32(self.cfg.lidar.blind),
                    jnp.float32(self.cfg.lidar.map_voxel),
                    insert_cap=self.cfg.lidar.insert_cap,
                )
                self._lidar_pending.append(staged_scan)
                self._last_staged_scan = staged_scan

        with self.timers.stage("sync"):
            n_inl = int(res.n_inliers)  # the frame's device->host sync
        # resolve async host mirrors queued by the previous keyframe event
        # (their device values are ready now — the frame sync drained the
        # device queue past them)
        self._drain_async()

        if n_inl < max(self.cfg.tracking.min_inliers, 10):
            # the optimistic scan staging above used a failed pose: drop it
            if staged_scan is not None and self._lidar_pending \
                    and self._lidar_pending[-1] is staged_scan:
                self._lidar_pending.pop()
                staged_scan = None
            # motion-model pass came back weak: run the window-free global
            # re-acquisition + refinement (TrackReferenceKeyFrame's role) —
            # gated on the host so the common path never pays for it
            with self.timers.stage("track_recover"):
                new_map, res, T_new, vel_new = tracking.track_step_recover(
                    self.map, frame, self.T_cw, T_pred, self.velocity, sub,
                    self.cam, self.scale_factors, self.sigma2,
                    jnp.asarray(self.cfg.tracking.match_radius_narrow,
                                jnp.float32),
                )
                n_inl = int(res.n_inliers)

        if n_inl < 10 and self.voc is not None:
            # relocalization (Tracking.cc:3478): BoW candidates + PnP RANSAC
            self._rng_key, sub = jax.random.split(self._rng_key)
            rr = relocalization.relocalize(
                self.map, frame, self.cam, self.voc, self.kf_words,
                self.sigma2, sub,
            )
            if rr.ok:
                res = tracking.TrackResult(
                    rr.T_cw, rr.feat_lm, jnp.int32(rr.n_inliers), jnp.int32(rr.n_inliers)
                )
                n_inl = rr.n_inliers
                T_new = rr.T_cw
                vel_new = jnp.eye(4)  # motion model invalid after reloc

        if n_inl < 10:
            self.state = TrackingState.RECENTLY_LOST
            self.n_lost += 1
            # dead-reckon: with a matured inertial stack, predict from the
            # last keyframe's VI state + the since-KF preintegration
            # (PredictStateIMU, Tracking.cc:1825 — the reference holds
            # RECENTLY_LOST frames exactly this way, Tracking.cc:2069-2102);
            # otherwise track_step already returned T_new = motion model
            self.last_T_cw = self.T_cw
            if (self.use_imu and self._vi_initialized
                    and self._imu_ring is not None and self._imu_ring_n > 0
                    and not self._imu_ring_overflow):
                T_new = self._predict_pose_imu()
            self.T_cw = T_new
            self.frames_since_kf += 1
            if self.n_lost >= self.cfg.tracking.recently_lost_frames:
                # RECENTLY_LOST -> LOST: freeze the map, start a new one
                # (CreateMapInAtlas / ResetActiveMap, Tracking.cc:2104-2123)
                self._create_map_in_atlas()
            return

        self.state = TrackingState.OK
        self.n_lost = 0
        self.last_T_cw = self.T_cw
        self.T_cw = T_new
        self.velocity = vel_new
        self.map = new_map

        # deferred LocalMapping pass for the keyframe created last frame
        # (LocalMapping thread semantics: tracking of frame k+1 proceeds
        # while the KF-k mapping work runs; here it is dispatched now and
        # overlaps THIS frame's remaining host work + the next H2D)
        if self._pending_mapping is not None:
            with self.timers.stage("mapping"):
                kf_q = self._pending_mapping
                self._pending_mapping = None
                self._mapping_step(kf_q)

        # Tightly-coupled VI pose refinement (visual + IMU preintegration
        # prior at frame rate) once the inertial stack is initialized
        if self.use_imu and self._imu_initialized and self._vi_initialized:
            self._last_frame = frame
            with self.timers.stage("vi_refine"):
                self._vi_frame_refine(res)

        # LiDAR scan staging: normally already done pre-sync (above); on a
        # recovery path the pre-sync staging used the failed pose and was
        # dropped — re-stage at the recovered pose.
        if (staged_scan is None and self.lidar_enabled
                and scan is not None and not self.use_imu):
            with self.timers.stage("lidar_update"):
                restaged = lio.camera_scan_stage(
                    scan, jnp.asarray(scan_valid), self.T_cw,
                    self.T_cl, jnp.float32(self.cfg.lidar.blind),
                    jnp.float32(self.cfg.lidar.map_voxel),
                    insert_cap=self.cfg.lidar.insert_cap,
                )
                self._lidar_pending.append(restaged)
                self._last_staged_scan = restaged
        if len(self._lidar_pending) >= self.cfg.lidar.insert_every:
            with self.timers.stage("lidar_update"):
                self._lidar_flush()

        if self.localization_only:
            self.frames_since_kf += 1
            return

        if self._need_new_keyframe(n_inl, frame):
            with self.timers.stage("keyframe"):
                self._create_keyframe(frame, t, scan, scan_valid, res.feat_lm,
                                      run_ba=True)
            self.frames_since_kf = 0
        else:
            self.frames_since_kf += 1

    # ------------------------------------------------------------------
    def _need_new_keyframe(self, n_inliers: int, frame) -> bool:
        """NeedNewKeyFrame (Tracking.cc:2942), simplified to its dominant
        terms: reference-KF track ratio + frame interval bounds."""
        t = self.cfg.tracking
        if self.frames_since_kf < t.kf_min_interval:
            return False
        if self.frames_since_kf >= t.kf_max_interval:
            return True
        return n_inliers < t.kf_track_ratio * max(self.ref_kf_tracked, 1)

    # ------------------------------------------------------------------
    def _create_keyframe(self, frame, t, scan, scan_valid, feat_lm, run_ba):
        if self.lidar_enabled and not self.use_imu:
            # the KF event reads the voxel map (plane gating + plane-feature
            # selection) — land any staged scan batches first
            self._lidar_flush()
        # host mirror of the slot id (add_keyframe writes min(n_kf, K-1)):
        # avoids a device->host sync on the hot keyframe path
        kf_id = min(self.n_kf_host, self.cfg.tracking.max_kf - 1)
        self.n_kf_host = min(self.n_kf_host + 1, self.cfg.tracking.max_kf)

        # One fused program: KF snapshot + stereo-landmark gating (near-
        # duplicate suppression, LiDAR plane-consistency verification —
        # the tightly-coupled depth gate: a stereo landmark must lie on
        # LiDAR structure; 512-query compaction,
        # the reference caps close-depth MapPoints at 100/KF,
        # Tracking.cc:3121) + allocation + the ref-KF tracked count.
        use_gate = (self.lidar_enabled and scan is not None
                    and self.frame_idx > 0)
        self.map, rkt, n_lm_dev = _kf_create_kernel(
            self.map, self.vmap, jnp.int32(kf_id), frame, self.T_cw,
            jnp.asarray(t, jnp.float32), feat_lm, self.cam,
            jnp.asarray(self.cfg.camera.th_depth, jnp.float32),
            self.scale_factors,
            use_lidar=use_gate,
        )

        # store LiDAR features for this KF (BuildLidarFeat4KeyFrame)
        if self.lidar_enabled and scan is not None:
            self._store_kf_lidar(kf_id, scan, scan_valid)

        if self.voc is not None:
            words, _ = bow.quantize(self.voc, frame.desc, frame.valid,
                                    self.voc.depth)
            self.kf_words = self.kf_words.at[kf_id].set(jnp.sort(words))

        if self.use_imu:
            pre = None
            if self._imu_buf and kf_id > 0:
                g = np.concatenate([b[0] for b in self._imu_buf])
                a = np.concatenate([b[1] for b in self._imu_buf])
                d = np.concatenate([b[2] for b in self._imu_buf])
                pre = imu_est.integrate(
                    self.imu_cal, jnp.asarray(g), jnp.asarray(a),
                    jnp.asarray(d), self.filt.x.bg, self.filt.x.ba,
                )
            self._imu_buf = []
            # velocity snapshot in visual-world axes; prefer the VI frame
            # tracker's estimate once it runs (it lives in the visual frame)
            if self._prev_vi_state is not None and self._vi_initialized:
                v_vis = self._vi_vel
            else:
                v_vis = lie.rotation(self.T_cb) @ self.filt.x.vel
            self.imu_store = self.imu_store.set_kf(
                kf_id, pre, v_vis, bg=self.filt.x.bg, ba=self.filt.x.ba
            )
            if pre is not None:
                self._has_factor_host[kf_id] = True
            # reset the per-frame tight coupling at the KF boundary (the
            # reference switches back to ...LastKeyFrame on map update)
            self._imu_ring_reset()
            self._frame_prior = None

        self.ref_kf = kf_id
        # reference-KF track baseline = features now linked to landmarks
        # (TrackedMapPoints semantics, not raw depth count). Fetched
        # asynchronously — resolved at the next frame's sync point; until
        # then the previous baseline stands (one-frame lag, no blocking).
        self._async_fetch(rkt)
        self._ref_kf_tracked_dev = rkt
        # landmark-count mirror (sizes the BA's active-landmark bucket)
        self._async_fetch(n_lm_dev)
        self._n_lm_dev = n_lm_dev

        # loop closing (per KF, when place recognition is available and the
        # config enables it — the parsed loopClosing flag is honored here)
        if (self.voc is not None and self.cfg.loop_closing and run_ba
                and kf_id > self.cfg.loop_min_kf):
            self._try_close_loop(kf_id)

        if run_ba and self.n_kf_host >= 3:
            # defer the mapping pass to the next frame (LocalMapping-thread
            # semantics); prefetch the covisibility window now so its
            # device->host copy rides along with the keyframe device chain
            self._pending_mapping = kf_id
            neigh, w = mapstate.top_covisible(
                self.map, jnp.int32(kf_id),
                self.cfg.tracking.local_window - 1, min_weight=10,
            )
            self._async_fetch(neigh)
            self._async_fetch(w)
            self._covis_fetch = (neigh, w)
        return kf_id

    # ------------------------------------------------------------------
    @staticmethod
    def _async_fetch(arr):
        """Start a non-blocking device->host copy (ignored where the
        runtime lacks the API — the later blocking read still works)."""
        try:
            arr.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass

    def _drain_async(self):
        """Resolve async host mirrors (called right after the frame sync)."""
        if self.use_imu and self._imu_bad_dev is not None:
            bad = bool(self._imu_bad_dev)
            self._imu_bad_dev = None
            if bad:
                # diverged / non-finite filter: the device side already
                # reverted the state and skipped the insert; re-arm the
                # inertial stack (static init will re-converge)
                self._reset_imu()
        if self._ref_kf_tracked_dev is not None:
            self.ref_kf_tracked = int(self._ref_kf_tracked_dev)
            self._ref_kf_tracked_dev = None
        if self._n_lm_dev is not None:
            self.n_lm_host = int(self._n_lm_dev)
            self._n_lm_dev = None
        if self._cull_fetch is not None:
            killed = int(self._cull_fetch)
            self._cull_fetch = None
            if killed >= 0:
                self.kf_alive[killed] = False

    def _lidar_flush(self):
        """Insert all staged scan batches into the voxel-map pool at once.

        The batch list is padded to a CONSTANT ``insert_every`` entries
        (empty batches carry valid=False): a keyframe event can force an
        early flush with 1-3 staged batches, and a per-count concat shape
        would compile a fresh multi-second insert program per count —
        exactly the mid-run compile class the prewarm exists to prevent."""
        if not self._lidar_pending:
            return
        pend = list(self._lidar_pending)
        self._lidar_pending = []
        n_pad = max(self.cfg.lidar.insert_every - len(pend), 0)
        if n_pad:
            p0, v0 = pend[0]
            pend += [(jnp.zeros_like(p0), jnp.zeros_like(v0))] * n_pad
        pts = jnp.concatenate([p for p, _ in pend])
        val = jnp.concatenate([v for _, v in pend])
        center = lie.translation(lie.se3_inverse(self.T_cw) @ self.T_cl)
        self.vmap = lio.camera_map_flush(self.vmap, pts, val, center)

    def flush_mapping(self):
        """Run any deferred LocalMapping work now (System::Shutdown waits
        for the mapping thread the same way). Call before reading final map
        state or saving trajectories/checkpoints."""
        if self._pending_mapping is not None:
            kf_q = self._pending_mapping
            self._pending_mapping = None
            self._mapping_step(kf_q)
        if self.lidar_enabled and not self.use_imu:
            self._lidar_flush()
        self._drain_async()

    # ------------------------------------------------------------------
    def _ba_active_bucket(self) -> int:
        """Power-of-2 active-landmark budget for the windowed BA, sized from
        the (async-mirrored) landmark count: the Schur cost scales linearly
        with the budget, and a young map solving at the full configured cap
        wastes 2-4x on padded rows (530 -> 209 -> ~120 ms measured). The
        floor matters as much as the cap: every DISTINCT bucket compiles its
        own multi-minute XLA BA variant, and a bucket that grows mid-run
        drops that compile into the live frame stream (the round-4 bench
        regression: two fresh local_ba variants compiled mid-measurement).
        ``ba_active_min`` keeps typical runs on a single prewarmed variant."""
        cap = self.cfg.tracking.ba_active_landmarks
        hint = int(self.n_lm_host * 1.25) + 512   # headroom: mirror lags 1 KF
        b = min(self.cfg.tracking.ba_active_min, cap)
        while b < hint and b < cap:
            b *= 2
        return min(b, cap)

    def _ba_buckets_reachable(self) -> list[int]:
        """All bucket sizes ``_ba_active_bucket`` can ever return with this
        config (for prewarm)."""
        cap = self.cfg.tracking.ba_active_landmarks
        out, b = [], min(self.cfg.tracking.ba_active_min, cap)
        while b < cap:
            out.append(b)
            b *= 2
        out.append(cap)
        return out

    # ------------------------------------------------------------------
    def prewarm(self):
        """Compile every steady-state program variant NOW, outside the live
        frame stream.

        XLA compiles lazily at first call: programs whose first occurrence
        is data-dependent (the first tracking recovery, the first keyframe
        cull, a BA bucket the growing map reaches minutes in) otherwise
        drop a multi-second-to-minute compile stall into a live frame (the
        round-4 bench shipped two such compiles mid-measurement). Call
        after a few bootstrap frames (>= 3 keyframes); all invocations are
        functional — results are dropped, no SLAM state changes. The
        persistent compile cache (tc2li_slam_tpu/__init__.py) makes later
        processes skip the work entirely."""
        if self.n_kf_host < 1:
            return
        t = self.cfg.tracking
        kf_id = min(max(self.ref_kf, 0), self.cfg.tracking.max_kf - 1)
        m = self.map

        # frame-path variants that only fire on rare host branches (uint8
        # input — what cameras deliver and what the bench/app layer sends)
        c = self.cfg.camera
        img0 = jnp.zeros((c.height, c.width), jnp.uint8)
        frame = tracking.build_frame(
            img0, img0, self.cam, self.scale_factors,
            n_features=self.cfg.orb.n_features, n_levels=self.cfg.orb.n_levels)
        key = jax.random.PRNGKey(0)
        tracking.track_step(
            m, frame, self.T_cw, self.velocity, key, self.cam,
            self.scale_factors, self.sigma2,
            jnp.asarray(t.match_radius_narrow, jnp.float32))
        tracking.track_step_recover(
            m, frame, self.T_cw, self.T_cw, self.velocity, key, self.cam,
            self.scale_factors, self.sigma2,
            jnp.asarray(t.match_radius_narrow, jnp.float32))

        # keyframe-event kernel, both lidar-gate variants
        feat_lm0 = jnp.full((m.F,), mapstate.NO_LM, jnp.int32)
        for ul in ([False, True] if self.lidar_enabled else [False]):
            _kf_create_kernel(
                m, self.vmap, jnp.int32(kf_id), frame, self.T_cw,
                jnp.float32(0.0), feat_lm0, self.cam,
                jnp.asarray(self.cfg.camera.th_depth, jnp.float32),
                self.scale_factors, use_lidar=ul)

        # deferred-mapping maintenance + keyframe culling
        nbs = jnp.full((t.tri_pairs,), mapstate.NO_KF, jnp.int32)
        _mapping_maintain_kernel(
            m, jnp.int32(kf_id), nbs, jnp.int32(mapstate.NO_KF), self.cam,
            self.sigma2, self.scale_factors, max_pairs=t.tri_pairs,
            do_triangulate=t.triangulate)
        ls = self.lidar_store if self.lidar_enabled else None
        _cull_kernel(
            m, jnp.zeros(m.K, bool),
            ls.valid if ls is not None else None,
            self.kf_words if self.voc is not None else None,
            jnp.float32(t.cull_kf_redundancy))
        mapstate.top_covisible(m, jnp.int32(kf_id), t.local_window - 1,
                               min_weight=10)

        # windowed BA at every bucket the adaptive budget can pick
        if self.n_kf_host >= 3:
            for b in self._ba_buckets_reachable():
                local_mapping.run_local_ba(
                    m, self.lidar_store, kf_id, self.cam, self.sigma2,
                    self.T_cl, n_window=t.local_window,
                    balm_window=self.cfg.lidar.balm_window,
                    balm_voxel=self.cfg.lidar.balm_voxel,
                    balm_max_voxels=self.cfg.lidar.balm_max_voxels,
                    balm_min_points=self.cfg.lidar.balm_min_points,
                    w_lba=self.cfg.lidar.w_lba if self.lidar_enabled else 0.0,
                    iters=t.ba_iters, n_kf=self.n_kf_host,
                    max_active=b, mesh=self.mesh)

        # post-loop-closure global BA (64-KF window): only reachable with
        # place recognition on, but then it fires exactly once mid-run —
        # the worst place for its compile
        if (self.voc is not None and self.cfg.loop_closing
                and self.n_kf_host >= 3):
            alive = [k for k in range(self.n_kf_host) if self.kf_alive[k]]
            window = alive[-self.GLOBAL_BA_KFS:]
            pad = self.GLOBAL_BA_KFS - len(window)
            for b in self._ba_buckets_reachable():
                local_mapping.run_local_ba(
                    m, None, window[-1], self.cam, self.sigma2, self.T_cl,
                    n_window=self.GLOBAL_BA_KFS, w_lba=0.0, iters=8,
                    n_kf=self.n_kf_host,
                    window=window + [mapstate.NO_KF] * pad,
                    fixed=[w == window[0] for w in window] + [True] * pad,
                    max_active=b)

        if self.use_imu:
            self._prewarm_imu(kf_id)

    def _prewarm_imu(self, kf_id: int):
        """Compile the inertial programs whose first natural occurrence is
        minutes into a run: the VIBA refinement-ladder rungs (5 s / 15 s
        after init, LocalMapping::Run:220-243) and the fixed-20-slot
        FullInertialBA window. State mutated by the solvers is snapshotted
        and restored — prewarm has no estimation side effects."""
        if self.n_kf_host < 4 or not any(self._has_factor_host):
            return
        snap = (self.map, self.imu_store, self.gravity_vis,
                self._vi_initialized, self._vi_stage, self._vi_init_time)
        try:
            if self._vi_initialized:
                # every reachable landmark bucket, for BOTH window sizes —
                # a bucket first reached mid-run would otherwise drop a
                # minute-class LVI-BA compile into the live frame stream
                for b in self._ba_buckets_reachable():
                    self._run_lvi_ba(kf_id, max_active=b)
                    self._run_lvi_ba(kf_id, n_window=20, use_balm=False,
                                     iters=10, max_active=b)
                for stage in (1, 2):
                    self._initialize_imu(kf_id, stage=stage)
        finally:
            (self.map, self.imu_store, self.gravity_vis,
             self._vi_initialized, self._vi_stage, self._vi_init_time) = snap

    # ------------------------------------------------------------------
    def _mapping_step(self, kf_id: int):
        """One deterministic LocalMapping pass for the new keyframe, in the
        reference thread's order (LocalMapping::Run, LocalMapping.cc:70-295):
        MapPointCulling -> CreateNewMapPoints -> SearchInNeighbors/Fuse ->
        local (LVI-)BA -> KeyFrameCulling."""
        t = self.cfg.tracking
        covis, self._covis_fetch = self._covis_fetch, None
        window, fixed = local_mapping.select_window(
            self.map, kf_id, t.local_window, n_kf=self.n_kf_host,
            alive=self.kf_alive, covis=covis,
        )
        # The mapping pass may run one frame after the KF (deferred): BA
        # refines the reference KF's pose, and the CURRENT frame's pose must
        # follow it relatively (exactly how the trajectory recomposes,
        # Tracking.cc:2393-2411) — capture the pre-BA reference pose now.
        T_ref_old = self.map.kf_T_cw[kf_id]

        with self.timers.stage("maintain"):
            # nearest (most covisible / most recent) neighbors first; the
            # second fuse target is the best covisible neighbor
            # (SearchInNeighbors runs BOTH directions in the reference)
            neighbors = sorted(
                (w for w in window if w not in (kf_id, mapstate.NO_KF)),
                reverse=True,
            )
            nbs = neighbors[:t.tri_pairs]
            nbs += [mapstate.NO_KF] * (t.tri_pairs - len(nbs))
            nb_fuse = neighbors[0] if neighbors else mapstate.NO_KF
            self.map = _mapping_maintain_kernel(
                self.map, jnp.int32(kf_id), jnp.asarray(nbs, jnp.int32),
                jnp.int32(nb_fuse), self.cam, self.sigma2,
                self.scale_factors, max_pairs=t.tri_pairs,
                do_triangulate=t.triangulate,
            )

        with self.timers.stage("local_ba"):
            use_lvi = self.use_imu and self.cfg.inertial_ba
            if use_lvi and not self._vi_initialized:
                # staged bootstrap: needs a few consecutive KFs with factors
                if self.n_kf_host >= 4:
                    self._initialize_imu(kf_id)
                use_lvi = self._vi_initialized
            if use_lvi:
                self._run_lvi_ba(kf_id)
                # staged-init refinement ladder (VIBA1/VIBA2) — runs before
                # the reference-pose recomposition below so the current
                # frame follows any FullInertialBA pose correction
                self._maybe_refine_imu_init(kf_id)
            else:
                self.map = local_mapping.run_local_ba(
                    self.map, self.lidar_store, kf_id, self.cam, self.sigma2,
                    self.T_cl,
                    n_window=t.local_window,
                    balm_window=self.cfg.lidar.balm_window,
                    balm_voxel=self.cfg.lidar.balm_voxel,
                    balm_max_voxels=self.cfg.lidar.balm_max_voxels,
                    balm_min_points=self.cfg.lidar.balm_min_points,
                    w_lba=self.cfg.lidar.w_lba if self.lidar_enabled else 0.0,
                    iters=t.ba_iters,
                    n_kf=self.n_kf_host,
                    window=window, fixed=fixed,
                    max_active=self._ba_active_bucket(),
                    mesh=self.mesh,
                )

        # carry the BA's correction of the reference KF onto the current
        # frame's pose: T_cw' = (T_cw o T_ref_old^-1) o T_ref_new
        T_ref_new = self.map.kf_T_cw[kf_id]
        self.T_cw = (self.T_cw @ lie.se3_inverse(T_ref_old)) @ T_ref_new

        if (t.cull_kf_every > 0 and kf_id % t.cull_kf_every == 0
                and self.n_kf_host > t.local_window + 4):
            with self.timers.stage("cull_kf"):
                self._cull_keyframes(protect=set(window) | {0, kf_id})

    # ------------------------------------------------------------------
    def _cull_keyframes(self, protect: set[int]):
        """KeyFrameCulling (LocalMapping.cc:913): invalidate the most
        redundant keyframe (>= cull_kf_redundancy of its landmarks observed
        by >= 4 other KFs). Selection and all state updates run ON DEVICE
        in ONE program (redundancy + removal + lidar/BoW mask scrub); the
        killed slot id rides back asynchronously and updates the host
        ``kf_alive`` mirror at the next frame sync (one-frame lag — a culled
        KF may appear in one more window with zero remaining observations,
        which is inert). Culled slots keep their (frozen) pose so per-frame
        relative trajectory entries stay recomposable — slots NOT recycled."""
        K = self.map.K
        pm = np.zeros(K, bool)
        for k in protect:
            if 0 <= k < K:
                pm[k] = True
        # not-yet-drained prior cull: protect nothing extra (kf_valid on
        # device already reflects it)
        ls = self.lidar_store if (self.lidar_enabled
                                  and self.lidar_store is not None) else None
        self.map, killed, ls_valid, kf_words = _cull_kernel(
            self.map, jnp.asarray(pm),
            ls.valid if ls is not None else None,
            self.kf_words if self.voc is not None else None,
            jnp.float32(self.cfg.tracking.cull_kf_redundancy),
        )
        if ls_valid is not None:
            self.lidar_store = self.lidar_store._replace(valid=ls_valid)
        if kf_words is not None:
            self.kf_words = kf_words
        self._async_fetch(killed)
        self._cull_fetch = killed

    # ------------------------------------------------------------------
    def _kf_body_poses(self, window_arr):
        """T_wb per window KF from the visual map (T_wb = inv(T_bc T_cw))."""
        T_cw_win = self.map.kf_T_cw[window_arr]
        return jax.vmap(
            lambda T: lie.se3_inverse(T) @ lie.se3_inverse(self.T_bc)
        )(T_cw_win)

    def _seed_velocities(self, window_arr, T_wb_win):
        """Per-KF velocity init: optimizer output where available, else a
        finite difference of keyframe positions (the reference seeds its
        inertial optimization the same way, LocalMapping::InitializeIMU —
        pre-convergence ESEKF velocities are unreliable)."""
        pos_w = T_wb_win[:, :3, 3]
        dts = jnp.maximum(self.imu_store.dt[window_arr][1:], 1e-2)
        v_mid = (pos_w[1:] - pos_w[:-1]) / dts[:, None]
        v_fd = jnp.concatenate([v_mid[:1], v_mid], axis=0)
        v_st = self.imu_store.vel[window_arr]
        use_st = self.imu_store.vel_opt[window_arr]
        return jnp.where(use_st[:, None], v_st, v_fd)

    # (priorG, priorA) bias-prior weights per refinement stage — the
    # reference's 1e2/1e10 -> 1/1e5 -> 0/0 ladder (LocalMapping.cc:220-243),
    # rescaled for the floored-covariance factors (imu_mode.SIGMA_*_FLOOR).
    # The floors bound the factors' information, so a ~zero prior would let
    # the weakly observed bias directions overfit them (measured: free
    # stage-2 ba overshooting 3x its true value); the last rung therefore
    # keeps a small positive weight.
    VI_STAGE_PRIORS = ((1e2, 1e6), (1.0, 1e4), (0.1, 1e3))
    VI_STAGE_TIMES = (0.0, 5.0, 15.0)   # elapsed-since-init gates (s)

    def _initialize_imu(self, kf_id: int, stage: int = 0) -> bool:
        """Staged visual-inertial initialization (InitializeIMU,
        LocalMapping.cc:1184-1445): gravity bootstrap from preintegrated
        velocity deltas -> InertialOptimization (gravity dir + shared biases
        + per-KF velocities on FIXED poses) -> adopt gravity/biases/
        velocities. Stereo fixes scale, so ApplyScaledRotation reduces to
        adopting the refined gravity vector (the map frame is kept; our
        lvi_ba takes gravity as data rather than assuming -z).

        ``stage`` selects the refinement rung (VIBA 0/1/2): later rungs
        loosen the bias priors and re-estimate the gravity direction
        against the by-then mature keyframe map, then a full-window joint
        inertial BA (FullInertialBA, Optimizer.cc:394) refines poses /
        velocities / biases / structure together.

        Returns True iff the optimization actually ran (the reference
        retries InitializeIMU each LocalMapping pass until it does —
        LocalMapping::Run:210-243); callers must not advance the
        refinement ladder on an early-out."""
        from ..solver import inertial_init
        # CONSECUTIVE temporal window, culled KFs included (same policy as
        # _run_lvi_ba): culled slots keep their frozen pose and their
        # preintegration factor, so the consecutive chain stays intact —
        # where the reference merges preintegrations into the next KF on
        # cull (KeyFrame::SetBadFlag), this build keeps the factor chain
        # whole by construction. Filtering to alive KFs instead would
        # break the chain at every cull and permanently starve the
        # VIBA1/VIBA2 rungs of factors (observed in the r5 bench).
        window = list(range(max(0, kf_id - 19), kf_id + 1))
        if len(window) < 4:
            return False
        # Factor validity from the HOST mirror — no device sync; window
        # padded to a FIXED 20 slots by repeating the last KF (real poses,
        # invalid factors): a data-dependent window length compiled a fresh
        # inertial_optimization + ~30 fresh eager-op programs per rung,
        # ~0.4 s EACH, mid-run (JAX_LOG_COMPILES caught it in the r5 bench).
        P_INIT = 20
        fac_valid_host = [self._has_factor_host[b] for b in window[1:]]
        if sum(fac_valid_host) < 3:
            return False
        pad = P_INIT - len(window)
        wvalid_host = [True] * len(window) + [False] * pad
        window = window + [window[-1]] * pad
        window_arr = jnp.asarray(window, jnp.int32)
        fac = imu_mode.window_factors(self.imu_store, window,
                                      has_factor=self._has_factor_host)
        T_wb = self._kf_body_poses(window_arr)
        # Gravity frame. With a RUNNING LIO the ESEKF owns gravity at every
        # stage: its S2 state is continuously corrected by the point-to-
        # plane updates and is strictly more accurate than a re-estimate
        # against fixed visual poses + covariance-floored factors (measured:
        # a free stage-2 re-estimate DEGRADED gravity 0.6 -> 1.7 deg while
        # lowering the floored-factor cost — overfitting). The refinement
        # rungs therefore loosen only the bias/velocity priors here; gravity
        # is re-estimated only when no LIO estimate exists (visual-inertial
        # bootstrap), which is the case the reference's free-gravity ladder
        # actually addresses.
        if self._imu_initialized:
            R_wg0 = inertial_init.gravity_to_rwg(self.gravity_vis)
            fix_gravity = True
        else:
            R_wb = T_wb[:, :3, :3]
            R_wg0 = inertial_init.estimate_gravity_direction(
                R_wb, fac.dV, fac.valid
            )
            fix_gravity = False
        prior_g, prior_a = self.VI_STAGE_PRIORS[min(stage, 2)]
        vel0 = self._seed_velocities(window_arr, T_wb)
        res = inertial_init.inertial_optimization(
            T_wb, fac.dR, fac.dV, fac.dP, fac.JRg, fac.JVg, fac.JVa,
            fac.JPg, fac.JPa, fac.dt, fac.C_inv, fac.bg_lin, fac.ba_lin,
            fac.valid, R_wg0, vel0, prior_g=prior_g, prior_a=prior_a,
            fix_scale=True, fix_gravity=fix_gravity,
        )
        self.gravity_vis = res.R_wg @ jnp.asarray([0.0, 0.0, -9.81])
        # padded (repeated) slots are dropped from the writeback
        w_sc = jnp.where(jnp.asarray(wvalid_host), window_arr,
                         self.cfg.tracking.max_kf)
        self.imu_store = self.imu_store._replace(
            vel=self.imu_store.vel.at[w_sc].set(res.vel, mode="drop"),
            vel_opt=self.imu_store.vel_opt.at[w_sc].set(True, mode="drop"),
            bg=self.imu_store.bg.at[w_sc].set(
                jnp.broadcast_to(res.bg, (len(window), 3)), mode="drop"),
            ba=self.imu_store.ba.at[w_sc].set(
                jnp.broadcast_to(res.ba, (len(window), 3)), mode="drop"),
        )
        if not self._vi_initialized:
            self._vi_init_time = self._last_t
        self._vi_initialized = True
        if stage >= 1:
            # FullInertialBA analog: joint pose/velocity/bias/structure
            # solve over the whole recent-KF window (no BALM edge — the
            # reference's FullInertialBA is visual-inertial only). FIXED
            # 20-slot window: a data-dependent len(window) size would
            # compile a fresh multi-minute LVI-BA variant per rung
            # (NO_KF padding absorbs short windows).
            self._run_lvi_ba(kf_id, n_window=20, use_balm=False,
                             iters=10)
        return True

    def _maybe_refine_imu_init(self, kf_id: int):
        """Advance the staged-initialization ladder (VIBA1 at 5 s, VIBA2 at
        15 s after the first init — LocalMapping::Run:220-243)."""
        if not self._vi_initialized:
            return
        if self._vi_stage >= 2 or self._last_t is None:
            return
        if self._vi_init_time is None:
            # checkpoint restore: restart the ladder clock from now
            self._vi_init_time = self._last_t
            return
        elapsed = self._last_t - self._vi_init_time
        nxt = self._vi_stage + 1
        if elapsed > self.VI_STAGE_TIMES[nxt]:
            # advance the ladder only when the rung actually ran (too-few
            # alive KFs / factors early-outs are retried at later KFs,
            # matching the reference's per-pass retry)
            ran = self._initialize_imu(kf_id, stage=nxt)
            if profiling.DEBUG_VI:
                print(f"[vi] rung {nxt} at kf {kf_id} t={self._last_t:.1f} "
                      f"elapsed={elapsed:.1f}: ran={ran}", flush=True)
            if ran:
                self._vi_stage = nxt

    # ------------------------------------------------------------------
    def _run_lvi_ba(self, kf_id: int, n_window: int | None = None,
                    use_balm: bool = True, iters: int | None = None,
                    max_active: int | None = None):
        """Temporal-window visual-inertial(-LiDAR) BA (LocalLVIBA dispatch,
        LocalMapping.cc:158-173) with write-back of poses/velocities/biases.

        With ``n_window`` spanning the whole early map and ``use_balm=False``
        this doubles as the FullInertialBA analog (Optimizer.cc:394)."""
        n_kf = self.n_kf_host
        P = n_window or self.cfg.tracking.local_window
        n_real = min(P, n_kf, kf_id + 1)
        # NO_KF-pad the window to a FIXED P: a growing window recompiles the
        # ~minute-long LVI-BA program once per size (measured 3.5 s/frame
        # amortized compile in the IMU bench); padded slots carry invalid
        # factors, no observations, and a fixed identity-anchored state
        window = list(range(kf_id - n_real + 1, kf_id + 1))
        pad = P - n_real
        window_arr = jnp.asarray(
            window + [0] * pad, jnp.int32)  # clipped gathers for pads
        wvalid = jnp.asarray([True] * n_real + [False] * pad)
        # consecutive-pair factor validity from the host has-factor mirror
        fac_valid = jnp.asarray(
            [self._has_factor_host[b] for b in window[1:]]
            + [False] * pad)
        use_balm = use_balm and self.lidar_enabled and self.cfg.lidar.w_lba > 0
        n_l = min(self.cfg.lidar.balm_window, P) if use_balm else 0
        lidar_in = self.lidar_store if use_balm else local_mapping.LidarStore(
            jnp.zeros((1, 1, 3), jnp.float32), jnp.zeros((1, 1), bool))
        self.map, self.imu_store = _lvi_kernel(
            self.map, self.imu_store, lidar_in, window_arr, wvalid,
            fac_valid, self.filt.x.bg, self.filt.x.ba, self.cam, self.T_cb,
            self.T_bc, self.T_cl, self.sigma2, self.gravity_vis,
            iters=iters if iters is not None else self.cfg.tracking.ba_iters,
            use_balm=use_balm, n_l=n_l,
            max_active=max_active if max_active is not None
            else self._ba_active_bucket(),
            balm_voxel=float(self.cfg.lidar.balm_voxel),
            balm_max_voxels=self.cfg.lidar.balm_max_voxels,
            balm_min_points=self.cfg.lidar.balm_min_points,
            w_lba=float(self.cfg.lidar.w_lba),
        )
        # (the caller recomposes self.T_cw against the refined KF pose)

    # ------------------------------------------------------------------
    def _try_close_loop(self, kf_id: int):
        """Loop detection + Sim3 verification + pose-graph correction
        (the LoopClosing thread's job, run synchronously per keyframe)."""
        # closure cooldown (LoopClosing::DetectLoop's mLastLoopKFid + 10
        # gate): immediately re-closing from the next keyframes re-solves
        # the graph against an already-corrected chain and accumulates
        # correction noise instead of information
        if kf_id < getattr(self, "_last_loop_kf", -100) + 10:
            return
        if not hasattr(self, "_word_idf"):
            self._word_idf = bow.word_idf(self.voc)
        cands = loop_closing.detect_candidates(
            self.map, kf_id, self.kf_words,
            min_gap=self.cfg.loop_min_gap, n_best=3,
            word_weights=self._word_idf,
        )
        for cand in cands:
            self._rng_key, sub = jax.random.split(self._rng_key)
            # stereo gives metric scale, so the relative transform is
            # verified as SE3 (bFixScale=true for stereo in the reference's
            # Sim3 machinery); mono would pass with_scale=True here
            ok, S, n_inl, _ = loop_closing.verify_candidate(
                self.map, kf_id, cand, sub, with_scale=False,
            )
            if ok:
                self.map = loop_closing.close_loop(self.map, kf_id, cand, S)
                # Post-closure refinement (the loop-closing family's
                # follow-up full BA, Optimizer::BundleAdjustment /
                # Optimizer.cc:62): the pose graph only redistributes the
                # loop error along poses — a joint pose+structure solve over
                # BOTH loop endpoints' neighborhoods welds the re-mapped
                # landmarks to the corrected poses. Windowed to the loop
                # region (the rest of the map was consistent already).
                if getattr(self, "_post_loop_ba", True):
                    self._global_ba(anchor=cand)
                # current pose follows the corrected keyframe
                self.T_cw = self.map.kf_T_cw[kf_id]
                self.velocity = jnp.eye(4)
                self.n_loops_closed = getattr(self, "n_loops_closed", 0) + 1
                self._last_loop_kf = kf_id
                break

    # ------------------------------------------------------------------
    GLOBAL_BA_KFS = 64

    def _global_ba(self, anchor: int, iters: int = 8):
        """Global bundle adjustment after a loop closure (the follow-up
        full BA of the loop-closing family, Optimizer::BundleAdjustment /
        Optimizer.cc:62). The Sim3 pose graph can only DISTRIBUTE the loop
        error smoothly along the chain; the landmarks co-observed across
        the drift boundary are what concentrates the correction where the
        error actually accumulated — that takes a joint pose+structure
        solve over the whole (recent) map. Windowed to the newest
        GLOBAL_BA_KFS alive keyframes (one extra compiled BA variant)."""
        alive = [k for k in range(self.n_kf_host) if self.kf_alive[k]]
        window = alive[-self.GLOBAL_BA_KFS:]
        if len(window) < 3:
            return
        fixed = [(w == anchor) if anchor in window else (w == window[0])
                 for w in window]
        pad = self.GLOBAL_BA_KFS - len(window)
        self.map = local_mapping.run_local_ba(
            self.map, None, window[-1], self.cam, self.sigma2, self.T_cl,
            n_window=self.GLOBAL_BA_KFS, w_lba=0.0, iters=iters,
            n_kf=self.n_kf_host,
            window=window + [mapstate.NO_KF] * pad,
            fixed=fixed + [True] * pad,
            max_active=self._ba_active_bucket(),
        )

    # ------------------------------------------------------------------
    def _store_kf_lidar(self, kf_id, scan, scan_valid):
        """Downsample + planar-select the KF's scan (feature_extraction).

        One fused program (staged or raw-scan variant) instead of the ~8
        dispatches of the preprocess -> downsample -> plane-select ->
        compact chain."""
        staged = getattr(self, "_last_staged_scan", None)
        use_staged = (not self.use_imu and staged is not None
                      and self.cfg.lidar.scan_voxel == self.cfg.lidar.map_voxel)
        if use_staged:
            src, src_valid = staged
        else:
            src, src_valid = jnp.asarray(scan), jnp.asarray(scan_valid)
        self.lidar_store = _kf_lidar_kernel(
            self.lidar_store, self.vmap, jnp.int32(kf_id), src, src_valid,
            self.T_cw, self.T_cl, jnp.float32(self.cfg.lidar.blind),
            jnp.float32(self.cfg.lidar.scan_voxel), lio_cfg=self.lio_cfg,
            staged=use_staged,
        )

    # ------------------------------------------------------------------
    def _create_map_in_atlas(self):
        """Freeze the active map and start a fresh one (Atlas recovery).

        Maps with < atlas_min_kf keyframes are discarded (ResetActiveMap);
        the new map initializes anchored at the current dead-reckoned pose
        on the next frame with enough stereo depth."""
        # finish any deferred mapping on the old map before freezing it
        self.flush_mapping()
        t = self.cfg.tracking
        bundle = atlas_mod.MapBundle(
            map=self.map,
            lidar_store=self.lidar_store,
            kf_words=self.kf_words if self.voc is not None else None,
            imu_store=self.imu_store if self.use_imu else None,
            n_kf=self.n_kf_host,
            map_id=self.map_id,
        )
        self.atlas.freeze_or_discard(bundle, min_kf=t.atlas_min_kf)
        self.map_id = self.atlas.n_created - 1
        self.map = mapstate.create(
            max_kf=t.max_kf, max_feats=self.cfg.orb.n_features,
            max_lm=t.max_lm, max_obs=t.max_obs,
        )
        if self.lidar_enabled:
            self.lidar_store = local_mapping.LidarStore.create(
                t.max_kf, self.cfg.lidar.kf_points
            )
        if self.voc is not None:
            self.kf_words = jnp.full(
                (t.max_kf, self.cfg.orb.n_features), -1, jnp.int32
            )
        if self.use_imu:
            self.imu_store = imu_mode.ImuKfStore.create(t.max_kf)
            self._vi_initialized = False
            self._vi_stage = 0
            self._vi_init_time = None
            self._has_factor_host = [False] * t.max_kf
            self._imu_ring_reset()
            self._frame_prior = None
            self._prev_vi_state = None
        self.n_kf_host = 0
        self.n_lm_host = 0
        self._n_lm_dev = None
        self.kf_alive = [True] * t.max_kf
        self.ref_kf = -1
        self.ref_kf_tracked = 0
        self._pending_mapping = None
        self._covis_fetch = None
        self._ref_kf_tracked_dev = None
        self._cull_fetch = None
        self.frames_since_kf = 0
        self.n_lost = 0
        self.velocity = jnp.eye(4)
        self._last_staged_scan = None
        self._lidar_pending = []
        self.state = TrackingState.NOT_INITIALIZED

    # ------------------------------------------------------------------
    def _record_pose(self, t):
        T_ref = self.map.kf_T_cw[max(self.ref_kf, 0)]
        T_rel = self.T_cw @ lie.se3_inverse(T_ref)  # stays on device
        self.traj.append((float(t), self.map_id, self.ref_kf, T_rel))

    # ------------------------------------------------------------------
    def trajectory_world_from_cam(self) -> np.ndarray:
        """Recompose per-frame poses against (possibly BA-refined) KF poses
        and return world-from-camera [N, 4, 4] (SaveTrajectoryKITTI logic).

        Per-frame poses are stored relative to their reference KF *within
        their sub-map*; each sub-map's (possibly refined) KF pose array is
        fetched once. Frames whose sub-map was discarded fall back to the
        recorded relative pose against identity (dead-reckoned segment)."""
        self.flush_mapping()  # deferred BA refinements land before export
        kf_T_by_map: dict[int, np.ndarray] = {self.map_id: np.asarray(self.map.kf_T_cw)}
        for bundle in self.atlas.frozen:
            kf_T_by_map[bundle.map_id] = np.asarray(bundle.map.kf_T_cw)
        # one batched fetch for all per-frame relative poses (device arrays)
        T_rels = np.asarray(jnp.stack([T_rel for *_, T_rel in self.traj]))
        eye = np.eye(4, dtype=T_rels.dtype)
        out = []
        for (t, mid, ref, _), T_rel in zip(self.traj, T_rels):
            kf_T = kf_T_by_map.get(mid)
            T_ref = kf_T[max(ref, 0)] if (kf_T is not None and ref >= 0) else eye
            out.append(np.linalg.inv(T_rel @ T_ref))
        return np.stack(out)

    def save_trajectory_kitti(self, path: str):
        trajectory.save_kitti(path, self.trajectory_world_from_cam())

    def save_trajectory_tum(self, path: str):
        times = [t for t, *_ in self.traj]
        trajectory.save_tum(path, times, self.trajectory_world_from_cam())
