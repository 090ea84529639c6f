"""LiDAR-inertial odometry: the per-scan FAST-LIO2 pipeline step.

Device-side equivalent of ``LidarInertialProcess`` (``LidarFrontEnd.cpp:615-780``)
— one functional per-scan step instead of a free-running thread with guarded
globals:

    predict (IMU scan window) -> undistort -> voxel downsample ->
    iterated ESEKF point-to-plane update against the voxel map ->
    map insert (+ recenter when near the grid edge)

The measurement model matches ``h_share_model`` (``LidarFrontEnd.cpp:485-602``):
per point, 5-NN in the map, plane fit with 0.1 threshold, weight gate
``s = 1 - 0.9|pd|/sqrt(|p|)`` kept when > 0.9, residual ``-pd``, H columns for
position, rotation and (optionally) the LiDAR-IMU extrinsic.

Also provides the camera-pose-driven variant used in STEREO_LIDAR mode
(``LidarCameraProcess`` / ``feature_extraction``, ``LidarFrontEnd.cpp:801-1073``):
no EKF — just select planar inlier points given an externally supplied pose.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..estimation import esekf, undistort as undist
from ..geom import lie
from ..ops import plane_fit, pointcloud, voxel_map


class LioConfig(NamedTuple):
    scan_voxel: float = 0.5          # filter_size_surf
    map_voxel: float = 0.5           # filter_size_map
    plane_thresh: float = 0.1        # esti_plane threshold
    meas_cov: float = 0.001          # LASER_POINT_COV
    max_iters: int = 4               # NUM_MAX_ITERATIONS
    det_range: float = 100.0
    blind: float = 4.0
    estimate_extrinsic: bool = False
    work_cap: int = 1 << 15          # downsampled-point budget per scan


def make_h_fn(m: voxel_map.VoxelMap, points_l: jax.Array, valid: jax.Array,
              cfg: LioConfig):
    """Build the measurement closure for the iterated update.

    ``points_l`` [M, 3] are undistorted, downsampled points in the LiDAR
    frame at scan end. Re-evaluated at each GN iterate with the *current*
    state (fresh kNN + plane fit, exactly like ``h_share_model``).
    """

    def h_fn(x: esekf.State):
        p_b = points_l @ x.R_LI.T + x.t_LI          # body frame
        p_w = p_b @ x.R.T + x.pos                   # world frame
        dists, nbrs, nb_valid = voxel_map.knn(m, p_w, k=5, radius=2)
        normals, d, plane_ok = plane_fit.fit_planes(nbrs, nb_valid, cfg.plane_thresh)
        pd = plane_fit.point_to_plane(p_w, normals, d)
        # FAST-LIO inlier gate: s = 1 - 0.9 |pd| / sqrt(|p_l|)
        norm_p = jnp.linalg.norm(points_l, axis=-1)
        s = 1.0 - 0.9 * jnp.abs(pd) / jnp.sqrt(jnp.maximum(norm_p, 1e-6))
        ok = valid & plane_ok & (s > 0.9) & (dists[:, 0] < 5.0)

        M = points_l.shape[0]
        H = jnp.zeros((M, esekf.ERR_DIM), points_l.dtype)
        H = H.at[:, esekf.POS].set(normals)
        # d pd / d rot (right perturbation on R): n^T d(R Exp(δ) p_b)/dδ
        Rn = normals @ x.R  # = R^T n  (row convention)
        H = H.at[:, esekf.ROT].set(jnp.cross(p_b, Rn))
        if cfg.estimate_extrinsic:
            # d p_b/d ext_rot chains through R: rows in the lidar frame.
            RLn = Rn @ x.R_LI
            H = H.at[:, esekf.EXT_R].set(jnp.cross(points_l, RLn))
            H = H.at[:, esekf.EXT_T].set(Rn)
        # Hard-zero masked rows so no non-finite value can leak through 0*x.
        okf = ok[:, None]
        z = jnp.where(ok, pd, 0.0)
        z = jnp.where(jnp.isfinite(z), z, 0.0)
        H = jnp.where(okf & jnp.isfinite(H), H, 0.0)
        ok &= jnp.all(jnp.isfinite(H), axis=-1)
        return z, H, ok

    return h_fn


class ScanResult(NamedTuple):
    filt: esekf.Filter
    map: voxel_map.VoxelMap
    points_world: jax.Array   # [M, 3] downsampled scan in world frame
    points_valid: jax.Array   # [M]
    n_iters: jax.Array
    n_effective: jax.Array    # matched planar inliers at the final state
    bad: jax.Array            # scalar bool: diverged / non-finite state


@partial(jax.jit, static_argnames=("cfg", "map_insert"))
def lio_scan_step(
    filt: esekf.Filter,
    m: voxel_map.VoxelMap,
    scan_l: jax.Array,     # [Mraw, 3] raw scan, LiDAR frame (padded)
    t_points: jax.Array,   # [Mraw] per-point relative times
    scan_valid: jax.Array, # [Mraw]
    gyro: jax.Array,       # [N, 3] IMU window covering the scan (padded)
    acc: jax.Array,        # [N, 3]
    dts: jax.Array,        # [N]
    t_samples: jax.Array,  # [N] sample times within scan (+inf pad)
    noise: esekf.NoiseCfg,
    cfg: LioConfig,
    map_insert: bool = True,
) -> ScanResult:
    """One full FAST-LIO2 scan iteration (LidarFrontEnd.cpp:681-775).

    The bad-IMU guard (mbBadImu, LocalMapping.cc:144-154) runs ON DEVICE:
    a non-finite or diverged (>60 m/s) post-update state reverts the filter
    to its pre-scan value and suppresses the map insert, and the ``bad``
    flag rides back to the host asynchronously — no per-frame blocking
    ``isfinite``/norm fetches."""
    filt0 = filt
    # 1. propagate through the scan's IMU samples
    filt, R_traj, p_traj = esekf.predict(filt, gyro, acc, dts, noise)

    # 2. motion-compensate points to scan end
    pts_end = undist.undistort(
        scan_l, t_points, t_samples, R_traj, p_traj, filt.x.R_LI, filt.x.t_LI
    )

    # 3. preprocess + voxel downsample in lidar frame; the downsample
    # compacts valid voxels to the front (KEY order = spatial order), so the
    # work_cap subset must be STRIDED over the whole valid range — a prefix
    # truncation keeps one spatial REGION of the scan and the biased
    # geometry eventually diverges the update (reproduced at bench frame 66:
    # velocity 2 -> 17 m/s in one update). Strided indices cover the full
    # scan at any cap; <= cap valid voxels reduce to the identity.
    keep = pointcloud.preprocess(pts_end, t_points, scan_valid, blind=cfg.blind)
    pts_ds, ds_valid = pointcloud.voxel_downsample(pts_end, keep, cfg.scan_voxel)
    if pts_ds.shape[0] > cfg.work_cap:
        n = jnp.sum(ds_valid)
        step = jnp.maximum(n, cfg.work_cap).astype(jnp.float32) / cfg.work_cap
        pos = (jnp.arange(cfg.work_cap).astype(jnp.float32) * step)
        idx = jnp.minimum(pos.astype(jnp.int32), pts_ds.shape[0] - 1)
        pts_ds = pts_ds[idx]
        ds_valid = idx < n

    # 4. iterated point-to-plane update
    h_fn = make_h_fn(m, pts_ds, ds_valid, cfg)
    filt, n_iters = esekf.update_iterated(
        filt, h_fn, jnp.float32(cfg.meas_cov), max_iters=cfg.max_iters
    )

    # 5. divergence guard: revert to the pre-scan filter on a bad state
    stx = filt.x
    bad = (
        ~jnp.all(jnp.isfinite(jnp.concatenate(
            [stx.pos, stx.vel, stx.bg, stx.ba, stx.grav,
             stx.R.ravel(), filt.P.ravel()]
        )))
        | (jnp.sum(stx.vel * stx.vel) > 60.0 ** 2)
    )
    filt = jax.tree_util.tree_map(
        lambda a, b: jnp.where(bad, a, b), filt0, filt)

    # 6. map insert at the converged pose
    p_b = pts_ds @ filt.x.R_LI.T + filt.x.t_LI
    p_w = p_b @ filt.x.R.T + filt.x.pos
    _, _, ok = h_fn(filt.x)
    n_eff = jnp.sum(ok)
    if map_insert:
        m = voxel_map.insert(m, p_w, ds_valid & ~bad)
    return ScanResult(filt, m, p_w, ds_valid, n_iters, n_eff, bad)


@partial(jax.jit, static_argnames=("margin",))
def maybe_recenter(m: voxel_map.VoxelMap, pos: jax.Array, margin: float = 150.0):
    """Recenter the grid when the pose nears the edge
    (``lasermap_fov_segment`` semantics). Returns (map, did_recenter).

    Device-side ``lax.cond`` — a host-side ``if bool(...)`` here would force
    a device->host sync every frame.
    """
    need = voxel_map.needs_recenter(m, pos, margin)
    m2 = jax.lax.cond(
        need, lambda mm: voxel_map.recenter(mm, pos), lambda mm: mm, m
    )
    return m2, need


@partial(jax.jit, static_argnames=("insert_cap",))
def camera_scan_stage(
    scan: jax.Array,        # [N, 3] raw scan, LiDAR frame (padded)
    scan_valid: jax.Array,  # [N]
    T_cw: jax.Array,        # [4, 4] tracked camera pose
    T_cl: jax.Array,        # [4, 4] camera-from-lidar extrinsic
    blind,
    map_voxel,
    insert_cap: int = 1 << 15,
) -> tuple[jax.Array, jax.Array]:
    """Per-frame half of the map maintenance: preprocess -> downsample ->
    world transform. Returns (points_w [cap, 3], valid [cap]) for a later
    batched ``camera_map_flush``.

    The (N_pool + B)-sized sort inside ``voxel_map.insert`` costs ~37 ms at
    512k pool on the chip and its cost is dominated by the POOL size, so
    running it per frame wastes ~3/4 of it on re-sorting unchanged keys;
    staging frames and flushing every few frames amortizes the sort with no
    loss (the reference's ikd-tree likewise defers restructuring work to its
    background rebalance thread, ikd_Tree.h:260-263)."""
    keep = pointcloud.preprocess(
        scan, jnp.zeros(scan.shape[0], scan.dtype), scan_valid, blind=blind)
    ds, dsv = pointcloud.voxel_downsample(scan, keep, map_voxel)
    ds, dsv = ds[:insert_cap], dsv[:insert_cap]
    T_wl = lie.se3_inverse(T_cw) @ T_cl
    return lie.se3_apply(T_wl, ds), dsv


@jax.jit
def camera_map_flush(
    m: voxel_map.VoxelMap,
    pts_w: jax.Array,     # [B, 3] staged world points (concatenated frames)
    valid: jax.Array,     # [B]
    center: jax.Array,    # [3] current sensor position (recenter trigger)
) -> voxel_map.VoxelMap:
    """Batched insert + recenter for staged scan points."""
    m = voxel_map.insert(m, pts_w, valid)
    m, _ = maybe_recenter(m, center)
    return m


@partial(jax.jit, static_argnames=("insert_cap",))
def camera_map_update(
    m: voxel_map.VoxelMap,
    scan: jax.Array,        # [N, 3] raw scan, LiDAR frame (padded)
    scan_valid: jax.Array,  # [N]
    T_cw: jax.Array,        # [4, 4] tracked camera pose
    T_cl: jax.Array,        # [4, 4] camera-from-lidar extrinsic
    blind,
    map_voxel,
    insert_cap: int = 1 << 15,
) -> voxel_map.VoxelMap:
    """STEREO_LIDAR per-frame map maintenance as ONE device program:
    preprocess -> voxel downsample -> world transform -> insert -> recenter
    (UpdateMap -> map_incremental, Tracking.cc:1603 / LidarFrontEnd.cpp:1075).

    Folding the chain into one jit saves ~4 program launches and lets the
    caller dispatch it against the un-synced tracked pose so it overlaps
    the frame's host fetch."""
    keep = pointcloud.preprocess(
        scan, jnp.zeros(scan.shape[0], scan.dtype), scan_valid, blind=blind)
    ds, dsv = pointcloud.voxel_downsample(scan, keep, map_voxel)
    ds, dsv = ds[:insert_cap], dsv[:insert_cap]
    T_wl = lie.se3_inverse(T_cw) @ T_cl
    p_w = lie.se3_apply(T_wl, ds)
    m = voxel_map.insert(m, p_w, dsv)
    m, _ = maybe_recenter(m, lie.translation(T_wl))
    return m


# ---------------------------------------------------------------------------
# Camera-pose-driven mode (STEREO_LIDAR): plane-feature selection, no EKF
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def select_plane_features(
    m: voxel_map.VoxelMap,
    points_l: jax.Array,  # [M, 3] scan in LiDAR frame (downsampled)
    valid: jax.Array,     # [M]
    T_wl: jax.Array,      # [4, 4] world-from-lidar pose (from camera track)
    cfg: LioConfig,
) -> jax.Array:
    """Planar-inlier mask, as in ``feature_extraction`` (LidarFrontEnd.cpp:999).

    Used by the visual pipeline to pick the LiDAR points that participate in
    the BALM local-BA residual for a keyframe.
    """
    p_w = lie.se3_apply(T_wl, points_l)
    dists, nbrs, nb_valid = voxel_map.knn(m, p_w, k=5, radius=1)
    normals, d, plane_ok = plane_fit.fit_planes(nbrs, nb_valid, cfg.plane_thresh)
    pd = plane_fit.point_to_plane(p_w, normals, d)
    norm_p = jnp.linalg.norm(points_l, axis=-1)
    s = 1.0 - 0.9 * jnp.abs(pd) / jnp.sqrt(jnp.maximum(norm_p, 1e-6))
    return valid & plane_ok & (s > 0.9)
