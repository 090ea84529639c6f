"""Synthetic stereo + LiDAR + IMU sequence generator.

Stands in for KITTI in tests and benchmarks (no dataset ships with this
environment): a plane-rich world decorated with point "texture dots" is
rendered into stereo pairs (dots become corner features ORB can track),
sampled into LiDAR scans, and differentiated into exact IMU measurements
along an analytic trajectory. Ground truth poses come with every frame, so
end-to-end ATE is measurable offline exactly like the reference's
KITTI-devkit evaluation flow.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

GRAVITY = np.array([0.0, 0.0, -9.81])


def so3_exp_np(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


class CameraRig(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    width: int
    height: int

    @property
    def bf(self):
        return self.fx * self.baseline


KITTI_LIKE = CameraRig(fx=718.856, fy=718.856, cx=607.19, cy=185.2,
                       baseline=0.537, width=1241, height=376)
SMALL = CameraRig(fx=320.0, fy=320.0, cx=320.0, cy=120.0,
                  baseline=0.5, width=640, height=240)


class Plane(NamedTuple):
    p0: np.ndarray      # [3] a point on the plane
    n: np.ndarray       # [3] unit normal
    ax_u: np.ndarray    # [3] in-plane axis (texture u)
    ax_v: np.ndarray    # [3] in-plane axis (texture v)
    lim_u: tuple        # (min, max) extent along ax_u
    lim_v: tuple
    seed: int


class World(NamedTuple):
    planes: list        # list[Plane] textured surfaces (render + LiDAR)
    surf: np.ndarray    # [S, 3] LiDAR sample points on the surfaces


def _hash01(ix, iy, seed):
    """Integer lattice hash -> [0, 1) floats, vectorized (value-noise base)."""
    h = (ix.astype(np.uint64) * np.uint64(374761393)
         + iy.astype(np.uint64) * np.uint64(668265263)
         + np.uint64(seed) * np.uint64(1442695040888963))
    h = (h ^ (h >> np.uint64(13))) * np.uint64(1274126177)
    h = h ^ (h >> np.uint64(16))
    return (h & np.uint64(0xFFFFFF)).astype(np.float64) / float(0x1000000)


def _value_noise(u, v, scale, seed):
    """Bilinear value noise at lattice pitch ``scale`` meters."""
    x = u / scale
    y = v / scale
    x0 = np.floor(x); y0 = np.floor(y)
    fx = x - x0; fy = y - y0
    fx = fx * fx * (3 - 2 * fx)   # smoothstep for C1 continuity
    fy = fy * fy * (3 - 2 * fy)
    n00 = _hash01(x0, y0, seed)
    n10 = _hash01(x0 + 1, y0, seed)
    n01 = _hash01(x0, y0 + 1, seed)
    n11 = _hash01(x0 + 1, y0 + 1, seed)
    return (n00 * (1 - fx) * (1 - fy) + n10 * fx * (1 - fy)
            + n01 * (1 - fx) * fy + n11 * fx * fy)


def _texture(u, v, seed):
    """Multi-octave surface texture in [0, 255] — view-consistent because it
    is a pure function of the surface point (this is what makes ORB
    descriptors repeatable across frames, unlike splatted sprites)."""
    t = (0.45 * _value_noise(u, v, 0.9, seed)
         + 0.35 * _value_noise(u, v, 0.35, seed + 1)
         + 0.20 * _value_noise(u, v, 0.13, seed + 2))
    return 25.0 + 215.0 * t


def make_world(rng, extent=60.0, n_dots=None, n_surf=24000) -> World:
    """Street-like scene: road strip + corridor walls + far walls, all as
    textured planes (rendered by ray casting; LiDAR samples the same
    surfaces so camera and LiDAR observe identical geometry)."""
    ex = np.array([1.0, 0, 0]); ey = np.array([0, 1.0, 0]); ez = np.array([0, 0, 1.0])
    planes = [
        # ground
        Plane(np.zeros(3), ez, ex, ey, (-extent, extent + 40), (-extent, extent), 7),
        # corridor walls
        Plane(np.array([0, -8.0, 0]), ey, ex, ez, (-12, extent + 40), (0, 5.0), 11),
        Plane(np.array([0, 8.0, 0]), -ey, ex, ez, (-12, extent + 40), (0, 5.0), 13),
        # far cross walls
        Plane(np.array([extent + 40, 0, 0]), -ex, ey, ez, (-extent, extent), (0, 8.0), 17),
        Plane(np.array([-12.0, 0, 0]), ex, ey, ez, (-extent, extent), (0, 8.0), 19),
    ]
    # LiDAR surf samples on the planes
    pts = []
    per = n_surf // len(planes)
    for p in planes:
        uu = rng.uniform(p.lim_u[0], p.lim_u[1], per)
        vv = rng.uniform(p.lim_v[0], p.lim_v[1], per)
        pts.append(p.p0 + uu[:, None] * p.ax_u + vv[:, None] * p.ax_v)
    return World(planes=planes, surf=np.concatenate(pts).astype(np.float32))


class Trajectory:
    """R(t) = Exp(w t); p(t) = p0 + v t — constant world velocity with
    optional turn rate, exact IMU."""

    def __init__(self, w_body=(0.0, 0.0, 0.04), v_world=(2.0, 0.2, 0.0), z0=1.6):
        self.w = np.asarray(w_body, np.float64)
        self.v = np.asarray(v_world, np.float64)
        self.p0 = np.array([0.0, 0.0, z0])

    def pose(self, t):
        """World-from-body (x forward, y left, z up)."""
        return so3_exp_np(self.w * t), self.p0 + self.v * t

    def imu(self, t):
        R, _ = self.pose(t)
        return self.w.copy(), R.T @ (-GRAVITY)


class CircleTrajectory:
    """Constant yaw rate + body-frame forward speed -> exact circle.

    Closed-form kinematics (exact IMU incl. centripetal specific force);
    used by the loop-closure tests: the platform revisits its start."""

    def __init__(self, omega=0.5, speed=2.0, z0=1.6, y0=None):
        self.w = np.asarray([0.0, 0.0, omega], np.float64)
        self.v_body = np.asarray([speed, 0.0, 0.0], np.float64)
        # default start: circle centered on y=0 (radius below the corridor
        # half-width) — starting at y=0 would graze the wall at y = 2r
        r = speed / max(abs(omega), 1e-9)
        self.p0 = np.array([0.0, -r if y0 is None else y0, z0])

    def pose(self, t):
        R = so3_exp_np(self.w * t)
        om = self.w[2]
        s = self.v_body[0]
        if abs(om) < 1e-9:
            p = self.p0 + np.array([s * t, 0.0, 0.0])
        else:
            p = self.p0 + np.array(
                [s / om * np.sin(om * t), s / om * (1.0 - np.cos(om * t)), 0.0]
            )
        return R, p

    def imu(self, t):
        R, _ = self.pose(t)
        a_w = np.cross(self.w, R @ self.v_body)   # centripetal
        return self.w.copy(), R.T @ (a_w - GRAVITY)


# Camera mounted looking along body +x: camera frame z=forward, x=right, y=down.
R_BC = np.array([
    [0.0, -1.0, 0.0],   # cam x = -body y (right)
    [0.0, 0.0, -1.0],   # cam y = -body z (down)
    [1.0, 0.0, 0.0],    # cam z =  body x (forward)
], np.float64).T  # body-from-camera rotation


def body_from_cam() -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R_BC
    return T


def render_stereo(world: World, cam: CameraRig, T_wb: np.ndarray, rng=None):
    """Ray-cast the textured planes into a rectified stereo pair.

    Exact pinhole geometry per pixel; the texture is attached to the
    surfaces, so feature descriptors repeat across viewpoints (required for
    BoW/relocalization) and stereo disparity is subpixel-exact.
    """
    T_wc = T_wb @ body_from_cam()
    R = T_wc[:3, :3]
    H, W = cam.height, cam.width
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    dirs_c = np.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                       np.ones_like(uu)], axis=-1)          # [H, W, 3]
    dirs_w = dirs_c @ R.T                                    # [H, W, 3]
    imgs = []
    for side in range(2):
        o = T_wc[:3, 3] + R @ np.array([side * cam.baseline, 0.0, 0.0])
        best_t = np.full((H, W), np.inf)
        best = np.full((H, W), -1)
        best_u = np.zeros((H, W))
        best_v = np.zeros((H, W))
        for k, p in enumerate(world.planes):
            denom = dirs_w @ p.n
            denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            t = ((p.p0 - o) @ p.n) / denom
            hit = o + t[..., None] * dirs_w
            pu = (hit - p.p0) @ p.ax_u
            pv = (hit - p.p0) @ p.ax_v
            ok = ((t > 0.3) & (t < best_t)
                  & (pu >= p.lim_u[0]) & (pu <= p.lim_u[1])
                  & (pv >= p.lim_v[0]) & (pv <= p.lim_v[1]))
            best = np.where(ok, k, best)
            best_u = np.where(ok, pu, best_u)
            best_v = np.where(ok, pv, best_v)
            best_t = np.where(ok, t, best_t)
        # texture only the visible surface of each pixel
        img = np.full((H, W), 18.0)
        for k, p in enumerate(world.planes):
            sel = best == k
            img[sel] = _texture(best_u[sel], best_v[sel], p.seed)
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
    return imgs[0], imgs[1]


def lidar_scan(world: World, T_wb: np.ndarray, rng, max_range=60.0,
               n_max=4096, noise=0.015, T_bl: np.ndarray | None = None):
    """Surf points near the sensor, in the LiDAR frame, padded."""
    if T_bl is None:
        T_bl = np.eye(4)
    T_wl = T_wb @ T_bl
    R, t = T_wl[:3, :3], T_wl[:3, 3]
    d = np.linalg.norm(world.surf - t, axis=-1)
    sel = np.nonzero(d < max_range)[0]
    if len(sel) > n_max:
        sel = rng.choice(sel, n_max, replace=False)
    pw = world.surf[sel] + rng.normal(0, noise, (len(sel), 3))
    pl = (pw - t) @ R
    out = np.zeros((n_max, 3), np.float32)
    out[: len(pl)] = pl
    valid = np.zeros(n_max, bool)
    valid[: len(pl)] = True
    return out, valid


def imu_window(traj: Trajectory, t0, t1, rate=100.0, n_max=32,
               noise_g=0.0, noise_a=0.0, rng=None):
    """Padded IMU samples covering (t0, t1]."""
    ts = np.arange(np.ceil(t0 * rate), np.floor(t1 * rate) + 1) / rate
    ts = ts[(ts > t0) & (ts <= t1)]
    gyro = np.zeros((n_max, 3), np.float32)
    acc = np.zeros((n_max, 3), np.float32)
    dts = np.zeros(n_max, np.float32)
    trel = np.full(n_max, np.inf, np.float32)
    prev = t0
    k = 0
    for t in ts[:n_max]:
        g, a = traj.imu(t)
        if rng is not None:
            g = g + rng.normal(0, noise_g, 3)
            a = a + rng.normal(0, noise_a, 3)
        gyro[k], acc[k], dts[k], trel[k] = g, a, t - prev, t - t0
        prev = t
        k += 1
    if k < n_max and prev < t1 - 1e-9:
        g, a = traj.imu(t1)
        gyro[k], acc[k], dts[k], trel[k] = g, a, t1 - prev, t1 - t0
    return gyro, acc, dts, trel


class FrameData(NamedTuple):
    t: float
    img_l: np.ndarray
    img_r: np.ndarray
    scan: np.ndarray
    scan_valid: np.ndarray
    scan_times: np.ndarray
    gyro: np.ndarray
    acc: np.ndarray
    imu_dts: np.ndarray
    imu_trel: np.ndarray
    T_wb_gt: np.ndarray


def generate_sequence(
    n_frames=30, fps=10.0, cam: CameraRig = SMALL, seed=0,
    traj: Trajectory | None = None, world: World | None = None,
    lidar_noise=0.015, n_scan=4096,
):
    """Yield FrameData for a full synthetic run (deterministic per seed)."""
    rng = np.random.default_rng(seed)
    world = world or make_world(rng)
    traj = traj or Trajectory()
    dt = 1.0 / fps
    frames = []
    for i in range(n_frames):
        t = i * dt
        R, p = traj.pose(t)
        T_wb = np.eye(4)
        T_wb[:3, :3] = R
        T_wb[:3, 3] = p
        img_l, img_r = render_stereo(world, cam, T_wb, rng)
        scan, sv = lidar_scan(world, T_wb, rng, noise=lidar_noise, n_max=n_scan)
        gyro, acc, dts, trel = imu_window(traj, max(t - dt, 0.0), t) if i else (
            np.zeros((32, 3), np.float32), np.zeros((32, 3), np.float32),
            np.zeros(32, np.float32), np.full(32, np.inf, np.float32),
        )
        frames.append(FrameData(
            t=t, img_l=img_l, img_r=img_r, scan=scan, scan_valid=sv,
            scan_times=np.full(n_scan, 0.0, np.float32),
            gyro=gyro, acc=acc, imu_dts=dts, imu_trel=trel, T_wb_gt=T_wb,
        ))
    return frames, world, traj


@dataclasses.dataclass(frozen=True)
class Deployment:
    """System and sensor shapes of one synthetic deployment, with the
    generator settings that make its sequence. ``KITTI`` is the
    KITTI-shaped one that ``bench.py`` and ``chip_smoke.py`` run."""

    cam: str = "KITTI_LIKE"          # name of a CameraRig in this module
    n_features: int = 2000
    n_levels: int = 8
    n_scan: int = 1 << 17            # scan pad; KITTI HDL-64E scans ~120k
    scan_decim: int = 4              # loader-side 1-in-k decimation
    n_surf: int = 300_000
    w_body: tuple = (0.0, 0.0, 0.03)
    v_world: tuple = (1.5, 0.1, 0.0)
    map_capacity: int = 1 << 19
    kf_points: int = 2048
    balm_max_voxels: int = 512
    voxel: float = 0.5
    blind: float = 2.0
    max_kf: int = 256
    max_lm: int = 32768
    max_obs: int = 8
    local_window: int = 6
    ba_iters: int = 6


KITTI = Deployment()


def deployment_config(dep: Deployment, imu=False, profile=False):
    """SystemConfig of ``dep`` in stereo+LiDAR mode, or stereo+LiDAR+IMU
    with inertial BA."""
    from ..slam import config as cfg_mod

    cam = globals()[dep.cam]
    cfg = cfg_mod.SystemConfig(
        camera=cfg_mod.CameraConfig(
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            width=cam.width, height=cam.height, baseline=cam.baseline,
            th_depth=35.0 * cam.baseline,
        ),
        orb=cfg_mod.OrbConfig(n_features=dep.n_features,
                              n_levels=dep.n_levels),
        lidar=cfg_mod.LidarConfig(
            enabled=True, map_capacity=dep.map_capacity,
            kf_points=dep.kf_points, balm_max_voxels=dep.balm_max_voxels,
            scan_voxel=dep.voxel, map_voxel=dep.voxel, blind=dep.blind,
            T_cl=np.linalg.inv(body_from_cam()),
        ),
        tracking=cfg_mod.TrackingConfig(
            max_kf=dep.max_kf, max_lm=dep.max_lm, max_obs=dep.max_obs,
            kf_max_interval=5, local_window=dep.local_window,
            ba_iters=dep.ba_iters,
        ),
        profile=profile,
    )
    if imu:
        cfg = dataclasses.replace(
            cfg, use_imu=True, inertial_ba=True,
            imu=cfg_mod.ImuConfig(
                noise_gyro=1e-4, noise_acc=1e-3, gyro_walk=1e-6,
                acc_walk=1e-5, T_bc=body_from_cam()),
        )
    return cfg


def deployment_sequence(dep: Deployment, n_frames: int, seed=0):
    """``n_frames`` FrameData of ``dep``'s world and trajectory."""
    world = make_world(np.random.default_rng(seed), n_surf=dep.n_surf)
    frames, _, _ = generate_sequence(
        n_frames=n_frames, cam=globals()[dep.cam], seed=seed,
        n_scan=dep.n_scan, world=world,
        traj=Trajectory(w_body=dep.w_body, v_world=dep.v_world),
    )
    return frames


def wire_scans(frames, dep: Deployment, quant: float):
    """Scans as the loader ships them, the reference's CPU preprocess
    (preprocess.cpp velodyne_handler): 1-in-k decimation (point_filter_num
    is 2-4 in every reference launch file) and int16 quantization at
    ``quant`` m. Invalid pad slots are zeroed: they land inside the blind
    radius and the device-side preprocess drops them, so no validity mask
    rides the host-to-device copy."""
    out = []
    for fr in frames:
        s = np.where(fr.scan_valid[:, None], fr.scan, 0.0)[::dep.scan_decim]
        out.append(np.clip(np.round(s / quant), -32767, 32767).astype(np.int16))
    return out


def ba_window(rng, cam, n_poses=16, n_landmarks=32768, n_obs=8,
              pose_noise=0.03, lm_noise=0.10):
    """Stereo BA window: ground truth, a perturbed start, observations.

    Poses step 0.5 m along x with small rotations; every landmark is seen
    by ``n_obs`` distinct poses (exact stereo projections). Pose 0 is the
    gauge anchor; the start perturbs the other poses by ~``pose_noise``
    (tangent units) and the landmarks by ``lm_noise`` m.
    Returns (T_gt [P,4,4], X_gt [L,3], T0 [P,4,4], X0 [L,3], obs, fixed [P]).
    """
    import jax.numpy as jnp

    from ..geom import camera as cam_mod, lie
    from ..solver.lm import BAObservations

    Pn, L, K = n_poses, n_landmarks, n_obs
    X = np.stack([
        rng.uniform(-15, 15, L), rng.uniform(-8, 8, L), rng.uniform(10, 50, L)
    ], -1).astype(np.float32)
    xi_gt = np.concatenate([
        np.stack([0.5 * np.arange(Pn), np.zeros(Pn), np.zeros(Pn)], -1),
        rng.uniform(-0.03, 0.03, (Pn, 3))], -1).astype(np.float32)
    T_gt = np.asarray(lie.se3_exp(jnp.asarray(xi_gt)))
    # K distinct poses per landmark (argsort of random keys)
    pose_idx = np.argsort(rng.random((L, Pn)), axis=1)[:, :K].astype(np.int32)
    T_o = T_gt[pose_idx.reshape(-1)]
    Xc = np.einsum("oij,oj->oi", T_o[:, :3, :3],
                   np.repeat(X, K, axis=0)) + T_o[:, :3, 3]
    uv = np.asarray(cam_mod.project_stereo(cam, jnp.asarray(Xc, jnp.float32)))
    obs = BAObservations(
        pose_idx=jnp.asarray(pose_idx), uv=jnp.asarray(uv.reshape(L, K, 3)),
        inv_sigma2=jnp.ones((L, K)), stereo=jnp.ones((L, K), bool),
        valid=jnp.ones((L, K), bool),
    )
    xi0 = (pose_noise * rng.standard_normal((Pn, 6))).astype(np.float32)
    xi0[0] = 0.0
    T0 = jnp.asarray(T_gt) @ lie.se3_exp(jnp.asarray(xi0))
    X0 = jnp.asarray(X + rng.normal(0, lm_noise, X.shape).astype(np.float32))
    fixed = jnp.zeros(Pn, bool).at[0].set(True)
    return T_gt, X, T0, X0, obs, fixed


def plane_scans(rng, T_wl, n_planes=8, pts_per=128, noise=0.01, extent=4.0):
    """[W, n_planes*pts_per, 3] LiDAR-frame points on ``n_planes`` shared
    world planes, one scan per world-from-lidar pose in ``T_wl``."""
    normals = rng.normal(size=(n_planes, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    ds = rng.uniform(2, 12, n_planes)
    scans = []
    for T in np.asarray(T_wl, np.float64):
        pw = []
        for n, d in zip(normals, ds):
            tangents = np.linalg.svd(n[None])[2][1:]
            uv = rng.uniform(-extent, extent, (pts_per, 2))
            pw.append(-d * n + uv @ tangents
                      + rng.normal(0, noise, (pts_per, 3)))
        pw = np.concatenate(pw)
        scans.append((pw - T[:3, 3]) @ T[:3, :3])
    return np.stack(scans).astype(np.float32)


def ate_rmse(T_est: np.ndarray, T_gt: np.ndarray) -> float:
    """Absolute trajectory error after SE3 (Umeyama, no scale) alignment —
    the KITTI-devkit/evo metric the reference is judged by."""
    p_est = T_est[:, :3, 3]
    p_gt = T_gt[:, :3, 3]
    mu_e = p_est.mean(0)
    mu_g = p_gt.mean(0)
    E = (p_est - mu_e).T @ (p_gt - mu_g)
    U, _, Vt = np.linalg.svd(E)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_e
    p_al = p_est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((p_al - p_gt) ** 2, axis=-1))))
