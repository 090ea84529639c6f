"""ESEKF manifold ops, propagation, and the full synthetic LIO loop."""

import numpy as np
import jax.numpy as jnp

from tc2li_slam_tpu.estimation import esekf
from tc2li_slam_tpu.ops import voxel_map, pointcloud
from tc2li_slam_tpu.slam import lio
from tests import synthetic as syn


def test_s2_basis_orthonormal(rng):
    for _ in range(10):
        g = rng.normal(size=3).astype(np.float32) * 9.81
        B = np.asarray(esekf.s2_basis(jnp.asarray(g)))
        np.testing.assert_allclose(B.T @ B, np.eye(2), atol=1e-5)
        np.testing.assert_allclose(B.T @ (g / np.linalg.norm(g)), 0, atol=1e-5)


def test_s2_boxplus_boxminus_roundtrip(rng):
    g = jnp.asarray([0.2, -0.3, -9.79], jnp.float32)
    d = jnp.asarray([0.05, -0.08], jnp.float32)
    g2 = esekf.s2_boxplus(g, d)
    assert abs(float(jnp.linalg.norm(g2)) - float(jnp.linalg.norm(g))) < 1e-4
    d2 = esekf.s2_boxminus(g2, g)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d), atol=1e-4)


def test_state_boxplus_boxminus(rng):
    x = esekf.init_state()
    dx = (rng.normal(size=23) * 0.1).astype(np.float32)
    x2 = esekf.boxplus(x, jnp.asarray(dx))
    back = np.asarray(esekf.boxminus(x2, x))
    np.testing.assert_allclose(back, dx, atol=1e-4)


def test_transport_jacobian_matches_finite_differences(rng):
    """The per-iteration tangent-basis re-projection
    (esekfom.hpp:1663-1700) — transport_jacobian must equal the numeric
    derivative of (x1 ⊞ δ) ⊟ x0 even for LARGE rotation/gravity offsets,
    and reduce to identity blocks on the Euclidean coordinates."""
    x0 = esekf.init_state()
    dx = (rng.normal(size=23) * 0.1).astype(np.float32)
    dx[3:6] = [0.5, -0.4, 0.3]      # large body-rotation offset
    dx[6:9] = [-0.3, 0.2, 0.25]     # large extrinsic-rotation offset
    dx[21:23] = [0.2, -0.15]        # large gravity-tangent offset
    x1 = esekf.boxplus(x0, jnp.asarray(dx))
    L = np.asarray(esekf.transport_jacobian(x1, x0))

    eps = 1e-3
    num = np.zeros((23, 23), np.float64)
    for i in range(23):
        e = np.zeros(23, np.float32)
        e[i] = eps
        p = np.asarray(esekf.boxminus(esekf.boxplus(x1, jnp.asarray(e)), x0))
        m = np.asarray(esekf.boxminus(esekf.boxplus(x1, jnp.asarray(-e)), x0))
        num[:, i] = (p - m) / (2 * eps)
    np.testing.assert_allclose(L, num, atol=2e-3)
    # Euclidean blocks are exactly identity; the SO(3) block is NOT (that
    # is the whole point of the re-projection at a 0.7 rad offset)
    for sl in (esekf.POS, esekf.EXT_T, esekf.VEL, esekf.BG, esekf.BA):
        np.testing.assert_allclose(L[sl, sl], np.eye(3), atol=1e-5)
    rot = L[esekf.ROT, esekf.ROT]
    assert np.abs(rot - np.eye(3)).max() > 0.05


def test_update_iterated_f32_tracks_f64_oracle(rng):
    """Bound the f32 filter against a float64 oracle (same code, x64) over
    a long aggressive propagation+update sequence: with the exact tangent
    transport the two must agree to f32 roundoff levels, both in state and
    in the posterior covariance."""
    import jax

    def run(dtype):
        f = esekf.Filter(
            jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a), dtype),
                esekf.init_state()),
            jnp.asarray(np.eye(esekf.ERR_DIM) * 1e-2, dtype),
        )
        noise = esekf.NoiseCfg(*[jnp.asarray(v, dtype)
                                 for v in (0.01, 0.01, 1e-5, 1e-5)])
        rloc = np.random.default_rng(3)
        N = 8
        pos_true = np.zeros(3)
        for step in range(30):
            # aggressive motion: 1.2 rad/s tumble + 3 m/s^2 specific force
            gyro = np.tile([1.2, -0.8, 0.9], (N, 1)) + rloc.normal(0, 1e-3, (N, 3))
            R_now = np.asarray(f.x.R, np.float64)
            acc = (R_now.T @ np.array([1.5, -2.0, 9.81 + 1.0]))[None, :] \
                + rloc.normal(0, 1e-3, (N, 3))
            dts = np.full(N, 0.01)
            f, _, _ = esekf.predict(
                f, jnp.asarray(gyro, dtype), jnp.asarray(acc, dtype),
                jnp.asarray(dts, dtype), noise)
            # pos+rot pseudo-measurements with a deliberate offset so every
            # update makes a LARGE correction (transport matters)
            pos_meas = np.asarray(f.x.pos, np.float64) + rloc.normal(0, 0.05, 3)
            dR = np.asarray(
                esekf.lie.so3_exp(jnp.asarray(rloc.normal(0, 0.08, 3), dtype)))
            R_meas = np.asarray(f.x.R, np.float64) @ dR

            def h_fn(x, pm=pos_meas, Rm=R_meas):
                z = jnp.concatenate([
                    x.pos - jnp.asarray(pm, dtype),
                    esekf.lie.so3_log(jnp.asarray(Rm, dtype).T @ x.R),
                ])
                H = jnp.zeros((6, esekf.ERR_DIM), dtype)
                H = H.at[0:3, esekf.POS].set(jnp.eye(3, dtype=dtype))
                H = H.at[3:6, esekf.ROT].set(jnp.eye(3, dtype=dtype))
                return z, H, jnp.ones(6, bool)
            f, _ = esekf.update_iterated(f, h_fn, jnp.asarray(1e-3, dtype),
                                         max_iters=3)
        return (np.asarray(f.x.pos, np.float64),
                np.asarray(f.x.R, np.float64),
                np.asarray(f.P, np.float64))

    p32, R32, P32 = run(jnp.float32)
    import jax as _jax
    _jax.config.update("jax_enable_x64", True)
    try:
        p64, R64, P64 = run(jnp.float64)
    finally:
        _jax.config.update("jax_enable_x64", False)
    assert np.linalg.norm(p32 - p64) < 2e-2, np.linalg.norm(p32 - p64)
    dang = np.degrees(np.arccos(np.clip(
        (np.trace(R32.T @ R64) - 1) / 2, -1, 1)))
    assert dang < 0.5, f"rotation divergence {dang:.3f} deg"
    relP = np.linalg.norm(P32 - P64) / np.linalg.norm(P64)
    assert relP < 0.05, f"covariance divergence {relP:.3f}"


def test_predict_stationary():
    f = esekf.init_filter()
    N = 20
    gyro = jnp.zeros((N, 3))
    acc = jnp.tile(jnp.asarray([0.0, 0.0, 9.81]), (N, 1))
    dts = jnp.full((N,), 0.01)
    noise = esekf.NoiseCfg.create()
    f2, R_traj, p_traj = esekf.predict(f, gyro, acc, dts, noise)
    np.testing.assert_allclose(np.asarray(f2.x.pos), 0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(f2.x.vel), 0, atol=1e-3)
    # covariance grows
    assert float(jnp.trace(f2.P)) > float(jnp.trace(f.P))


def test_predict_constant_velocity():
    f = esekf.init_filter()
    f = f._replace(x=f.x._replace(vel=jnp.asarray([2.0, 0.0, 0.0])))
    N = 50
    gyro = jnp.zeros((N, 3))
    acc = jnp.tile(jnp.asarray([0.0, 0.0, 9.81]), (N, 1))
    dts = jnp.full((N,), 0.01)
    f2, _, _ = esekf.predict(f, gyro, acc, dts, esekf.NoiseCfg.create())
    np.testing.assert_allclose(np.asarray(f2.x.pos), [1.0, 0, 0], atol=1e-3)


def test_static_init(rng):
    f = esekf.init_filter()
    N = 50
    # gravity tilted: accelerometer reads -R^T g with R = I tilted world
    acc = np.tile([0.5, 0.0, 9.79], (N, 1)) + rng.normal(0, 0.01, (N, 3))
    gyro = np.tile([0.01, -0.02, 0.005], (N, 1)) + rng.normal(0, 0.001, (N, 3))
    f2 = esekf.static_init(
        f, jnp.asarray(gyro, jnp.float32), jnp.asarray(acc, jnp.float32),
        jnp.ones(N, bool),
    )
    g = np.asarray(f2.x.grav)
    np.testing.assert_allclose(np.linalg.norm(g), 9.81, atol=1e-3)
    np.testing.assert_allclose(
        g / np.linalg.norm(g), -np.array([0.5, 0.0, 9.79]) / np.linalg.norm([0.5, 0.0, 9.79]),
        atol=2e-3,
    )
    np.testing.assert_allclose(np.asarray(f2.x.bg), gyro.mean(0), atol=1e-4)


def _run_lio(n_scans=12, noise=0.01, drop_extrinsic=True):
    rng = np.random.default_rng(3)
    world = syn.make_world(rng, n_ground=12000, n_wall=4000, extent=50.0)
    traj = syn.Trajectory(w_body=(0.0, 0.0, 0.08), v_world=(2.0, 0.3, 0.0))
    cfg = lio.LioConfig(blind=0.5, scan_voxel=0.4, map_voxel=0.4)
    noise_cfg = esekf.NoiseCfg.create(gyr=1e-3, acc=1e-2, bg_rw=1e-5, ba_rw=1e-4)

    f = esekf.init_filter()
    R0, p0 = traj.pose(0.0)
    f = f._replace(x=f.x._replace(
        R=jnp.asarray(R0, jnp.float32),
        pos=jnp.asarray(p0, jnp.float32),
        vel=jnp.asarray(traj.v, jnp.float32),
    ))
    m = voxel_map.create(1 << 17, cfg.map_voxel)

    # bootstrap map with scan 0 at ground-truth pose
    scan, valid = syn.make_scan(rng, world, R0, p0, noise=noise)
    pw = scan @ np.asarray(R0, np.float32).T + p0.astype(np.float32)
    ds, dsv = pointcloud.voxel_downsample(jnp.asarray(pw), jnp.asarray(valid), cfg.map_voxel)
    m = voxel_map.insert(m, ds, dsv)

    dt_scan = 0.1
    errs = []
    for k in range(1, n_scans + 1):
        t0, t1 = (k - 1) * dt_scan, k * dt_scan
        R_gt, p_gt = traj.pose(t1)
        scan, valid = syn.make_scan(rng, world, R_gt, p_gt, noise=noise)
        gyro, acc, dts, trel = syn.imu_window(traj, t0, t1, n_max=16)
        res = lio.lio_scan_step(
            f, m, jnp.asarray(scan),
            jnp.full(scan.shape[0], dt_scan, jnp.float32), jnp.asarray(valid),
            jnp.asarray(gyro), jnp.asarray(acc), jnp.asarray(dts), jnp.asarray(trel),
            noise_cfg, cfg,
        )
        f, m = res.filt, res.map
        errs.append(np.linalg.norm(np.asarray(f.x.pos) - p_gt))
    return np.array(errs)


def test_lio_synthetic_tracks_trajectory():
    errs = _run_lio()
    # Perfect IMU + planar world: drift should stay near the map noise level.
    assert errs[-1] < 0.15, f"final position error {errs[-1]:.3f} m"
    assert np.median(errs) < 0.12, f"median error {np.median(errs):.3f} m"
