#!/usr/bin/env python3
"""Smoke run of the SLAM main path on NVIDIA GPUs.

    python chip_smoke.py               # one card: pipeline, kernels, gpu-tests
    python chip_smoke.py --devices 4   # four cards: sharded BA and System(mesh)

Everything runs in this one process. Without a GPU the script exits
non-zero and prints no result. A passing run ends with the line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
every phase failure propagates. The times printed on the way are smoke
readings of one run, not benchmark numbers.

Phases on one card:

- ``pipeline``: a seeded KITTI-shaped synthetic sequence (1241x376 uint8
  stereo, 2000 ORB features on 8 levels, 131,072-point scans decimated
  1-in-4 on the loader, 100 Hz IMU) through ``System.track``, first in
  stereo+LiDAR mode, then in stereo+LiDAR+IMU mode; ATE against the
  generator's ground truth.
- ``kernels``: each device op of that path at its real width against a
  plain reference (numpy, or the same call on the CPU device), and its
  median time alone and inside its jitted caller.
- ``gpu-tests``: the tests marked ``gpu``.

With ``--devices 4`` only the multi-card path runs: the sharded BA on a
4-card mesh against one card, and ``System(mesh=...)`` against
``System()`` on the stereo+LiDAR sequence.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Size:
    """Shapes of one smoke run: the deployment (``synthetic.KITTI`` with
    the ``deploy`` overrides) and the smoke's own sizes and bounds. ``FULL``
    is the KITTI-shaped deployment of ``bench.py``; ``TINY`` exercises the
    same code on the CPU in tests."""

    deploy: tuple = ()      # (field, value) overrides of synthetic.KITTI
    frames: int = 40
    warm: int = 10          # stereo+LiDAR warm-up frames
    imu_warm: int = 25      # IMU mode: the VI bootstrap fires inside these
    min_kf: int = 3
    ate_lidar: float = 0.15
    ate_imu: float = 0.10
    ham_rows: int = 32768
    ba_landmarks: int = 4096
    ba_poses: int = 8
    ba_obs: int = 8
    knn_queries: int = 8192
    dist_landmarks: int = 32768
    dist_poses: int = 16
    reps: int = 20

    @property
    def dep(self):
        from tc2li_slam_tpu.io import synthetic as syn

        return dataclasses.replace(syn.KITTI, **dict(self.deploy))


FULL = Size()
TINY = Size(
    deploy=(("cam", "SMALL"), ("n_features", 512), ("n_levels", 4),
            ("n_scan", 2048), ("scan_decim", 1), ("n_surf", 24_000),
            ("map_capacity", 1 << 16), ("kf_points", 512),
            ("balm_max_voxels", 256), ("voxel", 0.4), ("blind", 1.0),
            ("max_kf", 64), ("max_lm", 8192)),
    frames=18, warm=6, imu_warm=12, ham_rows=512, ba_landmarks=256,
    ba_poses=4, ba_obs=4, knn_queries=256, dist_landmarks=512, dist_poses=8,
    reps=2,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """A smoke check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def median_ms(fn, reps: int) -> float:
    """Median wall time of ``fn()`` to ``block_until_ready``, after two
    warm-up calls (the first compiles)."""
    import jax

    for _ in range(2):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def make_sequence(size: Size, seed: int = 0):
    """Seeded synthetic sequence, its scans in the loader's wire format,
    and the ground-truth world-from-camera poses."""
    from tc2li_slam_tpu.io import synthetic as syn

    dep = size.dep
    frames = syn.deployment_sequence(dep, size.frames, seed)
    quant = syn.deployment_config(dep).lidar.scan_quant
    gt = np.stack([fr.T_wb_gt @ syn.body_from_cam() for fr in frames])
    return frames, syn.wire_scans(frames, dep, quant), gt


def run_mode(size: Size, seq, imu: bool = False, mesh=None) -> dict:
    """Track the whole sequence through ``System.track``; returns readings
    and the System itself (``"slam"``)."""
    import jax

    from tc2li_slam_tpu.io import synthetic as syn
    from tc2li_slam_tpu.slam import evaluate, system as sys_mod

    frames, scans, gt = seq
    slam = sys_mod.System(syn.deployment_config(size.dep, imu), mesh=mesh)
    n_warm = size.imu_warm if imu else size.warm

    def track(i):
        fr = frames[i]
        if imu:
            slam.track(fr.img_l, fr.img_r, fr.t, scans[i], None,
                       gyro=fr.gyro, acc=fr.acc, imu_dts=fr.imu_dts,
                       imu_trel=fr.imu_trel,
                       scan_times=fr.scan_times[::size.dep.scan_decim])
        else:
            slam.track(fr.img_l, fr.img_r, fr.t, scans[i], None)
        return jax.block_until_ready(slam.T_cw)

    t0 = time.perf_counter()
    for i in range(n_warm):
        track(i)
    slam.prewarm()
    jax.block_until_ready(slam.T_cw)
    setup_s = time.perf_counter() - t0
    frame_ms = []
    t0 = time.perf_counter()
    for i in range(n_warm, len(frames)):
        tf = time.perf_counter()
        track(i)
        frame_ms.append((time.perf_counter() - tf) * 1e3)
    wall = time.perf_counter() - t0
    est = slam.trajectory_world_from_cam()
    return {
        "slam": slam,
        "setup_s": setup_s,
        "frames": len(frame_ms),
        "fps": len(frame_ms) / wall if frame_ms else None,
        "p50_ms": float(np.percentile(frame_ms, 50)) if frame_ms else None,
        "p90_ms": float(np.percentile(frame_ms, 90)) if frame_ms else None,
        "ate_m": evaluate.ate_rmse(est, gt),
        "finite": bool(np.isfinite(est).all()),
        "state_ok": slam.state == sys_mod.TrackingState.OK,
        "n_kf": int(slam.map.n_kf),
        "vi_initialized": bool(getattr(slam, "_vi_initialized", False)),
    }


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_pipeline(size: Size) -> dict:
    """Both modes on one sequence. Returns the stereo+LiDAR System and the
    sequence for the kernels phase."""
    t0 = time.perf_counter()
    seq = make_sequence(size)
    log(f"pipeline: sequence of {size.frames} frames made in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    out = {"seq": seq}
    for imu in (False, True):
        name = "stereo+LiDAR+IMU" if imu else "stereo+LiDAR"
        r = run_mode(size, seq, imu=imu)
        slam = r.pop("slam")
        r["peak_bytes_in_use"] = peak_bytes()
        log(f"pipeline [{name}] smoke readings (not benchmark numbers): "
            + json.dumps({k: v for k, v in r.items()}))
        check(r["finite"], f"{name}: non-finite poses")
        check(r["state_ok"], f"{name}: tracking state is {slam.state}")
        check(r["n_kf"] >= size.min_kf, f"{name}: only {r['n_kf']} keyframes")
        bound = size.ate_imu if imu else size.ate_lidar
        check(r["ate_m"] < bound, f"{name}: ATE {r['ate_m']:.4f} m >= {bound}")
        if imu:
            check(r["vi_initialized"], f"{name}: VI bootstrap never fired")
            del slam
        else:
            out["slam"] = slam
        out[name] = r
        gc.collect()
    return out


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def check_fast(img, size: Size) -> dict:
    """XLA FAST score on every pyramid level against the numpy segment
    test, exactly."""
    import jax
    import jax.numpy as jnp

    from tc2li_slam_tpu.ops import orb, reference

    levels = jax.jit(lambda im: orb.pyramid_levels(
        im.astype(jnp.float32), size.dep.n_levels, 1.2))(img)
    score_all = jax.jit(lambda lv: [orb.fast_score_raw(x) for x in lv])
    for li, (lv, sc) in enumerate(zip(levels, score_all(levels))):
        ref = reference.fast_score(np.asarray(lv))
        got = np.asarray(sc)
        check(got.shape == ref.shape, (li, got.shape, ref.shape))
        np.testing.assert_array_equal(got, ref, err_msg=f"FAST level {li}")
    return {"fast_all_levels_ms": median_ms(lambda: score_all(levels), size.reps)}


def check_hamming(size: Size, seed: int = 1) -> dict:
    """Hamming matrix [ham_rows, 8] x [n_features, 8] against numpy
    popcount, exactly; all-zero and all-one rows included."""
    import jax

    from tc2li_slam_tpu.ops import matching, reference

    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 1 << 32, (size.ham_rows, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.integers(0, 1 << 32, (size.dep.n_features, 8), dtype=np.uint64).astype(np.uint32)
    d1[0] = 0
    d1[1] = 0xFFFFFFFF
    d2[0] = 0xFFFFFFFF
    d2[1] = 0
    fn = jax.jit(matching.hamming_matrix)
    a, b = jax.device_put(d1), jax.device_put(d2)
    got = np.asarray(fn(a, b))
    np.testing.assert_array_equal(got, reference.hamming_matrix(d1, d2))
    check(got[0, 0] == 256 and got[1, 0] == 0, "Hamming extremes")
    return {"hamming_ms": median_ms(lambda: fn(a, b), size.reps)}


def check_rbrief(img, size: Size) -> dict:
    """``orb.extract``'s descriptors for the image's keypoints against
    numpy from the uint8 image: its float64 pyramid, blur and steered
    tests. Each device stage is held to its numpy counterpart: the pyramid
    within the float32 sample-grid error, the blur of the device's levels
    within float32 rounding, every steered test whose taps lie away from a
    rounding boundary bit for bit."""
    import jax
    import jax.numpy as jnp

    from tc2li_slam_tpu.ops import orb, reference

    dep = size.dep
    pad, R = orb.STACK_PAD, orb._PATTERN_RADIUS
    kp = orb.extract(img, n_features=dep.n_features, n_levels=dep.n_levels)
    levels = jax.jit(lambda im: orb.pyramid_levels(
        im.astype(jnp.float32), dep.n_levels, 1.2))(img)
    _, blur = jax.jit(lambda lv: orb.level_stacks(lv, pad))(levels)
    levels = [np.asarray(x) for x in levels]

    ref_levels = reference.pyramid(np.asarray(img), dep.n_levels, 1.2)
    level_dev = max(float(np.abs(a - b).max())
                    for a, b in zip(levels, ref_levels))
    check(level_dev < 0.05, f"pyramid off numpy by {level_dev}")
    ref_blur = reference.blur_stack(levels, pad)
    blur_dev = float(np.abs(np.asarray(blur) - ref_blur).max())
    check(blur_dev < 1e-3, f"blur off numpy by {blur_dev}")

    lvl = np.asarray(kp.level)
    rows = np.asarray(kp.xy_level[:, 1]).astype(np.int32)
    cols = np.asarray(kp.xy_level[:, 0]).astype(np.int32)
    r64, c64, steer_tie = reference.steer_taps(np.asarray(kp.angle))
    want, round_tie = reference.brief_bits(ref_blur, lvl, rows, cols, r64,
                                           c64, pad, R, tol=1e-3)
    tie = round_tie | steer_tie[:, :256] | steer_tie[:, 256:]
    off = reference.unpack_words(np.asarray(kp.desc)) != want
    check(not (off & ~tie).any(),
          f"{int((off & ~tie).sum())} BRIEF tests differ away from ties")

    desc = jax.jit(orb.compute_descriptors_stacked, static_argnames=("pad",))
    ms = median_ms(lambda: desc(blur, kp.level, kp.xy_level[:, 1].astype(
        jnp.int32), kp.xy_level[:, 0].astype(jnp.int32), kp.angle, pad=pad),
        size.reps)
    return {"rbrief_ms": ms, "rbrief_keypoints": len(rows),
            "pyramid_dev": level_dev, "blur_dev": blur_dev,
            "rbrief_tie_tests": int(tie.sum()),
            "rbrief_tie_tests_differing": int((off & tie).sum())}


def time_callers(slam, frame_imgs, size: Size) -> dict:
    """The jitted callers of the ops above, on the live map: build_frame
    (FAST, rBRIEF) and track_step (Hamming)."""
    import jax
    import jax.numpy as jnp

    from tc2li_slam_tpu.slam import tracking

    img_l, img_r = (jax.device_put(x) for x in frame_imgs)

    def build():
        return tracking.build_frame(
            img_l, img_r, slam.cam, slam.scale_factors,
            n_features=size.dep.n_features, n_levels=size.dep.n_levels)

    frame = build()
    key = jax.random.PRNGKey(0)
    radius = jnp.asarray(9.0, jnp.float32)

    def track():
        return tracking.track_step(
            slam.map, frame, slam.T_cw, slam.velocity, key, slam.cam,
            slam.scale_factors, slam.sigma2, radius)

    return {"build_frame_ms": median_ms(build, size.reps),
            "track_step_ms": median_ms(track, size.reps)}


def _pose_dev(Ta, Tb):
    """(max translation deviation [m], max rotation deviation [rad])."""
    Ta = np.asarray(Ta, np.float64)
    Tb = np.asarray(Tb, np.float64)
    dt = np.linalg.norm(Ta[:, :3, 3] - Tb[:, :3, 3], axis=-1).max()
    Rd = np.swapaxes(Ta[:, :3, :3], -1, -2) @ Tb[:, :3, :3]
    A = 0.5 * (Rd - np.swapaxes(Rd, -1, -2))
    dr = np.linalg.norm(np.stack([A[:, 2, 1], A[:, 0, 2], A[:, 1, 0]], -1),
                        axis=-1).max()
    return float(dt), float(dr)


def default_precision_jaxpr(closed):
    """``closed`` with the precision of every ``dot_general`` reset to the
    default, through every nested jaxpr (jit, scan, while, cond bodies)."""
    from jax.extend import core as jcore

    def strip(jaxpr):
        eqns = []
        for e in jaxpr.eqns:
            params = {k: sub(v) for k, v in e.params.items()}
            if e.primitive.name == "dot_general":
                params["precision"] = None
            eqns.append(e.replace(params=params))
        return jaxpr.replace(eqns=eqns)

    def sub(v):
        if isinstance(v, jcore.ClosedJaxpr):
            return jcore.ClosedJaxpr(strip(v.jaxpr), v.consts)
        if isinstance(v, jcore.Jaxpr):
            return strip(v)
        if isinstance(v, tuple):  # cond branches, linear-solve jaxprs
            items = [sub(x) for x in v]
            if all(a is b for a, b in zip(items, v)):
                return v
            return type(v)(*items) if hasattr(v, "_fields") else tuple(items)
        return v

    return sub(closed)


def at_default_precision(fn, *args):
    """``fn(*args)`` run from its jaxpr with every contraction at the
    default precision."""
    import jax
    from jax.extend import core as jcore

    closed, out_shape = jax.make_jaxpr(fn, return_shape=True)(*args)
    run = jax.jit(jcore.jaxpr_as_fun(default_precision_jaxpr(closed)))
    out = run(*jax.tree_util.tree_leaves(args))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(out_shape), out)


def check_local_ba(size: Size, cpu, seed: int = 2) -> dict:
    """``lm.local_ba`` with the BALM quadratic on the card against the same
    call on the CPU device; and what default (TF32) precision would give."""
    import jax
    import jax.numpy as jnp

    from tc2li_slam_tpu.geom import camera as cam_mod
    from tc2li_slam_tpu.io import synthetic as syn
    from tc2li_slam_tpu.slam import local_mapping
    from tc2li_slam_tpu.solver import balm, lm

    rng = np.random.default_rng(seed)
    cam = cam_mod.Pinhole.create(718.856, 718.856, 607.19, 185.2, bf=386.1448)
    T_gt, X, T0, X0, obs, fixed = syn.ba_window(
        rng, cam, n_poses=size.ba_poses, n_landmarks=size.ba_landmarks,
        n_obs=size.ba_obs)
    P = size.ba_poses
    T_wl_gt = np.linalg.inv(T_gt)          # LiDAR = camera here
    scans = syn.plane_scans(rng, T_wl_gt)
    clusters = balm.build_clusters(
        jnp.asarray(scans), jnp.ones(scans.shape[:2], bool),
        jnp.linalg.inv(T0), max_voxels=128)
    extra = jax.tree_util.Partial(
        local_mapping._balm_extra, clusters=clusters,
        pos_in_win=jnp.arange(P, dtype=jnp.int32), lvalid=jnp.ones(P, bool),
        T_cl=jnp.eye(4), w_lba=jnp.float32(0.01))
    args = (cam, T0, X0, obs, fixed, jnp.ones(size.ba_landmarks, bool))

    def run(fn, device):
        a = jax.device_put(args, device)
        e = jax.device_put(extra, device)
        return fn(*a, iters=10, extra_fn=e)

    # what TF32 would do to a plain f32 product on this card, for scale
    k = jax.random.split(jax.random.PRNGKey(0))
    A = jax.random.normal(k[0], (2048, 2048), jnp.float32)
    B = jax.random.normal(k[1], (2048, 2048), jnp.float32)
    exact = np.asarray(A, np.float64) @ np.asarray(B, np.float64)
    mm_err = {}
    for prec in ("default", "tensorfloat32", "highest"):
        got = jax.jit(lambda a, b: jnp.matmul(a, b, precision=prec))(A, B)
        mm_err[prec] = float(np.abs(np.asarray(got) - exact).max()
                             / np.abs(exact).max())

    gpu = jax.devices()[0]
    res_gpu = run(lm.local_ba, gpu)
    res_cpu = run(lm.local_ba, cpu)
    dt, dr = _pose_dev(res_gpu.T_cw, res_cpu.T_cw)
    err0 = np.linalg.norm(np.asarray(T0)[1:, :3, 3] - T_gt[1:, :3, 3], axis=-1).mean()
    err1 = np.linalg.norm(np.asarray(res_gpu.T_cw)[1:, :3, 3] - T_gt[1:, :3, 3],
                          axis=-1).mean()
    # the same program with every contraction at the default precision,
    # past the numerics policy: what the card computes without it
    res_def = at_default_precision(
        lambda a, e: lm.local_ba(*a, iters=10, extra_fn=e),
        jax.device_put(args, gpu), jax.device_put(extra, gpu))
    dt_def, dr_def = _pose_dev(res_def.T_cw, res_cpu.T_cw)
    ms = median_ms(lambda: run(lm.local_ba, gpu), size.reps)
    out = {"local_ba_dt_m": dt, "local_ba_drot_rad": dr,
           "local_ba_default_precision_dt_m": dt_def,
           "local_ba_default_precision_drot_rad": dr_def,
           "local_ba_err_m": [float(err0), float(err1)], "local_ba_ms": ms,
           "matmul_2048_rel_err": mm_err}
    check(dt < 1e-4 and dr < 1e-5, out)
    check(err1 < 0.2 * err0, out)
    return out


def check_knn_esekf(slam, seq, size: Size, cpu) -> dict:
    """Voxel-map kNN and one iterated ESEKF update on the live LiDAR map,
    on the card against the CPU device."""
    import jax
    import jax.numpy as jnp

    from tc2li_slam_tpu.estimation import esekf
    from tc2li_slam_tpu.geom import lie
    from tc2li_slam_tpu.ops import voxel_map
    from tc2li_slam_tpu.slam import lio

    gpu = jax.devices()[0]
    frames, _, _ = seq
    fr = frames[-1]
    vmap = slam.vmap
    n = int(vmap.count)
    rng = np.random.default_rng(3)
    pick = rng.choice(n, min(size.knn_queries, n), replace=False)
    q = np.asarray(vmap.points)[pick] + rng.normal(0, 0.2, (len(pick), 3)).astype(np.float32)

    knn = jax.jit(voxel_map.knn, static_argnames=("k", "radius"))
    out_g = knn(jax.device_put(vmap, gpu), jax.device_put(q, gpu), k=5, radius=2)
    out_c = knn(jax.device_put(vmap, cpu), jax.device_put(q, cpu), k=5, radius=2)
    d_g, p_g, v_g = (np.asarray(x) for x in out_g)
    d_c, p_c, v_c = (np.asarray(x) for x in out_c)
    # the same neighbours (a stored point is its slot's identity)
    np.testing.assert_array_equal(v_g, v_c)
    np.testing.assert_array_equal(p_g, p_c)
    np.testing.assert_allclose(d_g, d_c, atol=1e-5)
    knn_ms = median_ms(lambda: knn(vmap, q, k=5, radius=2), size.reps)

    # one iterated update from a pose 5 cm / 0.5 deg off the scan's truth
    T_wb = fr.T_wb_gt
    pts = fr.scan[fr.scan_valid][::size.dep.scan_decim][:8192].astype(np.float32)
    f0 = esekf.init_filter()
    x0 = f0.x._replace(
        R=jnp.asarray(T_wb[:3, :3], jnp.float32) @ lie.so3_exp(jnp.asarray([0.0, 0.0, 0.009])),
        pos=jnp.asarray(T_wb[:3, 3] + [0.05, -0.03, 0.02], jnp.float32))
    f0 = f0._replace(x=x0)
    cfg = slam.lio_cfg

    @jax.jit
    def update(f, m, p):
        h_fn = lio.make_h_fn(m, p, jnp.ones(p.shape[0], bool), cfg)
        return esekf.update_iterated(f, h_fn, jnp.float32(cfg.meas_cov))

    f_g, it_g = update(*jax.device_put((f0, vmap, pts), gpu))
    f_c, it_c = update(*jax.device_put((f0, vmap, pts), cpu))
    dev = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for a, b in zip(jax.tree_util.tree_leaves(f_g.x),
                              jax.tree_util.tree_leaves(f_c.x)))
    upd_ms = median_ms(lambda: update(f0, vmap, pts), size.reps)
    out = {"knn_rows": len(pick),
           "knn_ms": knn_ms, "esekf_state_dev": dev,
           "esekf_iters": [int(it_g), int(it_c)], "esekf_update_ms": upd_ms}
    check(dev < 1e-4, out)
    return out


def phase_kernels(size: Size, slam, seq, cpu) -> dict:
    import jax

    frames = seq[0]
    img_l = jax.device_put(frames[-1].img_l)
    out = {}
    for name, fn in (
        ("fast", lambda: check_fast(img_l, size)),
        ("hamming", lambda: check_hamming(size)),
        ("rbrief", lambda: check_rbrief(img_l, size)),
        ("callers", lambda: time_callers(
            slam, (frames[-1].img_l, frames[-1].img_r), size)),
        ("local_ba", lambda: check_local_ba(size, cpu)),
        ("knn_esekf", lambda: check_knn_esekf(slam, seq, size, cpu)),
    ):
        r = fn()
        log(f"kernels [{name}] ok: " + json.dumps(r))
        out.update(r)
    return out


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_multi(size: Size, devices) -> dict:
    """Sharded BA on a mesh over ``devices`` against one device, then
    System(mesh=...) against System() on the stereo+LiDAR sequence."""
    import jax
    import jax.numpy as jnp

    from tc2li_slam_tpu.geom import camera as cam_mod
    from tc2li_slam_tpu.io import synthetic as syn
    from tc2li_slam_tpu.parallel import dist_ba

    n = len(devices)
    cam = cam_mod.Pinhole.create(500.0, 500.0, 320.0, 240.0, bf=250.0)
    T_gt, X, T0, X0, obs, fixed = syn.ba_window(
        np.random.default_rng(0), cam, n_poses=size.dist_poses,
        n_landmarks=size.dist_landmarks, n_obs=8)
    out = {}
    poses = {}
    for k in (n, 1):
        mesh = dist_ba.make_mesh(devices[:k])
        Xs, obs_s, vs = dist_ba.shard_problem(
            mesh, X0, obs, jnp.ones(X0.shape[0], bool))
        t0 = time.perf_counter()
        T1, _, cost = dist_ba.optimize(mesh, cam, T0, Xs, obs_s, vs, fixed,
                                       iters=10)
        T1 = np.asarray(T1)
        secs = time.perf_counter() - t0
        err0 = np.linalg.norm(np.asarray(T0)[1:, :3, 3] - T_gt[1:, :3, 3], axis=-1).mean()
        err1 = np.linalg.norm(T1[1:, :3, 3] - T_gt[1:, :3, 3], axis=-1).mean()
        check(np.isfinite(T1).all() and np.isfinite(float(cost)),
              f"{k} devices: non-finite BA result")
        check(err1 < 0.2 * err0, f"{k} devices: pose err {err0} -> {err1}")
        poses[k] = T1
        out[f"dist_ba_{k}dev"] = {"err_m": [float(err0), float(err1)],
                                  "s_with_compile": secs}
    dt, _ = _pose_dev(poses[n], poses[1])
    out["dist_ba_pose_dt_m"] = dt
    log(f"multi [dist_ba] {json.dumps(out)}")
    check(dt < 1e-3, f"{n}-device poses off the 1-device ones by {dt} m")

    seq = make_sequence(size)
    mesh = dist_ba.make_mesh(devices)
    r_mesh = run_mode(size, seq, mesh=mesh)
    r_mesh.pop("slam")
    r_one = run_mode(size, seq)
    r_one.pop("slam")
    out["system_ate_m"] = {"mesh": r_mesh["ate_m"], "single": r_one["ate_m"]}
    log(f"multi [system] ATE mesh {r_mesh['ate_m']:.4f} m, single "
        f"{r_one['ate_m']:.4f} m; mesh fps {r_mesh['fps']}")
    check(r_mesh["finite"] and r_mesh["state_ok"], "mesh run lost tracking")
    check(r_mesh["ate_m"] < 0.2, r_mesh["ate_m"])
    check(r_mesh["ate_m"] < r_one["ate_m"] * 1.5 + 0.02, out["system_ate_m"])
    return out


# ---------------------------------------------------------------------------

def run_gpu_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", os.path.join(REPO, "tests")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card path")
    args = ap.parse_args(argv)

    # the CPU backend stays visible beside the card: the kernels phase
    # compares with it
    if os.environ.get("JAX_PLATFORMS", "") in ("", "cuda", "gpu"):
        os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    try:
        import jax

        devices = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: JAX found no accelerator: {e}", file=sys.stderr)
        return 2
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    if len(devices) < args.devices:
        print(f"chip_smoke: needs {args.devices} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    from tc2li_slam_tpu.slam.profiling import card_line  # needs a checkout

    devices = devices[:args.devices]
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    t_all = time.perf_counter()
    if args.devices == 4:
        phase_multi(FULL, devices)
    else:
        cpu = jax.devices("cpu")[0]
        t0 = time.perf_counter()
        pipe = phase_pipeline(FULL)
        log(f"phase pipeline ok in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_kernels(FULL, pipe["slam"], pipe["seq"], cpu)
        log(f"phase kernels ok in {time.perf_counter() - t0:.1f} s")
        del pipe
        gc.collect()
        t0 = time.perf_counter()
        run_gpu_tests()
        log(f"phase gpu-tests ok in {time.perf_counter() - t0:.1f} s")
    log(f"all phases ok in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
