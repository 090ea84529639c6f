"""Benchmark: tracked frames/sec/card on the full SLAM pipeline.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.
Baseline = the reference's real-time rate (10 Hz sensor rate on CPU — it has
no published throughput beyond running real time; BASELINE.md). Runs on a
GPU; any other platform is an error unless ``BENCH_PLATFORM=cpu`` asks for
the CPU explicitly (then the roofline table is skipped: the CPU has no peak
row to divide by). The JSON names the platform, device kind, device count
and the card's power limit.

KITTI-shaped workload:
- KITTI-sized stereo pair (1241 x 376), 2000 ORB features, 8 levels
- full-size LiDAR scans (131,072-point pad — KITTI HDL-64E scans are ~120k)
- 100 measured frames past a 10-frame warmup (compile + map bootstrap)
- steady-state map occupancy (keyframes + landmarks + voxel map grown in)
- per-stage host-time breakdown (REGISTER_TIMES analog) in the JSON extras
"""

import json
import os
import sys
import time

import numpy as np

# Published dense peak rates per card, keyed by jax device_kind: bf16 and
# TF32 tensor-core TFLOP/s, float32 TFLOP/s outside the tensor cores, HBM
# GB/s. Source: NVIDIA H100 data sheet, SXM part, at its 700 W limit (a card
# set lower cannot hold these clocks; the power limit is reported beside
# every result).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0, "tf32_tflops": 495.0, "f32_tflops": 67.0,
        "hbm_gbps": 3350.0,
    },
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of ``device_kind``; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add a row "
            "to bench.PEAKS with its source") from None


def _devtime(fn, reps=20):
    """Median ms of ``jit(fn)()`` to ``block_until_ready`` after warm-up.

    The jit wrap matters: un-jitted, a composite like hamming_matrix
    dispatches ~10 separate ops, and the timing would be host dispatch."""
    import jax

    jfn = jax.jit(fn)
    for _ in range(2):
        jax.block_until_ready(jfn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(jfn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def roofline_table(slam, frame, scan, scan_valid, cfg):
    """Per-kernel ms + flops/bytes + % of nominal roofline for the frame
    path's hot kernels, measured on the LIVE jitted functions with the
    live map state (BASELINE's 'profiled to speed-of-light per chip')."""
    import jax
    import jax.numpy as jnp
    from tc2li_slam_tpu.ops import matching, orb, voxel_map
    from tc2li_slam_tpu.slam import lio, tracking

    peaks = device_peaks(jax.devices()[0].device_kind)
    peak_f32 = peaks["f32_tflops"]
    peak_gbs = peaks["hbm_gbps"]

    m = slam.map
    F = frame.xy.shape[0]
    L = m.L
    H, W = 376, 1241
    img = jnp.asarray(np.zeros((H, W), np.uint8))
    rows = {}

    def add(name, ms, gflop=None, gbyte=None, note=""):
        row = {"ms": round(ms, 2)}
        if gflop is not None:
            gfs = gflop / (ms * 1e-3)
            row["gflop"] = round(gflop, 2)
            row["gflops"] = round(gfs, 0)
            row["pct_f32_peak"] = round(100.0 * gfs / (peak_f32 * 1e3), 1)
        if gbyte is not None:
            gbs = gbyte / (ms * 1e-3)
            row["gbyte"] = round(gbyte, 3)
            row["gbps"] = round(gbs, 0)
            row["pct_hbm_peak"] = round(100.0 * gbs / peak_gbs, 1)
        if gflop is not None and gbyte is not None:
            cf = (gflop / (peak_f32 * 1e3))
            mf = (gbyte / peak_gbs)
            row["bound"] = "compute" if cf > mf else "memory"
        if note:
            row["note"] = note
        rows[name] = row

    # ORB extraction: 8-level pyramid, FAST + blur + orientation + rBRIEF.
    # Memory model: ~12 full-image reads/writes across levels (sum 1/s^2i
    # ~ 2.1x base) at f32.
    ms = _devtime(lambda: orb.extract(
        img, n_features=cfg.orb.n_features, n_levels=cfg.orb.n_levels))
    add("orb_extract (1 img)", ms, gbyte=12 * 2.1 * H * W * 4 / 1e9,
        note="pyramid+FAST+rBRIEF; bandwidth model")

    # full frame build (2x ORB + stereo row-band match + subpixel)
    ms = _devtime(lambda: tracking.build_frame(
        img, img, slam.cam, slam.scale_factors,
        n_features=cfg.orb.n_features, n_levels=cfg.orb.n_levels))
    add("build_frame (stereo pair)", ms)

    # Hamming projection match: [L, F] x 8 words x (xor+popcnt+acc)
    ms = _devtime(lambda: matching.hamming_matrix(m.lm_desc, frame.desc))
    add("hamming [32k x 2000]", ms, gflop=L * F * 8 * 3 / 1e9,
        gbyte=(L * 32 + F * 32 + L * F * 4) / 1e9,
        note="int ops counted as flops")

    # fused tracking step (3 matching passes + pose-only LM)
    key = jax.random.PRNGKey(0)
    ms = _devtime(lambda: tracking.track_step(
        m, frame, slam.T_cw, slam.velocity, key, slam.cam,
        slam.scale_factors, slam.sigma2, jnp.asarray(9.0, jnp.float32)))
    add("track_step (match+LM)", ms, gflop=3 * L * F * 8 * 3 / 1e9)

    if slam.vmap is not None:
        # voxel-map insert: (N+B)-key stable sort + compaction
        staged = lio.camera_scan_stage(
            scan, jnp.asarray(scan_valid), slam.T_cw, slam.T_cl,
            jnp.float32(cfg.lidar.blind), jnp.float32(cfg.lidar.map_voxel),
            insert_cap=cfg.lidar.insert_cap)
        ms = _devtime(lambda: lio.camera_scan_stage(
            scan, jnp.asarray(scan_valid), slam.T_cw, slam.T_cl,
            jnp.float32(cfg.lidar.blind), jnp.float32(cfg.lidar.map_voxel),
            insert_cap=cfg.lidar.insert_cap))
        add("scan_stage (prep+ds 131k)", ms,
            gbyte=scan.shape[0] * 16 * 4 / 1e9, note="sort-bound")
        N = slam.vmap.keys.shape[0]
        B = staged[0].shape[0]
        ms = _devtime(lambda: voxel_map.insert(
            slam.vmap, staged[0], staged[1]))
        add("voxel insert 32k->pool", ms,
            gbyte=(N + B) * 16 * np.log2(max(N + B, 2)) / 1e9,
            note="(N+B) stable sort model")
        q = m.lm_pos[:512]
        ms = _devtime(lambda: voxel_map.knn(slam.vmap, q, k=5, radius=2))
        add("knn 512q r2", ms)

    if slam.voc is not None:
        from tc2li_slam_tpu.ops import bow
        ms = _devtime(lambda: bow.quantize(
            slam.voc, frame.desc, frame.valid, slam.voc.depth))
        add(f"bow quantize {F}f depth{slam.voc.depth}", ms)

    # ORBvoc-scale vocabulary quantization (k=10, depth=6 — the shape of
    # the reference's 1M-word ORBvoc.txt): complete-tree synthetic vocab,
    # lock-step descent of all features
    from tc2li_slam_tpu.ops import bow as bow_mod
    kk, LL = 10, 6
    n_int = (kk ** LL - 1) // (kk - 1)
    n_nodes = n_int + kk ** LL
    idx = jnp.arange(n_nodes)
    ch = idx[:, None] * kk + 1 + jnp.arange(kk)[None, :]
    ch = jnp.where(ch < n_nodes, ch, -1).astype(jnp.int32)
    rngv = np.random.default_rng(0)
    voc_big = bow_mod.Vocabulary(
        node_desc=jnp.asarray(rngv.integers(
            0, 2 ** 32, (n_nodes, 8), dtype=np.uint32)),
        children=ch,
        is_leaf=idx >= n_int,
        word_id=jnp.where(idx >= n_int, idx - n_int, -1).astype(jnp.int32),
        weight=jnp.ones(n_nodes, jnp.float32),
        k=kk, depth=LL, n_words=kk ** LL,
    )
    ms = _devtime(lambda: bow_mod.quantize(
        voc_big, frame.desc, frame.valid, LL))
    add(f"bow quantize {F}f ORBvoc-scale k10 d6", ms,
        gbyte=LL * F * kk * 32 / 1e9, note="gather-bound tree descent")

    return {"device_kind": jax.devices()[0].device_kind,
            "peaks": peaks,
            "kernels": rows}


def run_imu_mode(frames, scans_q, dep, n_frames, n_warm):
    """IMU_STEREO_LIDAR throughput (ESEKF scan step + VI refine + LVI-BA) —
    the paper's flagship mode was perf-blind through round 3."""
    from tc2li_slam_tpu.io import synthetic as syn
    from tc2li_slam_tpu.slam import system as sys_mod

    icfg = syn.deployment_config(dep, imu=True, profile=True)
    slam = sys_mod.System(icfg)

    def track(i):
        fr = frames[i]
        slam.track(fr.img_l, fr.img_r, fr.t, scans_q[i],
                   None, gyro=fr.gyro, acc=fr.acc,
                   imu_dts=fr.imu_dts, imu_trel=fr.imu_trel,
                   scan_times=fr.scan_times[::dep.scan_decim])

    # warm until every IMU-mode program has compiled: static init, the
    # visual-inertial bootstrap (fires at ~4 KFs), the fixed-size LVI-BA
    # window, and BOTH per-frame VI refine branches
    n_warm = max(n_warm, 25)
    for i in range(min(n_warm, len(frames))):
        track(i)
    slam.prewarm()  # incl. the VIBA1/VIBA2 ladder + FullInertialBA window
    np.asarray(slam.T_cw)  # drain the queue before the measured window
    slam.timers.reset()
    n_meas = max(min(n_warm + n_frames, len(frames)) - n_warm, 0)
    t0 = time.perf_counter()
    for i in range(n_warm, n_warm + n_meas):
        track(i)
    dt = time.perf_counter() - t0
    st = slam.timers.stats()
    if n_meas == 0:
        return {"fps": None, "frames": 0, "note": "sequence shorter than warmup"}
    return {
        "fps": round(n_meas / dt, 3),
        "frames": n_meas,
        "stage_ms_per_frame": {
            k: round(v["total_s"] * 1e3 / n_meas, 2)
            for k, v in sorted(st.items())},
        "vi_initialized": bool(slam._vi_initialized),
        "vi_stage": slam._vi_stage,
    }


def main():
    import jax

    if os.environ.get("BENCH_PLATFORM") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    platform = jax.devices()[0].platform
    if platform != "gpu" and not (
            platform == "cpu" and os.environ.get("BENCH_PLATFORM") == "cpu"):
        raise SystemExit(f"bench.py needs a GPU, JAX found {platform!r} "
                         "(set BENCH_PLATFORM=cpu to bench the CPU)")

    import dataclasses
    import hashlib
    import pickle

    from tc2li_slam_tpu.io import synthetic as syn
    from tc2li_slam_tpu.slam import profiling, system as sys_mod

    n_frames = int(os.environ.get("BENCH_FRAMES", "100"))
    n_warm = int(os.environ.get("BENCH_WARMUP", "10"))
    dep = dataclasses.replace(
        syn.KITTI,
        n_scan=int(os.environ.get("BENCH_SCAN", str(syn.KITTI.n_scan))),
        scan_decim=int(os.environ.get("BENCH_SCAN_DECIM",
                                      str(syn.KITTI.scan_decim))))
    cfg = syn.deployment_config(dep, profile=True)

    # Synthetic-sequence datagen is pure deterministic host work — cache it
    # on disk keyed on the deployment + the generator source hash.
    t_gen0 = time.perf_counter()
    src = open(syn.__file__, "rb").read()
    key = hashlib.sha1(
        f"v2|{n_frames + n_warm}|{dep}".encode() + hashlib.sha1(src).digest()
    ).hexdigest()[:16]
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")
    cache_path = os.path.join(cache_dir, f"bench_seq_{key}.pkl")
    frames = None
    if os.path.exists(cache_path) and os.environ.get("BENCH_NOCACHE") != "1":
        try:
            with open(cache_path, "rb") as f:
                frames = [syn.FrameData(*row) for row in pickle.load(f)]
        except Exception:
            frames = None
    if frames is None:
        frames = syn.deployment_sequence(dep, n_frames + n_warm)
        if os.environ.get("BENCH_NOCACHE") != "1":
            os.makedirs(cache_dir, exist_ok=True)
            tmp = cache_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump([tuple(fr) for fr in frames], f, protocol=4)
            os.replace(tmp, cache_path)
    # loader-side wire format: decimated int16 scans, uint8 images
    scans_q = syn.wire_scans(frames, dep, cfg.lidar.scan_quant)
    t_gen = time.perf_counter() - t_gen0

    slam = sys_mod.System(cfg)
    # warmup: compile everything (first frames hit all code paths incl. BA),
    # then prewarm the variants whose first natural occurrence would land a
    # cold XLA compile mid-measurement (recover path, cull, BA buckets)
    for fr, sq in zip(frames[:n_warm], scans_q[:n_warm]):
        slam.track(fr.img_l, fr.img_r, fr.t, sq, None)
    slam.prewarm()
    np.asarray(slam.T_cw)  # drain the device queue: warmup/prewarm work
    #                        must not bleed into the measured window
    slam.timers.reset()  # stage stats = steady state only

    # steady state: prefetch frame k+1's sensor arrays (async H2D) before
    # processing frame k, so the copy overlaps device compute —
    # the reference's sensor-callback threads do the same (SURVEY §2.4)
    per_frame = os.environ.get("BENCH_PERFRAME") == "1"
    frame_ms = []
    t0 = time.perf_counter()
    staged = slam.prefetch(frames[n_warm].img_l, frames[n_warm].img_r,
                           scans_q[n_warm], None)
    for i in range(n_warm, len(frames)):
        fr, cur = frames[i], staged
        tf0 = time.perf_counter()
        if i + 1 < len(frames):
            staged = slam.prefetch(frames[i + 1].img_l, frames[i + 1].img_r,
                                   scans_q[i + 1], None)
        slam.track(fr.img_l, fr.img_r, fr.t, scans_q[i],
                   None, staged=cur)
        frame_ms.append(1e3 * (time.perf_counter() - tf0))
        if per_frame:
            print(f"frame {i}: {frame_ms[-1]:.1f} ms", file=sys.stderr)
    dt = time.perf_counter() - t0

    fps = n_frames / dt
    baseline_fps = 10.0  # reference real-time sensor rate
    st = slam.timers.stats()
    stages = {
        k: round(v["total_s"] * 1e3 / n_frames, 2)  # amortized ms per frame
        for k, v in sorted(st.items())
    }

    # Per-kernel roofline table on the live state (skip with
    # BENCH_ROOFLINE=0); GPU only, the CPU has no peak row
    roofline = None
    if platform == "gpu" and os.environ.get("BENCH_ROOFLINE", "1") != "0":
        from tc2li_slam_tpu.slam import tracking as trk_mod
        import jax.numpy as jnp
        fb = trk_mod.build_frame(
            jnp.asarray(frames[-1].img_l), jnp.asarray(frames[-1].img_r), slam.cam,
            slam.scale_factors, n_features=cfg.orb.n_features,
            n_levels=cfg.orb.n_levels)
        roofline = roofline_table(
            slam, fb, slam._scan_to_device(scans_q[-1]),
            np.ones(len(scans_q[-1]), bool), cfg)

    # Effective arithmetic throughput of the descriptor-matching kernel,
    # from its measured time (XOR + popcount + accumulate ~ 3 int ops per
    # uint32 word).
    L, F = cfg.tracking.max_lm, cfg.orb.n_features
    eff_gops = None
    if roofline:
        hk = next((v for k, v in roofline["kernels"].items()
                   if k.startswith("hamming")), None)
        if hk:
            eff_gops = (L * F * 8 * 3) / (hk["ms"] * 1e-3) / 1e9

    # IMU_STEREO_LIDAR mode variant (skip with BENCH_IMU=0)
    imu_mode_res = None
    if os.environ.get("BENCH_IMU", "1") != "0":
        # default 75 measured frames: the VIBA1 refinement rung (5 s after
        # init) fires INSIDE the measured window, so its steady-state cost
        # is part of the number
        n_imu = min(int(os.environ.get("BENCH_IMU_FRAMES", "75")),
                    len(frames) - n_warm)
        imu_mode_res = run_imu_mode(frames, scans_q, dep, n_imu, n_warm)

    n_kf = int(slam.map.n_kf)
    print(json.dumps({
        "metric": "tracked frames/sec/card (stereo+LiDAR, KITTI-shaped synthetic)",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 3),
        "frames": n_frames,
        "warmup": n_warm,
        "scan_points": dep.n_scan,
        "scan_points_wire": len(scans_q[0]),
        "scan_decim": dep.scan_decim,
        "orb_features": F,
        "keyframes": n_kf,
        "landmarks": int(slam.map.n_lm),
        "stage_ms_per_frame": stages,
        # per-frame median rate beside the wall-clock value above
        "fps_median_frame": round(
            1e3 / float(np.median(frame_ms)), 3) if frame_ms else None,
        "frame_ms_p90": round(
            float(np.percentile(frame_ms, 90)), 1) if frame_ms else None,
        "hamming_effective_gops": round(eff_gops, 1) if eff_gops else None,
        "roofline": roofline,
        "imu_mode": imu_mode_res,
        "datagen_s": round(t_gen, 1),
        "platform": platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
        "card": profiling.card_line() if platform == "gpu" else None,
    }))


if __name__ == "__main__":
    sys.exit(main())
