"""Distributed-BA scaling harness: step time vs mesh size.

Measures the sharded GN step (landmark-Schur local, reduced camera system
psum'd across the mesh) on 1..N devices with a problem whose landmark axis
scales with the mesh (weak scaling — the production regime: bigger maps,
more cards). Efficiency = t(1 card, base problem) / t(N cards, N x problem).

On GPUs the psum runs over NVLink. Under
XLA_FLAGS=--xla_force_host_platform_device_count=N it validates the
program's correctness, but the timing shares one host's cores and is not a
scaling measurement.

    python examples/scaling_bench.py [--devices 1 2 4 8] [--lm-per-dev 16384]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--lm-per-dev", type=int, default=16384)
    ap.add_argument("--poses", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp
    from tc2li_slam_tpu.geom import camera as cam_mod
    from tc2li_slam_tpu.io import synthetic
    from tc2li_slam_tpu.parallel import dist_ba

    n_avail = len(jax.devices())
    sizes = args.devices or sorted({1, 2, n_avail} & set(range(1, n_avail + 1)))
    sizes = [n for n in sizes if n <= n_avail]
    cam = cam_mod.Pinhole.create(500.0, 500.0, 320.0, 240.0, bf=250.0)

    results = {}
    for n in sizes:
        rng = np.random.default_rng(0)
        L = args.lm_per_dev * n
        _, _, T0, X0, obs, fixed = synthetic.ba_window(
            rng, cam, n_poses=args.poses, n_landmarks=L, n_obs=4)
        mesh = dist_ba.make_mesh(jax.devices()[:n])
        Xs, obs_s, vs = dist_ba.shard_problem(mesh, X0, obs, jnp.ones(L, bool))
        step = dist_ba.gn_step_fn(mesh, cam)
        D = args.poses * 6
        He, ge = jnp.zeros((D, D)), jnp.zeros(D)
        lam = jnp.float32(1e-4)
        out = step(T0, Xs, obs_s, vs, fixed, lam, He, ge)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = step(T0, Xs, obs_s, vs, fixed, lam, He, ge)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.iters
        results[n] = dt * 1e3

    base = results[sizes[0]]
    print(json.dumps({
        "metric": "distributed BA GN-step ms (weak scaling)",
        "lm_per_device": args.lm_per_dev,
        "poses": args.poses,
        "platform": jax.devices()[0].platform,
        "step_ms": {str(n): round(v, 3) for n, v in results.items()},
        "weak_scaling_efficiency": {
            str(n): round(base / results[n], 3) for n in sizes
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
