"""Multi-host distributed BA: two jax.distributed processes, 4 virtual CPU
devices each, one global 8-device mesh. The psum'd reduced camera system
crosses the process boundary (the network path between hosts); the result
must match the single-process solution."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
proc_id = int(sys.argv[1]); n_proc = int(sys.argv[2]); port = sys.argv[3]
out_path = sys.argv[4]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=n_proc, process_id=proc_id,
)
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, %(repo)r)
from tc2li_slam_tpu.geom import camera as cam_mod, lie
from tc2li_slam_tpu.parallel import dist_ba
from tc2li_slam_tpu.solver.lm import BAObservations

assert len(jax.devices()) == 4 * n_proc, jax.devices()

rng = np.random.default_rng(0)   # identical problem on every process
CAM = cam_mod.Pinhole.create(500.0, 500.0, 320.0, 240.0, bf=250.0)
Pn, L, K = 6, 512, 4
X = np.stack([rng.uniform(-15, 15, L), rng.uniform(-8, 8, L),
              rng.uniform(10, 50, L)], -1).astype(np.float32)
T_gt = []
for p in range(Pn):
    xi = np.concatenate([[0.6 * p, 0.02 * p, 0.0],
                         rng.uniform(-0.02, 0.02, 3)]).astype(np.float32)
    T_gt.append(np.asarray(lie.se3_exp(jnp.asarray(xi))))
T_gt = np.stack(T_gt)
pose_idx = np.stack([rng.choice(Pn, K, replace=False) for _ in range(L)]).astype(np.int32)
uv = np.zeros((L, K, 3), np.float32)
for l in range(L):
    for k in range(K):
        T = T_gt[pose_idx[l, k]]
        Xc = T[:3, :3] @ X[l] + T[:3, 3]
        uv[l, k] = np.asarray(cam_mod.project_stereo(CAM, jnp.asarray(Xc)))
obs = BAObservations(pose_idx=jnp.asarray(pose_idx), uv=jnp.asarray(uv),
                     inv_sigma2=jnp.ones((L, K)), stereo=jnp.ones((L, K), bool),
                     valid=jnp.ones((L, K), bool))
T0 = [T_gt[0]]
for p in range(1, Pn):
    xi = 0.03 * rng.standard_normal(6).astype(np.float32)
    T0.append(np.asarray(jnp.asarray(T_gt[p]) @ lie.se3_exp(jnp.asarray(xi))))
T0 = jnp.asarray(np.stack(T0))
X0 = jnp.asarray(X + 0.1 * rng.standard_normal(X.shape).astype(np.float32))
fixed = jnp.zeros(Pn, bool).at[0].set(True)

mesh = dist_ba.make_mesh(jax.devices())   # GLOBAL mesh over both processes
Xs, obs_s, vs = dist_ba.shard_problem(mesh, X0, obs, jnp.ones(L, bool))
T1, X1, cost = dist_ba.optimize(mesh, CAM, T0, Xs, obs_s, vs, fixed, iters=10)
T1_np = np.asarray(T1)   # replicated output: addressable everywhere
err = np.mean([np.linalg.norm(T1_np[i][:3, 3] - T_gt[i][:3, 3])
               for i in range(1, Pn)])
if proc_id == 0:
    np.savez(out_path, T1=T1_np, err=err, cost=cost)
print(f"proc {proc_id}: err={err:.5f} cost={float(cost):.4f}", flush=True)
"""


@pytest.mark.slow
def test_two_process_distributed_ba(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    out = str(tmp_path / "proc0.npz")
    script = WORKER % {"repo": REPO}
    sp = str(tmp_path / "worker.py")
    with open(sp, "w") as f:
        f.write(script)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen([sys.executable, sp, str(i), "2", port, out],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, cwd=REPO)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so[-2000:]}\n{se[-2000:]}"
    data = np.load(out)
    assert float(data["err"]) < 5e-3, float(data["err"])
    assert np.isfinite(data["T1"]).all()
