"""chip_smoke.py: refuses to run without a GPU, and its phase functions run
end to end at a tiny size on the CPU device (the four-card phase on four
virtual CPU devices)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs a GPU" in out.stderr


@pytest.fixture(scope="module")
def pipeline():
    return chip_smoke.phase_pipeline(chip_smoke.TINY)


def test_pipeline_phase_tiny(pipeline):
    for mode in ("stereo+LiDAR", "stereo+LiDAR+IMU"):
        r = pipeline[mode]
        assert r["frames"] == chip_smoke.TINY.frames - (
            chip_smoke.TINY.imu_warm if "IMU" in mode else chip_smoke.TINY.warm)
        assert r["p50_ms"] > 0 and r["setup_s"] > 0


def test_kernels_phase_tiny(pipeline):
    out = chip_smoke.phase_kernels(chip_smoke.TINY, pipeline["slam"],
                                   pipeline["seq"], jax.devices("cpu")[0])
    assert out["rbrief_keypoints"] == chip_smoke.TINY.dep.n_features
    assert out["local_ba_dt_m"] == 0.0  # same device, same program
    assert out["esekf_state_dev"] == 0.0


def test_multi_phase_on_four_virtual_devices():
    out = chip_smoke.phase_multi(chip_smoke.TINY, jax.devices()[:4])
    assert set(out["system_ate_m"]) == {"mesh", "single"}
    assert out["dist_ba_pose_dt_m"] < 1e-3


def test_default_precision_jaxpr_strips_the_policy(rng):
    """The smoke's default-precision rerun of ``lm.local_ba`` resets every
    contraction the numerics policy set to HIGHEST, and still computes the
    same result on the CPU."""
    from tests.test_precision import f32_dot_precisions, _ba_problem
    from tc2li_slam_tpu.solver import lm
    from tests.test_solver import CAM

    T0, X, obs, fixed = _ba_problem(rng)

    def fn(T0, X):
        return lm.local_ba(CAM, T0, X, obs, fixed, jnp.ones(X.shape[0], bool),
                           iters=2)

    closed = jax.make_jaxpr(fn)(T0, X)
    assert set(f32_dot_precisions(closed.jaxpr)) == {
        (jax.lax.Precision.HIGHEST,) * 2}
    stripped = chip_smoke.default_precision_jaxpr(closed)
    assert set(f32_dot_precisions(stripped.jaxpr)) == {None}
    got = chip_smoke.at_default_precision(fn, T0, X)
    np.testing.assert_allclose(np.asarray(got.T_cw),
                               np.asarray(fn(T0, X).T_cw), atol=1e-6)
