"""Compiled device ops on the card against plain references.

Marked ``gpu``: each test finds the card through the ``gpu`` fixture and
skips without one. ``python chip_smoke.py`` runs them on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tc2li_slam_tpu.ops import matching, orb, reference
from tc2li_slam_tpu.solver import lm
from tests.test_solver import CAM, make_ba_problem

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")


def test_fast_score_exact_on_gpu(gpu, rng):
    img = rng.integers(0, 255, (120, 200)).astype(np.uint8)
    got = jax.jit(orb.fast_score_raw)(jax.device_put(img, gpu))
    np.testing.assert_array_equal(np.asarray(got), reference.fast_score(img))


def test_hamming_exact_on_gpu(gpu, rng):
    d1 = rng.integers(0, 1 << 32, (300, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.integers(0, 1 << 32, (200, 8), dtype=np.uint64).astype(np.uint32)
    got = jax.jit(matching.hamming_matrix)(jax.device_put(d1, gpu),
                                           jax.device_put(d2, gpu))
    np.testing.assert_array_equal(np.asarray(got),
                                  reference.hamming_matrix(d1, d2))


def test_brief_exact_on_gpu(gpu, rng):
    R, pad, K = orb._PATTERN_RADIUS, orb.STACK_PAD, 64
    stack = rng.uniform(0, 255, (2, 90 + 2 * pad, 120 + 2 * pad)).astype(np.float32)
    lvl = rng.integers(0, 2, K).astype(np.int32)
    rows = rng.integers(0, 90, K).astype(np.int32)
    cols = rng.integers(0, 120, K).astype(np.int32)
    roff = rng.integers(-R, R + 1, (K, 512)).astype(np.int32)
    coff = rng.integers(-R, R + 1, (K, 512)).astype(np.int32)
    words = jax.jit(lambda s, l, r, c, ro, co: orb._brief_words(
        orb._gather_patches_stacked(s, l, r, c, R, pad), ro, co))
    got = words(*jax.device_put((stack, lvl, rows, cols, roff, coff), gpu))
    ref = reference.brief_words(stack, lvl, rows, cols, roff, coff, pad, R)
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_local_ba_matches_cpu_at_highest_precision(gpu, rng):
    """Under the f32 policy the card's BA lands where the CPU's does."""
    X, T_gt, T0, X0, obs = make_ba_problem(rng)
    fixed = jnp.zeros(T0.shape[0], bool).at[0].set(True)
    args = (CAM, jnp.asarray(T0), jnp.asarray(X0), obs, fixed,
            jnp.ones(X.shape[0], bool))
    res = {d.platform: lm.local_ba(*jax.device_put(args, d), iters=10)
           for d in (gpu, jax.devices("cpu")[0])}
    dt = np.abs(np.asarray(res["gpu"].T_cw) - np.asarray(res["cpu"].T_cw)).max()
    assert dt < 1e-4, dt


def test_peak_memory_is_reported(gpu):
    jax.block_until_ready(jax.device_put(np.ones(1 << 20, np.float32), gpu))
    assert gpu.memory_stats()["peak_bytes_in_use"] >= 4 << 20
