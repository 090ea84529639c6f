"""Matching + stereo kernels vs brute-force numpy oracles and synthetic
stereo geometry."""

import numpy as np
import jax.numpy as jnp

from tc2li_slam_tpu.ops import matching, orb, reference, stereo
from tc2li_slam_tpu.geom import camera


def rand_desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def np_hamming(a, b):
    return np.unpackbits(
        np.bitwise_xor(a[:, None, :], b[None, :, :]).view(np.uint8), axis=-1
    ).sum(-1)


def test_hamming_matrix_matches_numpy(rng):
    d1 = rand_desc(rng, 64)
    d2 = rand_desc(rng, 96)
    ours = np.asarray(matching.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    ref = np_hamming(d1, d2)
    np.testing.assert_array_equal(ours, ref)


def test_hamming_matrix_matches_reference(rng):
    d1 = rand_desc(rng, 300)
    d2 = rand_desc(rng, 70)
    ours = np.asarray(matching.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    np.testing.assert_array_equal(ours, reference.hamming_matrix(d1, d2, chunk=64))


def test_hamming_matrix_extremes():
    zeros = jnp.zeros((4, 8), jnp.uint32)
    ones = jnp.full((5, 8), 0xFFFFFFFF, jnp.uint32)
    np.testing.assert_array_equal(np.asarray(matching.hamming_matrix(zeros, ones)), 256)
    np.testing.assert_array_equal(np.asarray(matching.hamming_matrix(ones, ones)), 0)
    np.testing.assert_array_equal(np.asarray(matching.hamming_matrix(zeros, zeros)), 0)


def test_match_descriptors_exact_pairs(rng):
    d = rand_desc(rng, 128)
    perm = rng.permutation(128)
    idx, dist, ok = matching.match_descriptors(
        jnp.asarray(d), jnp.asarray(d[perm]),
        jnp.ones(128, bool), jnp.ones(128, bool),
        max_dist=0,
    )
    assert bool(np.all(np.asarray(ok)))
    np.testing.assert_array_equal(np.asarray(idx), np.argsort(perm))
    assert int(np.asarray(dist).max()) == 0


def test_match_ratio_test_rejects_ambiguous(rng):
    # two equal targets at nonzero distance -> second best == best -> ratio
    # test kills it (at distance 0 the reference also accepts: 0 <= r*0)
    d1 = rand_desc(rng, 1)
    d2x = d1 ^ np.uint32(1)
    d2 = np.concatenate([d2x, d2x], axis=0)
    _, _, ok = matching.match_descriptors(
        jnp.asarray(d1), jnp.asarray(d2), jnp.ones(1, bool), jnp.ones(2, bool),
        max_dist=256, ratio=0.9,
    )
    assert not bool(np.asarray(ok)[0])


def test_mutual_check(rng):
    d1 = rand_desc(rng, 32)
    d2 = np.concatenate([d1, rand_desc(rng, 32)], axis=0)
    idx, _, ok = matching.match_descriptors(
        jnp.asarray(d1), jnp.asarray(d2), jnp.ones(32, bool), jnp.ones(64, bool),
        max_dist=256, mutual=True,
    )
    okn = np.asarray(ok)
    np.testing.assert_array_equal(np.asarray(idx)[okn], np.arange(32)[okn])
    assert okn.mean() > 0.9


def test_window_and_level_mask():
    uv1 = jnp.asarray([[10.0, 10.0]])
    uv2 = jnp.asarray([[12.0, 11.0], [30.0, 10.0]])
    m = np.asarray(matching.window_mask(uv1, uv2, jnp.asarray([5.0])))
    np.testing.assert_array_equal(m, [[True, False]])
    lm = np.asarray(matching.level_mask(jnp.asarray([2]), jnp.asarray([1, 4])))
    np.testing.assert_array_equal(lm, [[True, False]])


def test_rotation_consistency(rng):
    n = 100
    a1 = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    a2 = (a1 - 0.3) % (2 * np.pi)  # consistent rotation
    a2[:10] = rng.uniform(0, 2 * np.pi, 10)  # 10 bad matches
    keep = matching.rotation_consistency(
        jnp.asarray(a1), jnp.asarray(a2), jnp.arange(n), jnp.ones(n, bool)
    )
    keep = np.asarray(keep)
    assert keep[10:].mean() > 0.95
    assert keep[:10].mean() < 0.5


def test_resolve_duplicates():
    idx = jnp.asarray([0, 0, 1])
    dist = jnp.asarray([5, 3, 7], jnp.int32)
    matched = jnp.ones(3, bool)
    keep = np.asarray(matching.resolve_duplicates(idx, dist, matched, 4))
    np.testing.assert_array_equal(keep, [False, True, True])


def test_epipolar_mask_stereo():
    # rectified stereo: F = [e]_x for horizontal epilines -> v must agree
    F = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    uv1 = jnp.asarray([[100.0, 50.0]])
    uv2 = jnp.asarray([[80.0, 50.5], [80.0, 70.0]])
    m = np.asarray(matching.epipolar_mask(uv1, uv2, F, jnp.ones(2)))
    np.testing.assert_array_equal(m, [[True, False]])


def _stereo_pair(rng, h=240, w=320, disp=12.0):
    """Right image = left shifted by disp (fronto-parallel plane)."""
    from tests.test_orb import make_test_image
    left = make_test_image(rng, h, w).astype(np.float32)
    right = np.roll(left, -int(disp), axis=1)
    return left, right


def test_stereo_matching_end_to_end(rng):
    disp_gt = 12.0
    left, right = _stereo_pair(rng, disp=disp_gt)
    kl = orb.extract(jnp.asarray(left.astype(np.uint8)), n_features=300, n_levels=2)
    kr = orb.extract(jnp.asarray(right.astype(np.uint8)), n_features=300, n_levels=2)
    scale_factors = jnp.asarray([1.2 ** i for i in range(8)], jnp.float32)
    bf = jnp.float32(40.0 * disp_gt)  # so max disparity ~40px at min_z=12
    idx, disp, ok = stereo.match_stereo(
        kl.xy, kl.level, kl.desc, kl.valid,
        kr.xy, kr.level, kr.desc, kr.valid,
        scale_factors, bf, jnp.float32(12.0),
    )
    okn = np.asarray(ok)
    assert okn.sum() > 50
    err = np.abs(np.asarray(disp)[okn] - disp_gt)
    assert np.median(err) < 1.0, f"median disparity err {np.median(err):.2f}"

    ur, ok2 = stereo.subpixel_refine(
        jnp.asarray(left), jnp.asarray(right), kl.xy,
        kl.xy[:, 0] - jnp.asarray(disp), ok,
    )
    ok2n = np.asarray(ok2) & okn
    disp_ref = np.asarray(kl.xy[:, 0])[ok2n] - np.asarray(ur)[ok2n]
    err2 = np.abs(disp_ref - disp_gt)
    # refined disparity stays subpixel-close (the integer stage is already
    # exact on this integer-shifted pair; the parabola adds <0.3 px content
    # bias, same as the reference's SAD interpolation)
    assert np.median(err2) < 0.5, f"refined median err {np.median(err2):.2f}"
