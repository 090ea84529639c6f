"""ORB extraction vs OpenCV goldens: descriptor bit-parity on shared
keypoints, orientation agreement, detection repeatability."""

import numpy as np
import cv2
import jax.numpy as jnp
import pytest

from tc2li_slam_tpu.ops import orb, reference


def make_test_image(rng, h=480, w=640):
    """Synthetic textured scene: gradient + random rectangles + circles."""
    img = np.tile(np.linspace(40, 200, w, dtype=np.float32), (h, 1))
    for _ in range(60):
        x, y = rng.integers(0, w - 40), rng.integers(0, h - 40)
        ww, hh = rng.integers(10, 40, 2)
        img[y : y + hh, x : x + ww] = rng.integers(0, 255)
    for _ in range(30):
        x, y, r = rng.integers(30, w - 30), rng.integers(30, h - 30), rng.integers(5, 15)
        cv2.circle(img, (int(x), int(y)), int(r), int(rng.integers(0, 255)), -1)
    img = cv2.GaussianBlur(img, (3, 3), 0.8)
    return img.astype(np.uint8)


def hamming(a, b):
    return np.unpackbits(np.bitwise_xor(a, b), axis=-1).sum(-1)


def test_descriptor_parity_with_cv2(rng):
    """Compute cv2 ORB keypoints/descriptors on level 0; our descriptor at the
    same (position, angle) must be near-identical (round-off on angle only)."""
    img = make_test_image(rng)
    det = cv2.ORB_create(nfeatures=300, nlevels=1, edgeThreshold=31, fastThreshold=20)
    kps = det.detect(img, None)
    kps, desc_cv = det.compute(img, kps)
    assert len(kps) > 100

    rows = jnp.asarray(np.array([round(k.pt[1]) for k in kps], np.int32))
    cols = jnp.asarray(np.array([round(k.pt[0]) for k in kps], np.int32))
    angles = jnp.asarray(np.array([np.deg2rad(k.angle) for k in kps], np.float32))

    blur = orb.gaussian_blur7(jnp.asarray(img))
    ours = orb.descriptors_to_bytes(orb.compute_descriptors(blur, rows, cols, angles))

    d = hamming(ours, desc_cv)
    # Identical sampling grid; differences only from fractional-center rounding
    # (cv2 samples at cvRound(pt) too) and blur fixed-point rounding.
    assert np.median(d) <= 8, f"median Hamming {np.median(d)}"
    assert (d <= 16).mean() > 0.8, f"close fraction {(d<=16).mean():.2f}"


def test_orientation_matches_cv2(rng):
    img = make_test_image(rng)
    det = cv2.ORB_create(nfeatures=300, nlevels=1, edgeThreshold=31, fastThreshold=20)
    kps = det.detect(img, None)
    kps, _ = det.compute(img, kps)
    rows = jnp.asarray(np.array([round(k.pt[1]) for k in kps], np.int32))
    cols = jnp.asarray(np.array([round(k.pt[0]) for k in kps], np.int32))
    ours = np.rad2deg(np.asarray(orb.compute_orientation(jnp.asarray(img), rows, cols))) % 360
    ref = np.array([k.angle for k in kps]) % 360
    diff = np.abs((ours - ref + 180) % 360 - 180)
    assert np.median(diff) < 2.0, f"median angle diff {np.median(diff):.2f} deg"


def test_fast_score_detects_cv2_corners(rng):
    img = make_test_image(rng)
    fast = cv2.FastFeatureDetector_create(threshold=20, nonmaxSuppression=False)
    kps_cv = fast.detect(img, None)
    mask_cv = np.zeros(img.shape, bool)
    for k in kps_cv:
        mask_cv[int(round(k.pt[1])), int(round(k.pt[0]))] = True

    score = np.asarray(orb.fast_score(jnp.asarray(img), 20.0))
    ours = score > 0
    inner = np.zeros_like(mask_cv)
    inner[10:-10, 10:-10] = True
    both = mask_cv & inner
    agree = (ours & both).sum() / max(both.sum(), 1)
    assert agree > 0.95, f"only {agree:.2%} of cv2 FAST corners detected"


def test_extract_full_pipeline(rng):
    img = make_test_image(rng)
    kp = orb.extract(jnp.asarray(img), n_features=1000, n_levels=8)
    valid = np.asarray(kp.valid)
    assert valid.sum() > 500
    xy = np.asarray(kp.xy)[valid]
    assert xy[:, 0].max() <= img.shape[1] and xy[:, 1].max() <= img.shape[0]
    # multi-level coverage
    levels = np.asarray(kp.level)[valid]
    assert len(np.unique(levels)) >= 4
    # spatial spread: keypoints in all 4 quadrants
    h, w = img.shape
    q = [(xy[:, 0] < w / 2) & (xy[:, 1] < h / 2), (xy[:, 0] >= w / 2) & (xy[:, 1] < h / 2),
         (xy[:, 0] < w / 2) & (xy[:, 1] >= h / 2), (xy[:, 0] >= w / 2) & (xy[:, 1] >= h / 2)]
    assert all(m.sum() > 20 for m in q)
    # descriptors valid & distinctive
    desc = np.asarray(kp.desc)[valid]
    assert len(np.unique(desc, axis=0)) > 0.9 * len(desc)


def test_extract_repeatability_under_shift(rng):
    """Shift image 8px; matched descriptors should mostly re-detect nearby."""
    img = make_test_image(rng)
    sh = np.roll(img, (8, 8), axis=(0, 1))
    kp1 = orb.extract(jnp.asarray(img), n_features=500, n_levels=4)
    kp2 = orb.extract(jnp.asarray(sh), n_features=500, n_levels=4)
    v1, v2 = np.asarray(kp1.valid), np.asarray(kp2.valid)
    d1 = orb.descriptors_to_bytes(kp1.desc)[v1]
    d2 = orb.descriptors_to_bytes(kp2.desc)[v2]
    xy1 = np.asarray(kp1.xy)[v1]
    xy2 = np.asarray(kp2.xy)[v2]
    # brute force match
    dm = np.array([[hamming(a[None], b[None])[0] for b in d2[:200]] for a in d1[:200]])
    best = dm.argmin(1)
    good = dm[np.arange(len(best)), best] < 40
    disp = xy2[best[good]] - xy1[:200][good]
    med = np.median(disp, axis=0)
    assert abs(med[0] - 8) < 2 and abs(med[1] - 8) < 2, f"median disp {med}"


@pytest.mark.parametrize("shape", [(64, 96), (121, 203)])
def test_fast_score_matches_numpy_segment_test(rng, shape):
    """The XLA FAST score equals the numpy brute-force segment test exactly,
    on integer images and on a resized (non-integer) pyramid level."""
    img = make_test_image(rng)[: shape[0], : shape[1]]
    got = np.asarray(orb.fast_score_raw(jnp.asarray(img)))
    np.testing.assert_array_equal(got, reference.fast_score(img))
    lvl = orb.pyramid_levels(jnp.asarray(img, jnp.float32), 2, 1.2)[1]
    np.testing.assert_array_equal(np.asarray(orb.fast_score_raw(lvl)),
                                  reference.fast_score(np.asarray(lvl)))


def test_descriptors_match_numpy_reference(rng):
    """rBRIEF over the level stacks equals the numpy steered-BRIEF reference
    bit for bit, from the same tap offsets; the offsets themselves match a
    float64 steering away from rounding ties."""
    img = jnp.asarray(make_test_image(rng))
    kp = orb.extract(img, n_features=300, n_levels=3)
    pad = orb.STACK_PAD
    _, blur = orb.level_stacks(
        orb.pyramid_levels(img.astype(jnp.float32), 3, 1.2), pad)
    rows = kp.xy_level[:, 1].astype(jnp.int32)
    cols = kp.xy_level[:, 0].astype(jnp.int32)
    got = np.asarray(orb.compute_descriptors_stacked(
        blur, kp.level, rows, cols, kp.angle, pad))
    np.testing.assert_array_equal(got, np.asarray(kp.desc))
    roff, coff = (np.asarray(x) for x in orb.steer_taps(kp.angle))
    ref = reference.brief_words(np.asarray(blur), np.asarray(kp.level),
                                np.asarray(rows), np.asarray(cols), roff, coff,
                                pad, orb._PATTERN_RADIUS)
    np.testing.assert_array_equal(got, ref)
    r64, c64, tie = reference.steer_taps(np.asarray(kp.angle))
    assert not (((roff != r64) | (coff != c64)) & ~tie).any()


@pytest.mark.parametrize("shape", [(120, 200), (376, 1241)])
def test_pyramid_and_blur_match_numpy_reference(rng, shape):
    """The float32 pyramid agrees with the float64 triangle-kernel resize
    within its sample-grid error, and the blurred level stack with a
    float64 blur of the same levels within float32 rounding."""
    img = make_test_image(rng, *shape)
    levels = orb.pyramid_levels(jnp.asarray(img, jnp.float32), 4, 1.2)
    for got, want in zip(levels, reference.pyramid(img, 4, 1.2)):
        assert got.shape == want.shape
        np.testing.assert_allclose(np.asarray(got), want, atol=0.05)
    _, blur = orb.level_stacks(levels, orb.STACK_PAD)
    np.testing.assert_allclose(
        np.asarray(blur), reference.blur_stack(levels, orb.STACK_PAD),
        atol=1e-3)


def test_descriptors_match_float64_reference_away_from_ties(rng):
    """``extract``'s descriptors equal steered BRIEF on a float64 blur of
    its levels for every test whose taps lie away from a rounding boundary
    (of the blurred value or of the steered offset)."""
    img = make_test_image(rng)
    kp = orb.extract(jnp.asarray(img), n_features=300, n_levels=3)
    levels = orb.pyramid_levels(jnp.asarray(img, jnp.float32), 3, 1.2)
    stack = reference.blur_stack(levels, orb.STACK_PAD)
    r64, c64, steer_tie = reference.steer_taps(np.asarray(kp.angle))
    want, tie = reference.brief_bits(
        stack, np.asarray(kp.level), np.asarray(kp.xy_level[:, 1]).astype(int),
        np.asarray(kp.xy_level[:, 0]).astype(int), r64, c64, orb.STACK_PAD,
        orb._PATTERN_RADIUS, tol=1e-3)
    tie |= steer_tie[:, :256] | steer_tie[:, 256:]
    off = reference.unpack_words(np.asarray(kp.desc)) != want
    assert tie.mean() < 0.02
    assert not (off & ~tie).any()
