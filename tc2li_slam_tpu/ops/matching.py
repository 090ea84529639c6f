"""Batched binary-descriptor matching (Hamming via XOR + popcount).

Replaces ``ORBmatcher`` (``slam_framework/src/ORBmatcher.cc``): all of its
search variants are per-keypoint loops over a 64x48 candidate grid — a CPU
cache trick. On the device the whole [N, M] masked Hamming matrix is cheaper
than pointer-chasing, so every matcher here is:

    distance matrix (popcount of XOR over [.., 8] uint32 words)
    + a predicate mask (window / scale-level / epipolar / radius gates)
    + row-wise top-2 with ratio + threshold tests
    + optional rotation-histogram consistency (ComputeThreeMaxima).

Thresholds mirror the reference: TH_LOW=50, TH_HIGH=100, ratio 0.6-0.9,
HISTO_LENGTH=30 (ORBmatcher.h).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30


def hamming_matrix(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """[N, 8] x [M, 8] uint32 -> [N, M] int32 Hamming distances (XOR +
    popcount over the eight words)."""
    x = jnp.bitwise_xor(d1[:, None, :], d2[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def hamming_pairs(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """Rowwise distances for aligned pairs [N, 8], [N, 8] -> [N]."""
    x = jnp.bitwise_xor(d1, d2)
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def _masked_best2(dist: jax.Array, mask: jax.Array):
    """Per-row best and second-best over masked columns.

    Returns (best_idx [N], best [N], second [N]); masked-out = BIG.
    Three plain min/argmin reductions instead of ``lax.top_k``, which sorts
    each row of the [N, M] matrix.
    """
    BIG = jnp.int32(1 << 20)
    d = jnp.where(mask, dist, BIG)
    best = jnp.min(d, axis=1)
    idx = jnp.argmin(d, axis=1)
    d2 = jnp.where(jnp.arange(d.shape[1])[None, :] == idx[:, None], BIG, d)
    second = jnp.min(d2, axis=1)
    return idx, best, second


def match_descriptors(
    d1: jax.Array, d2: jax.Array,
    valid1: jax.Array, valid2: jax.Array,
    mask: jax.Array | None = None,   # [N, M] extra predicate
    max_dist: int = TH_LOW,
    ratio: float = 1.0,
    mutual: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Generic guarded NN match: returns (idx2 [N], dist [N], matched [N])."""
    dist = hamming_matrix(d1, d2)
    full_mask = valid1[:, None] & valid2[None, :]
    if mask is not None:
        full_mask &= mask
    idx, best, second = _masked_best2(dist, full_mask)
    ok = (best <= max_dist) & valid1
    if ratio < 1.0:
        ok &= best.astype(jnp.float32) <= ratio * second.astype(jnp.float32)
    if mutual:
        BIG = jnp.int32(1 << 20)
        dm = jnp.where(full_mask, dist, BIG)
        back = jnp.argmin(dm, axis=0)  # best row for each column
        ok &= back[idx] == jnp.arange(d1.shape[0])
    return idx, best, ok


def rotation_consistency(
    angles1: jax.Array, angles2: jax.Array, idx: jax.Array, matched: jax.Array,
    keep_bins: int = 3,
) -> jax.Array:
    """Keep matches whose angle difference falls in the 3 dominant histogram
    bins (ORBmatcher::ComputeThreeMaxima semantics, 30 bins over 2*pi)."""
    diff = (angles1 - angles2[idx]) % (2 * jnp.pi)
    bins = jnp.clip(
        (diff * (HISTO_LENGTH / (2 * jnp.pi))).astype(jnp.int32), 0, HISTO_LENGTH - 1
    )
    hist = jnp.zeros(HISTO_LENGTH, jnp.int32).at[bins].add(matched.astype(jnp.int32))
    top_vals, top_idx = jax.lax.top_k(hist, keep_bins)
    # reference also drops bins < 0.1 * max
    good_bin = (hist[bins] > 0) & jnp.any(
        (bins[:, None] == top_idx[None, :])
        & (top_vals[None, :] >= (0.1 * top_vals[0]).astype(jnp.int32)),
        axis=-1,
    )
    return matched & good_bin


def window_mask(
    uv1: jax.Array,      # [N, 2] predicted positions in image 2
    uv2: jax.Array,      # [M, 2] keypoint positions in image 2
    radius: jax.Array,   # [N] search radius per query (scale-dependent)
) -> jax.Array:
    """Search-window predicate |du| < r, |dv| < r (SearchByProjection)."""
    du = jnp.abs(uv1[:, None, 0] - uv2[None, :, 0])
    dv = jnp.abs(uv1[:, None, 1] - uv2[None, :, 1])
    r = radius[:, None]
    return (du < r) & (dv < r)


def level_mask(
    lvl1: jax.Array, lvl2: jax.Array, lo: int = -1, hi: int = 1
) -> jax.Array:
    """Octave compatibility predicate (level2 in [level1+lo, level1+hi])."""
    d = lvl2[None, :] - lvl1[:, None]
    return (d >= lo) & (d <= hi)


def search_by_projection(
    uv_proj: jax.Array,    # [N, 2] projected map points
    pred_level: jax.Array,  # [N] predicted octave
    d_map: jax.Array,      # [N, 8] map point descriptors
    valid_map: jax.Array,  # [N]
    kp_uv: jax.Array,      # [M, 2] frame keypoints
    kp_level: jax.Array,   # [M]
    kp_desc: jax.Array,    # [M, 8]
    kp_valid: jax.Array,   # [M]
    radius: jax.Array,     # [N] window radius in pixels (incl. scale factor)
    max_dist: int = TH_HIGH,
    ratio: float = 0.9,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Map-point -> frame-keypoint guided match (ORBmatcher.cc:56h overload).

    Returns (kp_idx [N], dist [N], matched [N]): for each map point the best
    frame keypoint inside its window/level gate passing distance+ratio tests.
    """
    mask = window_mask(uv_proj, kp_uv, radius) & level_mask(pred_level, kp_level)
    return match_descriptors(
        d_map, kp_desc, valid_map, kp_valid, mask, max_dist, ratio
    )


def resolve_duplicates(idx: jax.Array, dist: jax.Array, matched: jax.Array,
                       m_size: int) -> jax.Array:
    """Keep only the best query per target (a frame keypoint may win several
    map points; the reference resolves this via its per-kp bookkeeping)."""
    BIG = jnp.int32(1 << 20)
    d = jnp.where(matched, dist, BIG)
    best_for_target = jnp.full((m_size,), BIG, jnp.int32).at[idx].min(d)
    is_best = d <= best_for_target[idx]
    # tie-break by query index: first query with the best distance wins
    N = idx.shape[0]
    qidx = jnp.arange(N, dtype=jnp.int32)
    q_big = jnp.where(is_best & matched, qidx, N)
    first_q = jnp.full((m_size,), N, jnp.int32).at[idx].min(q_big)
    return matched & is_best & (first_q[idx] == qidx)


def epipolar_mask(
    uv1: jax.Array,   # [N, 2] keypoints in view 1
    uv2: jax.Array,   # [M, 2] keypoints in view 2
    F12: jax.Array,   # [3, 3] fundamental matrix view1 -> view2
    sigma2: jax.Array,  # [M] per-level squared sigma of view-2 keypoints
    thresh: float = 3.84,
) -> jax.Array:
    """Point-to-epiline distance gate (CheckDistEpipolarLine, ORBmatcher.cc)."""
    ones1 = jnp.ones((uv1.shape[0], 1), uv1.dtype)
    x1 = jnp.concatenate([uv1, ones1], axis=-1)  # [N, 3]
    lines = x1 @ F12.T                            # [N, 3] epilines in view 2
    num = jnp.abs(
        lines[:, None, 0] * uv2[None, :, 0]
        + lines[:, None, 1] * uv2[None, :, 1]
        + lines[:, None, 2]
    )
    den2 = lines[:, 0] ** 2 + lines[:, 1] ** 2
    d2 = num * num / jnp.maximum(den2[:, None], 1e-12)
    return d2 < thresh * sigma2[None, :]
