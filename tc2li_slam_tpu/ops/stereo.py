"""Batched stereo keypoint matching with subpixel refinement.

Replaces ``Frame::ComputeStereoMatches`` (``Frame.cc:841``): the reference
builds per-row candidate lists, finds the best descriptor match per left
keypoint within a disparity range, then refines u_r by sliding an 11x11
image patch +-5 px and fitting a parabola to the SAD curve. Here the
candidate structure is a dense [N, M] predicate (row band, octave gate,
disparity range) over one Hamming matrix, and the SAD refinement gathers all
[N, 11, 21] patch strips in one shot.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import matching

SAD_W = 5      # half window (11x11 patches)
SAD_L = 5      # slide +-5 px


def match_stereo(
    kpl_uv: jax.Array,      # [N, 2] left keypoints (level-0 coords)
    kpl_level: jax.Array,   # [N]
    kpl_desc: jax.Array,    # [N, 8]
    kpl_valid: jax.Array,   # [N]
    kpr_uv: jax.Array,      # [M, 2] right keypoints
    kpr_level: jax.Array,   # [M]
    kpr_desc: jax.Array,    # [M, 8]
    kpr_valid: jax.Array,   # [M]
    scale_factors: jax.Array,  # [L] per-level scale (1.2**l)
    bf: jax.Array,          # baseline * fx
    min_z: jax.Array,       # minimum depth (= baseline)
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Descriptor stage: returns (right_idx [N], disparity [N], valid [N]).

    Row band: |v_l - v_r| <= 2 * scale(level_r); disparity in [minD, maxD]
    with minD = 0, maxD = bf / min_z (Frame.cc:854-860).
    """
    max_d = bf / min_z
    band = 2.0 * scale_factors[kpr_level]          # [M]
    dv = jnp.abs(kpl_uv[:, None, 1] - kpr_uv[None, :, 1])
    row_ok = dv <= band[None, :]
    disp = kpl_uv[:, None, 0] - kpr_uv[None, :, 0]  # [N, M]
    disp_ok = (disp >= -2.0) & (disp <= max_d)
    lvl_ok = matching.level_mask(kpl_level, kpr_level)
    mask = row_ok & disp_ok & lvl_ok
    # mutual L<->R best agreement + ratio test: repetitive texture makes
    # one-directional Hamming matches unreliable; the reference relies on
    # the SAD stage to catch these — the mutual+ratio gates remove most
    # gross mismatches up front (they are the dominant source of
    # catastrophic stereo depths).
    idx, dist, ok = matching.match_descriptors(
        kpl_desc, kpr_desc, kpl_valid, kpr_valid, mask,
        max_dist=matching.TH_HIGH, ratio=0.9, mutual=True,
    )
    disparity = jnp.clip(kpl_uv[:, 0] - kpr_uv[idx, 0], 0.01, None)
    return idx, disparity, ok


def subpixel_refine(
    img_l: jax.Array,   # [H, W] level-0 left image (float)
    img_r: jax.Array,   # [H, W] level-0 right image
    kpl_uv: jax.Array,  # [N, 2]
    ur0: jax.Array,     # [N] initial right u (level-0 coords)
    valid: jax.Array,   # [N]
) -> tuple[jax.Array, jax.Array]:
    """Parabola-refined right u + SAD outlier gate (Frame.cc:900-960).

    The reference runs this on the pyramid-level images; we run on level 0
    (equivalent up to the scale of the window — level-0 keypoints dominate on
    KITTI and the parabola interpolation is scale-invariant).
    """
    N = kpl_uv.shape[0]
    H, W = img_l.shape
    r = jnp.round(kpl_uv[:, 1]).astype(jnp.int32)
    cl = jnp.round(kpl_uv[:, 0]).astype(jnp.int32)
    cr = jnp.round(ur0).astype(jnp.int32)
    # A predicted right-strip center outside the image cannot be refined:
    # dynamic_slice would clamp the START index, silently shifting the whole
    # window (different border semantics than per-pixel clipping) — reject
    # instead, and clamp the centers so padded/invalid rows slice in-range.
    valid = valid & (cr >= 0) & (cr < W) & (r >= 0) & (r < H)
    r = jnp.clip(r, 0, H - 1)
    cl = jnp.clip(cl, 0, W - 1)
    cr = jnp.clip(cr, 0, W - 1)

    # vmap(dynamic_slice) over edge-padded images instead of [N, 11, ...]
    # advanced-index gathers; edge padding reproduces index clipping
    # exactly (border replication == clamp).
    W_L = SAD_W + SAD_L
    pad_l = jnp.pad(img_l.astype(jnp.float32), SAD_W, mode="edge")
    pad_r = jnp.pad(img_r.astype(jnp.float32), W_L, mode="edge")

    def _patch_l(rr_, cc_):
        return jax.lax.dynamic_slice(
            pad_l, (rr_, cc_), (2 * SAD_W + 1, 2 * SAD_W + 1))

    def _strip_r(rr_, cc_):
        return jax.lax.dynamic_slice(
            pad_r, (rr_ + SAD_L, cc_), (2 * SAD_W + 1, 2 * W_L + 1))

    # pad shifts coords by +half, slice wants the top-left corner: the two
    # cancel so the center coord itself is the start index
    patch_l = jax.vmap(_patch_l)(r, cl)                   # [N, 11, 11]
    patch_l = patch_l - patch_l[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
    strip = jax.vmap(_strip_r)(r, cr)                     # [N, 11, 21]

    sads = []
    for off in range(2 * SAD_L + 1):
        win = strip[:, :, off : off + 2 * SAD_W + 1]
        win = win - win[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
        sads.append(jnp.sum(jnp.abs(win - patch_l), axis=(1, 2)))
    sad = jnp.stack(sads, axis=-1)  # [N, 11]

    best = jnp.argmin(sad, axis=-1)
    best_c = jnp.clip(best, 1, 2 * SAD_L - 1)
    s_m = jnp.take_along_axis(sad, (best_c - 1)[:, None], axis=1)[:, 0]
    s_0 = jnp.take_along_axis(sad, best_c[:, None], axis=1)[:, 0]
    s_p = jnp.take_along_axis(sad, (best_c + 1)[:, None], axis=1)[:, 0]
    denom = jnp.maximum(2.0 * (s_m + s_p - 2.0 * s_0), 1e-6)
    delta = (s_m - s_p) / denom
    delta = jnp.clip(delta, -1.0, 1.0)
    ur = cr.astype(jnp.float32) + (best_c - SAD_L).astype(jnp.float32) + delta
    ok = valid & (jnp.abs(delta) <= 1.0)

    # median-SAD outlier gate (reference: keep dist < 1.5 * 1.4 * median)
    best_sad = s_0
    med = jnp.median(jnp.where(ok, best_sad, jnp.nan))
    thr = 2.1 * jnp.nan_to_num(med, nan=jnp.inf)
    ok &= best_sad <= thr
    return ur, ok


def stereo_depth(
    disparity: jax.Array, bf: jax.Array, valid: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Disparity -> depth with positivity gate."""
    ok = valid & (disparity > 0)
    z = bf / jnp.maximum(disparity, 1e-6)
    return jnp.where(ok, z, 0.0), ok
