"""Batched ORB feature extraction (pyramid FAST + oriented rBRIEF).

A batched re-design of the reference's ``ORBextractor``
(``slam_framework/src/ORBextractor.cc``): instead of per-cell scalar FAST
loops, a quad-tree distributor, and per-keypoint descriptor loops, every stage
is a dense array op over the whole pyramid level:

- FAST-16 corner test + score via 16 rolled comparisons and a min-over-9-run
  reduction (exact segment-test score, ORBextractor's FAST+score semantics),
- the reference's two-threshold scheme (iniThFAST=20, minThFAST=7 fallback
  per 35-px cell, ``ComputeKeyPointsOctTree``) as two masks + a cell max-pool,
- spatial distribution via per-cell cap + global top-k (replacing
  ``DistributeOctTree`` — same goal: spread N keypoints over the image),
- intensity-centroid orientation (``IC_Angle``) as one [K, 31, 31] masked
  gather + reduction,
- rBRIEF as a [K, 512] rotated-pattern gather with the standard OpenCV
  bit pattern, bit-compatible with cv2/ORB-SLAM3 descriptors so existing ORB
  vocabularies remain usable.

Descriptors are returned as [K, 8] uint32 words (= 32 bytes little-endian,
``descriptors_to_bytes`` converts to the cv2 layout).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ._orb_pattern import PATTERN

HALF_PATCH = 15
EDGE = 19  # ORB-SLAM3 EDGE_THRESHOLD

# FAST circle (dx, dy), radius 3, cv2 ordering.
_FAST_OFFS = np.array(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)],
    np.int32,
)


def _umax_table() -> np.ndarray:
    """Circular-patch row extents for IC_Angle (symmetric, OpenCV exact)."""
    umax = np.zeros(HALF_PATCH + 2, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.round(np.sqrt(225.0 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: HALF_PATCH + 1]


_UMAX = _umax_table()


def _ic_angle_weights() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mask, U, V) grids [31, 31] for the intensity centroid."""
    u = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    U, V = np.meshgrid(u, u)  # V = row offset, U = col offset
    mask = np.abs(U) <= _UMAX[np.abs(V)]
    return mask.astype(np.float32), U.astype(np.float32), V.astype(np.float32)


_IC_MASK, _IC_U, _IC_V = _ic_angle_weights()


def _gauss_kernel7(sigma: float = 2.0) -> np.ndarray:
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


_GK7 = _gauss_kernel7()

# Max |pixel offset| any rotated BRIEF tap can reach (rotation preserves the
# tap radius; +0.5 covers the round()). Bounds the descriptor patch size.
_PATTERN_RADIUS = int(np.ceil(np.sqrt(
    np.maximum(PATTERN[:, 0] ** 2 + PATTERN[:, 1] ** 2,
               PATTERN[:, 2] ** 2 + PATTERN[:, 3] ** 2).max()) + 0.5))
# Edge padding of the level stacks: covers the orientation and descriptor
# patches of any keypoint on the level.
STACK_PAD = max(HALF_PATCH, _PATTERN_RADIUS)


class Keypoints(NamedTuple):
    """Padded keypoint set for one image."""

    xy: jax.Array       # [N, 2] level-0 pixel coords (x, y), float
    xy_level: jax.Array  # [N, 2] coords on the detection level
    level: jax.Array    # [N] int32 pyramid level
    angle: jax.Array    # [N] radians
    score: jax.Array    # [N] FAST score
    desc: jax.Array     # [N, 8] uint32 rBRIEF words
    valid: jax.Array    # [N]


# ---------------------------------------------------------------------------
# FAST
# ---------------------------------------------------------------------------

def fast_score(img: jax.Array, threshold: float) -> jax.Array:
    """FAST-16 segment-test score map (0 where not a corner).

    Score = max over the 16 circular 9-runs of min(|neighbor - center|)
    restricted to runs that are all-brighter or all-darker by > threshold —
    the exact quantity OpenCV's FAST NMS ranks by.
    """
    raw = fast_score_raw(img)
    return jnp.where(raw > threshold, raw, 0.0)


def fast_score_raw(img: jax.Array) -> jax.Array:
    """Ungated FAST-16 segment-test score (may be <= 0 in flat regions).

    The threshold only ever appears as a final gate on this map, so the two
    detection thresholds of ``detect_level`` share one score computation.
    Sixteen rolled comparisons and a min-over-9-run reduction; XLA fuses the
    roll/min/max chain into a few elementwise kernels.
    """
    f = img.astype(jnp.float32)
    nbrs = jnp.stack(
        [jnp.roll(f, (-int(dy), -int(dx)), axis=(0, 1)) for dx, dy in _FAST_OFFS],
        axis=0,
    )  # [16, H, W]
    dpos = nbrs - f[None]           # brighter by
    dneg = -dpos                    # darker by
    # min over each circular window of 9
    def run_min(d):
        stacked = jnp.stack([jnp.roll(d, -s, axis=0) for s in range(9)], axis=0)
        window = jnp.min(stacked, axis=0)  # [16, H, W] min of run starting at i
        return jnp.max(window, axis=0)     # best run
    sb = run_min(dpos)
    sd = run_min(dneg)
    score = jnp.maximum(sb, sd)
    # kill borders (circle radius 3)
    H, W = img.shape
    border = jnp.zeros((H, W), bool).at[3 : H - 3, 3 : W - 3].set(True)
    return jnp.where(border, score, 0.0)


def _maxpool2d(x: jax.Array, k: int) -> jax.Array:
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (k, k), (1, 1), "SAME"
    )


def _cell_has(x: jax.Array, cell: int) -> jax.Array:
    """Per-cell any() broadcast back to pixels (cell grid of size ``cell``)."""
    H, W = x.shape
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    xp = jnp.zeros((Hp, Wp), x.dtype).at[:H, :W].set(x)
    cells = xp.reshape(Hp // cell, cell, Wp // cell, cell).max(axis=(1, 3))
    back = jnp.repeat(jnp.repeat(cells, cell, 0), cell, 1)
    return back[:H, :W]


def detect_level(
    img: jax.Array, ini_th: float = 20.0, min_th: float = 7.0, cell: int = 35
) -> jax.Array:
    """Adaptive-threshold FAST + 3x3 NMS score map (ComputeKeyPointsOctTree).

    One raw score computation serves both thresholds — they are just gates
    on the same segment-test score map.
    """
    raw = fast_score_raw(img)
    s_ini = jnp.where(raw > ini_th, raw, 0.0)
    s_min = jnp.where(raw > min_th, raw, 0.0)
    has_ini = _cell_has((s_ini > 0).astype(jnp.float32), cell) > 0
    score = jnp.where(has_ini, s_ini, s_min)
    is_max = score >= _maxpool2d(score, 3)
    score = jnp.where(is_max & (score > 0), score, 0.0)
    # detection margin: orientation patch + descriptor reach
    H, W = img.shape
    m = EDGE - 3
    inner = jnp.zeros((H, W), bool).at[m : H - m, m : W - m].set(True)
    return jnp.where(inner, score, 0.0)


def select_topk_grid(score: jax.Array, k: int, cell: int = 16) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Pick k keypoints: per-cell best first (spatial spread), then by score.

    Returns (rows [k], cols [k], scores [k]); empty slots have score 0.
    Replaces ``DistributeOctTree`` — per-cell winners get a large rank boost so
    coverage beats raw score, mirroring the quad-tree's one-per-node retention.

    Two-stage selection: NMS leaves at most a few corners per 16x16 cell, so
    a per-cell top-m (cheap reshaped reduction) feeds a global top_k over
    ~2 x n_cells candidates instead of H x W pixels — the full-image top_k
    was a sort over 466k elements per pyramid level and dominated the
    extractor's device time.
    """
    H, W = score.shape
    Hc = -(-H // cell)
    Wc = -(-W // cell)
    n_cells = Hc * Wc
    # m per-cell candidates cover k even on tiny top-pyramid levels
    m_cand = max(2, -(-k // n_cells) + 1)
    sp = jnp.full((Hc * cell, Wc * cell), -jnp.inf, score.dtype)
    sp = sp.at[:H, :W].set(score)
    cells = sp.reshape(Hc, cell, Wc, cell).transpose(0, 2, 1, 3)
    cells = cells.reshape(n_cells, cell * cell)
    cvals, cidx = jax.lax.top_k(cells, m_cand)       # [n_cells, m]
    # global candidate coordinates
    ci = jnp.arange(n_cells)[:, None]
    rows_c = (ci // Wc) * cell + cidx // cell
    cols_c = (ci % Wc) * cell + cidx % cell
    # rank: per-cell winners (slot 0) first, then raw score
    boost = jnp.zeros((n_cells, m_cand), score.dtype).at[:, 0].set(1e6)
    rank = jnp.where(jnp.isfinite(cvals) & (cvals > 0), cvals + boost,
                     -jnp.inf)
    vals, idx = jax.lax.top_k(rank.ravel(), k)
    rows = rows_c.ravel()[idx]
    cols = cols_c.ravel()[idx]
    sel_scores = cvals.ravel()[idx]
    ok = jnp.isfinite(vals) & (vals > 0)
    return (jnp.where(ok, rows, 0), jnp.where(ok, cols, 0),
            jnp.where(ok, sel_scores, 0.0))


# ---------------------------------------------------------------------------
# Orientation + descriptors
# ---------------------------------------------------------------------------

def _gather_patches(img: jax.Array, rows: jax.Array, cols: jax.Array, half: int) -> jax.Array:
    """Gather [K, 2h+1, 2h+1] patches centered at integer (rows, cols).

    vmap(dynamic_slice) over an edge-padded image; edge padding reproduces
    the per-tap clip semantics exactly (clipping an out-of-range index picks
    the border pixel, as does edge replication).
    """
    size = 2 * half + 1
    pad = jnp.pad(img, half, mode="edge")

    def one(r, c):
        return jax.lax.dynamic_slice(pad, (r, c), (size, size))

    return jax.vmap(one)(rows, cols)


def compute_orientation(img: jax.Array, rows: jax.Array, cols: jax.Array) -> jax.Array:
    """Intensity-centroid angle (radians), IC_Angle semantics."""
    patches = _gather_patches(img.astype(jnp.float32), rows, cols, HALF_PATCH)
    mask = jnp.asarray(_IC_MASK)
    m10 = jnp.sum(patches * mask * jnp.asarray(_IC_U), axis=(1, 2))
    m01 = jnp.sum(patches * mask * jnp.asarray(_IC_V), axis=(1, 2))
    return jnp.arctan2(m01, m10)


def gaussian_blur7(img: jax.Array) -> jax.Array:
    """Separable 7-tap Gaussian (sigma 2), REFLECT_101 borders — the blur the
    reference applies before computing descriptors."""
    f = img.astype(jnp.float32)
    k = jnp.asarray(_GK7)
    fp = jnp.pad(f, ((3, 3), (0, 0)), mode="reflect")
    f = sum(fp[i : i + f.shape[0], :] * k[i] for i in range(7))
    fp = jnp.pad(f, ((0, 0), (3, 3)), mode="reflect")
    f = sum(fp[:, i : i + img.shape[1]] * k[i] for i in range(7))
    return f


def steer_taps(angles: jax.Array) -> tuple[jax.Array, jax.Array]:
    """[K] angles -> (row, col) offsets [K, 512] of the rotated BRIEF taps
    (pattern points of both test sides, cv2's rounding)."""
    pat = jnp.asarray(PATTERN.astype(np.float32))  # [256, 4]
    px = jnp.concatenate([pat[:, 0], pat[:, 2]])   # [512]
    py = jnp.concatenate([pat[:, 1], pat[:, 3]])
    a = jnp.cos(angles)[:, None]
    b = jnp.sin(angles)[:, None]
    # cv2: row offset = round(x*b + y*a), col offset = round(x*a - y*b)
    roff = jnp.round(px[None] * b + py[None] * a).astype(jnp.int32)  # [K, 512]
    coff = jnp.round(px[None] * a - py[None] * b).astype(jnp.int32)
    return roff, coff


def _brief_words(patches: jax.Array, roff: jax.Array, coff: jax.Array) -> jax.Array:
    """Steered BRIEF tests on [K, S, S] descriptor patches -> [K, 8] uint32.

    Rotated taps stay inside the pattern radius, so each keypoint's 512 taps
    are one gather from its own flattened patch. Tap values are rounded to
    integers, as the reference compares uint8-blurred pixels.
    """
    R = _PATTERN_RADIUS
    S = 2 * R + 1
    flat = patches.reshape(-1, S * S)
    tap = (jnp.clip(roff, -R, R) + R) * S + (jnp.clip(coff, -R, R) + R)
    vals = jnp.round(jnp.take_along_axis(flat, tap, axis=1))  # [K, 512]
    bits = (vals[:, :256] < vals[:, 256:]).astype(jnp.uint32)  # [K, 256]
    words = bits.reshape(-1, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def compute_descriptors(
    img_blur: jax.Array,  # [H, W] float (blurred level image)
    rows: jax.Array,      # [K] int
    cols: jax.Array,      # [K] int
    angles: jax.Array,    # [K] radians
) -> jax.Array:
    """Steered BRIEF-256 -> [K, 8] uint32 (computeOrbDescriptor semantics)."""
    roff, coff = steer_taps(angles)
    patches = _gather_patches(img_blur, rows, cols, _PATTERN_RADIUS)
    return _brief_words(patches, roff, coff)


def descriptors_to_bytes(desc_words: jax.Array) -> np.ndarray:
    """[K, 8] uint32 -> [K, 32] uint8 in cv2's byte layout (little-endian)."""
    return np.asarray(desc_words).view(np.uint8).reshape(-1, 32)


def bytes_to_words(desc_bytes: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(desc_bytes).view(np.uint32).reshape(-1, 8)


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------

def features_per_level(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Geometric budget split across levels (ORBextractor ctor logic)."""
    factor = 1.0 / scale
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    per = []
    acc = 0
    for i in range(n_levels - 1):
        k = int(round(n_first * factor ** i))
        per.append(k)
        acc += k
    per.append(max(n_features - acc, 0))
    return per


def _gather_patches_stacked(stack, lvl, rows, cols, half: int, pad: int):
    """[K, 2h+1, 2h+1] patches from an edge-padded level stack
    [n_levels, H0+2p, W0+2p]; (rows, cols) are level coordinates. Each
    level was edge-padded by ``pad`` before stacking, so clamping
    semantics match the per-level path exactly."""
    size = 2 * half + 1
    off = pad - half

    def one(li, r, c):
        sl = jax.lax.dynamic_slice(
            stack, (li, r + off, c + off), (1, size, size))
        return sl[0]

    return jax.vmap(one)(lvl, rows, cols)


def compute_orientation_stacked(stack, lvl, rows, cols, pad: int):
    patches = _gather_patches_stacked(stack, lvl, rows, cols, HALF_PATCH, pad)
    mask = jnp.asarray(_IC_MASK)
    m10 = jnp.sum(patches * mask * jnp.asarray(_IC_U), axis=(1, 2))
    m01 = jnp.sum(patches * mask * jnp.asarray(_IC_V), axis=(1, 2))
    return jnp.arctan2(m01, m10)


def compute_descriptors_stacked(blur_stack, lvl, rows, cols, angles, pad: int):
    roff, coff = steer_taps(angles)
    patches = _gather_patches_stacked(
        blur_stack, lvl, rows, cols, _PATTERN_RADIUS, pad)
    return _brief_words(patches, roff, coff)


def pyramid_levels(f: jax.Array, n_levels: int, scale: float) -> list[jax.Array]:
    """Scale-pyramid level images (level 0 is ``f`` itself)."""
    H, W = f.shape
    levels = [f]
    for lvl in range(1, n_levels):
        s = scale ** lvl
        Hl, Wl = max(int(round(H / s)), 64), max(int(round(W / s)), 64)
        levels.append(jax.image.resize(f, (Hl, Wl), "linear"))
    return levels


def level_stacks(levels: list[jax.Array], pad: int) -> tuple[jax.Array, jax.Array]:
    """Edge-padded [n_levels, H0+2p, W0+2p] stacks of the level images and of
    their Gaussian-blurred copies (the descriptor input)."""
    H, W = levels[0].shape
    shape = (len(levels), H + 2 * pad, W + 2 * pad)
    img_stack = jnp.zeros(shape, jnp.float32)
    blur_stack = jnp.zeros(shape, jnp.float32)
    for lvl, li in enumerate(levels):
        Hl, Wl = li.shape
        img_stack = img_stack.at[lvl, : Hl + 2 * pad, : Wl + 2 * pad].set(
            jnp.pad(li, pad, mode="edge"))
        blur_stack = blur_stack.at[lvl, : Hl + 2 * pad, : Wl + 2 * pad].set(
            jnp.pad(gaussian_blur7(li), pad, mode="edge"))
    return img_stack, blur_stack


@partial(jax.jit, static_argnames=("n_features", "n_levels", "scale", "ini_th", "min_th"))
def extract(
    img: jax.Array,  # [H, W] uint8/float grayscale
    n_features: int = 2000,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
) -> Keypoints:
    """Full pyramid ORB extraction, padded to ``n_features`` keypoints.

    Detection/selection run per level (they need the level grids); the
    gather-bound orientation + rBRIEF run ONCE over all levels' keypoints
    against edge-padded level stacks, so the descriptor gathers see one
    batch of ``n_features`` keypoints instead of eight small ones."""
    per_level = features_per_level(n_features, n_levels, scale)
    levels = pyramid_levels(img.astype(jnp.float32), n_levels, scale)
    pad = STACK_PAD
    img_stack, blur_stack = level_stacks(levels, pad)
    parts = []
    for lvl, lvl_img in enumerate(levels):
        score = detect_level(lvl_img, ini_th, min_th)
        rows, cols, scores = select_topk_grid(score, per_level[lvl])
        parts.append((rows, cols, scores, lvl, scale ** lvl))

    rows_all = jnp.concatenate([p[0] for p in parts])
    cols_all = jnp.concatenate([p[1] for p in parts])
    scores_all = jnp.concatenate([p[2] for p in parts])
    lvl_all = jnp.concatenate([
        jnp.full((p[0].shape[0],), p[3], jnp.int32) for p in parts])
    s_all = jnp.concatenate([
        jnp.full((p[0].shape[0],), p[4], jnp.float32) for p in parts])

    angles = compute_orientation_stacked(
        img_stack, lvl_all, rows_all, cols_all, pad)
    desc = compute_descriptors_stacked(
        blur_stack, lvl_all, rows_all, cols_all, angles, pad)
    xy_level = jnp.stack([cols_all, rows_all], -1).astype(jnp.float32)
    return Keypoints(
        xy=xy_level * s_all[:, None],
        xy_level=xy_level,
        level=lvl_all,
        angle=angles,
        score=scores_all,
        desc=desc,
        valid=scores_all > 0,
    )
