"""Plain numpy references for the device ops of the frame path.

Written for clarity, not speed, and independent of the JAX code they check:
the smoke run compares the compiled ops with them at real widths, and the
tests at small ones.
"""

from __future__ import annotations

import numpy as np

from ._orb_pattern import PATTERN

# Bresenham circle of radius 3, OpenCV's order, as (dx, dy).
CIRCLE = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
          (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
          (-1, -3)]


def fast_score(img: np.ndarray) -> np.ndarray:
    """Ungated FAST-9/16 score: for each pixel, the best over the 16 arcs of
    9 contiguous circle pixels of the arc's least brighter-by (or
    darker-by) difference; 0 within 3 px of the border."""
    img = np.asarray(img, np.float32)
    H, W = img.shape
    p = np.pad(img, 3)
    diff = np.stack([p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - img
                     for dx, dy in CIRCLE])                  # [16, H, W]
    best = np.full((H, W), -np.inf, np.float32)
    for d in (diff, -diff):
        for start in range(16):
            arc = [(start + j) % 16 for j in range(9)]
            best = np.maximum(best, d[arc].min(axis=0))
    out = np.zeros_like(best)
    out[3:H - 3, 3:W - 3] = best[3:H - 3, 3:W - 3]
    return out


def hamming_matrix(d1: np.ndarray, d2: np.ndarray, chunk: int = 1024) -> np.ndarray:
    """[N, 8] x [M, 8] uint32 -> [N, M] int32 popcount(d1 ^ d2)."""
    d1 = np.asarray(d1, np.uint32)
    d2 = np.asarray(d2, np.uint32)
    out = np.empty((d1.shape[0], d2.shape[0]), np.int32)
    for i in range(0, d1.shape[0], chunk):
        x = d1[i:i + chunk, None, :] ^ d2[None, :, :]
        out[i:i + chunk] = _popcount32(x).sum(axis=-1, dtype=np.int32)
    return out


def _popcount32(x: np.ndarray) -> np.ndarray:
    if hasattr(np, "bitwise_count"):  # numpy >= 2.0
        return np.bitwise_count(x)
    bytes_ = x[..., None].view(np.uint8)
    return np.unpackbits(bytes_, axis=-1).sum(axis=-1)


def steer_taps(angles: np.ndarray):
    """Rotated BRIEF tap offsets in float64.

    Returns (row, col) [K, 512] int offsets rounded as cv2 does, and a mask
    of taps whose unrounded offset lies within 1e-4 of a rounding boundary,
    where a float32 evaluation may legitimately round the other way."""
    px = np.concatenate([PATTERN[:, 0], PATTERN[:, 2]]).astype(np.float64)
    py = np.concatenate([PATTERN[:, 1], PATTERN[:, 3]]).astype(np.float64)
    a = np.cos(np.asarray(angles, np.float64))[:, None]
    b = np.sin(np.asarray(angles, np.float64))[:, None]
    r = px[None] * b + py[None] * a
    c = px[None] * a - py[None] * b

    def near_half(v):
        return np.abs(np.abs(v - np.floor(v)) - 0.5) < 1e-4

    roff = np.floor(r + 0.5).astype(np.int32)
    coff = np.floor(c + 0.5).astype(np.int32)
    return roff, coff, near_half(r) | near_half(c)


def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of an antialiased linear (triangle) resize:
    the kernel widens by the downscale factor and each output's weights
    sum to one (``jax.image.resize(..., "linear")``'s definition)."""
    inv = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    return w / w.sum(axis=0, keepdims=True)


def pyramid(img: np.ndarray, n_levels: int, scale: float) -> list:
    """float64 scale-pyramid levels; level l is the image resized to
    1/scale**l (at least 64 px a side) with the triangle kernel.

    A float32 evaluation computes the sample positions in float32, where
    at x ~ 1000 they move by ~1e-4 px: on a sharp uint8 image its levels
    differ from these by up to ~0.02."""
    f = np.asarray(img, np.float64)
    H, W = f.shape
    out = [f]
    for lvl in range(1, n_levels):
        s = scale ** lvl
        Hl, Wl = max(int(round(H / s)), 64), max(int(round(W / s)), 64)
        out.append(_triangle_weights(H, Hl).T @ f @ _triangle_weights(W, Wl))
    return out


def gaussian_blur7(img: np.ndarray) -> np.ndarray:
    """float64 separable 7-tap Gaussian, sigma 2, REFLECT_101 borders."""
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-x * x / 8.0)
    k /= k.sum()
    H, W = img.shape
    p = np.pad(img, ((3, 3), (0, 0)), mode="reflect")
    f = sum(p[i:i + H] * k[i] for i in range(7))
    p = np.pad(f, ((0, 0), (3, 3)), mode="reflect")
    return sum(p[:, i:i + W] * k[i] for i in range(7))


def blur_stack(levels: list, pad: int) -> np.ndarray:
    """[n_levels, H+2p, W+2p] float64 stack of the blurred ``levels``, each
    edge-padded by ``pad`` and placed at the top-left."""
    H, W = np.shape(levels[0])
    out = np.zeros((len(levels), H + 2 * pad, W + 2 * pad))
    for i, lv in enumerate(levels):
        lv = np.asarray(lv, np.float64)
        h, w = lv.shape
        out[i, :h + 2 * pad, :w + 2 * pad] = np.pad(
            gaussian_blur7(lv), pad, mode="edge")
    return out


def brief_bits(blur_stack, lvl, rows, cols, roff, coff, pad: int,
               radius: int, tol: float = 0.0):
    """Steered BRIEF-256 tests [K, 256] bool from an edge-padded blurred
    level stack: test i holds when the (rounded) first tap of pattern pair
    i is darker than the second; taps are clipped to ``radius``.

    Also returns a [K, 256] mask of tests with a tap value within ``tol``
    of a rounding boundary, where a float32 evaluation of the same stack
    may legitimately round the other way."""
    stack = np.asarray(blur_stack)
    r = np.clip(np.asarray(roff), -radius, radius)
    c = np.clip(np.asarray(coff), -radius, radius)
    li = np.asarray(lvl)[:, None]
    vals = stack[li, np.asarray(rows)[:, None] + pad + r,
                 np.asarray(cols)[:, None] + pad + c]
    near = np.abs(np.abs(vals - np.floor(vals)) - 0.5) < tol
    vals = np.round(vals)
    return vals[:, :256] < vals[:, 256:], near[:, :256] | near[:, 256:]


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[K, 256] bool -> [K, 8] uint32, bit j of word w is test 32w + j."""
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    words = (bits.astype(np.uint64).reshape(-1, 8, 32) * weights).sum(axis=-1)
    return words.astype(np.uint32)


def unpack_words(words: np.ndarray) -> np.ndarray:
    """[K, 8] uint32 -> [K, 256] bool, the inverse of ``pack_bits``."""
    w = np.asarray(words, np.uint32)[:, :, None]
    return ((w >> np.arange(32, dtype=np.uint32)) & 1).astype(bool).reshape(
        len(w), 256)


def brief_words(blur_stack, lvl, rows, cols, roff, coff, pad: int,
                radius: int) -> np.ndarray:
    """Steered BRIEF-256 words [K, 8] uint32 (``brief_bits``, packed)."""
    bits, _ = brief_bits(np.asarray(blur_stack, np.float32), lvl, rows, cols,
                         roff, coff, pad, radius)
    return pack_bits(bits)
