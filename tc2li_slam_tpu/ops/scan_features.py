"""LOAM-style scan feature extraction (surf / edge), batched re-design.

Behavioral port of the reference's ``give_feature`` / ``plane_judge`` /
``edge_jump_judge`` (lidar_front_end/preprocess.cpp:200-470): classify each
point of an azimuth-ordered ring scan as planar (surf) or edge by LOCAL
geometry, emit a decimated surf set + the edge set. The reference walks each
ring sequentially with a group-growing state machine; this port replaces
the walk with fixed-radius sliding-window tests evaluated for ALL points at
once — same quantities (chord point-to-line distances, range jumps,
neighbor-spacing ratios), batched semantics:

- ``plane``: the G-point window centered at i is planar when every interior
  point sits within ``p2l_ratio`` of the window chord (plane_judge's
  two-point-distance/vx-projection test, preprocess.cpp:482-563) and the
  spacing bounds disA/disB hold.
- ``edge_jump``: a range discontinuity to either neighbor whose local beam
  geometry passes the jump_up/jump_down cosine gates (edge_jump_judge,
  preprocess.cpp:565-603), excluding occlusion shadows (the hidden side
  must not itself be near-parallel to the beam).
- ``small_plane`` smoothing: near-equal neighbor spacing with a shallow
  intersection angle upgrades points to planar
  (preprocess.cpp:391-427).
- surf decimation: every ``point_filter_num``-th point of a planar run
  (preprocess.cpp:429-460's last_surface emission).

The reference ships this path DISABLED for KITTI (feature_enabled=0 in
every config; the pipeline then voxel-downsamples raw points instead);
it exists for rigs/datasets that enable it, with the same config gate
(``LidarConfig.feature_extract``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# reference defaults (preprocess.cpp ctor, :34-60)
DIS_A = 0.01
DIS_B = 0.1
P2L_RATIO = 225.0          # (point-to-line distance)^2 ratio gate
LIMIT_MAXMID = 6.25        # spacing-uniformity gates of plane_judge
LIMIT_MIDMIN = 6.25
JUMP_UP_COS = -0.9848      # cos(170 deg)
JUMP_DOWN_COS = 0.9397     # cos(20 deg)
EDGE_A = 2.0               # neighbor-distance ratio gates of edge_jump_judge
EDGE_B = 0.1
SMALLP_INTERSECT = 172.5   # degrees
SMALLP_RATIO = 1.2
GROUP_G = 8                # plane window size (group_size)


class ScanFeatures(NamedTuple):
    surf: jax.Array    # [N] bool decimated planar points
    edge: jax.Array    # [N] bool edge points
    plane: jax.Array   # [N] bool un-decimated planar classification


def _shift(x, s):
    """Roll along the point axis; out-of-range wraps are masked by callers
    via the validity of the shifted slot."""
    return jnp.roll(x, -s, axis=0)


@partial(jax.jit, static_argnames=("point_filter_num",))
def extract_features(
    points: jax.Array,   # [N, 3] ONE ring, azimuth-ordered, sensor frame
    valid: jax.Array,    # [N]
    blind: float = 2.0,
    point_filter_num: int = 2,
) -> ScanFeatures:
    """Classify one azimuth-ordered ring; vmap over rings for a full scan."""
    N = points.shape[0]
    r = jnp.linalg.norm(points, axis=-1)
    valid = valid & (r > blind)
    nxt = _shift(points, 1)
    d_fwd = jnp.sum((nxt - points) ** 2, axis=-1)        # types[i].dista

    # --- plane test: window [i, i+G) against its chord
    G = GROUP_G
    chord = _shift(points, G - 1) - points               # [N, 3]
    chord_n2 = jnp.maximum(jnp.sum(chord * chord, -1), 1e-12)
    max_p2l = jnp.zeros(N)
    win_ok = valid
    max_spacing = jnp.zeros(N)
    min_spacing = jnp.full((N,), jnp.inf)
    for k in range(1, G - 1):
        off = _shift(points, k) - points
        # squared point-to-chord distance via the cross product
        cr = jnp.cross(off, chord)
        p2l = jnp.sum(cr * cr, -1) / chord_n2
        max_p2l = jnp.maximum(max_p2l, p2l)
        win_ok &= _shift(valid, k)
        sp = jnp.sum((_shift(points, k) - _shift(points, k - 1)) ** 2, -1)
        max_spacing = jnp.maximum(max_spacing, sp)
        min_spacing = jnp.minimum(min_spacing, sp)
    win_ok &= _shift(valid, G - 1)
    # disA/disB spacing bound scaled by range (plane_judge's two_dis gate)
    spacing_lim = (DIS_A * r + DIS_B) ** 2
    uniform = (max_spacing <= LIMIT_MAXMID * jnp.maximum(min_spacing, 1e-12))
    plane_win = (
        win_ok
        & (max_p2l * P2L_RATIO <= chord_n2)   # all interior pts near chord
        & (max_spacing <= spacing_lim)
        & uniform
    )
    # a point is planar if ANY window containing it is planar
    plane = jnp.zeros(N, bool)
    for k in range(G):
        plane |= jnp.roll(plane_win, k, axis=0)
    plane &= valid

    # --- small-plane smoothing (preprocess.cpp:391-427): near-equal
    # neighbor spacing + shallow intersection angle
    d_prev = jnp.roll(d_fwd, 1, axis=0)
    ratio = jnp.maximum(d_prev, d_fwd) / jnp.maximum(
        jnp.minimum(d_prev, d_fwd), 1e-12)
    a = points - jnp.roll(points, 1, axis=0)
    b = nxt - points
    an = jnp.maximum(jnp.linalg.norm(a, axis=-1), 1e-9)
    bn = jnp.maximum(jnp.linalg.norm(b, axis=-1), 1e-9)
    cos_i = jnp.sum(a * b, -1) / (an * bn)
    intersect_deg = 180.0 - jnp.degrees(jnp.arccos(jnp.clip(cos_i, -1, 1)))
    smallp = (intersect_deg > SMALLP_INTERSECT) & (ratio < SMALLP_RATIO)
    smallp &= valid & jnp.roll(valid, 1, axis=0) & _shift(valid, 1)
    plane |= smallp | jnp.roll(smallp, 1, axis=0) | jnp.roll(smallp, -1, axis=0)
    plane &= valid

    # --- edge jumps (edge_jump_judge): a range discontinuity where the
    # beam-to-edge angle passes the cosine gates and the near side is the
    # visible one (the reference's Nr_180 / Nr_zero direction classes)
    def jump(to_prev: bool):
        nb = jnp.roll(points, 1, axis=0) if to_prev else nxt
        nb_v = jnp.roll(valid, 1, axis=0) if to_prev else _shift(valid, 1)
        nb_r = jnp.roll(r, 1, axis=0) if to_prev else _shift(r, 1)
        e = nb - points
        en = jnp.maximum(jnp.linalg.norm(e, axis=-1), 1e-9)
        beam = points / jnp.maximum(r, 1e-9)[:, None]
        cos_b = jnp.sum(beam * e, -1) / en
        d_n = jnp.sum(e * e, -1)
        big_jump = d_n > EDGE_A * EDGE_A * jnp.minimum(
            jnp.maximum(d_prev, 1e-12), jnp.maximum(d_fwd, 1e-12))
        # a NEAR-RADIAL discontinuity (the Nr_180 / Nr_zero direction
        # classes: the step to the neighbor runs along the beam) seen from
        # the NEAR side — the visible silhouette edge; the occluded far
        # side is excluded exactly as edge_jump_judge's two_dis gate does
        radial = (cos_b < JUMP_UP_COS) | (cos_b > JUMP_DOWN_COS)
        return (nb_v & big_jump & radial & (d_n > EDGE_B) & (r < nb_r))

    edge = valid & ~plane & (jump(True) | jump(False))

    # --- surf decimation: every point_filter_num-th point of a planar run
    if point_filter_num > 1:
        idx = jnp.arange(N)
        surf = plane & ((idx % point_filter_num) == 0)
    else:
        surf = plane
    return ScanFeatures(surf=surf, edge=edge, plane=plane)


@partial(jax.jit, static_argnames=("point_filter_num",))
def extract_features_rings(
    points: jax.Array,   # [R, N, 3] ring-major organized scan
    valid: jax.Array,    # [R, N]
    blind: float = 2.0,
    point_filter_num: int = 2,
) -> ScanFeatures:
    """Full multi-ring scan: vmap of ``extract_features`` over rings."""
    f = jax.vmap(
        lambda p, v: extract_features(
            p, v, blind=blind, point_filter_num=point_filter_num)
    )(points, valid)
    return f
