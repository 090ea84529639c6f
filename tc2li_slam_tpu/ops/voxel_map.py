"""Incremental LiDAR map on the device: sorted voxel-key point pool.

Replaces the reference's ikd-Tree (``/root/reference/slam_framework/include/
ikd-Tree/ikd_Tree.{h,cpp}``: incremental kd-tree with kNN, on-tree voxel
downsample, box deletes, and a background rebalance pthread). A pointer tree
with lazy rebuilds is the wrong shape for XLA; instead the map is a fixed
capacity pool of points kept **sorted by packed voxel key**, which makes every
operation a batched primitive:

- *kNN query*  -> ``searchsorted`` the keys of the 3x3x3 neighbor voxels,
  gather a fixed number of candidates per voxel, top-k by distance
  (replaces ``KD_TREE::Nearest_Search``).
- *insert*     -> per-voxel downsample of the new batch (sort + segment
  reduce), drop points whose voxel is already occupied (the on-tree
  downsample semantics of ``KD_TREE::Add_Points``), then an O(N+B)
  merge by rank = position + searchsorted(other, keys)
  (no rebuild thread needed — the structure is always "balanced").
- *box evict*  -> mask + stable compaction via cumsum (replaces
  ``Delete_Point_Boxes`` / ``lasermap_fov_segment``'s far-cube deletes).

The voxel grid is anchored to a moving integer origin; when the sensor
approaches the box edge the origin shifts and keys are recomputed + re-sorted
(rare, mirrors ``lasermap_fov_segment``, ``LidarFrontEnd.cpp:183-231``).

Keys pack 3 x 10-bit local indices into an int32 (grid of 1024^3 voxels);
empty slots hold ``EMPTY_KEY`` = int32 max so they sort to the tail.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

GRID_BITS = 10  # voxels per axis = 2**GRID_BITS = 1024
GRID_SIZE = 1 << GRID_BITS
EMPTY_KEY = jnp.iinfo(jnp.int32).max


class VoxelMap(NamedTuple):
    """Fixed-capacity voxel-hashed point map (all arrays device-resident)."""

    points: jax.Array      # [N, 3] f32 world coords (undefined where ~valid)
    keys: jax.Array        # [N] int32 packed voxel keys, ascending; EMPTY_KEY pad
    origin: jax.Array      # [3] f32 world position of voxel (0,0,0) corner
    voxel_size: jax.Array  # [] f32
    count: jax.Array       # [] int32 number of valid points

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def create(capacity: int, voxel_size: float, origin=(0.0, 0.0, 0.0)) -> VoxelMap:
    """Empty map centered so ``origin`` maps to the middle of the grid."""
    origin = jnp.asarray(origin, jnp.float32)
    corner = origin - (GRID_SIZE / 2.0) * voxel_size
    return VoxelMap(
        points=jnp.zeros((capacity, 3), jnp.float32),
        keys=jnp.full((capacity,), EMPTY_KEY, jnp.int32),
        origin=corner,
        voxel_size=jnp.float32(voxel_size),
        count=jnp.int32(0),
    )


def voxel_indices(m: VoxelMap, pts: jax.Array) -> jax.Array:
    """World points [..., 3] -> integer voxel coords [..., 3] (may be out of grid)."""
    return jnp.floor((pts - m.origin) / m.voxel_size).astype(jnp.int32)


def pack_key(idx: jax.Array) -> jax.Array:
    """Integer voxel coords [..., 3] -> int32 key; out-of-grid -> EMPTY_KEY."""
    in_grid = jnp.all((idx >= 0) & (idx < GRID_SIZE), axis=-1)
    key = (idx[..., 0] << (2 * GRID_BITS)) | (idx[..., 1] << GRID_BITS) | idx[..., 2]
    return jnp.where(in_grid, key, EMPTY_KEY)


def point_keys(m: VoxelMap, pts: jax.Array) -> jax.Array:
    return pack_key(voxel_indices(m, pts))


# ---------------------------------------------------------------------------
# Insert
# ---------------------------------------------------------------------------

@jax.jit
def insert(m: VoxelMap, pts: jax.Array, valid: jax.Array) -> VoxelMap:
    """Insert a batch of world points [B, 3] (mask ``valid`` [B]).

    Semantics follow ``map_incremental`` (``LidarFrontEnd.cpp:387-435``):
    at most one stored point per voxel; voxels already occupied keep their
    existing point. On overflow the newest points are dropped (the reference
    instead relies on box deletes to bound memory; we do both).

    Cost: ONE stable argsort of the N+B concatenated keys and O(N+B)-sized
    scatters.
    """
    B = pts.shape[0]
    N = m.capacity
    keys0 = jnp.where(valid, point_keys(m, pts), EMPTY_KEY)

    # The merge IS one stable sort of the concatenated runs: on equal keys
    # the map entry sorts first (stable sort, map segment precedes the
    # batch), so marking equal-to-predecessor entries as duplicates
    # implements both occupied-voxel rejection and in-batch dedup at once.
    comb_keys = jnp.concatenate([m.keys, keys0])
    comb_pts = jnp.concatenate([m.points, pts])
    order = jnp.argsort(comb_keys, stable=True)
    k_s = comb_keys[order]
    p_s = comb_pts[order]
    dup = jnp.concatenate(
        [jnp.zeros((1,), bool), k_s[1:] == k_s[:-1]]
    ) & (k_s != EMPTY_KEY)
    keep = (~dup) & (k_s != EMPTY_KEY)

    # compact survivors to the front; overflow (rank >= N) and duplicates
    # fall into the drop lane past the end (largest keys dropped — same
    # truncation the rank-merge applied)
    rank = jnp.cumsum(keep.astype(jnp.int32)) - 1
    idx = jnp.where(keep, rank, N + B)
    out_keys = jnp.full((N + B + 1,), EMPTY_KEY, jnp.int32).at[idx].set(
        jnp.where(keep, k_s, EMPTY_KEY))
    out_pts = jnp.zeros((N + B + 1, 3), jnp.float32).at[idx].set(p_s)

    return m._replace(
        points=out_pts[:N],
        keys=out_keys[:N],
        count=jnp.minimum(jnp.sum(keep).astype(jnp.int32), N),
    )


# ---------------------------------------------------------------------------
# kNN query
# ---------------------------------------------------------------------------

def _neighbor_offsets(radius: int) -> jnp.ndarray:
    r = jnp.arange(-radius, radius + 1)
    ox, oy, oz = jnp.meshgrid(r, r, r, indexing="ij")
    return jnp.stack([ox.ravel(), oy.ravel(), oz.ravel()], axis=-1).astype(jnp.int32)


def _column_offsets(radius: int) -> jnp.ndarray:
    r = jnp.arange(-radius, radius + 1)
    ox, oy = jnp.meshgrid(r, r, indexing="ij")
    return jnp.stack([ox.ravel(), oy.ravel()], axis=-1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("k", "radius", "per_voxel"))
def knn(
    m: VoxelMap,
    queries: jax.Array,  # [Q, 3]
    k: int = 5,
    radius: int = 1,
    per_voxel: int = 1,  # kept for API compat; the map stores 1 pt/voxel
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """k nearest stored points for each query (replaces ``Nearest_Search``).

    Candidates come from the ``(2*radius+1)^3`` voxel neighborhood. The key
    packing makes a fixed-(x, y) column of voxels CONTIGUOUS in key space, so
    only one binary search per column of the neighborhood is needed
    ((2r+1)^2 instead of (2r+1)^3 searchsorteds over the big key pool): the
    run of
    slots [pos(key_lo), pos(key_lo)+2r+1) covers every stored point of the
    column, validated by key <= key_hi. Returns
    (dists [Q, k], points [Q, k, 3], valid [Q, k]) with dists sorted asc.
    """
    del per_voxel
    Q = queries.shape[0]
    W = 2 * radius + 1
    cols = _column_offsets(radius)  # [C2, 2]
    qidx = voxel_indices(m, queries)  # [Q, 3]
    col_idx = qidx[:, None, :2] + cols[None, :, :]  # [Q, C2, 2]
    z_lo = jnp.clip(qidx[:, 2] - radius, 0, GRID_SIZE - 1)
    z_hi = jnp.clip(qidx[:, 2] + radius, 0, GRID_SIZE - 1)
    lo3 = jnp.concatenate(
        [col_idx, jnp.broadcast_to(z_lo[:, None, None], (Q, cols.shape[0], 1))],
        axis=-1,
    )
    key_lo = pack_key(lo3)                       # [Q, C2]
    key_hi = key_lo + (z_hi - z_lo)[:, None]     # same column, top of z range
    pos0 = jnp.searchsorted(
        m.keys, key_lo.reshape(-1), method="sort"
    ).reshape(key_lo.shape).astype(jnp.int32)  # [Q, C2]

    run = jnp.arange(W, dtype=jnp.int32)
    cand_pos = jnp.clip(
        pos0[..., None] + run, 0, m.capacity - 1
    ).reshape(Q, -1)                              # [Q, C2*W]
    cand_keys = m.keys[cand_pos]
    lo_b = jnp.repeat(key_lo, W, axis=-1)
    hi_b = jnp.repeat(key_hi, W, axis=-1)
    cand_valid = (
        (cand_keys >= lo_b) & (cand_keys <= hi_b)
        & (cand_keys != EMPTY_KEY) & (lo_b != EMPTY_KEY)
    )
    cand_pts = m.points[cand_pos]  # [Q, C2*W, 3]

    d2 = jnp.sum((cand_pts - queries[:, None, :]) ** 2, axis=-1)
    d2 = jnp.where(cand_valid, d2, jnp.inf)
    # top-k smallest via negated top_k (lax.top_k gives largest)
    neg_d2, sel = jax.lax.top_k(-d2, k)  # [Q, k]
    dists = jnp.sqrt(jnp.maximum(-neg_d2, 0.0))
    sel_pts = jnp.take_along_axis(cand_pts, sel[..., None], axis=1)
    sel_valid = jnp.take_along_axis(cand_valid, sel, axis=1)
    return dists, sel_pts, sel_valid


# ---------------------------------------------------------------------------
# Eviction / recentering
# ---------------------------------------------------------------------------

@jax.jit
def evict_outside_box(m: VoxelMap, center: jax.Array, half_extent) -> VoxelMap:
    """Remove points outside an axis-aligned box (FOV segment deletes).

    Stable compaction preserves the ascending key order.
    """
    keep = jnp.all(jnp.abs(m.points - center) <= half_extent, axis=-1)
    keep &= m.keys != EMPTY_KEY
    return _compact(m, keep)


def _compact(m: VoxelMap, keep: jax.Array) -> VoxelMap:
    N = m.capacity
    new_pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    idx = jnp.where(keep, new_pos, N)  # dropped -> scatter to overflow slot
    out_keys = jnp.full((N + 1,), EMPTY_KEY, jnp.int32).at[idx].set(
        jnp.where(keep, m.keys, EMPTY_KEY)
    )
    out_pts = jnp.zeros((N + 1, 3), jnp.float32).at[idx].set(m.points)
    return m._replace(
        points=out_pts[:N],
        keys=out_keys[:N],
        count=jnp.sum(keep).astype(jnp.int32),
    )


@jax.jit
def recenter(m: VoxelMap, center: jax.Array) -> VoxelMap:
    """Shift the grid origin so ``center`` is mid-grid; evict out-of-grid points.

    Call when the sensor approaches the box edge (``lasermap_fov_segment``'s
    MOV_THRESHOLD logic lives in the caller). Shifts by whole voxels so
    surviving points keep exact voxel alignment, then re-keys and re-sorts.
    """
    target_corner = center - (GRID_SIZE / 2.0) * m.voxel_size
    shift_vox = jnp.round((target_corner - m.origin) / m.voxel_size)
    new_origin = m.origin + shift_vox * m.voxel_size
    m2 = m._replace(origin=new_origin)
    new_keys = jnp.where(
        m.keys != EMPTY_KEY, point_keys(m2, m.points), EMPTY_KEY
    )
    order = jnp.argsort(new_keys)
    return m2._replace(
        points=m.points[order],
        keys=new_keys[order],
        count=jnp.sum(new_keys != EMPTY_KEY).astype(jnp.int32),
    )


def needs_recenter(m: VoxelMap, pos: jax.Array, margin: float) -> jax.Array:
    """True when ``pos`` is within ``margin`` meters of the grid boundary."""
    rel = (pos - m.origin) / m.voxel_size
    margin_vox = margin / m.voxel_size
    return jnp.any((rel < margin_vox) | (rel > GRID_SIZE - margin_vox))
