"""BALM2 plane eigen-factor for LiDAR bundle adjustment.

Batched re-design of the reference's BALM machinery (``bavoxel.h``:
``cut_voxel`` world-frame voxelization, ``OCTO_TREE_NODE::recut`` adaptive
plane test, ``VOX_HESS::acc_evaluate2`` analytic per-voxel Jacobian/Hessian;
``LidarRes.cc``: window accumulation + chain rule; ``G2oTypesWithLidar``:
the g2o multi-edge injecting the dense cross-pose Hessian).

Key re-designs:

- **Point clusters, not points, at optimization time.** Following BALM2's
  point-cluster insight, per-(voxel, keyframe) second-moment accumulators
  (N, Σp, Σpp^T) are built ONCE in each keyframe's LiDAR frame; during
  optimization only the 10-number clusters are rigidly transformed and
  summed — the cost per LM iteration is independent of point count.
- **Fixed-depth voxelization.** The reference's octree is capped at
  ``layer_limit=2`` anyway (bavoxel.cc); we voxelize at the configured sizes
  (1 m root; optionally a finer pass), keep the voxels whose total cluster
  passes the plane test (min points, eigenvalue-ratio — ``judge_eigen``,
  bavoxel.h:492), padded to a static voxel capacity.
- **Autodiff J/H instead of 400 lines of hand-derived blocks.** The cost
  ``Σ_v N_v λ_min(cov_v)`` is a closed differentiable function of the window
  pose tangents; ``jax.grad`` + forward-over-reverse ``jax.hessian`` on the
  6W-dim tangent reproduce ``acc_evaluate2``'s analytic Hessian exactly
  (verified against finite differences in tests). W <= ~8 keeps the Hessian
  tiny.
- Numerical anchoring is per voxel: clusters are stored centered (mean +
  scatter) and evaluated in world-minus-voxel-anchor coordinates, a stronger
  f32-safe version of the reference's re-anchoring at the first window pose
  (``LidarRes.cc:52-54``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom import lie
from ..numerics import f32_highest


class VoxelClusters(NamedTuple):
    """Per-(voxel, window-KF) point clusters in each KF's LiDAR frame.

    Stored in CENTERED form: per-cluster mean + within-cluster scatter
    (Σ (p-m)(p-m)^T). With the first moment identically zero, the rigid
    transform of a cluster has no cross terms and every quantity stays
    O(voxel_size) — f32-exact where raw Σpp^T moments (|p| ~ 10-100 m)
    catastrophically cancel. Equivalent information to BALM2's PointCluster
    (tools.h:163), just in the numerically stable basis.
    """

    N: jax.Array      # [V, W] point counts
    mean: jax.Array   # [V, W, 3] cluster mean, LiDAR frame
    Pc: jax.Array     # [V, W, 3, 3] centered scatter Σ (p-m)(p-m)^T
    center: jax.Array  # [V, 3] build-time world voxel center (f32 anchor)
    valid: jax.Array  # [V] voxel passes the plane test


@f32_highest
def _cluster_pass(key, pts_l, pts_w, kf, W, max_voxels, dtype):
    """One voxelization pass: accumulate centered per-(voxel, KF) clusters.

    ``key`` [WM] int32 (BIG = excluded). Returns (N, mean, Pc, centers,
    slot_of_point [WM] in ORIGINAL point order; max_voxels = overflow)."""
    BIG = jnp.iinfo(jnp.int32).max
    WM = key.shape[0]
    order = jnp.argsort(key)
    key_s = key[order]
    head = jnp.concatenate([jnp.array([True]), key_s[1:] != key_s[:-1]])
    head &= key_s != BIG
    vox_of_sorted = jnp.cumsum(head.astype(jnp.int32)) - 1
    vox_of_sorted = jnp.where(key_s != BIG, vox_of_sorted, max_voxels)
    vox_of_sorted = jnp.clip(vox_of_sorted, 0, max_voxels)

    pts_l_s = pts_l[order]
    kf_s = kf[order]
    wgt = (key_s != BIG).astype(dtype)
    idx = (vox_of_sorted, kf_s)
    N = jnp.zeros((max_voxels + 1, W), dtype).at[idx].add(wgt)
    S = jnp.zeros((max_voxels + 1, W, 3), dtype).at[idx].add(
        pts_l_s * wgt[:, None]
    )
    mean = S / jnp.maximum(N, 1.0)[..., None]
    centered = (pts_l_s - mean[idx]) * wgt[:, None]
    Pc = jnp.zeros((max_voxels + 1, W, 3, 3), dtype).at[idx].add(
        jnp.einsum("mi,mj->mij", centered, centered)
    )
    Sw_sum = jnp.zeros((max_voxels + 1, 3), dtype).at[(vox_of_sorted,)].add(
        pts_w[order] * wgt[:, None]
    )[:max_voxels]
    N, mean, Pc = N[:max_voxels], mean[:max_voxels], Pc[:max_voxels]
    n_tot0 = jnp.maximum(jnp.sum(N, axis=1), 1.0)
    centers = Sw_sum / n_tot0[:, None]
    # slot per point in ORIGINAL order (inverse permutation scatter)
    slot_orig = jnp.zeros(WM, jnp.int32).at[order].set(vox_of_sorted)
    return N, mean, Pc, centers, slot_orig


def _plane_test(N, mean, Pc, centers, T_wl, min_points, ratio):
    c = VoxelClusters(N, mean, Pc, centers, jnp.ones(N.shape[0], bool))
    cov, n_tot = _total_cov(c, T_wl)
    evals = jnp.linalg.eigvalsh(cov)  # ascending
    lam0, lam1 = evals[:, 0], evals[:, 1]
    planar = (n_tot >= min_points) & (lam0 < ratio * jnp.maximum(lam1, 1e-9))
    return planar, n_tot


@partial(jax.jit, static_argnames=("voxel_size", "max_voxels", "min_points",
                                   "plane_ratio", "child_ratio", "refine"))
def build_clusters(
    points: jax.Array,   # [W, M, 3] surf points per window KF, LiDAR frame
    valid: jax.Array,    # [W, M]
    T_wl: jax.Array,     # [W, 4, 4] initial world-from-lidar poses
    voxel_size: float = 1.0,
    max_voxels: int = 512,
    min_points: int = 15,
    plane_ratio: float = 1.0 / 36.0,
    child_ratio: float = 1.0 / 25.0,
    refine: bool = True,
) -> VoxelClusters:
    """cut_voxel + adaptive two-level plane harvest, vectorized.

    Voxel membership is fixed using the *initial* poses (exactly the
    reference's behavior: ``cut_voxel`` hashes world coordinates once per
    window build). Root voxels that pass the plane test (>= ``min_points``
    and λ_min/λ_mid < ``plane_ratio`` — judge_eigen with
    eigen_value_array[0] = 1/36, bavoxel.cc:30-39) are harvested directly;
    non-planar roots SPLIT once into half-size children tested with
    ``child_ratio`` (eigen_value_array[1] = 1/25) — the fixed-depth
    equivalent of ``OCTO_TREE_NODE::recut`` at the layer_limit=2 the
    reference runs on KITTI. Planar roots + planar children are compacted
    into ``max_voxels`` padded slots.
    """
    W, M, _ = points.shape
    dtype = points.dtype
    p_w = jax.vmap(lie.se3_apply)(T_wl, points)           # [W, M, 3]
    pts = p_w.reshape(-1, 3)
    pts_l = points.reshape(-1, 3)
    val = valid.reshape(-1)
    kf = jnp.repeat(jnp.arange(W, dtype=jnp.int32), M)
    BIG = jnp.iinfo(jnp.int32).max

    # Root keys on a 512^3 grid centered at the window centroid (9 bits per
    # axis so a child key = root*8 + octant still fits in int32).
    center = jnp.sum(jnp.where(val[:, None], pts, 0.0), axis=0) / jnp.maximum(
        jnp.sum(val), 1
    )
    rel_f = (pts - center) / voxel_size
    rel = jnp.floor(rel_f).astype(jnp.int32) + 256
    in_grid = jnp.all((rel >= 0) & (rel < 512), axis=-1) & val
    key_root = (rel[:, 0] << 18) | (rel[:, 1] << 9) | rel[:, 2]
    key_root = jnp.where(in_grid, key_root, BIG)

    N, mean, Pc, centers, slot_pt = _cluster_pass(
        key_root, pts_l, pts, kf, W, max_voxels, dtype
    )
    planar_root, n_tot = _plane_test(
        N, mean, Pc, centers, T_wl, min_points, plane_ratio
    )

    if not refine:
        return VoxelClusters(N, mean, Pc, centers, planar_root)

    # Split points of big-but-nonplanar roots into half-size children.
    splittable = (~planar_root) & (n_tot >= min_points)
    pt_split = (slot_pt < max_voxels) & splittable[jnp.clip(slot_pt, 0, max_voxels - 1)]
    frac = rel_f - jnp.floor(rel_f)
    octant = (
        (frac[:, 0] >= 0.5).astype(jnp.int32)
        | ((frac[:, 1] >= 0.5).astype(jnp.int32) << 1)
        | ((frac[:, 2] >= 0.5).astype(jnp.int32) << 2)
    )
    key_child = jnp.where(
        pt_split & (key_root != BIG), key_root * 8 + octant, BIG
    )
    Nc, meanc, Pcc, centersc, _ = _cluster_pass(
        key_child, pts_l, pts, kf, W, max_voxels, dtype
    )
    planar_child, _ = _plane_test(
        Nc, meanc, Pcc, centersc, T_wl, min_points, child_ratio
    )

    # Harvest: planar roots first, then planar children; compact to capacity.
    N2 = jnp.concatenate([N, Nc], axis=0)
    mean2 = jnp.concatenate([mean, meanc], axis=0)
    Pc2 = jnp.concatenate([Pc, Pcc], axis=0)
    cen2 = jnp.concatenate([centers, centersc], axis=0)
    val2 = jnp.concatenate([planar_root, planar_child], axis=0)
    sel = jnp.argsort(~val2)[:max_voxels]
    return VoxelClusters(
        N2[sel], mean2[sel], Pc2[sel], cen2[sel], val2[sel]
    )


@partial(jax.jit, static_argnames=("n_marg",))
@f32_highest
def marginalize(c: VoxelClusters, T_wl_marg: jax.Array, n_marg: int) -> VoxelClusters:
    """Fold the first ``n_marg`` window columns into ONE fixed prior column
    (``OCTO_TREE_NODE::to_margi``, bavoxel.h:604-637): their moments are
    rigidly transformed to world at the given (final) poses and summed; the
    prior re-enters as column 0 whose "pose" is identity — the caller keeps
    that pose fixed, so the eigen cost sees the old scans as a constant.
    Exact: rigid transforms of second moments lose nothing.

    Returns clusters with W' = W - n_marg + 1 columns; pair with
    ``T_wl' = concat([eye, T_wl[n_marg:]])``.
    """
    cm = c._replace(N=c.N[:, :n_marg], mean=c.mean[:, :n_marg],
                    Pc=c.Pc[:, :n_marg])
    S_q, P_q = _transform_moments(cm, T_wl_marg[:n_marg])
    N_m = jnp.sum(cm.N, axis=1)                         # [V]
    S_m = jnp.sum(S_q, axis=1)                          # [V, 3] voxel-centered
    P_m = jnp.sum(P_q, axis=1)                          # [V, 3, 3]
    n = jnp.maximum(N_m, 1.0)
    mu = S_m / n[:, None]
    Pc_m = P_m - N_m[:, None, None] * jnp.einsum("vi,vj->vij", mu, mu)
    # store the UN-centered world centroid: the identity "pose" of the prior
    # column re-subtracts the voxel anchor inside _transform_moments
    mean_col = mu + c.center
    return VoxelClusters(
        N=jnp.concatenate([N_m[:, None], c.N[:, n_marg:]], axis=1),
        mean=jnp.concatenate([mean_col[:, None, :], c.mean[:, n_marg:]], axis=1),
        Pc=jnp.concatenate([Pc_m[:, None, :, :], c.Pc[:, n_marg:]], axis=1),
        center=c.center,
        valid=c.valid,
    )


@f32_highest
def _transform_moments(c: "VoxelClusters", T_wl: jax.Array):
    """Transform all (voxel, KF) clusters to voxel-centered world coords.

    With centered storage the cluster in world-minus-anchor coordinates is
    mean' = R m + t - center (O(voxel)) and scatter' = R Pc R^T; the first
    moment of the centered part is exactly zero so there are no cross terms.
    Returns (S_q [V, W, 3], P_q [V, W, 3, 3]) — the Σq and Σqq^T moments.
    """
    R = lie.rotation(T_wl)          # [W, 3, 3]
    t = lie.translation(T_wl)       # [W, 3]
    m_w = jnp.einsum("wij,vwj->vwi", R, c.mean) + (
        t[None, :, :] - c.center[:, None, :]
    )                                                    # [V, W, 3]
    RPR = jnp.einsum("wij,vwjk,wlk->vwil", R, c.Pc, R)   # [V, W, 3, 3]
    S_q = c.N[..., None] * m_w
    P_q = RPR + c.N[..., None, None] * jnp.einsum("vwi,vwj->vwij", m_w, m_w)
    return S_q, P_q


@f32_highest
def _total_cov(c: VoxelClusters, T_wl: jax.Array):
    """Total voxel-centered covariance per voxel given window poses [W, 4, 4].

    Numerical anchoring is PER VOXEL (each voxel's build-time centroid is
    subtracted inside the rigid transform) — a stronger version of the
    reference's window re-anchoring at mPose0 (LidarRes.cc:52-54). The
    covariance is exactly invariant to the shift, and every moment stays
    O(voxel_size) so f32 does not cancel.
    """
    Sw, Pw = _transform_moments(c, T_wl)
    N_tot = jnp.sum(c.N, axis=1)                      # [V]
    S_tot = jnp.sum(Sw, axis=1)                       # [V, 3]
    P_tot = jnp.sum(Pw, axis=1)                       # [V, 3, 3]
    n = jnp.maximum(N_tot, 1.0)
    mu = S_tot / n[:, None]
    cov = P_tot / n[:, None, None] - jnp.einsum("vi,vj->vij", mu, mu)
    # Invalid/padded voxels get a fixed well-separated spectrum: exactly
    # repeated eigenvalues NaN the eigh autodiff even under a zero weight
    # (0 * nan = nan), so never let them reach eigvalsh.
    safe = jnp.diag(jnp.asarray([1.0, 2.0, 3.0], cov.dtype))
    cov = jnp.where(c.valid[:, None, None], cov, safe)
    cov = cov + 1e-9 * jnp.eye(3, dtype=cov.dtype)
    return cov, N_tot


def eigen_cost(c: VoxelClusters, T_wl: jax.Array) -> jax.Array:
    """Window cost Σ_v coe_v · λ_min(cov_v), coe = N (evaluate_only_residual,
    bavoxel.h:276; coe accumulation bavoxel.h:66-71).

    λ_min via the closed-form trigonometric solution (ops/plane_fit):
    ``quadratic`` takes a 6W-dim Hessian through this cost, and the
    elementwise form is ~20x cheaper to doubly-differentiate than
    ``eigvalsh``'s decomposition-based autodiff rules."""
    from ..ops.plane_fit import smallest_eigval_sym3
    cov, N_tot = _total_cov(c, T_wl)
    lam_min = smallest_eigval_sym3(cov)
    w = c.valid.astype(cov.dtype) * N_tot
    return jnp.sum(w * lam_min)


@f32_highest
def _cost_of_tangent(xi: jax.Array, c: VoxelClusters, T_wl0: jax.Array) -> jax.Array:
    """Cost as a function of stacked right-tangent updates [W*6]."""
    W = T_wl0.shape[0]
    dT = lie.se3_exp(xi.reshape(W, 6))
    return eigen_cost(c, T_wl0 @ dT)


class BalmQuad(NamedTuple):
    H: jax.Array     # [6W, 6W]
    g: jax.Array     # [6W]
    cost: jax.Array


@partial(jax.jit, static_argnames=())
def quadratic(c: VoxelClusters, T_wl: jax.Array) -> BalmQuad:
    """Exact gradient + Hessian of the eigen cost at the current poses
    (right perturbation per pose) — the payload the reference injects via
    ``EdgeLidar::constructQuadraticForm``."""
    W = T_wl.shape[0]
    xi0 = jnp.zeros(W * 6, T_wl.dtype)
    cost, g = jax.value_and_grad(_cost_of_tangent)(xi0, c, T_wl)
    H = jax.hessian(_cost_of_tangent)(xi0, c, T_wl)
    return BalmQuad(H, g, cost)


def gradient(c: VoxelClusters, T_wl: jax.Array):
    W = T_wl.shape[0]
    xi0 = jnp.zeros(W * 6, T_wl.dtype)
    return jax.value_and_grad(_cost_of_tangent)(xi0, c, T_wl)


# ---------------------------------------------------------------------------
# Standalone BALM solve (used for LiDAR-only window refinement + tests)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("iters",))
@f32_highest
def optimize_window(
    c: VoxelClusters,
    T_wl0: jax.Array,   # [W, 4, 4]
    iters: int = 10,
    fix_first: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Damped-Newton minimization of the eigen cost over window poses
    (the inner loop of BALM2's ``damping_iter``). Pose 0 is gauge-fixed."""
    W = T_wl0.shape[0]
    D = 6 * W

    def step(carry, _):
        T, lam, cost_prev = carry
        q = quadratic(c, T)
        free = jnp.ones(D, T.dtype)
        if fix_first:
            free = free.at[:6].set(0.0)
        H = q.H * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
        H = H + lam * jnp.diag(jnp.abs(jnp.diag(H))) + 1e-7 * jnp.eye(D, dtype=T.dtype)
        delta = -jnp.linalg.solve(H, q.g * free)
        T_new = T @ lie.se3_exp(delta.reshape(W, 6))
        cost_new = eigen_cost(c, T_new)
        accept = cost_new < cost_prev
        T = jnp.where(accept, T_new, T)
        lam = jnp.where(accept, lam * 0.3, lam * 5.0)
        cost = jnp.where(accept, cost_new, cost_prev)
        return (T, lam, cost), cost

    cost0 = eigen_cost(c, T_wl0)
    (T, _, cost), _ = jax.lax.scan(
        step, (T_wl0, jnp.asarray(1e-4, T_wl0.dtype), cost0), None, length=iters
    )
    return T, cost
