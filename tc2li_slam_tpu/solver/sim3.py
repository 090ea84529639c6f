"""Sim(3) estimation (Horn/Umeyama + batched RANSAC) and pose-graph GN.

Replaces ``Sim3Solver`` (Sim3Solver.cc — shipped dead in the reference but a
declared capability target) and g2o's ``OptimizeEssentialGraph``
(sim3 types, removed from the reference's Optimizer): loop-closure geometric
verification and the essential-graph relaxation that propagates a loop
correction through the keyframe chain.

- ``umeyama``: closed-form s, R, t between 3D point sets (batched).
- ``sim3_ransac``: hypotheses from 3-point minimal sets, all evaluated in one
  batch; inliers by symmetric reprojection-free 3D distance.
- ``pose_graph_optimize``: Gauss-Newton on Sim3 poses with relative-pose
  constraints r = log(S_ij * S_i * S_j^-1) (the essential-graph edges:
  spanning tree + covisibility + loop edge), dense solve — a pose graph of
  K keyframes is only 7K dims.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom import lie
from ..numerics import f32_highest


@f32_highest
def umeyama(
    src: jax.Array,   # [..., N, 3]
    dst: jax.Array,   # [..., N, 3]
    w: jax.Array,     # [..., N] weights
    with_scale: bool = True,
) -> jax.Array:
    """Weighted closed-form Sim3 aligning src -> dst (packed 4x4 with sR)."""
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    mu_s = jnp.sum(src * w[..., None], axis=-2) / wsum
    mu_d = jnp.sum(dst * w[..., None], axis=-2) / wsum
    cs = (src - mu_s[..., None, :]) * w[..., None]
    cd = dst - mu_d[..., None, :]
    cov = jnp.einsum("...ni,...nj->...ij", cd, cs) / wsum[..., None]
    U, D, Vt = jnp.linalg.svd(cov)
    det = jnp.linalg.det(U @ Vt)
    S = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    R = (U * S[..., None, :]) @ Vt
    if with_scale:
        var_s = jnp.sum(jnp.sum(cs * (src - mu_s[..., None, :]), axis=-1), axis=-1) / wsum[..., 0]
        s = jnp.sum(D * S, axis=-1) / jnp.maximum(var_s, 1e-12)
    else:
        s = jnp.ones(R.shape[:-2], R.dtype)
    t = mu_d - s[..., None] * jnp.einsum("...ij,...j->...i", R, mu_s)
    return lie.sim3(s, R, t)


class Sim3Result(NamedTuple):
    S: jax.Array          # [4, 4] packed Sim3 dst<-src
    inliers: jax.Array    # [N]
    n_inliers: jax.Array
    ok: jax.Array


@partial(jax.jit, static_argnames=("n_hyp", "with_scale"))
@f32_highest
def sim3_ransac(
    src: jax.Array,    # [N, 3] points in frame A
    dst: jax.Array,    # [N, 3] matched points in frame B
    valid: jax.Array,  # [N]
    key: jax.Array,
    n_hyp: int = 128,
    thresh: float = 0.3,
    min_inliers: int = 12,
    with_scale: bool = False,   # stereo/LiDAR: scale observable -> SE3
) -> Sim3Result:
    """Batched 3-point Sim3 RANSAC (Sim3Solver::iterate role)."""
    N = src.shape[0]
    logits = jnp.where(valid, 0.0, -jnp.inf)
    keys = jax.random.split(key, n_hyp)

    def hyp(k):
        g = jax.random.gumbel(k, (N,)) + logits
        idx = jax.lax.top_k(g, 3)[1]
        return umeyama(src[idx], dst[idx], jnp.ones(3), with_scale)

    Ss = jax.vmap(hyp)(keys)                      # [H, 4, 4]
    pred = jnp.einsum("hij,nj->hni", Ss[:, :3, :3], src) + Ss[:, None, :3, 3]
    d = jnp.linalg.norm(pred - dst[None], axis=-1)
    inl = (d < thresh) & valid[None]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    inliers = inl[best]
    # refine on all inliers
    S = umeyama(src, dst, inliers.astype(src.dtype), with_scale)
    pred2 = lie.sim3_apply(S, src)
    inliers2 = (jnp.linalg.norm(pred2 - dst, axis=-1) < thresh) & valid
    S = umeyama(src, dst, inliers2.astype(src.dtype), with_scale)
    n = jnp.sum(inliers2)
    return Sim3Result(S, inliers2, n, n >= min_inliers)


# ---------------------------------------------------------------------------
# Pose-graph optimization
# ---------------------------------------------------------------------------

class PoseGraphEdges(NamedTuple):
    i: jax.Array       # [E] int32
    j: jax.Array       # [E]
    S_ij: jax.Array    # [E, 4, 4] measured S_i * S_j^-1 (world->frame convention)
    weight: jax.Array  # [E]
    valid: jax.Array   # [E]


@partial(jax.jit, static_argnames=("iters",))
@f32_highest
def pose_graph_optimize(
    S_w: jax.Array,           # [K, 4, 4] packed Sim3 (world->kf), init
    edges: PoseGraphEdges,
    fixed: jax.Array,         # [K] bool
    iters: int = 20,
) -> jax.Array:
    """GN on r_e = log(S_ij * S_j * S_i^-1) over Sim3 poses
    (OptimizeEssentialGraph semantics; right-multiplicative tangent updates,
    autodiff Jacobians — the graph is small, exactness beats hand-derived
    blocks)."""
    K = S_w.shape[0]
    D = 7 * K
    free = jnp.repeat((~fixed).astype(S_w.dtype), 7)

    def gn_step(carry, _):
        S_cur, cost_prev = carry
        xi0 = jnp.zeros(D, S_w.dtype)

        def res_at(xi_flat):
            xi = xi_flat.reshape(K, 7)
            S = S_cur @ lie.sim3_exp(xi)
            Si = S[edges.i]
            Sj = S[edges.j]
            err = edges.S_ij @ Sj @ lie.sim3_inverse(Si)
            r = lie.sim3_log(err)
            w = (edges.weight * edges.valid.astype(r.dtype))[:, None]
            return (r * jnp.sqrt(w)).reshape(-1)

        J = jax.jacfwd(res_at)(xi0)               # [7E, 7K]
        r = res_at(xi0)
        J = J * free[None, :]
        H = J.T @ J + 1e-6 * jnp.eye(D, dtype=S_w.dtype) + jnp.diag(1.0 - free)
        g = J.T @ r
        dx = -jnp.linalg.solve(H, g) * free
        S_new = S_cur @ lie.sim3_exp(dx.reshape(K, 7))
        # evaluate cost at the new state
        Si = S_new[edges.i]
        Sj = S_new[edges.j]
        err = edges.S_ij @ Sj @ lie.sim3_inverse(Si)
        rn = lie.sim3_log(err)
        w = (edges.weight * edges.valid.astype(rn.dtype))[:, None]
        cost_new = jnp.sum(w * rn * rn)
        accept = cost_new < cost_prev
        S_out = jnp.where(accept, S_new, S_cur)
        return (S_out, jnp.where(accept, cost_new, cost_prev)), cost_new

    # initial cost
    Si = S_w[edges.i]
    Sj = S_w[edges.j]
    err = edges.S_ij @ Sj @ lie.sim3_inverse(Si)
    r0 = lie.sim3_log(err)
    w0 = (edges.weight * edges.valid.astype(r0.dtype))[:, None]
    cost0 = jnp.sum(w0 * r0 * r0)
    (S_fin, _), _ = jax.lax.scan(gn_step, (S_w, cost0), None, length=iters)
    return S_fin
