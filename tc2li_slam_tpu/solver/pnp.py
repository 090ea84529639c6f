"""Batched-hypothesis PnP RANSAC.

Replaces ``MLPnPsolver`` (``MLPnPsolver.cpp``, used only by relocalization —
Tracking.cc:3517-3552): instead of a sequential RANSAC loop with a
maximum-likelihood nullspace solver, all hypotheses run as one batch — each
hypothesis solves the 6-point DLT (P-matrix from SVD of the [2n, 12] design,
rotation snapped to SO(3)), inliers are counted for all hypotheses at once,
and the winner is polished by the standard pose-only LM.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom import camera as cam_mod, lie
from ..numerics import f32_highest
from . import lm as lm_mod


def _dlt_pose(X: jax.Array, xn: jax.Array) -> jax.Array:
    """DLT pose from n>=6 correspondences: world points [n, 3], normalized
    image coords [n, 2] -> T_cw [4, 4] (rotation SVD-orthogonalized)."""
    n = X.shape[0]
    ones = jnp.ones((n, 1), X.dtype)
    Xh = jnp.concatenate([X, ones], axis=-1)  # [n, 4]
    zero = jnp.zeros_like(Xh)
    # rows: [X 0 -x*X ; 0 X -y*X]
    r1 = jnp.concatenate([Xh, zero, -xn[:, 0:1] * Xh], axis=-1)
    r2 = jnp.concatenate([zero, Xh, -xn[:, 1:2] * Xh], axis=-1)
    A = jnp.concatenate([r1, r2], axis=0)     # [2n, 12]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    p = Vt[-1].reshape(3, 4)
    R_raw = p[:, :3]
    # scale + sign: det(R) > 0, unit-ish scale
    scale = jnp.cbrt(jnp.abs(jnp.linalg.det(R_raw)) + 1e-12)
    sgn = jnp.sign(jnp.linalg.det(R_raw))
    p = p * (sgn / jnp.maximum(scale, 1e-12))
    R = lie.orthogonalize(p[:, :3])
    t = p[:, 3]
    return lie.se3(R, t)


class PnPResult(NamedTuple):
    T_cw: jax.Array
    inliers: jax.Array    # [N]
    n_inliers: jax.Array
    ok: jax.Array


@partial(jax.jit, static_argnames=("n_hyp", "min_pts"))
@f32_highest
def pnp_ransac(
    cam: cam_mod.Pinhole,
    X_w: jax.Array,        # [N, 3]
    uv: jax.Array,         # [N, 2]
    valid: jax.Array,      # [N]
    key: jax.Array,        # PRNG key
    n_hyp: int = 64,
    min_pts: int = 6,
    thresh_px: float = 4.0,
    min_inliers: int = 12,
) -> PnPResult:
    """Batched RANSAC + DLT + pose-only polish (MLPnPsolver::iterate role)."""
    N = X_w.shape[0]
    xn = jnp.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], axis=-1
    )
    # weighted sampling of valid indices: use gumbel-top-k per hypothesis
    logits = jnp.where(valid, 0.0, -jnp.inf)
    keys = jax.random.split(key, n_hyp)

    def one_hyp(k):
        g = jax.random.gumbel(k, (N,)) + logits
        idx = jax.lax.top_k(g, min_pts)[1]
        return _dlt_pose(X_w[idx], xn[idx])

    Ts = jax.vmap(one_hyp)(keys)                    # [H, 4, 4]

    # count inliers for all hypotheses at once
    Xc = jnp.einsum("hij,nj->hni", Ts[:, :3, :3], X_w) + Ts[:, None, :3, 3]
    z = Xc[..., 2]
    pred_u = cam.fx * Xc[..., 0] / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z) + cam.cx
    pred_v = cam.fy * Xc[..., 1] / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z) + cam.cy
    err2 = (pred_u - uv[None, :, 0]) ** 2 + (pred_v - uv[None, :, 1]) ** 2
    inl = (err2 < thresh_px ** 2) & (z > 0.1) & valid[None, :]
    counts = jnp.sum(inl, axis=-1)                  # [H]
    best = jnp.argmax(counts)
    T_best = Ts[best]
    inliers = inl[best]
    ok = counts[best] >= min_inliers

    # polish with pose-only LM on the inlier set (stereo column unused)
    uvr = jnp.concatenate([uv, -jnp.ones((N, 1), uv.dtype)], axis=-1)
    res = lm_mod.pose_only_optimize(
        cam, T_best, X_w, uvr, jnp.ones(N, uv.dtype),
        jnp.zeros(N, bool), inliers, rounds=2, iters=8,
    )
    return PnPResult(res.T_cw, res.inliers, res.n_inliers, ok)
