"""Batched two-view triangulation.

Replaces ``GeometricTools::Triangulate`` (``GeometricTools.cc:77``, used by
``LocalMapping::CreateNewMapPoints``) with a batched DLT: for each match we
build the 4x4 design matrix from the two projective rows and take the
smallest-singular-vector — all matches triangulated in one ``svd`` over a
``[N, 4, 4]`` stack (no per-point loop).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def triangulate_dlt(
    xn1: jax.Array,  # [N, 2] normalized image coords in cam1 (x/z, y/z)
    xn2: jax.Array,  # [N, 2] normalized image coords in cam2
    T1w: jax.Array,  # [4, 4] or [N, 4, 4] world->cam1
    T2w: jax.Array,  # [4, 4] or [N, 4, 4] world->cam2
) -> jax.Array:
    """Returns world points [N, 3] minimizing algebraic error."""
    P1 = jnp.broadcast_to(T1w[..., :3, :], xn1.shape[:-1] + (3, 4))
    P2 = jnp.broadcast_to(T2w[..., :3, :], xn2.shape[:-1] + (3, 4))
    rows = [
        xn1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        xn1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        xn2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        xn2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = jnp.stack(rows, axis=-2)  # [N, 4, 4]
    # Smallest right singular vector of A.
    _, _, Vt = jnp.linalg.svd(A)
    Xh = Vt[..., 3, :]
    w = Xh[..., 3]
    w_safe = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / w_safe[..., None]


def parallax_cos(
    p_world: jax.Array, c1: jax.Array, c2: jax.Array
) -> jax.Array:
    """cos of ray parallax angle per point (KF-pair baseline test,
    ``LocalMapping.cc:402`` ff. uses cosParallaxRays < 0.9998)."""
    r1 = p_world - c1
    r2 = p_world - c2
    num = jnp.sum(r1 * r2, axis=-1)
    den = jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1)
    return num / jnp.maximum(den, 1e-12)
