"""Batched k-point plane fitting for point-to-plane residuals.

Replaces ``esti_plane`` (``LidarFrontEnd.cpp:454-482``). The reference solves,
per query point and per ESEKF iteration, the 5x3 least-squares system
``A n = -1`` in double precision. That formulation is ill-conditioned in f32
(it degenerates when the plane passes near the origin or the points are far
out), so this version fits via the centered second-moment matrix instead:
``n`` = eigenvector of the smallest eigenvalue of ``Σ (p-μ)(p-μ)^T``,
``d = -n·μ`` — closed-form symmetric-3x3 eigen math for the whole scan
(``jnp.linalg.eigh`` lowers batched 3x3 problems to a generic iterative
decomposition). The acceptance test is
the same as the reference's: every neighbor within ``threshold`` of the
plane.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..numerics import f32_highest


def _det3(B: jax.Array) -> jax.Array:
    """Cofactor-expansion 3x3 determinant: ``jnp.linalg.det`` lowers to LU,
    whose autodiff rules explode when a Hessian is taken through it."""
    return (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )


def smallest_eigval_sym3(A: jax.Array) -> jax.Array:
    """Smallest eigenvalue of symmetric [..., 3, 3], closed form.

    Trigonometric solution of the characteristic cubic — pure elementwise
    math, so both the value and its first/second derivatives (the BALM
    eigen-factor needs a Hessian through λ_min) cost a handful of flops per
    matrix, vs the generic iterative lowering of ``jnp.linalg.eigvalsh``
    and its autodiff rules. The arccos argument is clipped strictly inside
    (-1, 1): at exactly repeated eigenvalues λ_min is not differentiable
    anyway (callers keep padded/degenerate entries away from it)."""
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    I = jnp.eye(3, dtype=A.dtype)
    Aq = A - q[..., None, None] * I
    p2 = jnp.sum(Aq * Aq, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    B = Aq / p[..., None, None]
    r = _det3(B) / 2.0
    phi = jnp.arccos(jnp.clip(r, -1.0 + 1e-6, 1.0 - 1e-6)) / 3.0
    return q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)


def smallest_eigvec_sym3(A: jax.Array) -> jax.Array:
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3, 3].

    Closed form (trigonometric eigenvalues + cross-product eigenvector):
    ``jnp.linalg.eigh`` lowers batched 3x3 problems to a generic iterative
    decomposition; this form is pure elementwise math. Degenerate inputs (isotropic /
    repeated eigenvalues) return an arbitrary unit vector — callers gate on
    the plane residual test, which rejects those neighborhoods anyway."""
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    I = jnp.eye(3, dtype=A.dtype)
    Aq = A - q[..., None, None] * I
    p2 = jnp.sum(Aq * Aq, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    B = Aq / p[..., None, None]
    r = _det3(B) / 2.0
    phi = jnp.arccos(jnp.clip(r, -1.0, 1.0)) / 3.0
    # smallest eigenvalue: q + 2 p cos(phi + 2*pi/3)
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    M = A - lam_min[..., None, None] * I
    # eigenvector = kernel of M: the largest cross product of two rows
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = jnp.cross(r0, r1)
    c1 = jnp.cross(r0, r2)
    c2 = jnp.cross(r1, r2)
    n0 = jnp.sum(c0 * c0, axis=-1)
    n1 = jnp.sum(c1 * c1, axis=-1)
    n2 = jnp.sum(c2 * c2, axis=-1)
    best = jnp.where(
        (n0 >= n1)[..., None] & (n0 >= n2)[..., None], c0,
        jnp.where((n1 >= n2)[..., None], c1, c2),
    )
    nrm = jnp.linalg.norm(best, axis=-1, keepdims=True)
    fallback = jnp.zeros_like(best).at[..., 2].set(1.0)
    return jnp.where(nrm > 1e-20, best / jnp.maximum(nrm, 1e-20), fallback)


@f32_highest
def fit_planes(
    neighbors: jax.Array,   # [Q, k, 3] neighbor points
    valid: jax.Array,       # [Q, k] neighbor validity
    threshold: float = 0.1,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Fit a plane n·p + d = 0 (|n| = 1) through each neighbor set.

    Returns (normals [Q, 3], d [Q], ok [Q]); ``ok`` requires >= 3 valid
    neighbors, all valid neighbors within ``threshold`` of the plane, and a
    finite solution.
    """
    w = valid.astype(neighbors.dtype)  # [Q, k]
    cnt = jnp.maximum(jnp.sum(w, axis=-1), 1.0)  # [Q]
    mu = jnp.sum(neighbors * w[..., None], axis=-2) / cnt[..., None]  # [Q, 3]
    centered = (neighbors - mu[..., None, :]) * w[..., None]
    cov = jnp.einsum("qki,qkj->qij", centered, centered) / cnt[..., None, None]
    # smallest-eigenvalue eigenvector = plane normal (closed form)
    normals = smallest_eigvec_sym3(cov + 1e-12 * jnp.eye(3, dtype=cov.dtype))
    d = -jnp.einsum("qi,qi->q", normals, mu)

    finite = jnp.all(jnp.isfinite(normals), axis=-1) & jnp.isfinite(d)
    normals = jnp.where(finite[..., None], normals, 0.0)
    d = jnp.where(finite, d, 0.0)

    resid = jnp.abs(jnp.einsum("qki,qi->qk", neighbors, normals) + d[..., None])
    ok = jnp.all(jnp.where(valid, resid < threshold, True), axis=-1)
    ok &= jnp.sum(valid, axis=-1) >= 3
    ok &= finite
    return normals, d, ok


@f32_highest
def point_to_plane(
    points: jax.Array,   # [Q, 3] (world frame)
    normals: jax.Array,  # [Q, 3]
    d: jax.Array,        # [Q]
) -> jax.Array:
    """Signed distances n·p + d (the ESEKF measurement residual ``pd2``)."""
    return jnp.einsum("qi,qi->q", points, normals) + d
