"""Batched Lie-group operations: SO(3), SE(3), Sim(3).

A batched replacement for the reference's vendored Sophus
(``/root/reference/slam_framework/Thirdparty/Sophus``) — every op is a pure
function over arrays with arbitrary leading batch dimensions, safe under
``jit``/``vmap``/``grad``, with Taylor-series branches (via ``jnp.where``) at
the identity so there is no data-dependent control flow.

Conventions
-----------
- Rotations are 3x3 matrices ``[..., 3, 3]``; SE(3) is a 4x4 homogeneous
  matrix ``[..., 4, 4]``; Sim(3) is ``(s, R, t)``-packed into a 4x4 with
  ``sR`` in the upper-left block.
- Tangent vectors: so3 = ``[..., 3]``; se3 = ``[..., 6]`` ordered
  ``(rho, phi)`` = (translation, rotation), matching Sophus' ``SE3::log``;
  sim3 = ``[..., 7]`` ordered ``(rho, phi, sigma)``.
- ``exp``/``log`` are exact inverses on the principal branch; right/left
  Jacobians follow Barfoot's conventions: ``exp(phi + dphi) ~= exp(phi)
  exp(Jr(phi) dphi)``.

All angle thresholds switch to Taylor series below ``_EPS`` = 5e-3 — in f32
the closed forms (1-cos θ)/θ² etc. cancel catastrophically well above the
usual 1e-6 threshold, so the switchover is early and the series carry θ⁴
terms (series error ~1e-13 at the boundary, far below f32 ulp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..numerics import f32_highest

_EPS = 5e-3


def _safe_theta(w: jax.Array) -> jax.Array:
    """|w| with a NaN-free gradient at w = 0 (norm's grad is 0/0 there).

    The floor only moves theta by <= 1e-12, far below the Taylor-branch
    threshold, so values are unchanged; reverse-mode gets w/theta_floor = 0.
    """
    return jnp.sqrt(jnp.maximum(jnp.sum(w * w, axis=-1), 1e-24))


# ---------------------------------------------------------------------------
# so(3)
# ---------------------------------------------------------------------------

def hat(w: jax.Array) -> jax.Array:
    """so3 hat: [..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of :func:`hat`: [..., 3, 3] -> [..., 3]."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc(x: jax.Array) -> jax.Array:
    """sin(x)/x with Taylor fallback."""
    small = jnp.abs(x) < _EPS
    xs = jnp.where(small, 1.0, x)  # avoid 0/0 in the false branch
    x2 = x * x
    return jnp.where(small, 1.0 - x2 / 6.0 + x2 * x2 / 120.0, jnp.sin(xs) / xs)


def _cosc(x: jax.Array) -> jax.Array:
    """(1 - cos(x)) / x**2 with Taylor fallback."""
    small = jnp.abs(x) < _EPS
    xs = jnp.where(small, 1.0, x)
    x2 = x * x
    return jnp.where(small, 0.5 - x2 / 24.0 + x2 * x2 / 720.0, (1.0 - jnp.cos(xs)) / (xs * xs))


def _sinc3(x: jax.Array) -> jax.Array:
    """(x - sin(x)) / x**3 with Taylor fallback."""
    small = jnp.abs(x) < _EPS
    xs = jnp.where(small, 1.0, x)
    x2 = x * x
    return jnp.where(
        small,
        1.0 / 6.0 - x2 / 120.0 + x2 * x2 / 5040.0,
        (xs - jnp.sin(xs)) / (xs * xs * xs),
    )


@f32_highest
def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues: so3 tangent [..., 3] -> rotation matrix [..., 3, 3]."""
    theta = _safe_theta(w)
    W = hat(w)
    W2 = W @ W
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> so3 tangent [..., 3] (principal branch).

    Handles theta ~ 0 (Taylor) and theta ~ pi (axis from diagonal of
    ``(R + I)/2``) without data-dependent branching.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # theta via atan2(sin, cos): arccos has an infinite derivative at the
    # identity (exactly where pose-graph/BA residuals live), which NaNs any
    # autodiff through log; atan2 is smooth there.
    w_skew = vee(R - jnp.swapaxes(R, -1, -2))  # = 2 sin(theta) * axis
    sin_theta = 0.5 * jnp.sqrt(
        jnp.maximum(jnp.sum(w_skew * w_skew, axis=-1), 1e-24)
    )
    theta = jnp.arctan2(sin_theta, cos_theta)

    # Generic: w = theta / (2 sin(theta)) * vee(R - R^T)
    generic = 0.5 / _sinc(theta)[..., None] * w_skew

    # Near pi: |sin| ~ 0 but axis recoverable from symmetric part.
    # R = I + 2 sin^2? Use: (R + I) diag -> axis^2 * (1 - cos) * 2 + ...
    # axis_i^2 = (R_ii + 1) / 2 normalized; signs from the skew part where
    # available, else from largest off-diagonal products.
    near_pi = theta > (jnp.pi - 1e-3)
    Rp = (R + jnp.eye(3, dtype=R.dtype)) * 0.5
    diag = jnp.clip(
        jnp.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], axis=-1), 0.0, None
    )
    axis_abs = jnp.sqrt(diag)
    # Pick the largest component as reference sign +, derive others from
    # symmetric off-diagonals: axis_i * axis_j = Rp_ij (for theta = pi).
    k = jnp.argmax(axis_abs, axis=-1)
    off = jnp.stack(
        [
            jnp.stack([diag[..., 0], Rp[..., 0, 1], Rp[..., 0, 2]], axis=-1),
            jnp.stack([Rp[..., 1, 0], diag[..., 1], Rp[..., 1, 2]], axis=-1),
            jnp.stack([Rp[..., 2, 0], Rp[..., 2, 1], diag[..., 2]], axis=-1),
        ],
        axis=-2,
    )
    row_k = jnp.take_along_axis(off, k[..., None, None].repeat(3, axis=-1), axis=-2)[
        ..., 0, :
    ]
    denom = jnp.take_along_axis(axis_abs, k[..., None], axis=-1)
    axis_pi = row_k / jnp.where(denom < 1e-12, 1.0, denom)
    axis_pi = axis_pi / jnp.maximum(
        jnp.linalg.norm(axis_pi, axis=-1, keepdims=True), 1e-12
    )
    pi_branch = axis_pi * theta[..., None]

    return jnp.where(near_pi[..., None], pi_branch, generic)


@f32_highest
def so3_left_jacobian(w: jax.Array) -> jax.Array:
    """Left Jacobian J_l of SO(3): [..., 3] -> [..., 3, 3]."""
    theta = _safe_theta(w)
    W = hat(w)
    W2 = W @ W
    a = _cosc(theta)[..., None, None]
    b = _sinc3(theta)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_right_jacobian(w: jax.Array) -> jax.Array:
    """Right Jacobian J_r(w) = J_l(-w)."""
    return so3_left_jacobian(-w)


@f32_highest
def so3_left_jacobian_inv(w: jax.Array) -> jax.Array:
    """Inverse left Jacobian of SO(3)."""
    theta = _safe_theta(w)
    W = hat(w)
    W2 = W @ W
    half = 0.5
    # coefficient: 1/theta^2 (1 - theta sin / (2 (1-cos)))
    small = theta < _EPS
    ts = jnp.where(small, 1.0, theta)
    t2 = theta * theta
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
        (1.0 / (ts * ts)) - (jnp.sin(ts) / (2.0 * ts * (1.0 - jnp.cos(ts)))),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - half * W + cot_term[..., None, None] * W2


def so3_right_jacobian_inv(w: jax.Array) -> jax.Array:
    return so3_left_jacobian_inv(-w)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3(R: jax.Array, t: jax.Array) -> jax.Array:
    """Pack rotation [..., 3, 3] + translation [..., 3] into [..., 4, 4]."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def se3_identity(batch: tuple = (), dtype=jnp.float32) -> jax.Array:
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), batch + (4, 4))


def rotation(T: jax.Array) -> jax.Array:
    return T[..., :3, :3]


def translation(T: jax.Array) -> jax.Array:
    return T[..., :3, 3]


@f32_highest
def se3_orthonormalize(T: jax.Array) -> jax.Array:
    """Project the rotation block back onto SO(3) (nearest in Frobenius).

    Long chains of f32 SE3 compositions (dead-reckoning on the motion model,
    velocity updates) drift off the manifold; the drift compounds
    EXPONENTIALLY once |det R| != 1. One 3x3 SVD per call keeps the chain
    bounded."""
    R = T[..., :3, :3]
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    S = jnp.ones(T.shape[:-2] + (3,), T.dtype).at[..., 2].set(det)
    Rn = (U * S[..., None, :]) @ Vt
    return T.at[..., :3, :3].set(Rn)


@f32_highest
def se3_inverse(T: jax.Array) -> jax.Array:
    R = rotation(T)
    t = translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return se3(Rt, -(Rt @ t[..., None])[..., 0])


@f32_highest
def se3_apply(T: jax.Array, p: jax.Array) -> jax.Array:
    """Apply SE(3) to points.

    Two layouts are supported, disambiguated by rank:
    - ``p.ndim == T.ndim`` — a point SET per transform: T [..., 4, 4] applied
      to p [..., N, 3] (includes the common T [4,4], p [N,3] case);
    - ``p.ndim == T.ndim - 1`` — batch-ALIGNED single points: T [..., 4, 4]
      with p [..., 3], one transform per point.
    """
    R = rotation(T)
    t = translation(T)
    if p.ndim == T.ndim:  # point set per transform
        return p @ jnp.swapaxes(R, -1, -2) + t[..., None, :]
    return (R @ p[..., None])[..., 0] + t


@f32_highest
def se3_exp(xi: jax.Array) -> jax.Array:
    """se3 tangent [..., 6] (rho, phi) -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = (V @ rho[..., None])[..., 0]
    return se3(R, t)


@f32_highest
def se3_log(T: jax.Array) -> jax.Array:
    """[..., 4, 4] -> se3 tangent [..., 6] (rho, phi)."""
    phi = so3_log(rotation(T))
    Vinv = so3_left_jacobian_inv(phi)
    rho = (Vinv @ translation(T)[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


@f32_highest
def se3_adjoint(T: jax.Array) -> jax.Array:
    """Adjoint of SE(3): [..., 6, 6] acting on (rho, phi) tangents."""
    R = rotation(T)
    t = translation(T)
    tR = hat(t) @ R
    z = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bot = jnp.concatenate([z, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


@f32_highest
def se3_interpolate(T0: jax.Array, T1: jax.Array, alpha) -> jax.Array:
    """Geodesic interpolation T0 * exp(alpha * log(T0^-1 T1)).

    Batched equivalent of the reference's ``Tracking::InterpolateSE3``
    (``Tracking.cc:1552``) used to express the LiDAR scan at a frame time.
    """
    dxi = se3_log(se3_inverse(T0) @ T1)
    alpha = jnp.asarray(alpha, dtype=dxi.dtype)
    return T0 @ se3_exp(alpha[..., None] * dxi)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def sim3(s: jax.Array, R: jax.Array, t: jax.Array) -> jax.Array:
    """Pack scale [...], rotation [..., 3, 3], translation [..., 3] -> 4x4."""
    return se3(s[..., None, None] * R, t)


def sim3_scale(S: jax.Array) -> jax.Array:
    """Recover s from the packed 4x4 (det(sR) = s^3)."""
    sR = S[..., :3, :3]
    return jnp.linalg.norm(sR[..., 0, :], axis=-1)


def sim3_rotation(S: jax.Array) -> jax.Array:
    return S[..., :3, :3] / sim3_scale(S)[..., None, None]


@f32_highest
def sim3_inverse(S: jax.Array) -> jax.Array:
    s = sim3_scale(S)
    R = sim3_rotation(S)
    t = translation(S)
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return sim3(s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0])


@f32_highest
def sim3_exp(xi: jax.Array) -> jax.Array:
    """sim3 tangent [..., 7] (rho, phi, sigma) -> packed 4x4.

    Uses the closed-form W matrix (scaled left Jacobian); see Sophus sim3 or
    Strasdat's thesis. Taylor-safe around sigma = 0, theta = 0.
    """
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(phi)
    theta = _safe_theta(phi)
    W = _sim3_W(theta, sigma, phi, xi.dtype)
    t = (W @ rho[..., None])[..., 0]
    return sim3(s, R, t)


@f32_highest
def _sim3_W(theta, sigma, phi, dtype):
    """Sim(3) translation matrix W = C·I + A·Phi + B·Phi^2.

    Closed form of ``W = ∫_0^1 exp(sigma·u) · exp(u·phi^) du`` so that
    ``exp(rho, phi, sigma)`` has translation ``t = W @ rho``:

        C = (s - 1)/sigma
        A = (a·sigma + (1 - b)·theta) / (theta·(sigma^2 + theta^2))
        B = (C - ((b - 1)·sigma + a·theta)/(sigma^2 + theta^2)) / theta^2

    with ``s = e^sigma``, ``a = s·sin(theta)``, ``b = s·cos(theta)``.
    Taylor limits: theta→0: A = ((sigma-1)s + 1)/sigma^2,
    B = (s(1 - sigma + sigma^2/2) - 1)/sigma^3; sigma→0 on top of that:
    C = 1 + sigma/2, A = 1/2 + sigma/3, B = 1/6 + sigma/8.
    """
    Phi = hat(phi)
    Phi2 = Phi @ Phi
    s = jnp.exp(sigma)

    small_sig = jnp.abs(sigma) < _EPS
    sig_s = jnp.where(small_sig, 1.0, sigma)
    small_th = theta < _EPS
    th_s = jnp.where(small_th, 1.0, theta)
    denom = sigma * sigma + theta * theta
    denom_s = jnp.where(denom < _EPS * _EPS, 1.0, denom)

    C = jnp.where(small_sig, 1.0 + 0.5 * sigma + sigma * sigma / 6.0, (s - 1.0) / sig_s)

    a_ = s * jnp.sin(theta)
    b_ = s * jnp.cos(theta)
    A_gen = (a_ * sigma + (1.0 - b_) * theta) / (th_s * denom_s)
    B_gen = (C - ((b_ - 1.0) * sigma + a_ * theta) / denom_s) / (th_s * th_s)

    A_th0 = jnp.where(
        small_sig, 0.5 + sigma / 3.0, ((sigma - 1.0) * s + 1.0) / (sig_s * sig_s)
    )
    B_th0 = jnp.where(
        small_sig,
        1.0 / 6.0 + sigma / 8.0,
        (s * (1.0 - sigma + 0.5 * sigma * sigma) - 1.0) / (sig_s * sig_s * sig_s),
    )

    A = jnp.where(small_th, A_th0, A_gen)
    B = jnp.where(small_th, B_th0, B_gen)

    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), Phi.shape)
    return C[..., None, None] * eye + A[..., None, None] * Phi + B[..., None, None] * Phi2


def sim3_log(S: jax.Array) -> jax.Array:
    """Packed Sim(3) -> tangent [..., 7] (rho, phi, sigma)."""
    s = sim3_scale(S)
    R = sim3_rotation(S)
    t = translation(S)
    sigma = jnp.log(s)
    phi = so3_log(R)
    theta = _safe_theta(phi)
    W = _sim3_W(theta, sigma, phi, S.dtype)
    rho = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def sim3_apply(S: jax.Array, p: jax.Array) -> jax.Array:
    """Apply Sim(3) to points (same signature as :func:`se3_apply`)."""
    return se3_apply(S, p)  # packed form already contains sR


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

@f32_highest
def orthogonalize(R: jax.Array) -> jax.Array:
    """Project [..., 3, 3] onto SO(3) via SVD (drift control after updates)."""
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    return (U * D[..., None, :]) @ Vt


def quat_to_mat(q: jax.Array) -> jax.Array:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation matrix."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def mat_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion (w, x, y, z), branch-free."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate constructions; pick the numerically best by max pivot.
    qw0 = jnp.sqrt(jnp.clip(1.0 + tr, 1e-12, None)) * 0.5
    c0 = jnp.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], -1)
    qx1 = jnp.sqrt(jnp.clip(1.0 + m00 - m11 - m22, 1e-12, None)) * 0.5
    c1 = jnp.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)], -1)
    qy2 = jnp.sqrt(jnp.clip(1.0 - m00 + m11 - m22, 1e-12, None)) * 0.5
    c2 = jnp.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)], -1)
    qz3 = jnp.sqrt(jnp.clip(1.0 - m00 - m11 + m22, 1e-12, None)) * 0.5
    c3 = jnp.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3], -1)

    pivots = jnp.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    best = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([c0, c1, c2, c3], axis=-2)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)
