"""Batched camera models: pinhole and Kannala-Brandt-8 fisheye.

A batched re-design of the reference's ``GeometricCamera`` hierarchy
(``/root/reference/slam_framework/src/CameraModels/{Pinhole,KannalaBrandt8}.cpp``).
Instead of virtual dispatch on per-point calls, each model is a pytree of
intrinsics plus pure batched functions ``project``/``unproject``/
``project_jac`` over ``[..., 3]`` / ``[..., 2]`` arrays, so a whole frame's
landmarks project in one fused kernel.

Distortion handling differs from the reference on purpose: the reference
pre-rectifies stereo images and then treats keypoints as undistorted pinhole
measurements (``Settings`` precomputes rectification maps). We keep the same
model: the pinhole path assumes rectified/undistorted keypoints; KB8 provides
the fisheye math (project + iterative unproject) for fisheye rigs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..numerics import f32_highest


class Pinhole(NamedTuple):
    """fx, fy, cx, cy (+ stereo baseline*fx ``bf`` when part of a rig)."""

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    bf: jax.Array  # stereo baseline [m] * fx; 0 for mono use
    width: jax.Array   # image bounds for frustum checks (Frame::isInFrustum)
    height: jax.Array

    @staticmethod
    def create(fx, fy, cx, cy, bf=0.0, width=None, height=None,
               dtype=jnp.float32) -> "Pinhole":
        # Callers that don't know the sensor size get the centered-principal-
        # point approximation (2cx x 2cy); configured systems pass real bounds.
        if width is None:
            width = 2.0 * float(cx)
        if height is None:
            height = 2.0 * float(cy)
        return Pinhole(*[jnp.asarray(v, dtype=dtype)
                         for v in (fx, fy, cx, cy, bf, width, height)])

    @property
    def baseline(self):
        return self.bf / self.fx

    @property
    def K(self) -> jax.Array:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx], -1),
                jnp.stack([z, self.fy, self.cy], -1),
                jnp.stack([z, z, o], -1),
            ],
            axis=-2,
        )


def in_image(cam: Pinhole, uv: jax.Array, margin: float = 0.0) -> jax.Array:
    """[...,2] pixel coords -> bool mask inside the configured image bounds
    (Frame::isInFrustum's mnMinX/mnMaxX/mnMinY/mnMaxY test, Frame.cc:542)."""
    return (
        (uv[..., 0] >= -margin) & (uv[..., 0] < cam.width + margin)
        & (uv[..., 1] >= -margin) & (uv[..., 1] < cam.height + margin)
    )


def project(cam: Pinhole, p_cam: jax.Array) -> jax.Array:
    """Camera-frame points [..., 3] -> pixel coords [..., 2].

    Matches ``Pinhole::project`` (Pinhole.cpp) — no distortion (rectified).
    Points with z <= 0 produce garbage; callers mask on depth.
    """
    z = p_cam[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * p_cam[..., 0] / z_safe + cam.cx
    v = cam.fy * p_cam[..., 1] / z_safe + cam.cy
    return jnp.stack([u, v], axis=-1)


def project_stereo(cam: Pinhole, p_cam: jax.Array) -> jax.Array:
    """Camera-frame points -> (u_l, v_l, u_r) [..., 3] for stereo residuals.

    ``u_r = u_l - bf/z`` as in the reference's stereo edges (G2oTypes.h
    EdgeStereo).
    """
    uv = project(cam, p_cam)
    z = p_cam[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    ur = uv[..., 0] - cam.bf / z_safe
    return jnp.concatenate([uv, ur[..., None]], axis=-1)


def unproject(cam: Pinhole, uv: jax.Array, depth: jax.Array) -> jax.Array:
    """Pixels [..., 2] + depth [...] -> camera-frame points [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return jnp.stack([x * depth, y * depth, depth], axis=-1)


def bearing(cam: Pinhole, uv: jax.Array) -> jax.Array:
    """Pixels -> unit bearing vectors [..., 3] (for PnP / epipolar checks)."""
    d = unproject(cam, uv, jnp.ones(uv.shape[:-1], uv.dtype))
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def project_jac(cam: Pinhole, p_cam: jax.Array) -> jax.Array:
    """d(u,v)/d(p_cam): [..., 2, 3] (``Pinhole::projectJac``)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    zero = jnp.zeros_like(x)
    row_u = jnp.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], axis=-1)
    row_v = jnp.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], axis=-1)
    return jnp.stack([row_u, row_v], axis=-2)


def project_stereo_jac(cam: Pinhole, p_cam: jax.Array) -> jax.Array:
    """d(u_l,v_l,u_r)/d(p_cam): [..., 3, 3]."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    zero = jnp.zeros_like(x)
    row_u = jnp.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], axis=-1)
    row_v = jnp.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], axis=-1)
    row_r = jnp.stack(
        [cam.fx * inv_z, zero, (-cam.fx * x + cam.bf) * inv_z2], axis=-1
    )
    return jnp.stack([row_u, row_v, row_r], axis=-2)


def depth_from_disparity(cam: Pinhole, disparity: jax.Array) -> jax.Array:
    """Stereo disparity -> depth: z = bf / d (``Frame::ComputeStereoMatches``)."""
    return cam.bf / jnp.maximum(disparity, 1e-6)


# ---------------------------------------------------------------------------
# Kannala-Brandt 8-parameter fisheye
# ---------------------------------------------------------------------------

class KannalaBrandt8(NamedTuple):
    """Equidistant fisheye with 4 radial terms (KannalaBrandt8.cpp)."""

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    k: jax.Array  # [..., 4] = (k1, k2, k3, k4)

    @staticmethod
    def create(fx, fy, cx, cy, k1, k2, k3, k4, dtype=jnp.float32) -> "KannalaBrandt8":
        return KannalaBrandt8(
            jnp.asarray(fx, dtype),
            jnp.asarray(fy, dtype),
            jnp.asarray(cx, dtype),
            jnp.asarray(cy, dtype),
            jnp.asarray([k1, k2, k3, k4], dtype),
        )


def kb8_project(cam: KannalaBrandt8, p_cam: jax.Array) -> jax.Array:
    """KB8 projection (``KannalaBrandt8::project``): theta-polynomial radial."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(r2)
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    k1, k2, k3, k4 = cam.k[..., 0], cam.k[..., 1], cam.k[..., 2], cam.k[..., 3]
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    r_safe = jnp.where(r < 1e-9, 1.0, r)
    scale = jnp.where(r < 1e-9, jnp.zeros_like(r), theta_d / r_safe)
    u = cam.fx * x * scale + cam.cx
    v = cam.fy * y * scale + cam.cy
    return jnp.stack([u, v], axis=-1)


def kb8_unproject(cam: KannalaBrandt8, uv: jax.Array, iters: int = 10) -> jax.Array:
    """Pixels -> unit-plane ray via Newton inversion of the theta polynomial.

    The reference solves this per-point with a scalar Newton loop
    (``KannalaBrandt8::unprojectEig``); here the Newton iterations run batched
    and unrolled (fixed ``iters``) so the whole keypoint set inverts in one
    fused kernel.
    """
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    theta_d = jnp.sqrt(mx * mx + my * my)
    theta_d = jnp.clip(theta_d, None, jnp.pi / 2)
    k1, k2, k3, k4 = cam.k[..., 0], cam.k[..., 1], cam.k[..., 2], cam.k[..., 3]

    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
        df = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + 9 * t2 * k4)))
        theta = theta - f / jnp.where(jnp.abs(df) < 1e-9, 1.0, df)

    scale = jnp.where(theta_d < 1e-9, jnp.ones_like(theta), jnp.tan(theta) / jnp.where(theta_d < 1e-9, 1.0, theta_d))
    return jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)


def kb8_project_jac(cam: KannalaBrandt8, p_cam: jax.Array) -> jax.Array:
    """d(u,v)/dp via JAX autodiff (matches KannalaBrandt8::projectJac)."""
    flat = p_cam.reshape(-1, 3)
    J = jax.vmap(jax.jacfwd(lambda p: kb8_project(cam, p)))(flat)
    return J.reshape(p_cam.shape[:-1] + (2, 3))


@f32_highest
def kb8_triangulate_matches(
    cam1: KannalaBrandt8,
    cam2: KannalaBrandt8,
    uv1: jax.Array,      # [N, 2] keypoints in view 1
    uv2: jax.Array,      # [N, 2] matched keypoints in view 2
    T_21: jax.Array,     # [4, 4] cam2-from-cam1 (the rig's Tlr^-1 for L->R)
    sigma2_1: jax.Array,  # [N] per-kp squared sigma (view 1)
    sigma2_2: jax.Array,  # [N]
    min_parallax_cos: float = 0.9998,
    chi2: float = 5.991,
) -> tuple[jax.Array, jax.Array]:
    """Fisheye dual-camera stereo triangulation
    (``KannalaBrandt8::TriangulateMatches``, KannalaBrandt8.cpp): unproject
    both views to rays, DLT-triangulate through the rig extrinsic, validate
    parallax + positive depth + reprojection chi2 in BOTH fisheye images.

    Returns (p_cam1 [N, 3], ok [N]) — 3D points in camera-1 coordinates.
    The reference uses this instead of rectified row matching for fisheye
    rigs (Frame's fisheye ctor path, Frame.cc:1064).
    """
    from . import triangulate as tri

    r1 = kb8_unproject(cam1, uv1)               # [N, 3] z=1 rays (cam1)
    r2 = kb8_unproject(cam2, uv2)               # [N, 3] (cam2)
    # parallax between the rays expressed in a common frame
    R21 = T_21[:3, :3]
    r2_in1 = r2 @ R21                           # R21^T r2
    cosp = jnp.sum(r1 * r2_in1, axis=-1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2_in1, axis=-1), 1e-12
    )
    ok = cosp < min_parallax_cos

    eye = jnp.eye(4, dtype=uv1.dtype)
    X1 = tri.triangulate_dlt(r1[:, :2] / r1[:, 2:], r2[:, :2] / r2[:, 2:],
                             eye, T_21)
    X2 = X1 @ R21.T + T_21[:3, 3]
    ok &= (X1[:, 2] > 1e-3) & (X2[:, 2] > 1e-3)
    e1 = jnp.sum((kb8_project(cam1, X1) - uv1) ** 2, axis=-1)
    e2 = jnp.sum((kb8_project(cam2, X2) - uv2) ** 2, axis=-1)
    ok &= (e1 <= chi2 * sigma2_1) & (e2 <= chi2 * sigma2_2)
    return X1, ok
