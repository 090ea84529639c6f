"""IMU preintegration on the manifold, as one ``lax.scan`` per window.

Re-design of the reference's ``IMU::Preintegrated``
(``slam_framework/src/ImuTypes.cc``, esp. ``IntegrateNewMeasurement:188``):
delta rotation/velocity/position between two frames/keyframes, the 15x15
covariance of the preintegrated error (dR, dV, dP, bg, ba ordering — matching
``EdgeInertial``'s residual layout), and the five bias Jacobians
(JRg, JVg, JVa, JPg, JPa) used for first-order bias correction without
re-integration.

Measurement buffers are padded to a static length with a validity mask
(``dt == 0`` for padding), so a frame-to-frame window of any size integrates
in one compiled scan.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom import lie
from ..numerics import f32_highest

GRAVITY = 9.81


class ImuCalib(NamedTuple):
    """Noise densities (discrete, per-sample — caller folds in sqrt(dt)) and
    the body-from-camera extrinsic (``IMU::Calib``, ImuTypes.h)."""

    sigma_g: jax.Array   # gyro white noise [rad/s]
    sigma_a: jax.Array   # accel white noise [m/s^2]
    sigma_gw: jax.Array  # gyro bias random walk
    sigma_aw: jax.Array  # accel bias random walk
    Tbc: jax.Array       # [4, 4] camera->body

    @staticmethod
    def create(sigma_g, sigma_a, sigma_gw, sigma_aw, Tbc=None):
        if Tbc is None:
            Tbc = jnp.eye(4, dtype=jnp.float32)
        return ImuCalib(
            jnp.float32(sigma_g),
            jnp.float32(sigma_a),
            jnp.float32(sigma_gw),
            jnp.float32(sigma_aw),
            jnp.asarray(Tbc, jnp.float32),
        )


class Preintegrated(NamedTuple):
    """Preintegrated deltas between t_i and t_j at linearization bias b."""

    dR: jax.Array       # [3, 3]
    dV: jax.Array       # [3]
    dP: jax.Array       # [3]
    C: jax.Array        # [15, 15] covariance (dR, dV, dP, bg, ba)
    JRg: jax.Array      # [3, 3] d dR / d bg
    JVg: jax.Array      # [3, 3]
    JVa: jax.Array      # [3, 3]
    JPg: jax.Array      # [3, 3]
    JPa: jax.Array      # [3, 3]
    dt: jax.Array       # [] total time
    bg: jax.Array       # [3] linearization gyro bias
    ba: jax.Array       # [3] linearization accel bias


def identity_preintegrated(dtype=jnp.float32) -> Preintegrated:
    z3 = jnp.zeros(3, dtype)
    z33 = jnp.zeros((3, 3), dtype)
    return Preintegrated(
        dR=jnp.eye(3, dtype=dtype),
        dV=z3,
        dP=z3,
        C=jnp.zeros((15, 15), dtype),
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        dt=jnp.zeros((), dtype),
        bg=z3, ba=z3,
    )


@jax.jit
@f32_highest
def integrate(
    calib: ImuCalib,
    gyro: jax.Array,   # [N, 3] body rates
    acc: jax.Array,    # [N, 3] specific force
    dts: jax.Array,    # [N] per-sample dt (0 for padding)
    bg: jax.Array,     # [3] linearization gyro bias
    ba: jax.Array,     # [3] linearization accel bias
) -> Preintegrated:
    """Integrate a padded IMU window (ImuTypes.cc:188 ``IntegrateNewMeasurement``).

    Covariance propagation uses the standard discrete A/B form
    (Forster et al. / ORB-SLAM3): state order (dR, dV, dP), then the
    bias-random-walk block accumulates independently.
    """
    dtype = gyro.dtype
    Ng2 = calib.sigma_g ** 2
    Na2 = calib.sigma_a ** 2
    Ngw2 = calib.sigma_gw ** 2
    Naw2 = calib.sigma_aw ** 2

    def step(carry, inp):
        p = carry
        w, a, dt = inp
        active = dt > 0
        dt = jnp.where(active, dt, 0.0)
        w_ub = w - p.bg
        a_ub = a - p.ba

        # Position/velocity first with the *current* dR (reference order:
        # ImuTypes.cc updates dP/dV before composing the rotation).
        dP = p.dP + p.dV * dt + 0.5 * (p.dR @ a_ub) * dt * dt
        dV = p.dV + (p.dR @ a_ub) * dt

        # Jacobians w.r.t. bias (before rotation update, as in the reference).
        a_hat = lie.hat(a_ub)
        JPa = p.JPa - 0.5 * p.dR * dt * dt  # d dP/d ba
        JPg = p.JPg + p.JVg * dt - 0.5 * (p.dR @ a_hat) @ p.JRg * dt * dt
        JVa = p.JVa - p.dR * dt
        JVg = p.JVg - (p.dR @ a_hat) @ p.JRg * dt

        dRi = lie.so3_exp(w_ub * dt)
        Jr = lie.so3_right_jacobian(w_ub * dt)
        dR = p.dR @ dRi
        JRg_new = dRi.T @ p.JRg - Jr * dt

        # Covariance: x = (dR, dV, dP); A [9,9], B [9,6] w/ noise (g, a).
        A = jnp.zeros((9, 9), dtype)
        A = A.at[0:3, 0:3].set(dRi.T)
        A = A.at[3:6, 0:3].set(-(p.dR @ a_hat) * dt)
        A = A.at[3:6, 3:6].set(jnp.eye(3, dtype=dtype))
        A = A.at[6:9, 0:3].set(-0.5 * (p.dR @ a_hat) * dt * dt)
        A = A.at[6:9, 3:6].set(jnp.eye(3, dtype=dtype) * dt)
        A = A.at[6:9, 6:9].set(jnp.eye(3, dtype=dtype))
        B = jnp.zeros((9, 6), dtype)
        B = B.at[0:3, 0:3].set(Jr * dt)
        B = B.at[3:6, 3:6].set(p.dR * dt)
        B = B.at[6:9, 3:6].set(0.5 * p.dR * dt * dt)

        Nga = jnp.diag(
            jnp.concatenate([jnp.full(3, Ng2 / jnp.maximum(dt, 1e-9)),
                             jnp.full(3, Na2 / jnp.maximum(dt, 1e-9))])
        )
        C9 = A @ p.C[:9, :9] @ A.T + B @ Nga @ B.T
        C = p.C.at[:9, :9].set(jnp.where(active, C9, p.C[:9, :9]))
        Cw = p.C[9:15, 9:15] + jnp.diag(
            jnp.concatenate([jnp.full(3, Ngw2 * dt), jnp.full(3, Naw2 * dt)])
        )
        C = C.at[9:15, 9:15].set(jnp.where(active, Cw, p.C[9:15, 9:15]))

        new = Preintegrated(
            dR=jnp.where(active, dR, p.dR),
            dV=jnp.where(active, dV, p.dV),
            dP=jnp.where(active, dP, p.dP),
            C=C,
            JRg=jnp.where(active, JRg_new, p.JRg),
            JVg=jnp.where(active, JVg, p.JVg),
            JVa=jnp.where(active, JVa, p.JVa),
            JPg=jnp.where(active, JPg, p.JPg),
            JPa=jnp.where(active, JPa, p.JPa),
            dt=p.dt + dt,
            bg=p.bg,
            ba=p.ba,
        )
        return new, None

    init = identity_preintegrated(dtype)._replace(bg=bg, ba=ba)
    out, _ = jax.lax.scan(step, init, (gyro, acc, dts))
    return out


# --- bias-corrected getters (ImuTypes.cc GetDeltaRotation/Velocity/Position) ---

@f32_highest
def delta_rotation(p: Preintegrated, bg: jax.Array) -> jax.Array:
    db = bg - p.bg
    return p.dR @ lie.so3_exp(p.JRg @ db)


@f32_highest
def delta_velocity(p: Preintegrated, bg: jax.Array, ba: jax.Array) -> jax.Array:
    return p.dV + p.JVg @ (bg - p.bg) + p.JVa @ (ba - p.ba)


@f32_highest
def delta_position(p: Preintegrated, bg: jax.Array, ba: jax.Array) -> jax.Array:
    return p.dP + p.JPg @ (bg - p.bg) + p.JPa @ (ba - p.ba)


@f32_highest
def predict_state(
    p: Preintegrated,
    Rwb: jax.Array,   # [3, 3] world-from-body at t_i
    pw: jax.Array,    # [3]
    vw: jax.Array,    # [3]
    bg: jax.Array,
    ba: jax.Array,
    gravity: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Dead-reckon state at t_j (``Tracking::PredictStateIMU``-equivalent)."""
    if gravity is None:
        gravity = jnp.array([0.0, 0.0, -GRAVITY], Rwb.dtype)
    t = p.dt
    R2 = Rwb @ delta_rotation(p, bg)
    v2 = vw + gravity * t + Rwb @ delta_velocity(p, bg, ba)
    p2 = pw + vw * t + 0.5 * gravity * t * t + Rwb @ delta_position(p, bg, ba)
    return R2, p2, v2
