"""Levenberg-Marquardt factor-graph core with Schur landmark elimination.

Replaces the vendored g2o stack (``Thirdparty/g2o``: SparseOptimizer +
BlockSolver + LM + Schur) with two dense-but-batched solvers:

- ``pose_only_optimize`` — frame pose vs. fixed landmarks, 4 rounds x 10 LM
  iterations with chi2 outlier gating between rounds, mirroring
  ``Optimizer::PoseOptimization`` (Optimizer.cc:816).
- ``local_ba`` — window poses + landmarks with landmark-major observations,
  per-landmark 3x3 elimination, and a DENSE reduced camera system [6P, 6P]
  solved densely: for a local window (P <= ~100) a dense reduced system
  is small and needs no sparse bookkeeping; the distributed layer shards this same
  structure. Extra dense pose terms (the BALM eigen-factor multi-edge, IMU
  factors, marginalization priors) plug in via an ``extra_fn`` callback that
  returns (H_extra, g_extra, cost_extra) — the analog of the reference's
  ``constructQuadraticForm`` dense-block injection
  (G2oTypesWithLidar.h:169-236).

Observation layout is landmark-major: each landmark carries up to K observer
slots (pose index, uv, sigma, stereo flag, valid) — the padded-array mirror
of MapPoint::GetObservations.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..geom import camera as cam_mod, lie
from ..numerics import f32_highest
from . import factors


def inv3x3(A: jax.Array) -> jax.Array:
    """Closed-form batched 3x3 inverse (adjugate / determinant).

    ``jnp.linalg.inv`` lowers small batched inverses to a batched LU; this
    form is pure elementwise math over the [L, 3, 3] landmark blocks.
    Callers pre-damp A, so det is bounded away
    from 0 for valid blocks; invalid blocks are masked by the caller."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g_, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g_ - d * i
    A11 = a * i - c * g_
    A12 = c * d - a * f
    A20 = d * h - e * g_
    A21 = b * g_ - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    adj = jnp.stack([
        jnp.stack([A00, A01, A02], -1),
        jnp.stack([A10, A11, A12], -1),
        jnp.stack([A20, A21, A22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def precond_solve(H: jax.Array, g: jax.Array) -> jax.Array:
    """Solve H x = g with Jacobi (diagonal) preconditioning.

    The factor graph mixes visual information (O(1) px^-2) with IMU
    preintegration information (O(1e6-1e8) for good IMUs) in one f32
    Hessian; the reference hides this behind g2o's double precision. In
    f32 the raw solve loses the small blocks to roundoff — symmetric
    diagonal scaling D^-1/2 H D^-1/2 restores O(1) conditioning for free.
    """
    d = jnp.sqrt(jnp.clip(jnp.abs(jnp.diag(H)), 1e-12, None))
    Hn = H / (d[:, None] * d[None, :])
    y = jnp.linalg.solve(Hn, g / d)
    return y / d


# ---------------------------------------------------------------------------
# Pose-only optimization
# ---------------------------------------------------------------------------

class PoseOnlyResult(NamedTuple):
    T_cw: jax.Array     # [4, 4]
    inliers: jax.Array  # [N] final inlier mask
    n_inliers: jax.Array
    cost: jax.Array


@partial(jax.jit, static_argnames=("rounds", "iters"))
@f32_highest
def pose_only_optimize(
    cam: cam_mod.Pinhole,
    T_cw0: jax.Array,       # [4, 4]
    X_w: jax.Array,         # [N, 3] matched map points (fixed)
    uv_obs: jax.Array,      # [N, 3] (u, v, u_r) with u_r<0 for mono
    inv_sigma2: jax.Array,  # [N]
    stereo: jax.Array,      # [N] bool
    valid: jax.Array,       # [N]
    rounds: int = 4,
    iters: int = 10,
) -> PoseOnlyResult:
    """PoseOptimization: LM on the frame pose with chi2 re-gating per round."""

    def residuals(T, active):
        rr = factors.reproj_residuals(
            cam, jnp.broadcast_to(T, (X_w.shape[0], 4, 4)), X_w, uv_obs,
            inv_sigma2, stereo,
        )
        w_huber = factors.huber_weight(
            rr.chi2, jnp.where(stereo, factors.CHI2_STEREO, factors.CHI2_MONO)
        )
        w = inv_sigma2 * w_huber * active.astype(rr.r.dtype) * rr.depth_ok.astype(rr.r.dtype)
        return rr, w

    def lm_round(T, active):
        lam0 = jnp.asarray(1e-3, T.dtype)

        def lm_iter(carry, _):
            T, lam, cost_prev = carry
            rr, w = residuals(T, active)
            Jw = rr.J_pose * w[:, None, None]
            H = jnp.einsum("oij,oik->jk", Jw, rr.J_pose)
            g = jnp.einsum("oij,oi->j", Jw, rr.r)
            Haug = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(6, dtype=T.dtype)
            delta = -jnp.linalg.solve(Haug, g)
            T_new = lie.se3_exp(delta) @ T
            rr2, w2 = residuals(T_new, active)
            cost_new = jnp.sum(w2 * jnp.sum(rr2.r * rr2.r, axis=-1))
            accept = cost_new < cost_prev
            T = jnp.where(accept, T_new, T)
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            cost = jnp.where(accept, cost_new, cost_prev)
            return (T, lam, cost), None

        rr0, w0 = residuals(T, active)
        cost0 = jnp.sum(w0 * jnp.sum(rr0.r * rr0.r, axis=-1))
        (T, _, cost), _ = jax.lax.scan(lm_iter, (T, lam0, cost0), None, length=iters)
        return T, cost

    T = T_cw0
    active = valid
    cost = jnp.asarray(0.0, T_cw0.dtype)
    for _ in range(rounds):
        T, cost = lm_round(T, active)
        rr, _ = residuals(T, valid)
        thresh = jnp.where(stereo, factors.CHI2_STEREO, factors.CHI2_MONO)
        active = valid & (rr.chi2 <= thresh) & rr.depth_ok
    return PoseOnlyResult(T, active, jnp.sum(active), cost)


# ---------------------------------------------------------------------------
# Local bundle adjustment (visual, T_cw blocks of 6)
# ---------------------------------------------------------------------------

class BAObservations(NamedTuple):
    """Landmark-major padded observation table."""

    pose_idx: jax.Array   # [L, K] int32 into the window pose array
    uv: jax.Array         # [L, K, 3]
    inv_sigma2: jax.Array  # [L, K]
    stereo: jax.Array     # [L, K] bool
    valid: jax.Array      # [L, K] bool


class BAResult(NamedTuple):
    T_cw: jax.Array       # [P, 4, 4]
    X_w: jax.Array        # [L, 3]
    cost: jax.Array
    obs_inlier: jax.Array  # [L, K]


def _assemble_visual(cam, T_cw, X_w, obs: BAObservations, gate: bool):
    """Flattened residual/Jacobian evaluation + robust weights."""
    L, K = obs.pose_idx.shape
    pidx = jnp.clip(obs.pose_idx, 0, T_cw.shape[0] - 1).reshape(-1)
    T_o = T_cw[pidx]
    X_o = jnp.repeat(X_w, K, axis=0)
    rr = factors.reproj_residuals(
        cam, T_o, X_o, obs.uv.reshape(-1, 3), obs.inv_sigma2.reshape(-1),
        obs.stereo.reshape(-1),
    )
    thresh = jnp.where(obs.stereo.reshape(-1), factors.CHI2_STEREO, factors.CHI2_MONO)
    w_huber = factors.huber_weight(rr.chi2, thresh)
    active = obs.valid.reshape(-1) & rr.depth_ok
    if gate:
        active &= rr.chi2 <= thresh
    w = obs.inv_sigma2.reshape(-1) * w_huber * active.astype(rr.r.dtype)
    return rr, w, active, pidx


@partial(jax.jit, static_argnames=("iters",))
@f32_highest
def local_ba(
    cam: cam_mod.Pinhole,
    T_cw0: jax.Array,        # [P, 4, 4]
    X_w0: jax.Array,         # [L, 3]
    obs: BAObservations,
    fixed_pose: jax.Array,   # [P] bool (observer KFs held constant)
    valid_lm: jax.Array,     # [L] bool
    iters: int = 10,
    extra_fn: Callable | None = None,  # (T_cw) -> (H [6P,6P], g [6P], cost)
) -> BAResult:
    """LocalBundleAdjustment / LocalLVBundleAdjustment core
    (Optimizer.cc:1118, OptimizerWithLidar.cc:60).

    ``extra_fn`` injects dense cross-pose quadratic terms — with the BALM
    eigen-factor it reproduces LocalLVBundleAdjustment's EdgeLidarSE3.
    It must be ``None`` or a ``jax.tree_util.Partial`` over a MODULE-LEVEL
    function with array operands: Partial is a pytree, so its arrays are
    traced arguments and only the (stable) function identity keys the jit
    cache — a fresh Python closure per call would recompile every time.
    """
    P = T_cw0.shape[0]
    L, K = obs.pose_idx.shape
    D = 6 * P

    # Lazy extra-quadratic relinearization (the reference's is_calc_hess
    # heuristic, G2oTypesWithLidar.h:134-138): the dense BALM Hessian is
    # evaluated ONCE at the entry poses; inside the iteration loop the
    # gradient follows the quadratic model g(ξ) = g0 + H0 ξ with ξ the
    # accumulated pose tangent. The 6W-dim eigen-Hessian costs ~6x an
    # iteration's visual work, so re-deriving it per LM step would dominate
    # the BA; BA steps are mm-scale so the model error
    # is far below the factor's own noise.
    if extra_fn is not None:
        H_e0, g_e0, c_e0 = extra_fn(T_cw0)

    def build_and_solve(T_cw, X_w, lam, xi, gate):
        rr, w, active, pidx = _assemble_visual(cam, T_cw, X_w, obs, gate)
        Jp = rr.J_pose * w[:, None, None]          # weighted
        Jl = rr.J_lm

        # One-hot pose-slot matrix: scatters into the [P, P] reduced system
        # become small dense einsums (P <= ~8) instead of scatter-adds.
        onehot = (jnp.clip(obs.pose_idx, 0, P - 1).reshape(-1)[:, None]
                  == jnp.arange(P)[None, :]).astype(T_cw.dtype)   # [O, P]

        # Pose-diagonal blocks + gradient
        Hpp_blk = jnp.einsum("oij,oik->ojk", Jp, rr.J_pose)   # [O, 6, 6]
        gp_blk = jnp.einsum("oij,oi->oj", Jp, rr.r)           # [O, 6]
        Hpp = jnp.einsum("op,ojk->pjk", onehot, Hpp_blk)
        gp = jnp.einsum("op,oj->pj", onehot, gp_blk)

        # Landmark blocks
        Hll_blk = jnp.einsum("oij,oik->ojk", rr.J_lm * w[:, None, None], rr.J_lm)
        gl_blk = jnp.einsum("oij,oi->oj", rr.J_lm * w[:, None, None], rr.r)
        Hll = jnp.sum(Hll_blk.reshape(L, K, 3, 3), axis=1)
        gl = jnp.sum(gl_blk.reshape(L, K, 3), axis=1)

        # Cross blocks B = Jp^T W Jl  [O, 6, 3] -> [L, K, 6, 3]
        B = jnp.einsum("oij,oik->ojk", Jp, Jl).reshape(L, K, 6, 3)

        # Damp + invert landmark blocks (closed-form 3x3: jnp.linalg.inv
        # lowers to LU and was the iteration's hot spot)
        lmw = valid_lm.astype(T_cw.dtype)
        Hll_d = Hll + (lam * jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(Hll)) + 1e-6 * jnp.eye(3, dtype=T_cw.dtype))
        Hll_inv = inv3x3(Hll_d) * lmw[:, None, None]

        # Reduced camera system via per-pose aggregates: with
        # U[l,p,i,m] = Σ_k 1[pi=p] BHinv, V[l,q,j,m] = Σ_k 1[pi=q] B,
        # the Schur correction is S_cross = Σ_l U V^T — dense contractions,
        # no [L, K, K, 6, 6] intermediate and no scatter.
        oh = onehot.reshape(L, K, P)
        BHinv = jnp.einsum("lkij,ljm->lkim", B, Hll_inv)       # [L, K, 6, 3]
        U = jnp.einsum("lkp,lkim->lpim", oh, BHinv)            # [L, P, 6, 3]
        V = jnp.einsum("lkp,lkjm->lpjm", oh, B)                # [L, P, 6, 3]
        corr_pq = jnp.einsum("lpim,lqjm->pqij", U, V)          # [P, P, 6, 6]
        S = jnp.zeros((P, P, 6, 6), T_cw.dtype)
        S = S.at[jnp.arange(P), jnp.arange(P)].add(Hpp)
        S = S - corr_pq
        # gradient correction: Σ_l Σ_k 1[pi=p] BHinv @ gl
        gcorr = jnp.einsum("lpim,lm->pi", U, gl)               # [P, 6]
        gp_red = gp - gcorr

        # Fixed poses: zero rows/cols, unit diagonal
        free = (~fixed_pose).astype(T_cw.dtype)
        S = S * free[:, None, None, None] * free[None, :, None, None]
        Sd = S.transpose(0, 2, 1, 3).reshape(D, D)
        Sd = Sd + jnp.diag(jnp.tile(1.0 - free, (6,)).reshape(6, P).T.reshape(-1))
        Sd = Sd + lam * jnp.diag(jnp.diag(Sd)) + 1e-8 * jnp.eye(D, dtype=T_cw.dtype)
        gp_red = gp_red * free[:, None]

        if extra_fn is not None:
            g_e = g_e0 + H_e0 @ xi.reshape(-1)
            mask_d = jnp.tile(free, (6, 1)).T.reshape(-1)
            Sd = Sd + H_e0 * mask_d[:, None] * mask_d[None, :]
            gp_red = gp_red + (g_e * mask_d).reshape(P, 6)

        delta_p = -precond_solve(Sd, gp_red.reshape(-1)).reshape(P, 6)
        delta_p = delta_p * free[:, None]

        # Back-substitute landmarks: δl = -Hll^-1 (gl + Σ_a B_a^T δp_a)
        dp_per_obs = jnp.einsum("lkp,pj->lkj", oh, delta_p)     # [L, K, 6]
        Bt_dp = jnp.einsum("lkij,lki->lj", B, dp_per_obs)       # [L, 3]
        delta_l = -jnp.einsum("lij,lj->li", Hll_inv, gl + Bt_dp)
        delta_l = delta_l * valid_lm[:, None]
        return delta_p, delta_l, active

    def total_cost(T_cw, X_w, xi, gate):
        rr, w, active, _ = _assemble_visual(cam, T_cw, X_w, obs, gate)
        c = jnp.sum(w * jnp.sum(rr.r * rr.r, axis=-1))
        if extra_fn is not None:
            # quadratic model of the extra cost at the entry linearization
            x = xi.reshape(-1)
            c = c + c_e0 + g_e0 @ x + 0.5 * x @ (H_e0 @ x)
        return c

    def lm_iter(carry, it):
        T_cw, X_w, lam, xi, cost_prev = carry
        gate = False
        dp, dl, _ = build_and_solve(T_cw, X_w, lam, xi, gate)
        T_new = lie.se3_exp(dp) @ T_cw
        X_new = X_w + dl
        xi_new = xi + dp
        cost_new = total_cost(T_new, X_new, xi_new, gate)
        accept = cost_new < cost_prev
        T_cw = jnp.where(accept, T_new, T_cw)
        X_w = jnp.where(accept, X_new, X_w)
        xi = jnp.where(accept, xi_new, xi)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        cost = jnp.where(accept, cost_new, cost_prev)
        return (T_cw, X_w, lam, xi, cost), cost

    xi0 = jnp.zeros((P, 6), T_cw0.dtype)
    cost0 = total_cost(T_cw0, X_w0, xi0, False)
    (T_cw, X_w, _, _, cost), _ = jax.lax.scan(
        lm_iter, (T_cw0, X_w0, jnp.asarray(1e-4, T_cw0.dtype), xi0, cost0),
        jnp.arange(iters),
    )

    if extra_fn is not None:
        # Safety net for the lazy quadratic model: when the accumulated
        # pose correction leaves the small-step regime (e.g. the first BA
        # after a loop-closure correction), the model can accept steps that
        # RAISE the true eigen cost. Re-evaluate the true extra cost once
        # at the exit poses and revert the whole update if the true total
        # increased (cost0 is exact: xi0 = 0). One extra extra_fn eval per
        # call — the lazy path still saves the per-iteration Hessians.
        rr_t, w_t, _, _ = _assemble_visual(cam, T_cw, X_w, obs, False)
        _, _, c_true = extra_fn(T_cw)
        true_total = jnp.sum(w_t * jnp.sum(rr_t.r * rr_t.r, axis=-1)) + c_true
        ok_true = true_total <= cost0
        T_cw = jnp.where(ok_true, T_cw, T_cw0)
        X_w = jnp.where(ok_true, X_w, X_w0)
        cost = jnp.where(ok_true, true_total, cost0)

    # Final outlier classification (the reference erases chi2-outlier obs).
    rr, w, active, _ = _assemble_visual(cam, T_cw, X_w, obs, True)
    return BAResult(T_cw, X_w, cost, active.reshape(L, K))
