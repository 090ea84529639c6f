"""Distributed bundle adjustment over a device mesh.

The reference has no distributed backend (single process, std::thread —
SURVEY §2.4); this is the new-capability north star from BASELINE.json:
shard the landmark/observation axis across devices, keep Schur landmark
elimination device-local, and build the dense reduced camera system with
``psum`` across the mesh — the SLAM analog of data-parallel gradient
all-reduce. The mesh is 1-D: the GPUs of a host reach each other all to
all over NVLink, so it follows the algorithm alone.

Layout:
- mesh axis ``"lm"``: landmarks (and their observation rows) are sharded;
  poses are replicated.
- per shard: residuals/Jacobians, per-landmark 3x3 elimination, local
  partial of the reduced system S and gradient.
- ``psum(S), psum(g)`` -> identical dense solve on every device
  (P*6 x P*6, tiny) -> landmark back-substitution device-local.
- dense pose-only extras (the BALM eigen-factor quadratic, priors) enter
  REPLICATED, added to the psum'd system — the distributed analog of
  ``EdgeLidarSE3::constructQuadraticForm``.

On multi-host, the same program runs under ``jax.distributed`` with a global
mesh; the network only carries the psum across hosts (the S matrix, ~(6P)^2 floats).
The damping schedule runs on the host: each step returns (candidate state,
model cost); the driver accepts/rejects and adapts lambda — bounded compute,
no device-side control flow.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geom import camera as cam_mod, lie
from ..numerics import f32_highest
from ..solver import factors
from ..solver.lm import BAObservations, inv3x3, precond_solve


def make_mesh(devices=None, axis: str = "lm") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(devices, (axis,))


def shard_problem(mesh: Mesh, X_w, obs: BAObservations, valid_lm):
    """Place landmark-major arrays sharded on the mesh, poses replicated."""
    sh = NamedSharding(mesh, P("lm"))
    put = lambda x: jax.device_put(x, sh)
    return (
        put(X_w),
        BAObservations(*(put(x) for x in obs)),
        put(valid_lm),
    )


def gn_step_fn(mesh: Mesh, cam: cam_mod.Pinhole):
    """Build the sharded one-LM-iteration function (jit over the mesh).

    Returns ``step(T_cw, X_w, obs, valid_lm, fixed_pose, lam, H_extra,
    g_extra) -> (T_new, X_new, cost_at_input)`` — cost is evaluated at the
    INPUT state so the host can run an accept/reject damping schedule with
    one extra call at the end.
    """

    @f32_highest
    def per_shard(T_cw, X_w, obs: BAObservations, valid_lm, fixed_pose,
                  lam, H_extra, g_extra):
        Pn = T_cw.shape[0]
        L, K = obs.pose_idx.shape
        pidx = jnp.clip(obs.pose_idx, 0, Pn - 1).reshape(-1)
        T_o = T_cw[pidx]
        X_o = jnp.repeat(X_w, K, axis=0)
        rr = factors.reproj_residuals(
            cam, T_o, X_o, obs.uv.reshape(-1, 3), obs.inv_sigma2.reshape(-1),
            obs.stereo.reshape(-1),
        )
        thresh = jnp.where(obs.stereo.reshape(-1), factors.CHI2_STEREO, factors.CHI2_MONO)
        w_hub = factors.huber_weight(rr.chi2, thresh)
        active = obs.valid.reshape(-1) & rr.depth_ok
        w = obs.inv_sigma2.reshape(-1) * w_hub * active.astype(rr.r.dtype)

        Jp = rr.J_pose * w[:, None, None]
        Hpp_blk = jnp.einsum("oij,oik->ojk", Jp, rr.J_pose)
        gp_blk = jnp.einsum("oij,oi->oj", Jp, rr.r)
        # one-hot pose-slot contraction instead of scatter-add (see
        # lm.local_ba)
        pi = jnp.clip(obs.pose_idx, 0, Pn - 1)
        oh = (pi.reshape(-1)[:, None]
              == jnp.arange(Pn)[None, :]).astype(jnp.float32)  # [O, Pn]
        Hpp = jnp.einsum("op,ojk->pjk", oh, Hpp_blk)
        gp = jnp.einsum("op,oj->pj", oh, gp_blk)

        Hll = jnp.sum(
            jnp.einsum("oij,oik->ojk", rr.J_lm * w[:, None, None], rr.J_lm
                       ).reshape(L, K, 3, 3), axis=1)
        gl = jnp.sum(
            jnp.einsum("oij,oi->oj", rr.J_lm * w[:, None, None], rr.r
                       ).reshape(L, K, 3), axis=1)
        B = jnp.einsum("oij,oik->ojk", Jp, rr.J_lm).reshape(L, K, 6, 3)

        lmw = valid_lm.astype(jnp.float32)
        Hll_d = Hll + lam * jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(Hll)) \
            + 1e-6 * jnp.eye(3)
        Hll_inv = inv3x3(Hll_d) * lmw[:, None, None]

        ohk = oh.reshape(L, K, Pn)
        BHinv = jnp.einsum("lkij,ljm->lkim", B, Hll_inv)
        U = jnp.einsum("lkp,lkim->lpim", ohk, BHinv)
        V = jnp.einsum("lkp,lkjm->lpjm", ohk, B)
        corr_pq = jnp.einsum("lpim,lqjm->pqij", U, V)
        S = jnp.zeros((Pn, Pn, 6, 6))
        S = S.at[jnp.arange(Pn), jnp.arange(Pn)].add(Hpp)
        S = S - corr_pq
        gcorr = jnp.einsum("lpim,lm->pi", U, gl)
        g_red = gp - gcorr

        # all-reduce the reduced camera system across the mesh
        S = jax.lax.psum(S, "lm")
        g_red = jax.lax.psum(g_red, "lm")
        cost = jax.lax.psum(jnp.sum(w * jnp.sum(rr.r * rr.r, -1)), "lm")

        free = (~fixed_pose).astype(jnp.float32)
        S = S * free[:, None, None, None] * free[None, :, None, None]
        D = Pn * 6
        Sd = S.transpose(0, 2, 1, 3).reshape(D, D)
        free_d = jnp.repeat(free, 6)
        # replicated dense pose extras (BALM quadratic / priors)
        Sd = Sd + H_extra * free_d[:, None] * free_d[None, :]
        g_full = g_red.reshape(-1) * free_d + g_extra * free_d
        Sd = Sd + jnp.diag(1.0 - free_d)
        Sd = Sd + lam * jnp.diag(jnp.abs(jnp.diag(Sd))) + 1e-8 * jnp.eye(D)
        dp = -precond_solve(Sd, g_full).reshape(Pn, 6)
        dp = dp * free[:, None]

        # landmark back-substitution — local to this shard
        dp_obs = jnp.einsum("lkp,pj->lkj", ohk, dp)
        Bt_dp = jnp.einsum("lkij,lki->lj", B, dp_obs)
        dl = -jnp.einsum("lij,lj->li", Hll_inv, gl + Bt_dp) * lmw[:, None]

        T_new = lie.se3_exp(dp) @ T_cw
        return T_new, X_w + dl, cost

    specs_obs = BAObservations(
        pose_idx=P("lm"), uv=P("lm"), inv_sigma2=P("lm"),
        stereo=P("lm"), valid=P("lm"),
    )
    fn = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(), P("lm"), specs_obs, P("lm"), P(), P(), P(), P()),
        out_specs=(P(), P("lm"), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def _cost_fn(mesh: Mesh, cam: cam_mod.Pinhole):
    """Sharded total-cost evaluation (for the accept/reject schedule)."""

    def per_shard(T_cw, X_w, obs: BAObservations, valid_lm):
        Pn = T_cw.shape[0]
        L, K = obs.pose_idx.shape
        pidx = jnp.clip(obs.pose_idx, 0, Pn - 1).reshape(-1)
        rr = factors.reproj_residuals(
            cam, T_cw[pidx], jnp.repeat(X_w, K, axis=0),
            obs.uv.reshape(-1, 3), obs.inv_sigma2.reshape(-1),
            obs.stereo.reshape(-1),
        )
        thresh = jnp.where(obs.stereo.reshape(-1), factors.CHI2_STEREO, factors.CHI2_MONO)
        w_hub = factors.huber_weight(rr.chi2, thresh)
        active = obs.valid.reshape(-1) & rr.depth_ok & valid_lm.repeat(K)
        w = obs.inv_sigma2.reshape(-1) * w_hub * active.astype(rr.r.dtype)
        return jax.lax.psum(jnp.sum(w * jnp.sum(rr.r * rr.r, -1)), "lm")

    specs_obs = BAObservations(
        pose_idx=P("lm"), uv=P("lm"), inv_sigma2=P("lm"),
        stereo=P("lm"), valid=P("lm"),
    )
    fn = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(), P("lm"), specs_obs, P("lm")),
        out_specs=P(), check_vma=False,
    )
    return jax.jit(fn)


@f32_highest
def optimize(mesh, cam, T_cw0, X_w0, obs, valid_lm, fixed_pose, iters=10,
             extra_fn=None, lam0=1e-4):
    """Damped multi-iteration driver with host-side accept/reject.

    ``extra_fn(T_cw) -> (H [6P,6P], g [6P], cost)`` supplies the replicated
    dense pose quadratic (e.g. the BALM eigen-factor via
    ``local_mapping._balm_extra``); evaluated on the host loop each
    iteration, outside the sharded step, under the same precision policy.
    """
    Pn = T_cw0.shape[0]
    D = 6 * Pn
    step = gn_step_fn(mesh, cam)
    cost_of = _cost_fn(mesh, cam)
    zeros = (jnp.zeros((D, D)), jnp.zeros(D))

    T, X = T_cw0, X_w0
    lam = lam0
    cost_prev = None
    for _ in range(iters):
        if extra_fn is not None:
            H_e, g_e, c_e = extra_fn(T)
        else:
            H_e, g_e, c_e = zeros[0], zeros[1], 0.0
        T_new, X_new, cost_in = step(T, X, obs, valid_lm, fixed_pose,
                                     jnp.float32(lam), H_e, g_e)
        if cost_prev is None:
            cost_prev = float(cost_in) + float(c_e)
        cost_new = float(cost_of(T_new, X_new, obs, valid_lm))
        if extra_fn is not None:
            cost_new += float(extra_fn(T_new)[2])
        if cost_new < cost_prev:
            T, X = T_new, X_new
            cost_prev = cost_new
            lam = max(lam * 0.5, 1e-7)
        else:
            lam = min(lam * 4.0, 1e2)
    return T, X, cost_prev
