"""Numerics policy: every float32 contraction of the solvers and filters is
traced at Precision.HIGHEST (a GPU would otherwise be free to run it in
TF32), checked on the jaxpr of each jitted entry point."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

from tc2li_slam_tpu.estimation import esekf, imu
from tc2li_slam_tpu.geom import camera, lie
from tc2li_slam_tpu.numerics import f32_highest
from tc2li_slam_tpu.ops import plane_fit
from tc2li_slam_tpu.parallel import dist_ba
from tc2li_slam_tpu.solver import balm, inertial_ba, lm, sim3

CAM = camera.Pinhole.create(500.0, 500.0, 320.0, 240.0, bf=250.0)
HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _subjaxprs(param):
    if isinstance(param, jcore.ClosedJaxpr):
        yield param.jaxpr
    elif isinstance(param, jcore.Jaxpr):
        yield param
    elif isinstance(param, (tuple, list)):
        for p in param:
            yield from _subjaxprs(p)


def f32_dot_precisions(jaxpr) -> list:
    """Precision of every dot_general with a float32 operand, recursively
    through jit, scan, cond, while and shard_map bodies."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
                v.aval.dtype == jnp.float32 for v in eqn.invars):
            out.append(eqn.params["precision"])
        for param in eqn.params.values():
            for sub in _subjaxprs(param):
                out.extend(f32_dot_precisions(sub))
    return out


def _ba_problem(rng, P=3, L=16, K=3):
    X = np.stack([rng.uniform(-4, 4, L), rng.uniform(-3, 3, L),
                  rng.uniform(8, 20, L)], -1).astype(np.float32)
    obs = lm.BAObservations(
        pose_idx=jnp.asarray(np.tile(np.arange(K) % P, (L, 1)), jnp.int32),
        uv=jnp.asarray(rng.uniform(100, 300, (L, K, 3)), jnp.float32),
        inv_sigma2=jnp.ones((L, K)), stereo=jnp.ones((L, K), bool),
        valid=jnp.ones((L, K), bool))
    T0 = jnp.tile(jnp.eye(4), (P, 1, 1))
    return T0, jnp.asarray(X), obs, jnp.zeros(P, bool).at[0].set(True)


def case_local_ba(rng):
    T0, X, obs, fixed = _ba_problem(rng)
    return lambda: lm.local_ba(CAM, T0, X, obs, fixed,
                               jnp.ones(X.shape[0], bool), iters=2)


def case_pose_only(rng):
    _, X, obs, _ = _ba_problem(rng)
    n = X.shape[0]
    return lambda: lm.pose_only_optimize(
        CAM, jnp.eye(4), X, obs.uv[:, 0], jnp.ones(n), jnp.ones(n, bool),
        jnp.ones(n, bool), rounds=1, iters=2)


def case_lvi_ba(rng):
    from tests.test_inertial_ba import GRAV, simulate_window
    T_gt, vels, fac, X, obs = simulate_window(rng, P=3, L=12)
    P = len(T_gt)
    state0 = inertial_ba.InertialState(
        T_wb=jnp.asarray(T_gt), vel=jnp.asarray(vels),
        bg=jnp.zeros((P, 3)), ba=jnp.zeros((P, 3)))
    fixed = jnp.zeros(P, bool).at[0].set(True)
    return lambda: inertial_ba.lvi_ba(
        CAM, jnp.eye(4), state0, jnp.asarray(X), obs, fac, fixed,
        jnp.ones(len(X), bool), GRAV, iters=2)


def _pos_h_fn(x):
    z = x.pos - jnp.asarray([0.1, -0.2, 0.3])
    H = jnp.zeros((3, esekf.ERR_DIM)).at[:, esekf.POS].set(jnp.eye(3))
    return z, H, jnp.ones(3, bool)


def case_esekf_update(rng):
    f = esekf.init_filter()
    return lambda: esekf.update_iterated(f, _pos_h_fn, jnp.float32(1e-3),
                                         max_iters=2)


def case_esekf_predict(rng):
    f = esekf.init_filter()
    noise = esekf.NoiseCfg.create(gyr=0.01, acc=0.01, bg_rw=1e-5, ba_rw=1e-5)
    g = jnp.asarray(rng.normal(0, 0.1, (4, 3)), jnp.float32)
    return lambda: esekf.predict(f, g, g + 9.81, jnp.full(4, 0.01), noise)


def case_imu_integrate(rng):
    cal = imu.ImuCalib.create(1.7e-3, 2e-2, 1.9e-5, 3e-4)
    g = jnp.asarray(rng.normal(0, 0.1, (4, 3)), jnp.float32)
    return lambda: imu.integrate(cal, g, g + 9.81, jnp.full(4, 0.01),
                                 jnp.zeros(3), jnp.zeros(3))


def case_dist_ba_step(rng):
    T0, X, obs, fixed = _ba_problem(rng)
    mesh = dist_ba.make_mesh(jax.devices()[:1])
    step = dist_ba.gn_step_fn(mesh, CAM)
    D = 6 * T0.shape[0]
    return lambda: step(T0, X, obs, jnp.ones(X.shape[0], bool), fixed,
                        jnp.float32(1e-4), jnp.zeros((D, D)), jnp.zeros(D))


def case_pose_graph(rng):
    K = 4
    edges = sim3.PoseGraphEdges(
        i=jnp.arange(K - 1, dtype=jnp.int32),
        j=jnp.arange(1, K, dtype=jnp.int32),
        S_ij=jnp.tile(jnp.eye(4), (K - 1, 1, 1)),
        weight=jnp.ones(K - 1), valid=jnp.ones(K - 1, bool))
    return lambda: sim3.pose_graph_optimize(
        jnp.tile(jnp.eye(4), (K, 1, 1)), edges,
        jnp.zeros(K, bool).at[0].set(True), iters=2)


def case_balm_window(rng):
    from tests.test_solver import make_balm_window
    pts, valid, T_gt = make_balm_window(rng, W=3, n_planes=3, pts_per=30)
    c = balm.build_clusters(pts, valid, T_gt, max_voxels=64)
    return lambda: balm.optimize_window(c, T_gt, iters=2)


def case_fit_planes(rng):
    pts = jnp.asarray(rng.normal(size=(8, 5, 3)), jnp.float32)
    return lambda: plane_fit.fit_planes(pts, jnp.ones((8, 5), bool))


CASES = {
    "local_ba": case_local_ba,
    "pose_only": case_pose_only,
    "lvi_ba": case_lvi_ba,
    "esekf_update": case_esekf_update,
    "esekf_predict": case_esekf_predict,
    "imu_integrate": case_imu_integrate,
    "dist_ba_step": case_dist_ba_step,
    "pose_graph": case_pose_graph,
    "balm_window": case_balm_window,
    "fit_planes": case_fit_planes,
}


@pytest.mark.parametrize("name", list(CASES))
def test_f32_contractions_run_at_highest(name, rng):
    fn = CASES[name](rng)
    precisions = f32_dot_precisions(jax.make_jaxpr(fn)().jaxpr)
    assert precisions, f"{name}: no float32 contraction traced"
    bad = [p for p in precisions if p != HIGHEST]
    assert not bad, f"{name}: {len(bad)}/{len(precisions)} at {bad[0]}"


def test_f32_highest_sets_and_scopes_precision():
    a = jnp.ones((3, 3))

    def prod(x):
        return lie.hat(x[0]) @ x

    plain = f32_dot_precisions(jax.make_jaxpr(prod)(a).jaxpr)
    assert plain and all(p is None for p in plain)
    held = f32_dot_precisions(jax.make_jaxpr(f32_highest(prod))(a).jaxpr)
    assert held == [HIGHEST] * len(plain)
    # the setting does not leak past the decorated call
    assert f32_dot_precisions(jax.make_jaxpr(prod)(a).jaxpr) == plain
    # a lower precision asked for around the call or globally does not win
    with jax.default_matmul_precision("tensorfloat32"):
        asked = f32_dot_precisions(jax.make_jaxpr(f32_highest(prod))(a).jaxpr)
        assert f32_dot_precisions(jax.make_jaxpr(prod)(a).jaxpr) != held
    assert asked == held
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "bfloat16")
    try:
        glob = f32_dot_precisions(jax.make_jaxpr(f32_highest(prod))(a).jaxpr)
    finally:
        jax.config.update("jax_default_matmul_precision", prev)
    assert glob == held
