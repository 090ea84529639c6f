"""Local mapping: keyframe processing + windowed (LiDAR-visual) BA.

Synchronous per-keyframe re-design of the reference's LocalMapping thread
(``LocalMapping.cc``): where the reference runs a free loop (ProcessNewKeyFrame
-> culling -> CreateNewMapPoints -> SearchInNeighbors -> local BA), this
build performs one deterministic mapping step per keyframe insertion — the
bounded-compute equivalent (no ``mbAbortBA`` interruption needed).

The local BA is ``LocalLVBundleAdjustment`` (OptimizerWithLidar.cc:60): the
covisibility window's poses + landmarks with reprojection factors, plus the
BALM plane eigen-factor over the last ``balm_window`` LiDAR-bearing KFs,
injected into the reduced camera system as a dense quadratic.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..geom import camera as cam_mod, lie
from ..solver import balm as balm_mod, lm as lm_mod
from . import mapstate


class LidarStore(NamedTuple):
    """Per-keyframe LiDAR surf points (LiDAR frame), fixed capacity."""

    points: jax.Array   # [K, Ms, 3]
    valid: jax.Array    # [K, Ms]

    @staticmethod
    def create(max_kf: int, n_points: int):
        return LidarStore(
            jnp.zeros((max_kf, n_points, 3), jnp.float32),
            jnp.zeros((max_kf, n_points), bool),
        )

    def set_kf(self, kf_id, pts, valid):
        return LidarStore(
            self.points.at[kf_id].set(pts),
            self.valid.at[kf_id].set(valid),
        )


def select_window(m: mapstate.MapState, kf_id: int, n_window: int,
                  n_kf: int | None = None,
                  alive: "list[bool] | None" = None,
                  covis=None):
    """Covisibility window KF ids (host-side): the new KF + best covisible.

    Falls back to temporal neighbors when covisibility is thin (early map);
    ``alive`` (host mirror of kf_valid) keeps culled keyframes out of the
    fallback. Returns (window list of EXACTLY n_window entries, NO_KF-padded
    at the tail, and the matching fixed mask) — fixed shapes keep one
    compiled BA for every window size. The oldest real KF is the gauge
    anchor, mirroring the reference fixing observer KFs; padded slots are
    held fixed too.

    ``covis`` optionally supplies the (neigh, weight) device arrays of an
    earlier ``mapstate.top_covisible(m, kf_id, n_window - 1, min_weight=10)``
    call whose device->host copy was started asynchronously — the fetch here
    is then free (the deferred-mapping pipeline in slam/system.py uses this
    to keep the keyframe event sync-free).
    """
    if covis is None:
        covis = mapstate.top_covisible(
            m, jnp.int32(kf_id), n_window - 1, min_weight=10)
    neigh, w = covis
    neigh = [int(i) for i, ww in zip(np.asarray(neigh), np.asarray(w)) if i >= 0 and ww > 0]
    if alive is not None:
        neigh = [i for i in neigh if alive[i]]
    window = sorted(set([kf_id] + neigh))
    # temporal fallback
    want = min(n_window, int(m.n_kf) if n_kf is None else n_kf)
    i = kf_id - 1
    while len(window) < want and i >= 0:
        if i not in window and (alive is None or alive[i]):
            window.append(i)
        i -= 1
    window = sorted(window)[:n_window]
    fixed = [w == window[0] for w in window]
    pad = n_window - len(window)
    return window + [mapstate.NO_KF] * pad, fixed + [True] * pad


def _balm_extra(
    T_cw_win: jax.Array,      # [P, 4, 4] window camera poses (traced)
    clusters: balm_mod.VoxelClusters,
    pos_in_win: jax.Array,    # [n_l] window-slot index per lidar KF
    lvalid: jax.Array,        # [n_l] real (non-padded) lidar slots
    T_cl: jax.Array,          # [4, 4] camera-from-lidar extrinsic
    w_lba: jax.Array,         # scalar LiDAR BA weight
):
    """BALM eigen-factor quadratic, transported to window pose tangents.

    Module-level on purpose: ``run_local_ba`` binds the per-window arrays
    via ``jax.tree_util.Partial`` so ``local_ba`` sees ONE stable callable
    and compiles exactly once (the round-1 per-keyframe closure recompiled
    XLA on every BA keyframe). This is the ``EdgeLidarSE3::
    constructQuadraticForm`` dense-block injection (G2oTypesWithLidar.h:
    169-236) with the camera-frame chain rule of ComputeJandHSE3
    (LidarRes.cc:130-175) folded into an adjoint transport.
    """
    P = T_cw_win.shape[0]
    n_l = pos_in_win.shape[0]
    # chain: left-tangent δ of T_cw -> right-tangent of T_wl is
    # -Adj(T_lc) δ  (T_wl = T_cw^-1 T_cl)
    C1 = -lie.se3_adjoint(lie.se3_inverse(T_cl))  # [6, 6]
    T_wl = jax.vmap(lambda T: lie.se3_inverse(T) @ T_cl)(T_cw_win[pos_in_win])
    q = balm_mod.quadratic(clusters, T_wl)
    D = 6 * P
    H = jnp.zeros((D, D), T_cw_win.dtype)
    g = jnp.zeros((D,), T_cw_win.dtype)
    Hq = q.H.reshape(n_l, 6, n_l, 6)
    gq = q.g.reshape(n_l, 6)
    # transport each block: H_ab -> C1^T H_ab C1 ; g_a -> C1^T g_a
    Ht = jnp.einsum("ki,akbl,lj->abij", C1, Hq, C1)
    gt = jnp.einsum("ki,ak->ai", C1, gq)
    # padded lidar slots contribute nothing
    lw = lvalid.astype(T_cw_win.dtype)
    Ht = Ht * lw[:, None, None, None] * lw[None, :, None, None]
    gt = gt * lw[:, None]
    rows = pos_in_win[:, None] * 6 + jnp.arange(6)[None, :]  # [n_l, 6]
    H = H.at[rows[:, :, None, None], rows[None, None, :, :]].add(
        Ht.transpose(0, 2, 1, 3) * w_lba
    )
    g = g.at[rows.reshape(-1)].add(gt.reshape(-1) * w_lba)
    return H, g, q.cost * w_lba


from functools import partial as _partial


def _ba_prep(m, window_arr, sigma2, max_active: int):
    """Window observation table + fixed-budget landmark compaction."""
    wvalid = window_arr != mapstate.NO_KF
    win_pos, uvr, inv_sigma2, stereo, ok = mapstate.landmark_major_obs(
        m, window_arr, sigma2
    )
    # landmarks active in this window, COMPACTED to a fixed budget: the
    # solver's Schur cross-terms are O(L x Ko^2 x 36) floats — over the full
    # 32k pool that is ~300 MB of HBM traffic per LM iteration, vs ~a tenth
    # for the few thousand landmarks a 6-KF window actually observes.
    lm_active_full = jnp.any(ok, axis=1) & m.lm_valid
    sel = jnp.argsort(~lm_active_full)[:max_active].astype(jnp.int32)
    obs = lm_mod.BAObservations(
        pose_idx=win_pos[sel], uv=uvr[sel], inv_sigma2=inv_sigma2[sel],
        stereo=stereo[sel], valid=ok[sel],
    )
    lm_active = lm_active_full[sel]
    # padded slots get identity poses (finite math; they are fixed + have no
    # observations, so they contribute nothing)
    T0 = jnp.where(
        wvalid[:, None, None],
        m.kf_T_cw[jnp.clip(window_arr, 0, m.K - 1)],
        jnp.eye(4, dtype=m.kf_T_cw.dtype),
    )
    return obs, lm_active, sel, T0, m.lm_pos[sel], wvalid


def _balm_extra_fn(m, lidar, lidx, pos_in_win, T_cl, w_lba,
                   balm_voxel, balm_max_voxels: int, balm_min_points: int):
    """Build the BALM quadratic term for the window's LiDAR keyframes."""
    lvalid = lidx != mapstate.NO_KF
    lidx_c = jnp.clip(lidx, 0, m.K - 1)
    T_wl_init = jax.vmap(
        lambda T: lie.se3_inverse(T) @ T_cl
    )(jnp.where(lvalid[:, None, None], m.kf_T_cw[lidx_c],
                jnp.eye(4, dtype=m.kf_T_cw.dtype)))
    clusters = balm_mod.build_clusters(
        lidar.points[lidx_c], lidar.valid[lidx_c] & lvalid[:, None],
        T_wl_init,
        voxel_size=balm_voxel, max_voxels=balm_max_voxels,
        min_points=balm_min_points,
    )
    # (no host-side emptiness check: an empty cluster set yields a zero
    # quadratic, keeping the step sync-free and single-variant)

    # Partial over the module-level function: the per-window arrays are
    # DATA (traced jit args), so local_ba compiles once — never a fresh
    # closure in static_argnames (round-1 recompiled per keyframe).
    return jax.tree_util.Partial(
        _balm_extra,
        clusters=clusters,
        pos_in_win=pos_in_win,
        lvalid=lvalid,
        T_cl=T_cl,
        w_lba=jnp.asarray(w_lba, jnp.float32),
    )


@_partial(jax.jit, static_argnames=(
    "max_active", "iters", "use_balm", "balm_max_voxels", "balm_min_points",
    "balm_voxel", "w_lba"))
def _ba_kernel(
    m, lidar, window_arr, fixed_arr, lidx, pos_in_win, cam, sigma2, T_cl,
    balm_voxel: float, w_lba: float,
    max_active: int, iters: int, use_balm: bool,
    balm_max_voxels: int, balm_min_points: int,
):
    """The WHOLE single-device BA pass as one XLA program: observation-table
    prep, landmark compaction, BALM cluster build, LM solve, and pose/
    landmark writeback (un-fused, the prep + writeback alone is ~20
    dispatches and an unfused 32k argsort chain)."""
    obs, lm_active, sel, T0, X0, wvalid = _ba_prep(
        m, window_arr, sigma2, max_active)
    extra_fn = None
    if use_balm:
        extra_fn = _balm_extra_fn(
            m, lidar, lidx, pos_in_win, T_cl, w_lba,
            balm_voxel, balm_max_voxels, balm_min_points)
    res = lm_mod.local_ba(
        cam, T0, X0, obs, fixed_arr, lm_active, iters=iters,
        extra_fn=extra_fn,
    )
    scatter_idx = jnp.where(wvalid, window_arr, m.K)  # padded -> dropped
    new_T = m.kf_T_cw.at[scatter_idx].set(res.T_cw, mode="drop")
    new_X = m.lm_pos.at[sel].set(
        jnp.where(lm_active[:, None], res.X_w, m.lm_pos[sel])
    )
    return new_T, new_X


def run_local_ba(
    m: mapstate.MapState,
    lidar: LidarStore | None,
    kf_id: int,
    cam: cam_mod.Pinhole,
    sigma2: jax.Array,
    T_cl: jax.Array,
    n_window: int = 8,
    balm_window: int = 6,
    balm_voxel: float = 1.0,
    balm_max_voxels: int = 512,
    balm_min_points: int = 15,
    w_lba: float = 0.01,
    iters: int = 8,
    n_kf: int | None = None,   # host mirror of m.n_kf (avoids a device sync)
    window: "list[int] | None" = None,   # precomputed select_window output
    fixed: "list[bool] | None" = None,
    max_active: int = 8192,    # landmark budget for the windowed solve
    mesh=None,                 # jax.sharding.Mesh -> distributed BA path
) -> mapstate.MapState:
    """One LocalLVBundleAdjustment pass around ``kf_id``; returns updated map.

    The window is NO_KF-padded to exactly ``n_window`` slots so every call
    (regardless of how many KFs exist yet) hits ONE compiled BA kernel —
    variable window lengths would otherwise compile a fresh ~minute-long
    XLA program per size.
    """
    if window is None:
        window, fixed = select_window(m, kf_id, n_window, n_kf=n_kf)
    P = len(window)  # == n_window always
    window_arr = jnp.asarray(window, jnp.int32)
    fixed_arr = jnp.asarray(fixed)

    use_balm = lidar is not None and w_lba > 0
    # last balm_window REAL KFs of the window carry the lidar residual;
    # static slice size, NO_KF-padded like the window itself (host-side
    # list math only — all device work happens inside _ba_kernel)
    bw = min(balm_window, n_window)
    lidar_ids = [i for i in window if i != mapstate.NO_KF][-bw:]
    pos_list = [window.index(i) for i in lidar_ids]
    lidar_ids += [mapstate.NO_KF] * (bw - len(lidar_ids))
    pos_list += [0] * (bw - len(pos_list))
    lidx = jnp.asarray(lidar_ids, jnp.int32)
    pos_in_win = jnp.asarray(pos_list, jnp.int32)

    if mesh is not None:
        # Distributed path: landmarks/observations shard over the mesh, the
        # reduced camera system is psum'd across it, the BALM quadratic
        # enters replicated (parallel/dist_ba). Same problem, same windows.
        obs, lm_active, sel, T0, X0, wvalid = _ba_prep(
            m, window_arr, sigma2, max_active)
        extra_fn = None
        if use_balm:
            extra_fn = _balm_extra_fn(
                m, lidar, lidx, pos_in_win, T_cl, w_lba,
                balm_voxel, balm_max_voxels, balm_min_points)
        from ..parallel import dist_ba
        Xs, obs_s, act_s = dist_ba.shard_problem(mesh, X0, obs, lm_active)
        res_T, res_X, _ = dist_ba.optimize(
            mesh, cam, T0, Xs, obs_s, act_s, fixed_arr, iters=iters,
            extra_fn=extra_fn,
        )
        scatter_idx = jnp.where(wvalid, window_arr, m.K)
        new_T = m.kf_T_cw.at[scatter_idx].set(res_T, mode="drop")
        new_X = m.lm_pos.at[sel].set(
            jnp.where(lm_active[:, None], res_X, m.lm_pos[sel])
        )
        return m._replace(kf_T_cw=new_T, lm_pos=new_X)

    lidar_in = lidar if use_balm else LidarStore(
        jnp.zeros((1, 1, 3), jnp.float32), jnp.zeros((1, 1), bool))
    new_T, new_X = _ba_kernel(
        m, lidar_in, window_arr, fixed_arr, lidx, pos_in_win, cam, sigma2,
        T_cl, balm_voxel=float(balm_voxel), w_lba=float(w_lba),
        max_active=max_active, iters=iters, use_balm=use_balm,
        balm_max_voxels=balm_max_voxels, balm_min_points=balm_min_points,
    )
    return m._replace(kf_T_cw=new_T, lm_pos=new_X)
