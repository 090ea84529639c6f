"""Array-pool SLAM map: keyframes, landmarks, observations, covisibility.

Device-array replacement for the reference's pointer-graph map layer
(``KeyFrame.cc`` / ``MapPoint.cc`` / ``Map.cc``): instead of heap objects,
``set<KeyFrame*>``, per-object mutexes and a covisibility adjacency kept by
hand (``KeyFrame::UpdateConnections``), the whole map lives in fixed-capacity
device arrays with validity masks, and every query (covisibility weights,
local-map assembly, observation tables for BA) is a batched gather/scatter.

Layout
------
- Keyframe pool ``[K]``: pose, per-feature keypoint data ``[K, F]`` and the
  feature->landmark assignment ``kf_feat_lm`` (−1 = unmatched). This table IS
  the observation structure — the landmark-major view needed by the solver is
  derived from the inverse table kept on landmarks.
- Landmark pool ``[L]``: position, distinctive descriptor, view normal,
  scale-invariance distance range, found/visible counters, and a padded
  observer table ``lm_obs_kf/feat [L, Ko]`` mirroring
  ``MapPoint::GetObservations``.

Functional updates: every mutation returns a new ``MapState`` (XLA aliases
buffers; no copies materialize under jit).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

NO_LM = -1
NO_KF = -1


class MapState(NamedTuple):
    # --- keyframes ---
    kf_T_cw: jax.Array       # [K, 4, 4] world->camera
    kf_valid: jax.Array      # [K]
    kf_timestamp: jax.Array  # [K]
    kf_xy: jax.Array         # [K, F, 2] keypoint pixel coords (level 0)
    kf_uvr: jax.Array        # [K, F, 3] (u, v, u_r) observation (u_r<0: mono)
    kf_level: jax.Array      # [K, F] octave
    kf_angle: jax.Array      # [K, F]
    kf_desc: jax.Array       # [K, F, 8] uint32
    kf_feat_valid: jax.Array  # [K, F]
    kf_feat_lm: jax.Array    # [K, F] int32 landmark id or NO_LM
    # --- landmarks ---
    lm_pos: jax.Array        # [L, 3]
    lm_desc: jax.Array       # [L, 8]
    lm_normal: jax.Array     # [L, 3]
    lm_dist: jax.Array       # [L, 2] (min, max) scale-invariance range
    lm_valid: jax.Array      # [L]
    lm_obs_kf: jax.Array     # [L, Ko] observing KF ids (NO_KF pad)
    lm_obs_feat: jax.Array   # [L, Ko] feature index within that KF
    lm_n_obs: jax.Array      # [L]
    lm_visible: jax.Array    # [L] TrackLocalMap visibility counter
    lm_found: jax.Array      # [L] inlier counter
    lm_first_kf: jax.Array   # [L]
    # --- counters ---
    n_kf: jax.Array          # []
    n_lm: jax.Array          # []

    @property
    def K(self):
        return self.kf_T_cw.shape[0]

    @property
    def F(self):
        return self.kf_xy.shape[1]

    @property
    def L(self):
        return self.lm_pos.shape[0]

    @property
    def Ko(self):
        return self.lm_obs_kf.shape[1]


def create(max_kf: int = 512, max_feats: int = 1024, max_lm: int = 16384,
           max_obs: int = 16, dtype=jnp.float32) -> MapState:
    K, F, L, Ko = max_kf, max_feats, max_lm, max_obs
    return MapState(
        kf_T_cw=jnp.tile(jnp.eye(4, dtype=dtype), (K, 1, 1)),
        kf_valid=jnp.zeros(K, bool),
        kf_timestamp=jnp.zeros(K, dtype),
        kf_xy=jnp.zeros((K, F, 2), dtype),
        kf_uvr=jnp.zeros((K, F, 3), dtype),
        kf_level=jnp.zeros((K, F), jnp.int32),
        kf_angle=jnp.zeros((K, F), dtype),
        kf_desc=jnp.zeros((K, F, 8), jnp.uint32),
        kf_feat_valid=jnp.zeros((K, F), bool),
        kf_feat_lm=jnp.full((K, F), NO_LM, jnp.int32),
        lm_pos=jnp.zeros((L, 3), dtype),
        lm_desc=jnp.zeros((L, 8), jnp.uint32),
        lm_normal=jnp.zeros((L, 3), dtype),
        lm_dist=jnp.zeros((L, 2), dtype),
        lm_valid=jnp.zeros(L, bool),
        lm_obs_kf=jnp.full((L, Ko), NO_KF, jnp.int32),
        lm_obs_feat=jnp.zeros((L, Ko), jnp.int32),
        lm_n_obs=jnp.zeros(L, jnp.int32),
        lm_visible=jnp.ones(L, jnp.int32),
        lm_found=jnp.ones(L, jnp.int32),
        lm_first_kf=jnp.zeros(L, jnp.int32),
        n_kf=jnp.int32(0),
        n_lm=jnp.int32(0),
    )


# ---------------------------------------------------------------------------
# Keyframe insertion
# ---------------------------------------------------------------------------

@jax.jit
def add_keyframe(
    m: MapState,
    T_cw: jax.Array,
    timestamp: jax.Array,
    xy: jax.Array,        # [F, 2]
    uvr: jax.Array,       # [F, 3]
    level: jax.Array,     # [F]
    angle: jax.Array,     # [F]
    desc: jax.Array,      # [F, 8]
    feat_valid: jax.Array,  # [F]
    feat_lm: jax.Array,   # [F] landmark ids already matched (NO_LM otherwise)
) -> tuple[MapState, jax.Array]:
    """Append a keyframe; returns (map, kf_id). Overflow drops the KF."""
    kid = m.n_kf
    ok = kid < m.K
    slot = jnp.minimum(kid, m.K - 1)
    sel = lambda new, old: jnp.where(ok, new, old)
    m = m._replace(
        kf_T_cw=m.kf_T_cw.at[slot].set(sel(T_cw, m.kf_T_cw[slot])),
        kf_valid=m.kf_valid.at[slot].set(sel(True, m.kf_valid[slot])),
        kf_timestamp=m.kf_timestamp.at[slot].set(sel(timestamp, m.kf_timestamp[slot])),
        kf_xy=m.kf_xy.at[slot].set(sel(xy, m.kf_xy[slot])),
        kf_uvr=m.kf_uvr.at[slot].set(sel(uvr, m.kf_uvr[slot])),
        kf_level=m.kf_level.at[slot].set(sel(level, m.kf_level[slot])),
        kf_angle=m.kf_angle.at[slot].set(sel(angle, m.kf_angle[slot])),
        kf_desc=m.kf_desc.at[slot].set(sel(desc, m.kf_desc[slot])),
        kf_feat_valid=m.kf_feat_valid.at[slot].set(sel(feat_valid, m.kf_feat_valid[slot])),
        kf_feat_lm=m.kf_feat_lm.at[slot].set(sel(feat_lm, m.kf_feat_lm[slot])),
        n_kf=m.n_kf + ok.astype(jnp.int32),
    )
    # register observations on the matched landmarks
    m = _add_observations(m, slot, feat_lm, feat_valid & (feat_lm != NO_LM) & ok)
    return m, slot


def _add_observations(m: MapState, kf_id, feat_lm, mask, feat_idx=None):
    """Append (kf_id, feat_idx) into each landmark's observer table.

    ``feat_idx`` defaults to the position in ``feat_lm`` (the add_keyframe
    case where the array is feature-aligned)."""
    F = feat_lm.shape[0]
    if feat_idx is None:
        feat_idx = jnp.arange(F, dtype=jnp.int32)
    lm = jnp.clip(feat_lm, 0, m.L - 1)
    # next free slot per landmark = lm_n_obs (capped)
    slot = jnp.clip(m.lm_n_obs[lm], 0, m.Ko - 1)
    # Collisions (two features of one KF to the same lm) are invalid upstream.
    lm_scatter = jnp.where(mask, lm, m.L - 1)  # dead-write lane
    can = mask & (m.lm_n_obs[lm] < m.Ko)
    obs_kf = m.lm_obs_kf.at[lm_scatter, slot].set(
        jnp.where(can, kf_id, m.lm_obs_kf[lm_scatter, slot])
    )
    obs_feat = m.lm_obs_feat.at[lm_scatter, slot].set(
        jnp.where(can, feat_idx, m.lm_obs_feat[lm_scatter, slot])
    )
    n_obs = m.lm_n_obs.at[lm_scatter].add(can.astype(jnp.int32))
    return m._replace(lm_obs_kf=obs_kf, lm_obs_feat=obs_feat, lm_n_obs=n_obs)


# ---------------------------------------------------------------------------
# Landmark insertion
# ---------------------------------------------------------------------------

@jax.jit
def add_landmarks(
    m: MapState,
    kf_id: jax.Array,
    feat_idx: jax.Array,   # [B] feature indices in kf_id to promote
    pos: jax.Array,        # [B, 3] world positions
    desc: jax.Array,       # [B, 8]
    normal: jax.Array,     # [B, 3]
    dist: jax.Array,       # [B, 2]
    valid: jax.Array,      # [B]
) -> tuple[MapState, jax.Array]:
    """Allocate new landmarks observed by (kf_id, feat_idx).

    Slots are RECYCLED: culled/fused landmarks free their slot and the
    allocator hands out the lowest-index invalid slots first, so fixed
    pools survive arbitrarily long sequences (the reference's new/delete
    churn; round 1 was append-only and overflowed at max_lm).

    Returns (map, lm_ids [B]) with NO_LM where not allocated.
    """
    B = feat_idx.shape[0]
    offset = jnp.cumsum(valid.astype(jnp.int32)) - 1
    # stable argsort of the validity mask lists free slots first, ascending
    free_order = jnp.argsort(m.lm_valid).astype(jnp.int32)
    n_free = m.L - jnp.sum(m.lm_valid).astype(jnp.int32)
    can = valid & (offset < n_free)
    slot = free_order[jnp.clip(offset, 0, m.L - 1)]
    lm_ids = jnp.where(can, slot, NO_LM)
    slot = jnp.where(can, slot, m.L - 1)

    # recycled slots must forget their previous observer table
    obs_kf_row = jnp.where(
        can[:, None] & (jnp.arange(m.Ko)[None, :] == 0),
        kf_id, jnp.where(can[:, None], NO_KF, m.lm_obs_kf[slot]),
    )
    obs_feat_row = jnp.where(
        can[:, None] & (jnp.arange(m.Ko)[None, :] == 0),
        feat_idx[:, None], jnp.where(can[:, None], 0, m.lm_obs_feat[slot]),
    )
    m = m._replace(
        lm_pos=m.lm_pos.at[slot].set(jnp.where(can[:, None], pos, m.lm_pos[slot])),
        lm_desc=m.lm_desc.at[slot].set(jnp.where(can[:, None], desc, m.lm_desc[slot])),
        lm_normal=m.lm_normal.at[slot].set(jnp.where(can[:, None], normal, m.lm_normal[slot])),
        lm_dist=m.lm_dist.at[slot].set(jnp.where(can[:, None], dist, m.lm_dist[slot])),
        lm_valid=m.lm_valid.at[slot].set(jnp.where(can, True, m.lm_valid[slot])),
        lm_obs_kf=m.lm_obs_kf.at[slot].set(obs_kf_row),
        lm_obs_feat=m.lm_obs_feat.at[slot].set(obs_feat_row),
        lm_n_obs=m.lm_n_obs.at[slot].set(jnp.where(can, 1, m.lm_n_obs[slot])),
        lm_first_kf=m.lm_first_kf.at[slot].set(jnp.where(can, kf_id, m.lm_first_kf[slot])),
        lm_visible=m.lm_visible.at[slot].set(jnp.where(can, 1, m.lm_visible[slot])),
        lm_found=m.lm_found.at[slot].set(jnp.where(can, 1, m.lm_found[slot])),
        n_lm=m.n_lm + jnp.sum(can).astype(jnp.int32),
    )
    # link the keyframe features to the new landmarks; dead writes go to an
    # out-of-bounds lane and are dropped (slot 0 would get clobbered by the
    # last duplicate scatter otherwise)
    fslot = jnp.where(can, feat_idx, m.F)
    new_links = m.kf_feat_lm.at[kf_id, fslot].set(lm_ids, mode="drop")
    return m._replace(kf_feat_lm=new_links), lm_ids


@jax.jit
def link_observations(
    m: MapState,
    kf_id: jax.Array,
    feat_idx: jax.Array,   # [B] feature indices in kf_id
    lm_ids: jax.Array,     # [B] landmark ids to link (NO_LM skipped)
    mask: jax.Array,       # [B]
) -> MapState:
    """Register (kf_id, feat_idx) as observers of existing landmarks: sets
    the keyframe feature link and appends to the landmark observer tables
    (MapPoint::AddObservation + KeyFrame::AddMapPoint). Used for the second
    view of triangulated points and for Fuse's observation extension."""
    can = mask & (lm_ids != NO_LM)
    fslot = jnp.where(can, feat_idx, m.F)
    links = m.kf_feat_lm.at[kf_id, fslot].set(
        jnp.where(can, lm_ids, NO_LM), mode="drop"
    )
    m = m._replace(kf_feat_lm=links)
    return _add_observations(m, kf_id, jnp.where(can, lm_ids, NO_LM), can,
                             feat_idx=feat_idx)


# ---------------------------------------------------------------------------
# Covisibility
# ---------------------------------------------------------------------------

@jax.jit
def covisibility_weights(m: MapState, kf_id: jax.Array) -> jax.Array:
    """Shared-landmark counts between ``kf_id`` and every other KF
    (KeyFrame::UpdateConnections weight = #shared MapPoints)."""
    lm = m.kf_feat_lm[kf_id]                       # [F]
    seen = m.kf_feat_valid[kf_id] & (lm != NO_LM)
    lm_c = jnp.clip(lm, 0, m.L - 1)
    # For each observation slot of those landmarks, count the observing KF.
    obs_kf = m.lm_obs_kf[lm_c]                     # [F, Ko]
    obs_ok = (obs_kf != NO_KF) & seen[:, None] & m.lm_valid[lm_c][:, None]
    kf_idx = jnp.where(obs_ok, obs_kf, m.K)        # overflow lane
    w = jnp.zeros(m.K + 1, jnp.int32).at[kf_idx.reshape(-1)].add(
        obs_ok.reshape(-1).astype(jnp.int32)
    )[: m.K]
    w = w.at[kf_id].set(0)
    return jnp.where(m.kf_valid, w, 0)


def top_covisible(m: MapState, kf_id: jax.Array, n: int, min_weight: int = 15):
    """Best-covisibility neighbor list (GetBestCovisibilityKeyFrames)."""
    w = covisibility_weights(m, kf_id)
    vals, idx = jax.lax.top_k(w, n)
    ok = vals >= min_weight
    return jnp.where(ok, idx, NO_KF), vals


# ---------------------------------------------------------------------------
# Solver views
# ---------------------------------------------------------------------------

def landmark_major_obs(
    m: MapState,
    window_kf: jax.Array,   # [P] KF ids of the BA window (NO_KF pad)
    scale_sigma2: jax.Array,  # [n_levels] per-octave sigma^2
):
    """Build the solver's landmark-major observation table restricted to a
    window: obs slots whose KF is in ``window_kf`` are mapped to window
    indices; others invalidated. Returns (BAObservations-tuple fields)."""
    P = window_kf.shape[0]
    # map global KF id -> window position (or -1)
    kf2win = jnp.full((m.K + 1,), -1, jnp.int32)
    wvalid = window_kf != NO_KF
    kf2win = kf2win.at[jnp.where(wvalid, window_kf, m.K)].set(
        jnp.where(wvalid, jnp.arange(P, dtype=jnp.int32), -1)
    )
    obs_kf = jnp.clip(m.lm_obs_kf, NO_KF, m.K - 1)
    win_pos = kf2win[jnp.clip(obs_kf, 0, m.K)]             # [L, Ko]
    ok = (obs_kf != NO_KF) & (win_pos >= 0) & m.lm_valid[:, None]

    kfc = jnp.clip(obs_kf, 0, m.K - 1)
    fc = jnp.clip(m.lm_obs_feat, 0, m.F - 1)
    uvr = m.kf_uvr[kfc, fc]                                 # [L, Ko, 3]
    level = m.kf_level[kfc, fc]
    ok &= m.kf_feat_valid[kfc, fc]
    inv_sigma2 = 1.0 / scale_sigma2[jnp.clip(level, 0, scale_sigma2.shape[0] - 1)]
    stereo = uvr[..., 2] > 0
    return win_pos, uvr, inv_sigma2, stereo, ok


# ---------------------------------------------------------------------------
# Landmark maintenance
# ---------------------------------------------------------------------------

@jax.jit
def remove_landmarks(m: MapState, kill: jax.Array) -> MapState:
    """Invalidate landmarks (MapPoint::SetBadFlag): clears validity and all
    KF feature links pointing at them."""
    lm_valid = m.lm_valid & ~kill
    # clear feature links: any kf_feat_lm pointing to a killed lm -> NO_LM
    pointed = jnp.clip(m.kf_feat_lm, 0, m.L - 1)
    links_bad = (m.kf_feat_lm != NO_LM) & kill[pointed]
    kf_feat_lm = jnp.where(links_bad, NO_LM, m.kf_feat_lm)
    return m._replace(lm_valid=lm_valid, kf_feat_lm=kf_feat_lm,
                      n_lm=jnp.sum(lm_valid).astype(jnp.int32))


@jax.jit
def update_landmark_stats(m: MapState) -> MapState:
    """Refresh view normals from mean observer direction
    (MapPoint::UpdateNormalAndDepth, batched over all valid landmarks)."""
    kfc = jnp.clip(m.lm_obs_kf, 0, m.K - 1)
    ok = (m.lm_obs_kf != NO_KF) & m.lm_valid[:, None]
    T = m.kf_T_cw[kfc]                                   # [L, Ko, 4, 4]
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    centers = -jnp.einsum("lkij,lki->lkj", R, t)         # camera centers
    d = m.lm_pos[:, None, :] - centers
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    n = jnp.sum(jnp.where(ok[..., None], d, 0.0), axis=1)
    cnt = jnp.maximum(jnp.sum(ok, axis=1), 1)[:, None]
    normal = n / cnt
    return m._replace(lm_normal=jnp.where(m.lm_valid[:, None], normal, m.lm_normal))
