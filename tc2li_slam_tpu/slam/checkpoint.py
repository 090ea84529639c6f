"""Checkpoint / resume: atlas serialization with integrity checksums.

Replaces the reference's boost-serialization atlas checkpoints
(``System::SaveAtlas``/``LoadAtlas``, System.cc:632-760): it writes the full
Atlas (maps, keyframes, map points, cameras) plus an MD5 of the vocabulary so
a resume with a different vocabulary is rejected. The device-side state is
already flat fixed-capacity arrays, so the checkpoint is a single ``.npz`` of
those pools plus a small JSON header — no per-object serialize methods needed.

``save_system`` captures everything required to continue tracking: the active
map bundle, frozen atlas maps, the LiDAR voxel map, current pose/velocity,
trajectory so far, and host counters. ``load_system`` restores into a fresh
``System`` built from the same config (mirroring the reference's flow where
settings are loaded first and the atlas after, System.cc:95-105,165-180).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any

import numpy as np
import jax.numpy as jnp


FORMAT_VERSION = 1


def _md5_of_arrays(*arrays) -> str:
    h = hashlib.md5()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def vocabulary_checksum(voc) -> str:
    """MD5 over the vocabulary arrays (the reference checksums ORBvoc.txt,
    System.cc:644-655; here the array form is the canonical content)."""
    return _md5_of_arrays(voc.node_desc, voc.children, voc.weight)


def _flatten(prefix: str, tree: Any, out: dict[str, np.ndarray]):
    """NamedTuple/array pytree -> flat {key: np.ndarray} dict."""
    if tree is None:
        return
    if hasattr(tree, "_fields"):  # NamedTuple
        for name in tree._fields:
            _flatten(f"{prefix}{name}.", getattr(tree, name), out)
        return
    out[prefix.rstrip(".")] = np.asarray(tree)


def _unflatten(cls, prefix: str, data: dict):
    """Rebuild a NamedTuple whose array fields were saved by ``_flatten``.

    Recurses into nested NamedTuple fields via the class annotations
    (e.g. ``esekf.Filter.x: State``)."""
    kwargs = {}
    annotations = getattr(cls, "__annotations__", {})
    for name in cls._fields:
        key = f"{prefix}{name}"
        if key in data:
            kwargs[name] = jnp.asarray(data[key])
        else:
            sub = annotations.get(name)
            if sub is not None and hasattr(sub, "_fields"):
                kwargs[name] = _unflatten(sub, f"{key}.", data)
            else:
                raise KeyError(f"checkpoint missing field {key}")
    return cls(**kwargs)


def save_system(slam, path: str):
    """Write a resumable checkpoint of the full system state."""
    slam.flush_mapping()  # land deferred LocalMapping work first
    arrays: dict[str, np.ndarray] = {}
    _flatten("map.", slam.map, arrays)
    if slam.lidar_enabled:
        _flatten("vmap.", slam.vmap, arrays)
        _flatten("lidar_store.", slam.lidar_store, arrays)
    if slam.voc is not None:
        arrays["kf_words"] = np.asarray(slam.kf_words)
    if slam.use_imu:
        _flatten("filt.", slam.filt, arrays)
        _flatten("imu_store.", slam.imu_store, arrays)
        arrays["gravity_vis"] = np.asarray(slam.gravity_vis)
    arrays["T_cw"] = np.asarray(slam.T_cw)
    arrays["velocity"] = np.asarray(slam.velocity)
    # frozen atlas maps
    for i, b in enumerate(slam.atlas.frozen):
        _flatten(f"atlas{i}.map.", b.map, arrays)
        if b.lidar_store is not None:
            _flatten(f"atlas{i}.lidar_store.", b.lidar_store, arrays)
        if b.kf_words is not None:
            arrays[f"atlas{i}.kf_words"] = np.asarray(b.kf_words)
    # trajectory (batched fetch)
    if slam.traj:
        arrays["traj.T_rel"] = np.asarray(
            jnp.stack([T for *_, T in slam.traj])
        )

    header = {
        "format_version": FORMAT_VERSION,
        "state": slam.state,
        "ref_kf": slam.ref_kf,
        "n_kf_host": slam.n_kf_host,
        "ref_kf_tracked": slam.ref_kf_tracked,
        "frames_since_kf": slam.frames_since_kf,
        "frame_idx": slam.frame_idx,
        "map_id": slam.map_id,
        "n_lost": slam.n_lost,
        "use_imu": slam.use_imu,
        "lidar_enabled": slam.lidar_enabled,
        "imu_initialized": getattr(slam, "_imu_initialized", False),
        "vi_initialized": getattr(slam, "_vi_initialized", False),
        "kf_alive": list(slam.kf_alive),
        "atlas": {
            "n_created": slam.atlas.n_created,
            "n_discarded": slam.atlas.n_discarded,
            "frozen": [
                {"n_kf": b.n_kf, "map_id": b.map_id,
                 "has_lidar": b.lidar_store is not None,
                 "has_words": b.kf_words is not None}
                for b in slam.atlas.frozen
            ],
        },
        "traj_meta": [(t, mid, ref) for t, mid, ref, _ in slam.traj],
        "voc_md5": vocabulary_checksum(slam.voc) if slam.voc is not None else None,
    }
    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_system(path: str, cfg, voc=None):
    """Rebuild a ``System`` from a checkpoint.

    Raises ``ValueError`` on vocabulary checksum mismatch (LoadAtlas's MD5
    guard, System.cc:692-706) or format-version mismatch.
    """
    from . import atlas as atlas_mod, imu_mode, local_mapping, mapstate
    from ..ops import voxel_map as vm_mod
    from ..estimation import esekf
    from . import system as sys_mod

    data = dict(np.load(path, allow_pickle=False))
    header = json.loads(bytes(data.pop("__header__").tobytes()).decode())
    if header["format_version"] != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format {header['format_version']} != {FORMAT_VERSION}"
        )
    if header["voc_md5"] is not None:
        if voc is None or vocabulary_checksum(voc) != header["voc_md5"]:
            raise ValueError("vocabulary checksum mismatch (LoadAtlas MD5 guard)")

    slam = sys_mod.System(cfg, voc)
    slam.map = _unflatten(type(slam.map), "map.", data)
    if slam.lidar_enabled and "vmap.points" in data:
        slam.vmap = _unflatten(type(slam.vmap), "vmap.", data)
        slam.lidar_store = _unflatten(
            type(slam.lidar_store), "lidar_store.", data
        )
    if voc is not None and "kf_words" in data:
        slam.kf_words = jnp.asarray(data["kf_words"])
    if header["use_imu"] and slam.use_imu and "filt.P" in data:
        slam.filt = _unflatten(type(slam.filt), "filt.", data)
        slam.imu_store = _unflatten(type(slam.imu_store), "imu_store.", data)
        slam.gravity_vis = jnp.asarray(data["gravity_vis"])
        slam._imu_initialized = header["imu_initialized"]
        slam._vi_initialized = header.get("vi_initialized", False)
        # host mirror of has_factor (one fetch here; the hot path never
        # reads the device array again)
        slam._has_factor_host = [
            bool(v) for v in np.asarray(slam.imu_store.has_factor)
        ]
        # restart the staged-refinement ladder clock conservatively: a
        # resumed run re-earns its VIBA1/VIBA2 rungs on fresh data
        slam._vi_stage = 0
        slam._vi_init_time = None
        # The per-frame VI ring (_imu_ring/_frame_prior/_prev_vi_state) is
        # NOT checkpointed: a restore mid-keyframe-interval would otherwise
        # preintegrate a truncated window against the pre-save KF anchor.
        # Hold the tightly-coupled frame refine until the next keyframe
        # resets the ring.
        slam._imu_ring_overflow = True
    slam.T_cw = jnp.asarray(data["T_cw"])
    slam.velocity = jnp.asarray(data["velocity"])

    slam.state = header["state"]
    slam.ref_kf = header["ref_kf"]
    slam.n_kf_host = header["n_kf_host"]
    slam.n_lm_host = int(np.asarray(slam.map.n_lm))  # BA-bucket mirror
    slam.ref_kf_tracked = header["ref_kf_tracked"]
    slam.frames_since_kf = header["frames_since_kf"]
    slam.frame_idx = header["frame_idx"]
    slam.map_id = header["map_id"]
    slam.n_lost = header["n_lost"]
    if "kf_alive" in header:
        slam.kf_alive = list(header["kf_alive"])

    slam.atlas = atlas_mod.Atlas(
        n_created=header["atlas"]["n_created"],
        n_discarded=header["atlas"]["n_discarded"],
    )
    for i, meta in enumerate(header["atlas"]["frozen"]):
        b = atlas_mod.MapBundle(
            map=_unflatten(type(slam.map), f"atlas{i}.map.", data),
            n_kf=meta["n_kf"],
            map_id=meta["map_id"],
        )
        if meta["has_lidar"] and slam.lidar_enabled:
            b.lidar_store = _unflatten(
                type(slam.lidar_store), f"atlas{i}.lidar_store.", data
            )
        if meta["has_words"] and f"atlas{i}.kf_words" in data:
            b.kf_words = jnp.asarray(data[f"atlas{i}.kf_words"])
        slam.atlas.frozen.append(b)

    slam.traj = []
    if "traj.T_rel" in data:
        T_rels = jnp.asarray(data["traj.T_rel"])
        for (t, mid, ref), T in zip(header["traj_meta"], T_rels):
            slam.traj.append((t, mid, ref, T))
    return slam
