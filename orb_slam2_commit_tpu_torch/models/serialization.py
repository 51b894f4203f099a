"""Map checkpoint and resume (PyTorch port of models/serialization.py).

The reference leaves SaveMap / LoadMap as a TODO (include/System.h:116-118).
The map is arrays, so a checkpoint is one .npz of every table and its
scalars, in the JAX package's layout: a map saved by either package loads
in the other. The keyframe database is derived data, rebuilt from the
keyframes' descriptors on load.
"""

from __future__ import annotations

import numpy as np

from orb_slam2_commit_tpu_torch.models.map_state import MapState
from orb_slam2_commit_tpu_torch.utils.config import MapConfig

_ARRAY_FIELDS = [
    "kf_valid", "kf_pose_R", "kf_pose_t", "kf_xy", "kf_octave", "kf_angle",
    "kf_desc", "kf_feat_valid", "kf_depth", "kf_ur", "kf_point_idx",
    "kf_frame_id", "kf_timestamp", "kf_parent", "kf_tcp_R", "kf_tcp_t",
    "pt_valid", "pt_pos", "pt_desc", "pt_normal", "pt_min_dist",
    "pt_max_dist", "pt_first_kf", "pt_visible", "pt_found",
    "cov_weight",
]


def save_map(map_state: MapState, path: str) -> None:
    arrays = {f: getattr(map_state, f) for f in _ARRAY_FIELDS}
    arrays["_loop_edges"] = np.asarray(map_state.loop_edges or [], np.int64).reshape(-1, 2)
    arrays["_meta"] = np.asarray([
        map_state.next_kf, map_state.next_pt, map_state.big_change_idx, map_state.n_feat,
        map_state.cfg.max_keyframes, map_state.cfg.max_points,
        map_state.cfg.covisibility_min_weight, map_state.cfg.grid_cols,
        map_state.cfg.grid_rows,
    ], np.int64)
    np.savez_compressed(path, **arrays)


def load_map(path: str) -> MapState:
    data = np.load(path)
    meta = data["_meta"]
    cfg = MapConfig(max_keyframes=int(meta[4]), max_points=int(meta[5]),
                    covisibility_min_weight=int(meta[6]), grid_cols=int(meta[7]),
                    grid_rows=int(meta[8]))
    m = MapState.create(cfg, int(meta[3]))
    for f in _ARRAY_FIELDS:
        if f in data:   # checkpoints written before a field existed
            getattr(m, f)[...] = data[f]
    m.next_kf = int(meta[0])
    m.next_pt = int(meta[1])
    m.big_change_idx = int(meta[2])
    if "_loop_edges" in data:
        m.loop_edges = [tuple(int(x) for x in row) for row in data["_loop_edges"]]
    return m


def rebuild_database(map_state: MapState, database) -> None:
    """Fill a KeyFrameDatabase from a loaded map's keyframe descriptors."""
    for k in range(map_state.next_kf):
        if map_state.kf_valid[k]:
            database.add(k, map_state.kf_desc[k], map_state.kf_feat_valid[k])
