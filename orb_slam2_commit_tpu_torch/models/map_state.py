"""Array-of-struct SLAM map state (the port's copy of models/map_state.py:
host tables in numpy, as in the JAX package; only what a kernel or BA
reads moves to the device, at its call site).

Replacement for the reference's pointer-graph map — Map /
KeyFrame / MapPoint with their mutex web (reference: src/Map.cc,
src/KeyFrame.cc, src/MapPoint.cc; SURVEY.md §5). Fixed-capacity arrays with
validity masks, single-writer host orchestration, and derived structures
(covisibility, spanning tree) recomputed incrementally from the
observation table:

  kf_point_idx [K, N] int32 — the map-point id observed by feature n of
  keyframe k (-1 if none). This one array IS the observation graph;
  covisibility weights, observation counts and reference descriptors all
  derive from it (replacing KeyFrame::UpdateConnections
  src/KeyFrame.cc:367-493 and MapPoint::ComputeDistinctiveDescriptors
  src/MapPoint.cc:249-320).

Host-side bookkeeping is NumPy (cheap, latency-insensitive); the hot math
(matching, BA) consumes these arrays directly as device inputs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from orb_slam2_commit_tpu_torch.models import native_core
from orb_slam2_commit_tpu_torch.utils.config import MapConfig, ORBConfig
from orb_slam2_commit_tpu_torch.utils.rotation import orthonormalize_rotation

INVALID = -1


@dataclasses.dataclass
class MapState:
    cfg: MapConfig
    n_feat: int

    # --- keyframes ---
    kf_valid: np.ndarray          # [K] bool
    kf_pose_R: np.ndarray         # [K, 3, 3] Tcw
    kf_pose_t: np.ndarray         # [K, 3]
    kf_xy: np.ndarray             # [K, N, 2] undistorted keypoints
    kf_octave: np.ndarray         # [K, N] int32
    kf_angle: np.ndarray          # [K, N] float32
    kf_desc: np.ndarray           # [K, N, 8] uint32
    kf_feat_valid: np.ndarray     # [K, N] bool
    kf_depth: np.ndarray          # [K, N] float32 — stereo/RGBD depth (<=0 none)
    kf_ur: np.ndarray             # [K, N] float32 — right-image u (<0 none)
    kf_point_idx: np.ndarray      # [K, N] int32 — observation table
    kf_frame_id: np.ndarray       # [K] int64
    kf_timestamp: np.ndarray      # [K] float64
    kf_parent: np.ndarray         # [K] int32 — spanning tree parent (-1 root)
    # Relative pose to the cull-time parent, frozen when a keyframe is
    # culled (reference: KeyFrame::mTcp set in SetBadFlag,
    # src/KeyFrame.cc:671) — used to chain trajectory references through
    # bad keyframes even after later BA moves the parent.
    kf_tcp_R: np.ndarray          # [K, 3, 3]
    kf_tcp_t: np.ndarray          # [K, 3]

    # --- map points ---
    pt_valid: np.ndarray          # [P] bool
    pt_pos: np.ndarray            # [P, 3]
    pt_desc: np.ndarray           # [P, 8] uint32 — representative descriptor
    pt_normal: np.ndarray         # [P, 3]
    pt_min_dist: np.ndarray       # [P]
    pt_max_dist: np.ndarray       # [P]
    pt_first_kf: np.ndarray       # [P] int32
    pt_visible: np.ndarray        # [P] int32 — frustum-visible counter
    pt_found: np.ndarray          # [P] int32 — tracking-found counter

    # --- covisibility ---
    cov_weight: np.ndarray        # [K, K] int32 — shared-point counts

    # Loop-closure edges, kept for the lifetime of the map (reference:
    # KeyFrame::AddLoopEdge both ways at src/LoopClosing.cc:792-793;
    # every later OptimizeEssentialGraph includes them,
    # src/Optimizer.cc:966-985, and their keyframes are protected from
    # culling via mbNotErase, src/KeyFrame.cc:532-565).
    loop_edges: Optional[List[Tuple[int, int]]] = None

    next_kf: int = 0
    next_pt: int = 0
    # Callbacks invoked with a keyframe id when it is culled (e.g. the
    # place-recognition database erasing its inverted-file entry).
    remove_kf_hooks: Optional[list] = None
    # Callbacks invoked as hook(kind, new_capacity) after the map doubles
    # a capacity ("keyframes" or "points"), so capacity-coupled structures
    # (the place-recognition database) can grow in step.
    grow_hooks: Optional[list] = None
    # Monotonically increasing map-change counter
    # (reference: Map::InformNewBigChange, src/Map.cc:70-80).
    big_change_idx: int = 0

    @classmethod
    def create(cls, cfg: MapConfig, n_feat: int, orb: Optional[ORBConfig] = None
               ) -> "MapState":
        K, P, N = cfg.max_keyframes, cfg.max_points, n_feat
        return cls(
            cfg=cfg,
            n_feat=N,
            kf_valid=np.zeros(K, bool),
            kf_pose_R=np.tile(np.eye(3, dtype=np.float64), (K, 1, 1)),
            kf_pose_t=np.zeros((K, 3), np.float64),
            kf_xy=np.zeros((K, N, 2), np.float32),
            kf_octave=np.zeros((K, N), np.int32),
            kf_angle=np.zeros((K, N), np.float32),
            kf_desc=np.zeros((K, N, 8), np.uint32),
            kf_feat_valid=np.zeros((K, N), bool),
            kf_depth=np.full((K, N), -1.0, np.float32),
            kf_ur=np.full((K, N), -1.0, np.float32),
            kf_point_idx=np.full((K, N), INVALID, np.int32),
            kf_frame_id=np.zeros(K, np.int64),
            kf_timestamp=np.zeros(K, np.float64),
            kf_parent=np.full(K, INVALID, np.int32),
            kf_tcp_R=np.tile(np.eye(3, dtype=np.float64), (K, 1, 1)),
            kf_tcp_t=np.zeros((K, 3), np.float64),
            pt_valid=np.zeros(P, bool),
            pt_pos=np.zeros((P, 3), np.float64),
            pt_desc=np.zeros((P, 8), np.uint32),
            pt_normal=np.zeros((P, 3), np.float64),
            pt_min_dist=np.zeros(P, np.float64),
            pt_max_dist=np.zeros(P, np.float64),
            pt_first_kf=np.full(P, INVALID, np.int32),
            pt_visible=np.ones(P, np.int32),
            pt_found=np.ones(P, np.int32),
            cov_weight=np.zeros((K, K), np.int32),
            loop_edges=[],
        )

    def add_loop_edge(self, a: int, b: int) -> None:
        pair = (int(min(a, b)), int(max(a, b)))
        if pair not in (self.loop_edges or []):
            if self.loop_edges is None:
                self.loop_edges = []
            self.loop_edges.append(pair)

    def has_loop_edge(self, k: int) -> bool:
        """Keyframes holding a loop edge must never be culled (reference
        mbNotErase, src/KeyFrame.cc:532-565)."""
        k = int(k)
        return any(k in pair for pair in (self.loop_edges or []))

    # ------------------------------------------------------------------
    # Capacity growth (the reference's pointer graph has no caps; the
    # array map doubles in place so long sequences never hit a wall)
    # ------------------------------------------------------------------

    def _grow_keyframe_capacity(self) -> None:
        k_old = self.cfg.max_keyframes
        k_new = 2 * k_old

        def pad(a: np.ndarray, fill) -> np.ndarray:
            ext = np.full((k_new - k_old,) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, ext], axis=0)

        self.kf_valid = pad(self.kf_valid, False)
        self.kf_pose_R = np.concatenate(
            [self.kf_pose_R,
             np.tile(np.eye(3, dtype=self.kf_pose_R.dtype),
                     (k_new - k_old, 1, 1))],
            axis=0,
        )
        self.kf_pose_t = pad(self.kf_pose_t, 0.0)
        self.kf_xy = pad(self.kf_xy, 0.0)
        self.kf_octave = pad(self.kf_octave, 0)
        self.kf_angle = pad(self.kf_angle, 0.0)
        self.kf_desc = pad(self.kf_desc, 0)
        self.kf_feat_valid = pad(self.kf_feat_valid, False)
        self.kf_depth = pad(self.kf_depth, -1.0)
        self.kf_ur = pad(self.kf_ur, -1.0)
        self.kf_point_idx = pad(self.kf_point_idx, INVALID)
        self.kf_frame_id = pad(self.kf_frame_id, 0)
        self.kf_timestamp = pad(self.kf_timestamp, 0.0)
        self.kf_parent = pad(self.kf_parent, INVALID)
        self.kf_tcp_R = np.concatenate(
            [self.kf_tcp_R,
             np.tile(np.eye(3, dtype=self.kf_tcp_R.dtype),
                     (k_new - k_old, 1, 1))],
            axis=0,
        )
        self.kf_tcp_t = pad(self.kf_tcp_t, 0.0)
        cov = np.zeros((k_new, k_new), self.cov_weight.dtype)
        cov[:k_old, :k_old] = self.cov_weight
        self.cov_weight = cov
        self.cfg = dataclasses.replace(self.cfg, max_keyframes=k_new)
        for hook in (self.grow_hooks or []):
            hook("keyframes", k_new)

    def _grow_point_capacity(self) -> None:
        p_old = self.cfg.max_points
        p_new = 2 * p_old

        def pad(a: np.ndarray, fill) -> np.ndarray:
            ext = np.full((p_new - p_old,) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, ext], axis=0)

        self.pt_valid = pad(self.pt_valid, False)
        self.pt_pos = pad(self.pt_pos, 0.0)
        self.pt_desc = pad(self.pt_desc, 0)
        self.pt_normal = pad(self.pt_normal, 0.0)
        self.pt_min_dist = pad(self.pt_min_dist, 0.0)
        self.pt_max_dist = pad(self.pt_max_dist, 0.0)
        self.pt_first_kf = pad(self.pt_first_kf, INVALID)
        self.pt_visible = pad(self.pt_visible, 1)
        self.pt_found = pad(self.pt_found, 1)
        self.cfg = dataclasses.replace(self.cfg, max_points=p_new)
        for hook in (self.grow_hooks or []):
            hook("points", p_new)

    # ------------------------------------------------------------------
    # Keyframe lifecycle
    # ------------------------------------------------------------------

    def add_keyframe(
        self,
        R: np.ndarray,
        t: np.ndarray,
        xy: np.ndarray,
        octave: np.ndarray,
        angle: np.ndarray,
        desc: np.ndarray,
        feat_valid: np.ndarray,
        point_idx: np.ndarray,
        frame_id: int,
        timestamp: float,
        depth: Optional[np.ndarray] = None,
        ur: Optional[np.ndarray] = None,
    ) -> int:
        """Insert a keyframe; returns its id. point_idx[n] binds feature n to
        an existing map point (tracked matches, reference:
        src/LocalMapping.cc:191-218)."""
        k = self.next_kf
        while k >= self.cfg.max_keyframes:
            self._grow_keyframe_capacity()
        n = xy.shape[0]
        assert n <= self.n_feat, (n, self.n_feat)
        self.kf_valid[k] = True
        self.kf_pose_R[k] = orthonormalize_rotation(R)
        self.kf_pose_t[k] = t
        self.kf_xy[k, :n] = xy
        self.kf_octave[k, :n] = octave
        self.kf_angle[k, :n] = angle
        self.kf_desc[k, :n] = desc
        self.kf_feat_valid[k, :n] = feat_valid
        self.kf_feat_valid[k, n:] = False
        self.kf_point_idx[k, :n] = np.where(feat_valid, point_idx, INVALID)
        self.kf_point_idx[k, n:] = INVALID
        self.kf_frame_id[k] = frame_id
        self.kf_timestamp[k] = timestamp
        if depth is not None:
            self.kf_depth[k, :n] = depth
        if ur is not None:
            self.kf_ur[k, :n] = ur
        self.next_kf += 1
        self.update_covisibility(k)
        # Spanning tree: parent = top covisible (reference:
        # src/KeyFrame.cc:482-490).
        if k > 0:
            row = self.cov_weight[k].copy()
            row[k] = 0
            parent = int(np.argmax(row))
            self.kf_parent[k] = parent if row[parent] > 0 else INVALID
        return k

    def remove_keyframe(self, k: int) -> None:
        """Cull a keyframe: detach observations, re-parent spanning-tree
        children, freeze the relative-to-parent pose.

        Re-parenting follows the reference's candidate-search loop
        (src/KeyFrame.cc:600-668): candidates start as {parent}; repeatedly
        the (child, candidate) pair with the highest covisibility weight is
        linked and the child joins the candidate set, so the subtree is
        re-attached along strong covisibility edges; children with no
        covisible candidate fall back to the grandparent (:660-668).
        The frozen ``Tcp = Tcw_k @ Twc_parent`` (KeyFrame::mTcp, :671) lets
        trajectory export chain through this keyframe even after later BA
        moves the parent. Previously-culled keyframes whose frozen parent
        is ``k`` keep pointing at it — their Tcp chains through ``k``'s own
        frozen Tcp, mirroring the reference's walk through bad keyframes
        (src/System.cc:376-380)."""
        assert self.kf_valid[k]
        for hook in (self.remove_kf_hooks or []):
            hook(int(k))
        parent = int(self.kf_parent[k])
        if parent >= 0:
            R_kp = self.kf_pose_R[k] @ self.kf_pose_R[parent].T
            self.kf_tcp_R[k] = R_kp
            self.kf_tcp_t[k] = self.kf_pose_t[k] - R_kp @ self.kf_pose_t[parent]
        children = [
            int(c)
            for c in np.where((self.kf_parent == k) & self.kf_valid)[0]
            if c != k
        ]
        candidates = [parent] if parent >= 0 else []
        while children and candidates:
            W = self.cov_weight[np.ix_(children, candidates)]
            flat = int(np.argmax(W))
            if W.flat[flat] <= 0:
                break
            ci, pi = divmod(flat, len(candidates))
            best_child = children.pop(ci)
            self.kf_parent[best_child] = candidates[pi]
            candidates.append(best_child)
        for c in children:
            self.kf_parent[c] = parent
        self.kf_valid[k] = False
        self.kf_point_idx[k] = INVALID
        self.kf_feat_valid[k] = False
        self.cov_weight[k, :] = 0
        self.cov_weight[:, k] = 0
        # Refresh observation-derived point attributes.
        self.refresh_point_stats()

    # ------------------------------------------------------------------
    # Map points
    # ------------------------------------------------------------------

    def add_points(
        self,
        positions: np.ndarray,          # [M, 3]
        first_kf: int,
    ) -> np.ndarray:
        """Allocate M new points; returns their ids."""
        m = positions.shape[0]
        while self.next_pt + m > self.cfg.max_points:
            self._grow_point_capacity()
        ids = np.arange(self.next_pt, self.next_pt + m, dtype=np.int32)
        self.pt_valid[ids] = True
        self.pt_pos[ids] = positions
        self.pt_first_kf[ids] = first_kf
        self.pt_visible[ids] = 1
        self.pt_found[ids] = 1
        self.next_pt += m
        return ids

    def remove_points(self, ids: np.ndarray) -> None:
        ids = np.asarray(ids, np.int32)
        if ids.size == 0:
            return
        self.pt_valid[ids] = False
        # Detach every observation of these points.
        kf_ids = np.where(self.kf_valid)[0]
        for k in kf_ids:
            mask = np.isin(self.kf_point_idx[k], ids)
            if mask.any():
                self.kf_point_idx[k][mask] = INVALID
                self.update_covisibility(k)

    def replace_point(self, old_id: int, new_id: int) -> None:
        """Merge old into new (reference: MapPoint::Replace,
        src/MapPoint.cc:179-221): rebind observations, drop duplicates."""
        kf_ids = np.where(self.kf_valid)[0]
        for k in kf_ids:
            row = self.kf_point_idx[k]
            has_new = (row == new_id).any()
            mask = row == old_id
            if mask.any():
                if has_new:
                    row[mask] = INVALID  # KF already sees new; drop dup obs
                else:
                    row[mask] = new_id
        self.pt_found[new_id] += self.pt_found[old_id]
        self.pt_visible[new_id] += self.pt_visible[old_id]
        self.pt_valid[old_id] = False

    # ------------------------------------------------------------------
    # Derived structures
    # ------------------------------------------------------------------

    def update_covisibility(self, k: int) -> None:
        """Recompute covisibility row/col for keyframe k: weight =
        #shared map points (reference: KeyFrame::UpdateConnections,
        src/KeyFrame.cc:367-493; edge threshold applied by consumers).

        The native C++ map core's covis_row (models/native_core.py: one
        pass with a point-mark table), or its plain numpy version where no
        compiler exists."""
        row = native_core.covis_row(
            self.kf_point_idx, self.kf_valid, self.cfg.max_points, int(k)
        )
        self.cov_weight[k, :] = row
        self.cov_weight[:, k] = row

    def covisible_keyframes(self, k: int, n: Optional[int] = None,
                            min_weight: int = 1) -> np.ndarray:
        """Ordered covisible keyframes of k (reference:
        GetBestCovisibilityKeyFrames, src/KeyFrame.cc:169-192)."""
        row = self.cov_weight[k] * self.kf_valid
        order = np.argsort(-row, kind="stable")
        out = order[row[order] >= min_weight]
        return out[:n] if n is not None else out

    def observation_count(self) -> np.ndarray:
        """[P] number of keyframes observing each point (the native C++
        map core's obs_counts, or its plain numpy version)."""
        return native_core.obs_counts(
            self.kf_point_idx, self.kf_valid, self.cfg.max_points
        ).astype(np.int64)

    def point_observers(self, pt_id: int) -> List[Tuple[int, int]]:
        """(kf, feature) pairs observing pt_id."""
        out = []
        for k in np.where(self.kf_valid)[0]:
            feats = np.where(self.kf_point_idx[k] == pt_id)[0]
            for f in feats:
                out.append((int(k), int(f)))
        return out

    def refresh_point_stats(self, point_ids: Optional[np.ndarray] = None) -> None:
        """Recompute representative descriptors, viewing normals and scale
        bands from the observation table.

        Replaces MapPoint::ComputeDistinctiveDescriptors (median-min Hamming,
        src/MapPoint.cc:249-320) and UpdateNormalAndDepth
        (src/MapPoint.cc:343-393). Vectorized over all observations.
        """
        kf_ids = np.where(self.kf_valid)[0]
        if kf_ids.size == 0:
            return
        obs_pt = self.kf_point_idx[kf_ids]                     # [K', N]
        flat_pt = obs_pt.reshape(-1)
        sel = flat_pt >= 0
        if point_ids is not None:
            point_ids = np.asarray(point_ids)
            if point_ids.size == 0:
                return
            mark = np.zeros(self.cfg.max_points, bool)
            mark[point_ids] = True
            sel &= mark[np.maximum(flat_pt, 0)]
        if not sel.any():
            return
        pt = flat_pt[sel]
        kf_of_obs = np.repeat(kf_ids, self.n_feat)[sel]
        feat_of_obs = np.tile(np.arange(self.n_feat), kf_ids.size)[sel]

        # Camera centers of the observing keyframes: c = -R^T t.
        R_obs = self.kf_pose_R[kf_of_obs]
        t_obs = self.kf_pose_t[kf_of_obs]
        centers = -np.einsum("mij,mi->mj", R_obs, t_obs)

        # Viewing normals: mean of unit rays from camera centers
        # (oracle: MapPoint::UpdateNormalAndDepth, src/MapPoint.cc:343-393).
        rays = self.pt_pos[pt] - centers
        norms = np.linalg.norm(rays, axis=1, keepdims=True)
        rays = rays / np.maximum(norms, 1e-9)
        normal_acc = np.zeros((self.cfg.max_points, 3))
        np.add.at(normal_acc, pt, rays)
        cnt = np.zeros(self.cfg.max_points)
        np.add.at(cnt, pt, 1.0)
        upd = np.unique(pt)
        self.pt_normal[upd] = normal_acc[upd] / np.maximum(cnt[upd, None], 1.0)

        # Scale-invariance band from the latest observing keyframe (the
        # reference uses pRefKF; highest kf id is our stand-in):
        # max_dist = dist * scale^octave, min = max / scale^(n_levels-1).
        order = np.argsort(kf_of_obs, kind="stable")
        last_src = np.full(self.cfg.max_points, -1, np.int64)
        last_src[pt[order]] = order  # later (higher kf id) overwrites
        pids = np.where(last_src >= 0)[0]
        src = last_src[pids]
        dist = np.linalg.norm(self.pt_pos[pids] - centers[src], axis=1)
        octv = self.kf_octave[kf_of_obs[src], feat_of_obs[src]]
        scale, n_levels = 1.2, 8
        self.pt_max_dist[pids] = dist * scale ** octv
        self.pt_min_dist[pids] = self.pt_max_dist[pids] / (
            scale ** (n_levels - 1)
        )

        # Representative descriptor: min median Hamming distance to the
        # other observations (oracle: MapPoint::ComputeDistinctiveDescriptors,
        # src/MapPoint.cc:249-320). Observations are sorted by point once
        # into contiguous groups, and the groups of one size are processed
        # together (a [G, n, n] distance block a chunk) — a per-point
        # `pt == pid` scan is O(points x observations) and was the dominant
        # mapper cost past ~150 keyframes. Each row's median and the first
        # argmin are numpy's, as for one group at a time.
        desc_obs = self.kf_desc[kf_of_obs, feat_of_obs]  # [M, 8] uint32
        grp_order = np.argsort(pt, kind="stable")
        pt_sorted = pt[grp_order]
        desc_sorted = desc_obs[grp_order]
        starts = np.r_[0, np.where(np.diff(pt_sorted) != 0)[0] + 1,
                       pt_sorted.size]
        sizes, heads = np.diff(starts), starts[:-1]
        for n in np.unique(sizes):
            groups = heads[sizes == n]
            step = max(1, (1 << 16) // (n * n))
            for c in range(0, groups.size, step):
                first = groups[c:c + step]
                grp = desc_sorted[first[:, None] + np.arange(n)]   # [G, n, 8]
                best = np.zeros(first.size, np.int64)
                if n > 1:
                    x = grp[:, :, None, :] ^ grp[:, None, :, :]
                    d = np.unpackbits(
                        x.view(np.uint8).reshape(first.size, n, n, 32), axis=-1
                    ).sum(-1)
                    best = np.argmin(np.median(d, axis=2), axis=1)
                self.pt_desc[pt_sorted[first]] = grp[np.arange(first.size), best]

    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    def n_points(self) -> int:
        return int(self.pt_valid.sum())
