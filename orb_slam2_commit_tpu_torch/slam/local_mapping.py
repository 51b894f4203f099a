"""Local mapping: keyframe insertion processing (PyTorch port of
slam/local_mapping.py; reference: src/LocalMapping.cc). The System calls
process_keyframe once per new keyframe, on its own thread or, with
asynchronous mapping, on the mapping worker's (slam/async_pipeline.py):

  1. recent-map-point culling           (MapPointCulling, :231-279)
  2. triangulate new points             (CreateNewMapPoints, :281-558)
  3. fuse duplicates with neighbours    (SearchInNeighbors, :560-664)
  4. local bundle adjustment            (Optimizer::LocalBundleAdjustment)
  5. redundant-keyframe culling         (KeyFrameCulling, :784-871)

Triangulation and the forward fuse pass take the batched route by default
(slam/jit_mapper.py: one batched K7 and one batched K6 launch per
keyframe). ORB_TPU_STAGED_MAPPER=1, read at each keyframe, takes the JAX
package's per-neighbour staged route, its oracle: K7 under the epipolar
band once per neighbour pair, with no batch axis, and K6 once per fuse
target, each a single-dispatch form (matchers.match_for_triangulation_jit,
matchers.search_fuse_jit: one CUDA graph replay on the card); the
reverse fuse pass takes search_fuse_jit on either route. Map tables stay
numpy on the host; what a kernel or
the BA reads goes to the mapper's device at its call. `map_lock` (the
asynchronous System's RLock) guards the host map mutations, as in the JAX
package. The mapping worker holds the same lock across the whole call, so
no global BA merges between the local BA's pack and its write-back (the
reference's RunGlobalBundleAdjustment stops local mapping before it
merges).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from typing import List

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.geometry import triangulation as tri
from orb_slam2_commit_tpu_torch.interop import resolve_device, to_device, to_host
from orb_slam2_commit_tpu_torch.models.map_state import INVALID, MapState
from orb_slam2_commit_tpu_torch.optim import ba
from orb_slam2_commit_tpu_torch.slam import jit_mapper, matchers
from orb_slam2_commit_tpu_torch.slam.tracking import (
    _round_up_pow2, build_ba_problem, write_back_ba,
)
from orb_slam2_commit_tpu_torch.utils.config import SLAMConfig
from orb_slam2_commit_tpu_torch.utils.precision import full_float32

_LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class RecentPoint:
    """Culling bookkeeping for newly created points (reference:
    mlpRecentAddedMapPoints, src/LocalMapping.cc:231-279)."""

    pt_id: int
    first_kf: int


class LocalMapper:
    def __init__(self, config: SLAMConfig, map_state: MapState, device="cuda"):
        self.config = config
        self.map = map_state
        self.device = resolve_device(device)
        self.recent_points: List[RecentPoint] = []
        # Abort flag: a pending keyframe interrupts local BA
        # (reference: mbAbortBA, src/LocalMapping.cc:149-154).
        self.abort_ba = False
        # The asynchronous System's coarse map lock (an RLock) around host
        # map mutations; the mapping worker also holds it across the call.
        self.map_lock = contextlib.nullcontext()
        # Optional sub-stage profiler (set by the System). Stages:
        # map_refresh, map_cullpts, map_tri, map_fuse, map_lba, map_cullkfs.
        self.profiler = None

    def _dev(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    def _timed(self, stage: str):
        if self.profiler is None:
            return contextlib.nullcontext()
        return self.profiler.timed(stage)

    # ------------------------------------------------------------------

    def process_keyframe(self, kf: int) -> None:
        with self.map_lock:
            # Stats refresh restricted to the points this keyframe touches.
            with self._timed("map_refresh"):
                self.map.refresh_point_stats(self._window_points(kf))
            with self._timed("map_cullpts"):
                self._cull_recent_points(kf)
            with self._timed("map_tri"):
                self._create_new_points(kf)
            with self._timed("map_fuse"):
                self._fuse_neighbors(kf)
            with self._timed("map_refresh"):
                self.map.refresh_point_stats(self._window_points(kf))
        if self.map.n_keyframes() > 2 and not self.abort_ba:
            with self._timed("map_lba"):
                self._local_ba(kf)
        with self.map_lock:
            with self._timed("map_cullkfs"):
                self._cull_keyframes(kf)

    # ------------------------------------------------------------------

    def _fuse_targets(self, kf: int) -> List[int]:
        """The keyframes SearchInNeighbors fuses into (src/LocalMapping.cc:
        560-664): the first covisible ring (10 keyframes for monocular, 20
        otherwise, weight >= 15) and each one's best 5 (weight >= 15), in
        that order, without repeats or kf itself."""
        n_first = 10 if self.config.sensor == "monocular" else 20
        targets: List[int] = []
        seen = {int(kf)}
        for k in self.map.covisible_keyframes(kf, n_first, min_weight=15):
            for k2 in (k, *self.map.covisible_keyframes(int(k), 5, min_weight=15)):
                if int(k2) not in seen:
                    targets.append(int(k2))
                    seen.add(int(k2))
        return targets

    def _window_points(self, kf: int) -> np.ndarray:
        """Points whose stats this keyframe's mapping round can change:
        everything bound in the fuse window (kf and its fuse targets, the
        neighbourhood _fuse_neighbors touches) plus the recent-point
        watchlist."""
        kfs = [int(kf)] + self._fuse_targets(kf)
        pids = self.map.kf_point_idx[np.asarray(kfs)].reshape(-1)
        pids = np.unique(pids[pids >= 0])
        recent = np.asarray(
            [rp.pt_id for rp in self.recent_points], np.int64
        )
        if recent.size:
            pids = np.union1d(pids, recent)
        return pids[self.map.pt_valid[pids]] if pids.size else pids

    # ------------------------------------------------------------------

    def _cull_recent_points(self, kf: int) -> None:
        """Oracle: MapPointCulling (src/LocalMapping.cc:231-279): drop
        points with found/visible < 0.25, or too few observations within
        2 keyframes of creation; stop tracking after 3 KFs."""
        th_obs = 2 if self.config.sensor == "monocular" else 3
        obs_counts = self.map.observation_count()
        keep: List[RecentPoint] = []
        drop: List[int] = []
        for rp in self.recent_points:
            if not self.map.pt_valid[rp.pt_id]:
                continue
            age = kf - rp.first_kf
            found_ratio = self.map.pt_found[rp.pt_id] / max(
                self.map.pt_visible[rp.pt_id], 1
            )
            if found_ratio < 0.25:
                drop.append(rp.pt_id)
            elif age >= 2 and obs_counts[rp.pt_id] <= th_obs:
                drop.append(rp.pt_id)
            elif age >= 3:
                pass  # graduated
            else:
                keep.append(rp)
        self.recent_points = keep
        if drop:
            self.map.remove_points(np.asarray(drop))

    # ------------------------------------------------------------------

    def _fundamental_from_poses(self, k1: int, k2: int) -> np.ndarray:
        """Fundamental matrix between two keyframes, in the convention of
        ops/matching.epipolar_mask: l2 = F @ x1 is the epipolar line of an
        image-1 point in image 2 (x2^T F x1 = 0), so F is built from the
        1->2 relative pose X2 = R21 X1 + t21.

        Oracle: ComputeF12 (src/LocalMapping.cc:672-699) builds the
        TRANSPOSED storage (from the 2->1 pose) because its
        CheckDistEpipolarLine indexes F column-wise (src/ORBmatcher.cc:
        156-158, kp1.x*F[0][0] + kp1.y*F[1][0] + F[2][0] == F^T x1); with
        row-wise math the 1->2 build is the equivalent. The two agree up
        to scale only when R is near identity ([t]x antisymmetry), which
        is why a transposed build passes low-yaw sequences but rejects
        every true match on rotation-heavy ones."""
        cam = self.config.camera
        K = np.asarray(cam.k_matrix)
        R1, t1 = self.map.kf_pose_R[k1], self.map.kf_pose_t[k1]
        R2, t2 = self.map.kf_pose_R[k2], self.map.kf_pose_t[k2]
        R21 = R2 @ R1.T
        t21 = -R21 @ t1 + t2
        tx = np.array(
            [[0, -t21[2], t21[1]], [t21[2], 0, -t21[0]], [-t21[1], t21[0], 0]]
        )
        Kinv = np.linalg.inv(K)
        return Kinv.T @ tx @ R21 @ Kinv

    def _create_new_points(self, kf: int) -> None:
        """CreateNewMapPoints (src/LocalMapping.cc:281-558): the batched
        route, or the per-neighbour staged one with
        ORB_TPU_STAGED_MAPPER=1."""
        if os.environ.get("ORB_TPU_STAGED_MAPPER") == "1":
            return self._create_new_points_staged(kf)
        return self._create_new_points_batched(kf)

    def _neighbor_pairs(self, kf: int):
        """Shared neighbor selection + host-side pair gates (baseline vs
        median depth for monocular, absolute stereo baseline otherwise;
        reference :286-337)."""
        cfg = self.config
        cam = cfg.camera
        n_neigh = 20 if cfg.sensor == "monocular" else 10
        neighbors = self.map.covisible_keyframes(kf, n_neigh, min_weight=15)
        if neighbors.size == 0:
            neighbors = self.map.covisible_keyframes(kf, 3, min_weight=1)
        R1, t1 = self.map.kf_pose_R[kf], self.map.kf_pose_t[kf]
        c1 = -R1.T @ t1
        pairs = []
        for k2 in neighbors:
            k2 = int(k2)
            R2, t2 = self.map.kf_pose_R[k2], self.map.kf_pose_t[k2]
            c2 = -R2.T @ t2
            baseline = np.linalg.norm(c2 - c1)
            if cfg.sensor == "monocular":
                pts2 = self.map.kf_point_idx[k2]
                pts2 = pts2[pts2 >= 0]
                if pts2.size == 0:
                    continue
                depths = (self.map.pt_pos[pts2] @ R2[2]) + t2[2]
                med = np.median(depths[depths > 0]) if (depths > 0).any() else 0
                if med <= 0 or baseline / med < 0.01:
                    continue
            elif baseline < cam.baseline:
                continue
            pairs.append(k2)
        return [int(x) for x in neighbors], pairs

    def _create_new_points_batched(self, kf: int) -> None:
        """CreateNewMapPoints (src/LocalMapping.cc:281-558): the whole
        neighbour loop as one call (jit_mapper.fused_triangulation_jit),
        with the sequential claim semantics restored on the host."""
        cfg = self.config
        cam = cfg.camera
        K = np.asarray(cam.k_matrix)
        neighbors, pairs = self._neighbor_pairs(kf)
        R1, t1 = self.map.kf_pose_R[kf], self.map.kf_pose_t[kf]
        c1 = -R1.T @ t1
        free1 = (self.map.kf_point_idx[kf] == INVALID) & self.map.kf_feat_valid[kf]
        if pairs and free1.any():
            n = self.map.n_feat
            B = _round_up_pow2(len(pairs), 4)
            kf_f32 = jit_mapper._pack_feats(
                self.map.kf_xy[kf], self.map.kf_angle[kf],
                self.map.kf_octave[kf], free1,
            )
            nb_f32 = np.zeros((B, n, jit_mapper.TRI_FEAT_COLS), np.float32)
            nb_desc = np.zeros((B, n, 8), np.uint32)
            pair_f32 = np.zeros((B, jit_mapper.TRI_PAIR_COLS), np.float32)
            for b, k2 in enumerate(pairs):
                R2, t2 = self.map.kf_pose_R[k2], self.map.kf_pose_t[k2]
                c2 = -R2.T @ t2
                free2 = (
                    self.map.kf_point_idx[k2] == INVALID
                ) & self.map.kf_feat_valid[k2]
                nb_f32[b] = jit_mapper._pack_feats(
                    self.map.kf_xy[k2], self.map.kf_angle[k2],
                    self.map.kf_octave[k2], free2,
                )
                nb_desc[b] = self.map.kf_desc[k2]
                c1_in_2 = R2 @ c1 + t2
                if abs(c1_in_2[2]) > 1e-6:
                    ep = np.array([
                        cam.fx * c1_in_2[0] / c1_in_2[2] + cam.cx,
                        cam.fy * c1_in_2[1] / c1_in_2[2] + cam.cy,
                    ])
                else:
                    ep = np.array([1e9, 1e9])
                P2 = K @ np.concatenate([R2, t2[:, None]], axis=1)
                pair_f32[b, 0:9] = self._fundamental_from_poses(
                    kf, k2
                ).reshape(-1)
                pair_f32[b, 9:11] = ep
                pair_f32[b, 11:23] = P2.reshape(-1)
                pair_f32[b, 23:26] = R2[2]
                pair_f32[b, 26] = t2[2]
                pair_f32[b, 27:30] = c2
                pair_f32[b, 30] = 1.0

            P1 = K @ np.concatenate([R1, t1[:, None]], axis=1)
            meta = np.zeros(jit_mapper.TRI_META_LEN, np.float32)
            meta[0:12] = P1.reshape(-1)
            meta[12:15] = c1
            meta[15] = np.cos(np.radians(cfg.tracker.tri_min_parallax_deg))
            meta[16] = 1.5 * cfg.orb.scale_factor

            pts_b, flags_b = jit_mapper.fused_triangulation_jit(
                self._dev(kf_f32), self._dev(self.map.kf_desc[kf]),
                self._dev(nb_f32), self._dev(nb_desc),
                self._dev(pair_f32), self._dev(meta), cfg,
            )
            pts_b = to_host(pts_b).astype(np.float64)
            flags_b = to_host(flags_b)

            # Sequential claim in neighbor order (matches the staged
            # loop's free1 update between pairs).
            for b, k2 in enumerate(pairs):
                good = (flags_b[b, :, 0] > 0.5) & free1
                g_rows = np.where(good)[0]
                if g_rows.size == 0:
                    continue
                idx2 = flags_b[b, :, 1].astype(np.int64)
                new_ids = self.map.add_points(pts_b[b][g_rows], first_kf=kf)
                self.map.kf_point_idx[kf, g_rows] = new_ids
                self.map.kf_point_idx[k2, idx2[g_rows]] = new_ids
                free1[g_rows] = False
                for nid in new_ids:
                    self.recent_points.append(RecentPoint(int(nid), kf))

        self.map.update_covisibility(kf)
        for k2 in neighbors:
            self.map.update_covisibility(int(k2))

    def _create_new_points_staged(self, kf: int) -> None:
        """The per-neighbour staged route of _create_new_points: for each
        neighbour past the pair gates, the fundamental matrix and epipole,
        the triangulation matcher with no batch axis (one K7 launch under
        the epipolar band), DLT triangulation on the device, then the
        gates (parallax, cheirality, reprojection, scale consistency) on
        the host and the claims of this keyframe's free features, in
        neighbour order; one covisibility refresh at the end."""
        cfg = self.config
        cam = cfg.camera
        K = np.asarray(cam.k_matrix)
        neighbors, pairs = self._neighbor_pairs(kf)
        R1, t1 = self.map.kf_pose_R[kf], self.map.kf_pose_t[kf]
        c1 = -R1.T @ t1
        free1 = (self.map.kf_point_idx[kf] == INVALID) & self.map.kf_feat_valid[kf]
        sigma2 = np.asarray(cfg.orb.level_sigma2())
        scale_factors = np.asarray(cfg.orb.scale_factors())
        ratio_factor = 1.5 * cfg.orb.scale_factor
        cos_gate = np.cos(np.radians(cfg.tracker.tri_min_parallax_deg))
        n_lv = cfg.orb.n_levels
        kf_side = [self._dev(a) for a in (
            self.map.kf_xy[kf], self.map.kf_desc[kf], self.map.kf_angle[kf])]
        K_R1_t1 = [self._dev(a) for a in (K, R1, t1)]
        for k2 in pairs:
            R2, t2 = self.map.kf_pose_R[k2], self.map.kf_pose_t[k2]
            c2 = -R2.T @ t2
            F12 = self._fundamental_from_poses(kf, k2)
            free2 = (self.map.kf_point_idx[k2] == INVALID) & self.map.kf_feat_valid[k2]
            # Epipole of camera 1 in image 2 (reference :826-838).
            c1_in_2 = R2 @ c1 + t2
            if abs(c1_in_2[2]) > 1e-6:
                ep = np.array([cam.fx * c1_in_2[0] / c1_in_2[2] + cam.cx,
                               cam.fy * c1_in_2[1] / c1_in_2[2] + cam.cy])
            else:
                ep = np.array([1e9, 1e9])
            m = matchers.match_for_triangulation_jit(
                *kf_side[:3], self._dev(free1),
                self._dev(self.map.kf_xy[k2]), self._dev(self.map.kf_desc[k2]),
                self._dev(self.map.kf_angle[k2]), self._dev(free2),
                self._dev(F12), self._dev(self.map.kf_octave[k2]), self._dev(ep),
                self._dev(np.float32(100.0)),
                n_levels=n_lv, scale=cfg.orb.scale_factor,
            )
            idx = to_host(m.idx)
            rows = np.where(idx >= 0)[0]
            if rows.size == 0:
                continue
            uv1 = self.map.kf_xy[kf][rows]
            uv2 = self.map.kf_xy[k2][idx[rows]]
            pts, e1, e2 = _triangulate_pair(self._dev(uv1), self._dev(uv2), *K_R1_t1,
                                            self._dev(R2), self._dev(t2))

            # Gates (reference :388-535) in float64 on the host.
            rays1 = pts - c1
            rays2 = pts - c2
            d1 = np.linalg.norm(rays1, axis=1)
            d2 = np.linalg.norm(rays2, axis=1)
            cos_par = np.sum(rays1 * rays2, axis=1) / np.maximum(d1 * d2, 1e-12)
            z1 = pts @ R1[2] + t1[2]
            z2 = pts @ R2[2] + t2[2]
            o1 = np.clip(self.map.kf_octave[kf][rows], 0, n_lv - 1)
            o2 = np.clip(self.map.kf_octave[k2][idx[rows]], 0, n_lv - 1)
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio_dist = d2 / np.maximum(d1, 1e-12)
            ratio_octave = scale_factors[o1] / scale_factors[o2]
            good = (
                (cos_par > 0)
                & (cos_par < cos_gate)
                & (z1 > 0)
                & (z2 > 0)
                & (e1 < 5.991 * sigma2[o1])
                & (e2 < 5.991 * sigma2[o2])
                & (ratio_dist * ratio_factor >= ratio_octave)
                & (ratio_dist <= ratio_octave * ratio_factor)
                & np.isfinite(pts).all(axis=1)
            )
            g_rows = rows[good]
            if g_rows.size == 0:
                continue
            new_ids = self.map.add_points(pts[good], first_kf=kf)
            self.map.kf_point_idx[kf, g_rows] = new_ids
            self.map.kf_point_idx[k2, idx[g_rows]] = new_ids
            free1[g_rows] = False
            for nid in new_ids:
                self.recent_points.append(RecentPoint(int(nid), kf))
        # One covisibility refresh for all bindings added above.
        self.map.update_covisibility(kf)
        for k2 in neighbors:
            self.map.update_covisibility(int(k2))

    # ------------------------------------------------------------------

    def _fuse_neighbors(self, kf: int) -> None:
        """Oracle: SearchInNeighbors (src/LocalMapping.cc:560-664): project
        this KF's points into first/second-ring neighbors and fuse, then the
        reverse direction."""
        cam = self.config.camera
        targets = self._fuse_targets(kf)

        # Observation counts are O(K x N) to build; per-target recompute
        # dominated map_fuse at 300+ keyframes. Cache across targets and
        # invalidate only when a merge actually moved observations —
        # bind-only targets (the common case) reuse the snapshot, exactly
        # as each reference Fuse call uses one live view per target.
        fuse_counts: dict = {"counts": None}

        def merge_matches(target_kf: int, pt_ids: np.ndarray,
                          idx: np.ndarray) -> None:
            if fuse_counts["counts"] is None:
                fuse_counts["counts"] = self.map.observation_count()
            obs_counts = fuse_counts["counts"]
            dirty = False
            for r in np.where(idx >= 0)[0]:
                pid = int(pt_ids[r])
                feat = int(idx[r])
                if not self.map.pt_valid[pid]:
                    # Consumed by a merge into an earlier target this
                    # round (the staged loop refilters pt_ids per target).
                    continue
                existing = int(self.map.kf_point_idx[target_kf, feat])
                if existing == pid:
                    continue
                if existing >= 0 and self.map.pt_valid[existing]:
                    # Merge: keep the more-observed point (reference:
                    # src/ORBmatcher.cc:1061-1075); one snapshot per
                    # target, like each reference Fuse call.
                    if obs_counts[existing] >= obs_counts[pid]:
                        self.map.replace_point(pid, existing)
                    else:
                        self.map.replace_point(existing, pid)
                    dirty = True
                else:
                    self.map.kf_point_idx[target_kf, feat] = pid
            # Plain binds (+1 obs) do not invalidate: the snapshot's only
            # consumer is the merge tie-break, and both the old
            # per-target recompute and the reference's live view are
            # equally approximate about same-round binds.
            if dirty:
                fuse_counts["counts"] = None

        def fuse_into(target_kf: int, pt_ids: np.ndarray) -> None:
            pt_ids = pt_ids[self.map.pt_valid[pt_ids]]
            if pt_ids.size == 0:
                return
            # Bucket the point count: every keyframe has a different
            # neighborhood size, and an exact-shaped dispatch here
            # recompiled per keyframe in the JAX package; the port keeps
            # the same padded shapes.
            n_real = pt_ids.size
            P = _round_up_pow2(n_real, 256)
            pad = P - n_real
            ids_p = np.concatenate([pt_ids, np.zeros(pad, pt_ids.dtype)])
            valid = np.zeros(P, bool)
            valid[:n_real] = True
            m = matchers.search_fuse_jit(
                self._dev(self.map.pt_pos[ids_p]),
                self._dev(self.map.pt_normal[ids_p]),
                self._dev(self.map.pt_min_dist[ids_p]),
                self._dev(self.map.pt_max_dist[ids_p]),
                self._dev(valid),
                self._dev(self.map.kf_pose_R[target_kf]),
                self._dev(self.map.kf_pose_t[target_kf]),
                cam.fx, cam.fy, cam.cx, cam.cy,
                float(cam.width), float(cam.height),
                self._dev(self.map.pt_desc[ids_p]),
                self._dev(self.map.kf_xy[target_kf]),
                self._dev(self.map.kf_desc[target_kf]),
                self._dev(self.map.kf_octave[target_kf]),
                self._dev(self.map.kf_feat_valid[target_kf]),
                n_levels=self.config.orb.n_levels,
                scale=self.config.orb.scale_factor,
            )
            merge_matches(target_kf, pt_ids, to_host(m.idx)[:n_real])

        kf_pts = self.map.kf_point_idx[kf]
        kf_pts = np.unique(kf_pts[kf_pts >= 0])
        kf_pts = kf_pts[self.map.pt_valid[kf_pts]]
        staged = os.environ.get("ORB_TPU_STAGED_MAPPER") == "1"
        if staged:
            # The staged forward pass: one K6 launch per target, each on the
            # map as the targets before it left it.
            with self._timed("map_fuse_fwd"):
                for tk in targets:
                    fuse_into(tk, kf_pts)
        elif targets and kf_pts.size:
            # Forward direction batched: one call projects this KF's points
            # into every target (jit_mapper.fused_fuse_forward_jit); merges
            # replay on the host in target order, as the staged loop
            # mutates the map.
            with self._timed("map_fuse_fwd"):
                B = _round_up_pow2(len(targets), 4)
                P = _round_up_pow2(kf_pts.size, 256)
                pt_f32 = np.zeros((P, jit_mapper.FUSE_PT_COLS), np.float32)
                pt_f32[: kf_pts.size, 0:3] = self.map.pt_pos[kf_pts]
                pt_f32[: kf_pts.size, 3:6] = self.map.pt_normal[kf_pts]
                pt_f32[: kf_pts.size, 6] = self.map.pt_min_dist[kf_pts]
                pt_f32[: kf_pts.size, 7] = self.map.pt_max_dist[kf_pts]
                pt_f32[: kf_pts.size, 8] = 1.0
                pt_desc = np.zeros((P, 8), np.uint32)
                pt_desc[: kf_pts.size] = self.map.pt_desc[kf_pts]
                n = self.map.n_feat
                tgt_feat = np.zeros(
                    (B, n, jit_mapper.FUSE_FEAT_COLS), np.float32
                )
                tgt_desc = np.zeros((B, n, 8), np.uint32)
                tgt_meta = np.zeros((B, jit_mapper.FUSE_TGT_COLS), np.float32)
                ti = np.asarray(targets)
                nt = ti.size
                tgt_feat[:nt, :, 0:2] = self.map.kf_xy[ti]
                tgt_feat[:nt, :, 2] = self.map.kf_octave[ti]
                tgt_feat[:nt, :, 3] = self.map.kf_feat_valid[ti]
                tgt_desc[:nt] = self.map.kf_desc[ti]
                tgt_meta[:nt, 0:9] = self.map.kf_pose_R[ti].reshape(nt, 9)
                tgt_meta[:nt, 9:12] = self.map.kf_pose_t[ti]
                tgt_meta[:nt, 12] = 1.0
                idx_b = to_host(jit_mapper.fused_fuse_forward_jit(
                    self._dev(pt_f32), self._dev(pt_desc),
                    self._dev(tgt_feat), self._dev(tgt_desc),
                    self._dev(tgt_meta), self.config,
                )).astype(np.int64)
            with self._timed("map_fuse_merge"):
                for b, tk in enumerate(targets):
                    merge_matches(tk, kf_pts, idx_b[b, : kf_pts.size])
        # Reverse: fuse neighbor points into this KF (already a single
        # dispatch over the union point set).
        if targets:
            with self._timed("map_fuse_rev"):
                neigh_pts = np.unique(
                    np.concatenate(
                        [self.map.kf_point_idx[tk] for tk in targets]
                    )
                )
                neigh_pts = neigh_pts[neigh_pts >= 0]
                fuse_into(kf, neigh_pts)

        with self._timed("map_fuse_cov"):
            self.map.update_covisibility(kf)
            for tk in targets:
                self.map.update_covisibility(tk)

    # ------------------------------------------------------------------

    def _local_ba(self, kf: int) -> None:
        """Oracle: Optimizer::LocalBundleAdjustment (src/Optimizer.cc:530-885):
        free = current KF + covisible; fixed = second ring; points of the
        free set; two-stage robust/non-robust LM with outlier erasure."""
        cam = self.config.camera
        tcfg = self.config.tracker
        max_free = tcfg.lba_max_free_kfs
        max_fixed = tcfg.lba_max_fixed_kfs
        max_pts = tcfg.lba_max_points
        # The reference's local window is UNBOUNDED (all covisible KFs +
        # every second-ring observer, src/Optimizer.cc:533-587); we bucket
        # shapes for compile reuse but never drop silently — truncation is
        # logged so dense-map runs are auditable.
        all_covis = [int(k) for k in self.map.covisible_keyframes(kf, None,
                                                                 min_weight=15)]
        free = [int(kf)] + all_covis[: max_free - 1]
        if len(all_covis) > max_free - 1:
            _LOG.warning(
                "local BA: truncating free window %d -> %d KFs (kf=%d)",
                len(all_covis) + 1, max_free, kf,
            )
        # The first keyframe is ALWAYS held fixed when it participates
        # (reference: vSE3->setFixed(pKFi->mnId==0), src/Optimizer.cc:633;
        # KF0 anchors the global gauge — leaving it free lets every local
        # BA drift the whole init-anchored frame).
        always_fixed = [k for k in free if k == 0]
        free = [k for k in free if k != 0]
        free_set = set(free)
        pts = np.unique(self.map.kf_point_idx[np.asarray(free)])
        pts = pts[pts >= 0]
        pts = pts[self.map.pt_valid[pts]]
        if pts.size > max_pts:
            _LOG.warning(
                "local BA: truncating points %d -> %d (kf=%d)",
                pts.size, max_pts, kf,
            )
            pts = pts[:max_pts]
        if pts.size < 10:
            return
        # Fixed second ring: KFs observing those points but not free.
        # One vectorized mark-gather over the whole observation table
        # (a per-KF np.isin scan is O(K * N log P) and dominates mapper
        # time past ~200 keyframes).
        fixed = list(always_fixed)
        truncated_fixed = False
        mark = np.zeros(self.map.cfg.max_points, bool)
        mark[pts] = True
        valid_kfs = np.where(self.map.kf_valid)[0]
        kpi = self.map.kf_point_idx[valid_kfs]                  # [K', N]
        observes = (mark[np.maximum(kpi, 0)] & (kpi >= 0)).any(axis=1)
        skip = free_set.union(always_fixed)
        for k in valid_kfs[observes]:
            if int(k) in skip:
                continue
            if len(fixed) >= max_fixed:
                truncated_fixed = True
                break
            fixed.append(int(k))
        if truncated_fixed:
            _LOG.warning(
                "local BA: truncating fixed ring at %d KFs (kf=%d)",
                max_fixed, kf,
            )
        if not fixed:
            # Gauge: anchor the oldest free keyframe.
            anchor = min(free)
            free = [k for k in free if k != anchor]
            fixed = [anchor]
        if not free:
            return

        with self.map_lock:
            assembled = build_ba_problem(
                self.map,
                free_kfs=np.asarray(free),
                fixed_kfs=np.asarray(fixed),
                point_ids=pts,
                orb_cfg=self.config.orb,
                device=self.device,
            )
        out, result = ba.local_bundle_adjust(
            assembled.problem, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            point_chunk=1024,
        )
        with self.map_lock:
            write_back_ba(self.map, assembled, out, result)
            # Only the solved points' stats can have changed.
            self.map.refresh_point_stats(pts)

    # ------------------------------------------------------------------

    def _cull_keyframes(self, kf: int) -> None:
        """Oracle: KeyFrameCulling (src/LocalMapping.cc:784-871): a covisible
        KF is redundant if >= 90% of its points are seen by >= 3 other KFs at
        the same or finer scale. Vectorized with a flat observation table."""
        valid_kfs = np.where(self.map.kf_valid)[0]
        if valid_kfs.size < 4:
            return
        # Flat observation table: (kf, pid, octave).
        obs_kf = np.repeat(valid_kfs, self.map.n_feat)
        obs_pid = self.map.kf_point_idx[valid_kfs].reshape(-1)
        obs_oct = self.map.kf_octave[valid_kfs].reshape(-1)
        sel = obs_pid >= 0
        obs_kf, obs_pid, obs_oct = obs_kf[sel], obs_pid[sel], obs_oct[sel]

        spacing_ratio = self.config.tracker.cull_min_spacing_ratio

        for k in self.map.covisible_keyframes(kf, None, min_weight=1):
            k = int(k)
            if k == 0 or k == kf or not self.map.kf_valid[k]:
                continue
            if self.map.has_loop_edge(k):
                # Loop-edge keyframes are never erased (reference
                # mbNotErase, src/KeyFrame.cc:532-565).
                continue
            if spacing_ratio > 0:
                # Spatial guard (beyond reference; rationale at
                # TrackerConfig.cull_min_spacing_ratio): keep spatially
                # isolated keyframes — they carry baseline information BA
                # cannot get from the remaining set. Isolation is measured
                # against OLDER surviving keyframes only: during steady
                # forward motion every keyframe transiently has a fresh
                # neighbor right beside it (which itself gets culled
                # later), so an all-neighbors test degenerates into a
                # treadmill that leaves gaps behind; the older-only test
                # makes survivors settle into a spacing_ratio-spaced
                # farthest-point chain.
                others = np.where(self.map.kf_valid)[0]
                others = others[others < k]
                if others.size == 0:
                    continue
                ck = -self.map.kf_pose_R[k].T @ self.map.kf_pose_t[k]
                co = np.einsum(
                    "kij,kj->ki",
                    -np.transpose(self.map.kf_pose_R[others], (0, 2, 1)),
                    self.map.kf_pose_t[others],
                )
                d_min = float(np.linalg.norm(co - ck, axis=1).min())
                row_k = self.map.kf_point_idx[k]
                pids_k = row_k[row_k >= 0]
                pids_k = pids_k[self.map.pt_valid[pids_k]]
                if pids_k.size >= 10:
                    zk = (self.map.pt_pos[pids_k] @ self.map.kf_pose_R[k][2]
                          ) + self.map.kf_pose_t[k][2]
                    med_k = float(np.median(zk[zk > 0])) if (zk > 0).any() else 0.0
                    if med_k > 0 and d_min > spacing_ratio * med_k:
                        continue
            row = self.map.kf_point_idx[k]
            feats = np.where((row >= 0) & self.map.pt_valid[np.maximum(row, 0)])[0]
            if feats.size == 0:
                continue
            pids = row[feats]
            octs = self.map.kf_octave[k, feats]
            # For each of this KF's points, count OTHER keyframes observing
            # it at octave <= o_here + 1.
            elsewhere = obs_kf != k
            # Map pid -> column in a compact [n_pts] space.
            uniq, inv = np.unique(pids, return_inverse=True)
            pos = np.searchsorted(uniq, obs_pid)
            pos_c = np.clip(pos, 0, uniq.size - 1)
            col = np.where(uniq[pos_c] == obs_pid, pos_c, -1)
            hit = elsewhere & (col >= 0)
            # octave threshold per target point.
            th_per_pt = np.full(uniq.size, -1, np.int64)
            th_per_pt[inv] = octs  # any feature's octave (one per pid here)
            ok_scale = hit.copy()
            ok_scale[hit] = obs_oct[hit] <= th_per_pt[col[hit]] + 1
            # Count distinct KFs per point.
            pair = col[ok_scale] * (valid_kfs.max() + 1) + obs_kf[ok_scale]
            uniq_pairs = np.unique(pair)
            cnt = np.zeros(uniq.size, np.int64)
            np.add.at(cnt, uniq_pairs // (valid_kfs.max() + 1), 1)
            n_redundant = (cnt[inv] >= 3).sum()
            if n_redundant > 0.9 * feats.size:
                self.map.remove_keyframe(k)
                # Rebuild the flat table after a removal.
                valid_kfs = np.where(self.map.kf_valid)[0]
                obs_kf = np.repeat(valid_kfs, self.map.n_feat)
                obs_pid = self.map.kf_point_idx[valid_kfs].reshape(-1)
                obs_oct = self.map.kf_octave[valid_kfs].reshape(-1)
                sel = obs_pid >= 0
                obs_kf, obs_pid, obs_oct = obs_kf[sel], obs_pid[sel], obs_oct[sel]


@full_float32
def _triangulate_pair(uv1, uv2, K, R1, t1, R2, t2):
    """One neighbour pair's DLT triangulation and reprojection errors on the
    device, in float32 -> (points [n, 3], e1 [n], e2 [n]) as numpy."""
    P1 = tri.projection_matrix(K, R1, t1)
    P2 = tri.projection_matrix(K, R2, t2)
    pts = tri.triangulate_dlt(uv1, uv2, P1, P2)
    return (to_host(pts), to_host(tri.reprojection_error_sq(pts, uv1, P1)),
            to_host(tri.reprojection_error_sq(pts, uv2, P2)))
