"""The tracking front end: the per-frame pose state machine (PyTorch port of
slam/tracking.py; reference: src/Tracking.cc).

Same state machine (NOT_INITIALIZED -> OK <-> LOST, include/Tracking.h:81-87)
and the same per-frame ladder:

  motion-model tracking -> reference-keyframe fallback ->
  (relocalization when LOST) -> local-map tracking -> keyframe decision

Every numeric stage runs on the tracker's device: projection matching (K6),
brute-force matching (K7 under a mask; batched over the relocalization
candidates), pose-only BA (K8), the two-view bootstrap
(geometry/twoview.py), EPnP RANSAC (geometry/pnp.py) and, on the fused
route, the whole motion stage and the local-map stage as one call each
(slam/jit_frontend.py). The staged route's units are called through
their single-dispatch forms (`*_jit`): on the card each is one CUDA graph
replay, or for the two-view bootstrap and EPnP RANSAC a few replays
around the eigensolves and SVDs. Host code orchestrates and keeps numpy
bookkeeping. The RANSAC sample sets come from the tracker's host sampler
(geometry/ransac.py), so the card and the CPU draw the same sets.

Relocalization takes its candidates from the keyframe database when the
System has one, else from the most recent keyframes (the JAX package's
path without a database). In the localization-only mode
(`localization_only`) no keyframe is made and the map is not changed: a
stereo or RGB-D tracker spawns one-frame visual-odometry points from the
last frame's depth and rides them while relocalization is tried each frame
(`vo_only`, the reference's mbVO), and tears them down at the end of every
`track`. With an asynchronous System, `mapping_worker` gates keyframe
insertion on the mapper's queue.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.geometry import pnp, twoview
from orb_slam2_commit_tpu_torch.geometry.ransac import RansacSampler
from orb_slam2_commit_tpu_torch.interop import image_to_device, resolve_device, to_device, to_host
from orb_slam2_commit_tpu_torch.models.map_state import INVALID, MapState
from orb_slam2_commit_tpu_torch.optim import ba, pose_opt
from orb_slam2_commit_tpu_torch.optim.residuals import BAObservations
from orb_slam2_commit_tpu_torch.slam import jit_frontend, matchers
from orb_slam2_commit_tpu_torch.slam.frame import Frame
from orb_slam2_commit_tpu_torch.utils.config import SLAMConfig
from orb_slam2_commit_tpu_torch.utils.rotation import orthonormalize_rotation

# Relocalization matches and solves all its candidates in one batch each;
# the batch is capped (best first) and padded to a power of two, as in the
# JAX package.
MAX_RELOC_CANDIDATES = 16


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclasses.dataclass
class TrajectoryEntry:
    """Relative-pose bookkeeping for trajectory export (reference:
    src/Tracking.cc:563-585 mlRelativeFramePoses)."""

    ref_kf: int
    R_rel: np.ndarray   # Tcw_frame * Twc_refkf
    t_rel: np.ndarray
    timestamp: float
    lost: bool


class Tracker:
    def __init__(self, config: SLAMConfig, map_state: MapState, device="cuda"):
        self.config = config
        self.map = map_state
        self.device = resolve_device(device)
        self.state = TrackingState.NO_IMAGES_YET
        self.last_frame: Optional[Frame] = None
        self.init_ref_frame: Optional[Frame] = None
        self.velocity: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = 0
        self.last_reloc_frame_id: int = -(10 ** 9)
        self.trajectory: List[TrajectoryEntry] = []
        self.n_inliers: int = 0
        self.localization_only = False
        # Visual odometry inside a localization-only session: the last frame
        # matched almost no map point, so tracking rides temporal depth
        # points while relocalization is tried each frame (mbVO,
        # src/Tracking.cc:382-447, :1113-1129).
        self.vo_only = False
        self._temporal_points = np.zeros(0, np.int32)
        # The asynchronous System's mapping worker (slam/async_pipeline.py):
        # need_new_keyframe consults its queue (AcceptKeyFrames,
        # src/Tracking.cc:1240-1295). None: the synchronous mapper, always
        # idle.
        self.mapping_worker = None
        # RANSAC sample sets for initialization and relocalization, drawn
        # on the host from a fixed seed (a test may put JAX's draws here).
        self.sampler = RansacSampler(seed=0)
        # The place-recognition database (set by a System with a
        # vocabulary): relocalization's candidates.
        self.kf_database = None
        # Set when tracking is lost soon after initialization and the map
        # is too small to relocalize against: the System resets
        # (src/Tracking.cc:540-552).
        self.request_reset = False
        # Optional stage profiler (set by the System). Stages:
        # track_init (init_twoview, init_global_ba), track_motion,
        # track_ref_kf, track_reloc (reloc_bow, reloc_match, reloc_epnp),
        # track_local_map.
        self.profiler = None

    def _dev(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    def _timed(self, stage: str):
        if self.profiler is None:
            return contextlib.nullcontext()
        return self.profiler.timed(stage)

    # ------------------------------------------------------------------
    # Pose optimization wrapper
    # ------------------------------------------------------------------

    def _optimize_pose(self, frame: Frame, R0, t0):
        """Pose-only BA over the frame's current point bindings
        (Optimizer::PoseOptimization call sites src/Tracking.cc:957,1110,1162)."""
        cam = self.config.camera
        bound = frame.point_ids >= 0
        pts = self.map.pt_pos[np.maximum(frame.point_ids, 0)]
        inv_sigma2 = (1.0 / self.config.orb.level_sigma2()[0]) / np.asarray(
            self.config.orb.level_sigma2()
        )[np.clip(frame.octave, 0, self.config.orb.n_levels - 1)]
        is_stereo = frame.ur >= 0
        uvr = np.concatenate(
            [frame.xy, np.where(is_stereo, frame.ur, 0.0)[:, None]], axis=1)
        obs = BAObservations(
            cam_idx=torch.zeros(frame.n, dtype=torch.int32, device=self.device),
            pt_idx=torch.arange(frame.n, dtype=torch.int32, device=self.device),
            uvr=self._dev(uvr),
            inv_sigma2=self._dev(inv_sigma2),
            is_stereo=self._dev(is_stereo & bound),
            valid=self._dev(bound & frame.valid),
        )
        res = pose_opt.pose_optimization_jit(
            self._dev(R0), self._dev(t0), self._dev(pts), obs,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
        )
        R_out, t_out = to_host(res.R), to_host(res.t)
        if not (np.all(np.isfinite(R_out)) and np.all(np.isfinite(t_out))):
            # A degenerate solve can return NaNs: report failure with the
            # initial pose.
            return np.asarray(R0), np.asarray(t0), np.zeros_like(bound), 0
        inliers = to_host(res.inliers)
        # Unbind outlier observations (src/Tracking.cc:1119-1133).
        frame.point_ids = np.where(bound & ~inliers, INVALID, frame.point_ids)
        return R_out, t_out, inliers, int(res.n_inliers)

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------

    def _try_initialize_mono(self, frame: Frame) -> bool:
        """Tracking::MonocularInitialization (src/Tracking.cc:661-757) and
        CreateInitialMapMonocular (:759-888): match the reference frame
        (K7 under a mask), the two-view bootstrap on the sampler's sets,
        the JAX package's flow-parallax gate, median-depth normalization,
        keyframes 0 and 1 and the initial global BA."""
        cfg = self.config
        if self.init_ref_frame is None or self.init_ref_frame.valid.sum() < 100:
            self.init_ref_frame = frame
            return False
        if frame.valid.sum() < 100:
            self.init_ref_frame = None
            return False

        ref = self.init_ref_frame
        dev = self._dev
        m = matchers.match_for_initialization_jit(
            dev(ref.xy), dev(ref.desc), dev(ref.angle), dev(ref.octave), dev(ref.valid),
            dev(frame.xy), dev(frame.desc), dev(frame.angle), dev(frame.octave),
            dev(frame.valid),
        )
        idx = to_host(m.idx)
        if int((idx >= 0).sum()) < cfg.tracker.min_matches_init:
            self.init_ref_frame = frame
            return False

        matched = idx >= 0
        with self._timed("init_twoview"):
            res = twoview.initialize_two_view_jit(
                dev(self.sampler.twoview(matched, twoview.N_RANSAC, twoview.SAMPLE_SIZE)),
                dev(ref.xy), dev(frame.xy[np.maximum(idx, 0)]), dev(matched),
                dev(np.asarray(cfg.camera.k_matrix)),
                min_parallax=float(cfg.tracker.init_min_parallax_deg),
            )
            if not bool(res.ok):
                return False
        R21 = to_host(res.R21).astype(np.float64)
        t21 = to_host(res.t21).astype(np.float64)
        good = to_host(res.good) & matched

        # The noise-robust parallax gate of the JAX package: warp the
        # reference pixels by the infinite homography K R21 K^-1 and take
        # the 50th-largest residual flow, which is f tan(parallax) to first
        # order (the reference gates on the triangulated points' 51st
        # parallax, src/Initializer.cc:1284-1295).
        Kc = np.asarray(cfg.camera.k_matrix)
        Hinf = Kc @ R21 @ np.linalg.inv(Kc)
        warped = np.concatenate([ref.xy, np.ones((ref.n, 1))], axis=1) @ Hinf.T
        warped = warped[:, :2] / np.maximum(warped[:, 2:3], 1e-9)
        flow = np.linalg.norm(frame.xy[np.maximum(idx, 0)] - warped, axis=1)
        sel = good if good.sum() >= 20 else matched
        if not sel.any():
            return False
        flows = np.sort(flow[sel])[::-1]
        flow_stat = float(flows[min(50, flows.size) - 1])
        f_px = 0.5 * (cfg.camera.fx + cfg.camera.fy)
        if flow_stat < f_px * np.tan(np.radians(cfg.tracker.init_min_parallax_deg)):
            return False
        pts = to_host(res.points).astype(np.float64)[good]

        # Median-depth normalization (src/Tracking.cc:846-869).
        med = np.median(pts[:, 2])
        if med <= 0 or good.sum() < cfg.tracker.min_matches_init:
            return False
        pts = pts / med
        t21 = t21 / med

        ref_feat = np.where(good)[0]
        cur_feat = idx[good]
        ref.set_pose(np.eye(3), np.zeros(3))
        frame.set_pose(R21, t21)
        pt_ids = self.map.add_points(pts, first_kf=0)
        ref_binding = np.full(ref.n, INVALID, np.int32)
        ref_binding[ref_feat] = pt_ids
        cur_binding = np.full(frame.n, INVALID, np.int32)
        cur_binding[cur_feat] = pt_ids
        kf0 = self.map.add_keyframe(
            ref.R, ref.t, ref.xy, ref.octave, ref.angle, ref.desc,
            ref.valid, ref_binding, ref.frame_id, ref.timestamp,
        )
        kf1 = self.map.add_keyframe(
            frame.R, frame.t, frame.xy, frame.octave, frame.angle, frame.desc,
            frame.valid, cur_binding, frame.frame_id, frame.timestamp,
        )
        frame.point_ids = cur_binding

        # GlobalBundleAdjustemnt(20) with KF0 fixed (src/Tracking.cc:830).
        with self._timed("init_global_ba"):
            self._initial_global_ba(kf0, kf1)
        self.map.refresh_point_stats()

        self.ref_kf = kf1
        self.last_kf_frame_id = frame.frame_id
        self.state = TrackingState.OK
        return True

    def _initial_global_ba(self, kf0: int, kf1: int, n_iters: int = 20) -> None:
        """The initial map's BA: every valid point, KF1 free, KF0 fixed."""
        cam = self.config.camera
        assembled = build_ba_problem(
            self.map, free_kfs=np.array([kf1]), fixed_kfs=np.array([kf0]),
            point_ids=np.where(self.map.pt_valid)[0], orb_cfg=self.config.orb,
            device=self.device,
        )
        out, result = ba.bundle_adjust_jit(
            assembled.problem, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            n_iters=n_iters, point_chunk=512,
        )
        write_back_ba(self.map, assembled, out, result)

    def _try_initialize_depth(self, frame: Frame) -> bool:
        """Tracking::StereoInitialization (src/Tracking.cc:590-658): the
        first frame with >= 500 features seeds the map from depth."""
        if frame.valid.sum() < 500:
            return False
        frame.set_pose(np.eye(3), np.zeros(3))
        cam = self.config.camera
        has_depth = (frame.depth > 0) & frame.valid
        feat = np.where(has_depth)[0]
        if feat.size < 100:
            return False
        z = frame.depth[feat].astype(np.float64)
        x = (frame.xy[feat, 0] - cam.cx) / cam.fx * z
        y = (frame.xy[feat, 1] - cam.cy) / cam.fy * z
        pts = np.stack([x, y, z], axis=-1)
        pt_ids = self.map.add_points(pts, first_kf=0)
        binding = np.full(frame.n, INVALID, np.int32)
        binding[feat] = pt_ids
        frame.point_ids = binding
        self.map.add_keyframe(
            frame.R, frame.t, frame.xy, frame.octave, frame.angle, frame.desc,
            frame.valid, binding, frame.frame_id, frame.timestamp,
            depth=frame.depth, ur=frame.ur,
        )
        self.map.refresh_point_stats()
        self.ref_kf = 0
        self.last_kf_frame_id = frame.frame_id
        self.state = TrackingState.OK
        return True

    # ------------------------------------------------------------------
    # Frame-to-frame tracking
    # ------------------------------------------------------------------

    def can_fuse_motion(self) -> bool:
        """Is the next frame eligible for the one-call fused motion stage?"""
        return (
            self.state == TrackingState.OK
            and self.velocity is not None
            and self.last_frame is not None
            and self.config.sensor in ("monocular", "stereo", "rgbd")
            # Localization mode takes the staged route: it spawns temporal
            # VO points before matching and drives the mbVO ladder.
            and not self.localization_only
            and int((self.last_frame.point_ids >= 0).sum()) >= 10
        )

    def fused_motion_frame(
        self, image, frame_id: int, timestamp: float,
        image_right=None, depth_image=None,
    ) -> Tuple[Frame, bool]:
        """Extraction + motion-model matching + pose BA as one device call
        (jit_frontend.fused_motion_track_packed_jit, or its stereo or RGB-D
        twin: one CUDA graph replay on the card) and the host Frame built
        from its outputs. Returns (frame, motion_ok); pass motion_ok to
        track() so the staged motion stage is skipped. Only when
        can_fuse_motion()."""
        self._update_last_frame_pose()
        last = self.last_frame
        Rv, tv = self.velocity
        R_pred = Rv @ last.R
        t_pred = Rv @ last.t + tv
        bound = last.point_ids >= 0
        pt_ids = np.maximum(last.point_ids, 0)
        pt_ok = bound & self.map.pt_valid[pt_ids]

        m = pt_ids.shape[0]
        pt_f32 = np.empty((m, jit_frontend.IN_PT_COLS), np.float32)
        pt_f32[:, 0:3] = self.map.pt_pos[pt_ids]
        pt_f32[:, 3] = last.octave
        pt_f32[:, 4] = last.angle
        pt_f32[:, 5] = pt_ok
        meta_in = np.empty(jit_frontend.IN_META_LEN, np.float32)
        meta_in[0:9] = np.asarray(R_pred).reshape(-1)
        meta_in[9:12] = t_pred
        meta_in[12] = self._tz_rel(last, R_pred, t_pred)

        args = (self._dev(pt_f32), self._dev(last.desc), self._dev(meta_in),
                self.config)
        img = image_to_device(image, self.device)
        if image_right is not None:
            meta, feat, desc = jit_frontend.fused_stereo_motion_track_packed_jit(
                img, image_to_device(image_right, self.device), *args)
        elif depth_image is not None:
            meta, feat, desc = jit_frontend.fused_rgbd_motion_track_packed_jit(
                img, self._dev(np.asarray(depth_image, np.float32)), *args)
        else:
            meta, feat, desc = jit_frontend.fused_motion_track_packed_jit(img, *args)
        dev_feat, dev_desc = feat, desc
        meta, feat, desc = to_host(meta), to_host(feat), to_host(desc).view(np.uint32)
        frame = Frame(
            frame_id=frame_id,
            timestamp=timestamp,
            xy=feat[:, 0:2].astype(np.float64),
            xy_raw=feat[:, 2:4].astype(np.float64),
            response=feat[:, 4].copy(),
            angle=feat[:, 5].copy(),
            octave=feat[:, 6].astype(np.int32),
            valid=feat[:, 7] > 0.5,
            depth=feat[:, 8].astype(np.float32),
            ur=feat[:, 9].astype(np.float32),
            desc=desc,
            dev_feat=dev_feat,
            dev_desc=dev_desc,
        )
        n_matches = int(meta[12]) if np.isfinite(meta[12]) else 0
        n_in = int(meta[13]) if np.isfinite(meta[13]) else 0
        if n_matches < 20 or not np.all(np.isfinite(meta[0:12])):
            # A non-finite device pose is a motion failure; the staged
            # ladder takes over.
            return frame, False
        binding = feat[:, 10].astype(np.int32)
        pid = np.where(
            binding >= 0, last.point_ids[np.maximum(binding, 0)], INVALID
        ).astype(np.int32)
        # Unbind pose-BA outliers, as _optimize_pose does
        # (src/Tracking.cc:1102-1119).
        inl = feat[:, 11] > 0.5
        frame.point_ids = np.where((pid >= 0) & ~inl, INVALID, pid).astype(np.int32)
        frame.set_pose(meta[0:9].reshape(3, 3).astype(np.float64),
                       meta[9:12].astype(np.float64))
        self.n_inliers = n_in
        return frame, n_in >= self.config.tracker.min_inliers_track

    def _spawn_temporal_vo_points(self) -> None:
        """Localization-only stereo / RGB-D: one-frame visual-odometry
        points from the last frame's depth for its unbound features, nearest
        first, at least 100 or all closer than th_depth
        (Tracking::UpdateLastFrame, src/Tracking.cc:971-1047)."""
        self._update_last_frame_pose()
        last = self.last_frame
        cam = self.config.camera
        if (not self.localization_only or self.config.sensor == "monocular"
                or last is None or last.R is None):
            return
        take, pw = close_depth_points(last, cam)
        if take.size == 0:
            return
        ids = self.map.add_points(pw, first_kf=max(self.ref_kf, 0))
        last.point_ids[take] = ids
        self._temporal_points = ids

    def _clear_temporal_vo_points(self, frame: Frame) -> None:
        """Delete this frame's temporal VO points (the reference deletes
        mlpTemporalPoints at the end of every Track, src/Tracking.cc:519-526).
        No keyframe observes them, so invalidating them and unbinding them
        from the two live frames is a full teardown; their slots are the
        newest and localization allocates nothing else, so they are
        reclaimed."""
        ids = self._temporal_points
        if ids.size == 0:
            return
        self._temporal_points = np.zeros(0, np.int32)
        self.map.pt_valid[ids] = False
        for f in (self.last_frame, frame):
            if f is not None:
                f.point_ids[np.isin(f.point_ids, ids)] = INVALID
        lo, hi = int(ids.min()), int(ids.max())
        if hi == self.map.next_pt - 1 and ids.size == self.map.next_pt - lo:
            self.map.next_pt = lo

    @staticmethod
    def _tz_rel(last: Frame, R_pred: np.ndarray, t_pred: np.ndarray) -> float:
        """z of the predicted camera centre in the last frame's camera
        coordinates (tlc.z, src/ORBmatcher.cc:1502-1507)."""
        c_pred = -np.asarray(R_pred).T @ np.asarray(t_pred)
        return float((last.R @ c_pred + last.t)[2])

    def _track_with_motion_model(self, frame: Frame) -> bool:
        """Tracking::TrackWithMotionModel (src/Tracking.cc:1049-1135). Both
        search radii (th and the widened 2 th) come from one K6 launch; the
        second is used when the first finds fewer than 20 matches."""
        if self.velocity is None or self.last_frame is None:
            return False
        self._update_last_frame_pose()
        cam = self.config.camera
        Rv, tv = self.velocity
        last = self.last_frame
        R_pred = Rv @ last.R
        t_pred = Rv @ last.t + tv
        bound = last.point_ids >= 0
        if bound.sum() < 10:
            return False
        pt_ids = np.maximum(last.point_ids, 0)
        pt_ok = bound & self.map.pt_valid[pt_ids]
        th = float(self.config.tracker.search_radius_motion)
        found = matchers.match_projection_last_frame_jit(
            self._dev(self.map.pt_pos[pt_ids]), self._dev(last.desc),
            self._dev(last.octave), self._dev(last.angle), self._dev(pt_ok),
            self._dev(R_pred), self._dev(t_pred),
            self._dev(frame.xy), self._dev(frame.desc), self._dev(frame.angle),
            self._dev(frame.octave), self._dev(frame.valid),
            cam.fx, cam.fy, cam.cx, cam.cy,
            float(cam.width), float(cam.height), th=(th, 2 * th),
            tz_rel=self._tz_rel(last, R_pred, t_pred),
            mono=self.config.sensor == "monocular",
            baseline=float(cam.baseline),
            n_levels=self.config.orb.n_levels,
            scale=self.config.orb.scale_factor,
        )
        for m in found:
            idx = to_host(m.idx)
            n_matches = int((idx >= 0).sum())
            if n_matches >= 20:
                break
        if n_matches < 20:
            return False

        # Bind matched features to the last frame's points.
        binding = np.full(frame.n, INVALID, np.int32)
        rows = np.where(idx >= 0)[0]
        binding[idx[rows]] = last.point_ids[rows]
        frame.point_ids = binding

        R, t, _, n_in = self._optimize_pose(frame, R_pred, t_pred)
        frame.set_pose(R, t)
        self.n_inliers = n_in
        if self.localization_only:
            # Map inliers against temporal VO inliers: almost none of the
            # former means raw visual odometry (mbVO = nmatchesMap < 10,
            # src/Tracking.cc:1113-1129).
            b = frame.point_ids[frame.point_ids >= 0]
            n_map_in = int((~np.isin(b, self._temporal_points)).sum()) if b.size else 0
            self.vo_only = n_map_in < 10
            return n_in >= 20
        return n_in >= self.config.tracker.min_inliers_track

    def _track_reference_keyframe(self, frame: Frame) -> bool:
        """Tracking::TrackReferenceKeyFrame (src/Tracking.cc:910-969), with
        brute-force + ratio matching (K7 under a mask) standing in for
        SearchByBoW."""
        if self.ref_kf < 0:
            return False
        k = self.ref_kf
        kf_bound = self.map.kf_point_idx[k] >= 0
        pt_ids = np.maximum(self.map.kf_point_idx[k], 0)
        kf_ok = kf_bound & self.map.pt_valid[pt_ids]
        m = matchers.match_brute_force_jit(
            self._dev(self.map.kf_desc[k]), self._dev(self.map.kf_angle[k]),
            self._dev(kf_ok),
            self._dev(frame.desc), self._dev(frame.angle), self._dev(frame.valid),
        )
        idx = to_host(m.idx)
        if (idx >= 0).sum() < 15:
            return False
        binding = np.full(frame.n, INVALID, np.int32)
        rows = np.where(idx >= 0)[0]
        binding[idx[rows]] = self.map.kf_point_idx[k][rows]
        frame.point_ids = binding

        R0 = self.last_frame.R if self.last_frame.R is not None else self.map.kf_pose_R[k]
        t0 = self.last_frame.t if self.last_frame.t is not None else self.map.kf_pose_t[k]
        R, t, _, n_in = self._optimize_pose(frame, R0, t0)
        frame.set_pose(R, t)
        self.n_inliers = n_in
        return n_in >= self.config.tracker.min_inliers_track

    def _relocalize(self, frame: Frame) -> bool:
        """Tracking::Relocalization (src/Tracking.cc:1653-1884): candidate
        keyframes -> one batched descriptor match (K7) -> one batched EPnP
        RANSAC -> the pose-optimization ladder. Candidates come from the
        keyframe database when there is one (BoW place recognition,
        DetectRelocalizationCandidates), else they are the 10 most recent
        keyframes; either list is taken in reverse, as in the JAX package."""
        cfg = self.config
        cam = cfg.camera
        if self.kf_database is not None:
            with self._timed("reloc_bow"):
                cand = self.kf_database.detect_relocalization_candidates(frame)
        else:
            cand = [k for k in range(self.map.next_kf) if self.map.kf_valid[k]][-10:]
        cand = [int(k) for k in reversed(list(cand)) if self.map.kf_valid[k]]
        cand = cand[:MAX_RELOC_CANDIDATES]
        if not cand:
            return False
        C = len(cand)
        Cp = max(4, 1 << (C - 1).bit_length())

        # Phase A: one batched match over every candidate
        # (src/Tracking.cc:1713-1727).
        ck = np.asarray(cand)
        pt_ids = np.maximum(self.map.kf_point_idx[ck], 0)
        kf_ok = (self.map.kf_point_idx[ck] >= 0) & self.map.pt_valid[pt_ids]
        n_kf = self.map.kf_desc.shape[1]
        desc_a = np.zeros((Cp, n_kf, 8), np.uint32)
        angle_a = np.zeros((Cp, n_kf), np.float32)
        valid_a = np.zeros((Cp, n_kf), bool)
        desc_a[:C] = self.map.kf_desc[ck]
        angle_a[:C] = self.map.kf_angle[ck]
        valid_a[:C] = kf_ok
        with self._timed("reloc_match"):
            m = matchers.match_brute_force_jit(
                self._dev(desc_a), self._dev(angle_a), self._dev(valid_a),
                self._dev(frame.desc), self._dev(frame.angle), self._dev(frame.valid),
            )
            idx_all = to_host(m.idx)

        # Phase B: the 2D-3D bindings of each candidate and one batched
        # EPnP RANSAC (src/Tracking.cc:1729-1762).
        bindings = np.full((Cp, frame.n), INVALID, np.int32)
        for c in range(C):
            rows = np.where(idx_all[c] >= 0)[0]
            bindings[c, idx_all[c][rows]] = self.map.kf_point_idx[ck[c]][rows]
        attempt = (bindings >= 0).sum(axis=1) >= 15
        if not attempt.any():
            return False
        bound_masks = (bindings >= 0) & frame.valid[None, :] & attempt[:, None]
        sigma2 = np.asarray(cfg.orb.level_sigma2())[
            np.clip(frame.octave, 0, cfg.orb.n_levels - 1)]
        with self._timed("reloc_epnp"):
            res = pnp.epnp_ransac_many_jit(
                self._dev(self.sampler.pnp(bound_masks)),
                self._dev(self.map.pt_pos[np.maximum(bindings, 0)]),
                self._dev(frame.xy), self._dev(bound_masks), self._dev(sigma2),
                cam.fx, cam.fy, cam.cx, cam.cy,
            )
            res_ok = to_host(res.ok)
        res_R = to_host(res.R).astype(np.float64)
        res_t = to_host(res.t).astype(np.float64)

        # Phase C: the refinement ladder per candidate, best first
        # (src/Tracking.cc:1764-1884).
        for c in range(C):
            if not attempt[c] or not res_ok[c]:
                continue
            k = cand[c]
            frame.point_ids = bindings[c].copy()
            R, t, _, n_in = self._optimize_pose(frame, res_R[c], res_t[c])
            if n_in < 10:
                continue

            def widen(th):
                """Project the candidate's not yet bound points through the
                current pose and bind the matches."""
                kf_pts = np.unique(self.map.kf_point_idx[k])
                kf_pts = kf_pts[kf_pts >= 0]
                kf_pts = kf_pts[self.map.pt_valid[kf_pts]]
                bound_now = frame.point_ids[frame.point_ids >= 0]
                if bound_now.size:
                    kf_pts = kf_pts[~np.isin(kf_pts, bound_now)]
                self._project_and_bind(frame, kf_pts, th=th)

            if n_in < 50:
                # Too few inliers: search the candidate's other points in a
                # wide window and optimize again (:1814-1831); between 30
                # and 50, once more in a narrow one (:1836-1860).
                frame.set_pose(R, t)
                widen(10.0)
                R, t, _, n_in = self._optimize_pose(frame, R, t)
                if 30 < n_in < 50:
                    frame.set_pose(R, t)
                    widen(3.0)
                    R, t, _, n_in = self._optimize_pose(frame, R, t)
            if n_in >= 50:
                # The reference's accept gate, nGood >= 50 (:1864).
                frame.set_pose(R, t)
                self.n_inliers = n_in
                self.ref_kf = k
                self.last_reloc_frame_id = frame.frame_id
                return True
        return False

    # ------------------------------------------------------------------
    # Local map tracking
    # ------------------------------------------------------------------

    def _local_keyframes(self, frame: Frame) -> np.ndarray:
        """K1 = observers of the frame's points, plus top covisible
        neighbours, spanning-tree children and parent, capped
        (UpdateLocalKeyFrames, src/Tracking.cc:1518-1651)."""
        bound = frame.point_ids[frame.point_ids >= 0]
        if bound.size == 0:
            return np.zeros(0, int)
        mark = np.zeros(self.map.cfg.max_points, bool)
        mark[bound] = True
        kpi = self.map.kf_point_idx
        hit = mark[np.maximum(kpi, 0)] & (kpi >= 0)
        counts = hit.sum(axis=1) * self.map.kf_valid
        k1 = np.where(counts > 0)[0]
        k1 = k1[np.argsort(-counts[k1], kind="stable")]
        cap = self.config.tracker.max_local_keyframes
        local = list(k1[:cap])
        seen = set(local)
        for k in list(local)[:10]:
            if len(local) >= cap:
                break
            k = int(k)
            extras = [int(n) for n in self.map.covisible_keyframes(k, 10)]
            parent_col = self.map.kf_parent[: self.map.next_kf]
            children = np.where(
                (parent_col == k) & self.map.kf_valid[: self.map.next_kf])[0]
            extras.extend(int(c) for c in children)
            parent = int(self.map.kf_parent[k])
            if parent >= 0 and self.map.kf_valid[parent]:
                extras.append(parent)
            for n in extras:
                if n not in seen:
                    local.append(n)
                    seen.add(n)
                if len(local) >= cap:
                    break
        if k1.size > 0:
            self.ref_kf = int(k1[0])
        return np.asarray(local, int)

    def _project_and_bind(self, frame: Frame, cand: np.ndarray, th: float) -> np.ndarray:
        """Frustum check + projection match of candidate map points into
        the frame's unbound features, binding the matches
        (SearchLocalPoints / SearchByProjection, src/Tracking.cc:1403-1468,
        src/ORBmatcher.cc:46-142). Returns the visibility mask over cand."""
        cam = self.config.camera
        M = self.config.tracker.max_local_points
        cand = cand[:M]
        m_c = cand.size
        pos = np.zeros((M, 3))
        normal = np.zeros((M, 3))
        dmin = np.zeros(M)
        dmax = np.zeros(M)
        desc = np.zeros((M, 8), np.uint32)
        pvalid = np.zeros(M, bool)
        pos[:m_c] = self.map.pt_pos[cand]
        normal[:m_c] = self.map.pt_normal[cand]
        dmin[:m_c] = self.map.pt_min_dist[cand]
        dmax[:m_c] = self.map.pt_max_dist[cand]
        desc[:m_c] = self.map.pt_desc[cand]
        pvalid[:m_c] = True

        info, m = matchers.search_local_points_jit(
            self._dev(pos), self._dev(normal), self._dev(dmin), self._dev(dmax),
            self._dev(pvalid), self._dev(frame.R), self._dev(frame.t),
            cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width), float(cam.height),
            self._dev(desc),
            self._dev(frame.xy), self._dev(frame.desc), self._dev(frame.octave),
            self._dev(frame.valid), self._dev(frame.point_ids >= 0), th=float(th),
            n_levels=self.config.orb.n_levels, scale=self.config.orb.scale_factor,
        )
        idx = to_host(m.idx)
        rows = np.where(idx >= 0)[0]
        rows = rows[rows < m_c]
        frame.point_ids[idx[rows]] = cand[rows]
        return to_host(info.visible)[:m_c]

    def _track_local_map(self, frame: Frame) -> bool:
        """TrackLocalMap + SearchLocalPoints (src/Tracking.cc:1137-1202,
        :1403-1468)."""
        cam = self.config.camera
        cap = self.config.tracker.max_local_points
        local_kfs = self._local_keyframes(frame)
        if local_kfs.size == 0:
            return False

        pts = np.unique(self.map.kf_point_idx[local_kfs])
        pts = pts[pts >= 0]
        pts = pts[self.map.pt_valid[pts]]
        already = set(frame.point_ids[frame.point_ids >= 0].tolist())
        new_mask = ~np.isin(pts, list(already)) if already else np.ones(pts.size, bool)
        cand = pts[new_mask][:cap]

        # Wider search shortly after relocalization (src/Tracking.cc:1460-1464).
        th = self.config.tracker.search_radius_local_map
        if frame.frame_id < self.last_reloc_frame_id + 2:
            th = 5.0

        if frame.dev_feat is not None:
            n_in = self._fused_local_map_core(frame, cand, th)
        else:
            visible = self._project_and_bind(frame, cand, th)
            # Visibility counter (IncreaseVisible, src/Tracking.cc:1420-1437).
            self.map.pt_visible[cand[visible]] += 1
            R, t, _, n_in = self._optimize_pose(frame, frame.R, frame.t)
            frame.set_pose(R, t)
        self.n_inliers = n_in
        # Found counter for culling (IncreaseFound, src/Tracking.cc:1175-1183).
        found = frame.point_ids[frame.point_ids >= 0]
        self.map.pt_found[found] += 1

        min_in = self.config.tracker.min_inliers_local_map
        if frame.frame_id < self.last_reloc_frame_id + cam.fps:
            min_in = self.config.tracker.min_inliers_local_map_recent
        return n_in >= min_in

    def _fused_local_map_core(self, frame: Frame, cand: np.ndarray, th: float) -> int:
        """TrackLocalMap's device part as one call
        (jit_frontend.fused_local_map_track_jit) on the motion stage's features
        left on the device; the host bookkeeping (bind matches, unbind
        outliers, counters) mirrors _project_and_bind + _optimize_pose."""
        M = self.config.tracker.max_local_points
        cand = cand[:M]
        m_c = cand.size
        cand_f32 = np.zeros((M, jit_frontend.LM_CAND_COLS), np.float32)
        cand_f32[:m_c, 0:3] = self.map.pt_pos[cand]
        cand_f32[:m_c, 3:6] = self.map.pt_normal[cand]
        cand_f32[:m_c, 6] = self.map.pt_min_dist[cand]
        cand_f32[:m_c, 7] = self.map.pt_max_dist[cand]
        cand_f32[:m_c, 8] = 1.0
        cand_desc = np.zeros((M, 8), np.uint32)
        cand_desc[:m_c] = self.map.pt_desc[cand]

        bound = frame.point_ids >= 0
        pid = np.maximum(frame.point_ids, 0)
        feat_state = np.zeros((frame.n, jit_frontend.LM_FEAT_COLS), np.float32)
        feat_state[:, 0:3] = self.map.pt_pos[pid]
        feat_state[:, 3] = bound

        meta_in = np.empty(jit_frontend.LM_META_LEN, np.float32)
        meta_in[0:9] = frame.R.reshape(-1)
        meta_in[9:12] = frame.t
        meta_in[12] = th

        meta, perfeat, visible = jit_frontend.fused_local_map_track_jit(
            frame.dev_feat, frame.dev_desc, self._dev(feat_state),
            self._dev(cand_f32), self._dev(cand_desc), self._dev(meta_in),
            self.config,
        )
        meta, perfeat = to_host(meta), to_host(perfeat)
        vis = to_host(visible) > 0.5

        self.map.pt_visible[cand[vis[:m_c]]] += 1
        binding = perfeat[:, 0].astype(np.int32)
        rows = np.where((binding >= 0) & (binding < m_c))[0]
        frame.point_ids[rows] = cand[binding[rows]]
        # Unbind pose-BA outliers (as _optimize_pose does).
        inl = perfeat[:, 1] > 0.5
        b2 = frame.point_ids >= 0
        frame.point_ids = np.where(b2 & ~inl, INVALID, frame.point_ids)
        frame.set_pose(meta[0:9].reshape(3, 3).astype(np.float64),
                       meta[9:12].astype(np.float64))
        return int(meta[12])

    # ------------------------------------------------------------------
    # Keyframe decision
    # ------------------------------------------------------------------

    def need_new_keyframe(self, frame: Frame) -> bool:
        """Tracking::NeedNewKeyFrame (src/Tracking.cc:1205-1309), with the
        mapper-idle gate (:1240-1295): when the mapping worker is busy, its
        BA is interrupted, and a stereo or RGB-D frame inserts only while
        fewer than 3 keyframes wait; a monocular one does not. The
        synchronous mapper is always idle. Never in localization mode."""
        if self.localization_only:
            return False
        n_kfs = self.map.n_keyframes()
        min_obs = 3 if n_kfs > 3 else 2
        obs_counts = self.map.observation_count()
        ref_pts = self.map.kf_point_idx[self.ref_kf]
        ref_pts = ref_pts[ref_pts >= 0]
        n_ref_matches = int(
            (obs_counts[ref_pts] >= min_obs).sum()
        ) if ref_pts.size else 0

        # Stereo/RGB-D: many close-depth features not yet in the map
        # (bNeedToInsertClose + c1c, src/Tracking.cc:1236-1272).
        close_needed = False
        if self.config.sensor != "monocular":
            cam = self.config.camera
            close_th = cam.baseline * cam.th_depth
            close = frame.valid & (frame.depth > 0) & (frame.depth < close_th)
            n_tracked_close = int((close & (frame.point_ids >= 0)).sum())
            n_untracked_close = int((close & (frame.point_ids < 0)).sum())
            close_needed = (n_tracked_close < 100) and (n_untracked_close > 70)

        c1a = frame.frame_id >= self.last_kf_frame_id + self.config.tracker.kf_max_frames
        c1b = frame.frame_id >= self.last_kf_frame_id + self.config.tracker.kf_min_frames
        c1c = self.config.sensor != "monocular" and (
            self.n_inliers < n_ref_matches * 0.25 or close_needed
        )
        ratio = self.config.tracker.kf_ref_ratio_mono
        if self.config.sensor != "monocular":
            ratio = self.config.tracker.kf_ref_ratio_stereo
        if n_kfs < 3:
            ratio = 0.4 if self.config.sensor != "monocular" else 0.9
        c2 = (
            (self.n_inliers < n_ref_matches * ratio) or close_needed
        ) and self.n_inliers > 15

        # Baseline / view-angle trigger (beyond the reference; rationale at
        # TrackerConfig.kf_baseline_depth_ratio).
        c_geom = False
        tcfg = self.config.tracker
        if (
            (tcfg.kf_baseline_depth_ratio > 0 or tcfg.kf_view_angle_deg > 0)
            and self.n_inliers > 15
            and frame.frame_id > self.last_kf_frame_id
            and frame.R is not None
            and self.map.kf_valid[self.ref_kf]
        ):
            k = int(self.ref_kf)
            c_cur = -frame.R.T @ frame.t
            c_ref = -self.map.kf_pose_R[k].T @ self.map.kf_pose_t[k]
            if tcfg.kf_baseline_depth_ratio > 0:
                bound = frame.point_ids[frame.point_ids >= 0]
                if bound.size >= 10:
                    z = (self.map.pt_pos[bound] @ frame.R[2]) + frame.t[2]
                    med_depth = float(np.median(z[z > 0])) if (z > 0).any() else 0.0
                    if med_depth > 0:
                        baseline = float(np.linalg.norm(c_cur - c_ref))
                        c_geom = baseline > tcfg.kf_baseline_depth_ratio * med_depth
            if not c_geom and tcfg.kf_view_angle_deg > 0:
                R_rel = frame.R @ self.map.kf_pose_R[k].T
                ang = np.degrees(
                    np.arccos(np.clip((np.trace(R_rel) - 1.0) / 2.0, -1.0, 1.0)))
                c_geom = ang > tcfg.kf_view_angle_deg

        if not (((c1a or c1b or c1c) and c2) or c_geom):
            return False
        worker = self.mapping_worker
        if worker is None or worker.accept_keyframes():
            return True
        worker.interrupt_ba()
        return self.config.sensor != "monocular" and worker.queued() < 3

    # ------------------------------------------------------------------
    # Main entry
    # ------------------------------------------------------------------

    def track(
        self, frame: Frame, motion_ok: Optional[bool] = None
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Process one frame; returns (R, t) = Tcw, or None while lost
        (Tracking::Track, src/Tracking.cc:275-587). motion_ok: the outcome
        of an already-run fused motion stage (fused_motion_frame); None
        runs the staged motion stage here."""
        if self.state == TrackingState.NO_IMAGES_YET:
            self.state = TrackingState.NOT_INITIALIZED

        if self.state == TrackingState.NOT_INITIALIZED:
            with self._timed("track_init"):
                if self.config.sensor == "monocular":
                    self._try_initialize_mono(frame)
                else:
                    self._try_initialize_depth(frame)
            self.last_frame = frame
            if self.state == TrackingState.OK:
                self._record_trajectory(frame, lost=False)
                return frame.R, frame.t
            return None

        ok = False
        vo = self.localization_only and self.vo_only
        if self.state == TrackingState.OK and vo and motion_ok is None:
            # Visual odometry: the motion model on temporal points and a
            # relocalization attempt; a successful relocalization wins
            # (src/Tracking.cc:396-447).
            self._spawn_temporal_vo_points()
            with self._timed("track_motion"):
                ok_mm = self._track_with_motion_model(frame)
            pose_mm = (frame.R, frame.t) if ok_mm else None
            ids_mm = frame.point_ids.copy()
            with self._timed("track_reloc"):
                ok_reloc = self._relocalize(frame)
            if ok_reloc:
                self.vo_only = False
                ok = True
            elif ok_mm:
                frame.set_pose(*pose_mm)
                frame.point_ids = ids_mm
                ok = True
        elif self.state == TrackingState.OK:
            if motion_ok is not None:
                ok = motion_ok
            else:
                self._spawn_temporal_vo_points()
                with self._timed("track_motion"):
                    ok = self._track_with_motion_model(frame)
            if not ok:
                # A failed motion stage falls back to the reference
                # keyframe (src/Tracking.cc:359-368).
                with self._timed("track_ref_kf"):
                    ok = self._track_reference_keyframe(frame)
        else:  # LOST
            with self._timed("track_reloc"):
                ok = self._relocalize(frame)

        if ok and not (self.localization_only and self.vo_only):
            with self._timed("track_local_map"):
                ok = self._track_local_map(frame)

        if ok:
            self.state = TrackingState.OK
            # Motion model update (src/Tracking.cc:477-487).
            if self.last_frame is not None and self.last_frame.R is not None:
                R_lv = frame.R @ self.last_frame.R.T
                t_lv = frame.t - R_lv @ self.last_frame.t
                self.velocity = (R_lv, t_lv)
        else:
            self.state = TrackingState.LOST
            self.velocity = None
            # Lost soon after initialization with a tiny map: the System
            # resets (src/Tracking.cc:540-552); never a loaded map in
            # localization mode.
            if self.map.n_keyframes() <= 5 and not self.localization_only:
                self.request_reset = True

        self._record_trajectory(frame, lost=not ok)
        self._clear_temporal_vo_points(frame)
        self.last_frame = frame
        return (frame.R, frame.t) if ok else None

    def _record_trajectory(self, frame: Frame, lost: bool) -> None:
        if lost or frame.R is None or self.ref_kf < 0:
            # The reference duplicates the last entry when lost
            # (src/Tracking.cc:575-585).
            if self.trajectory:
                e = self.trajectory[-1]
                self.trajectory.append(
                    TrajectoryEntry(e.ref_kf, e.R_rel, e.t_rel, frame.timestamp, True))
                frame.anchor = self.trajectory[-1]
            return
        Rr = self.map.kf_pose_R[self.ref_kf]
        tr = self.map.kf_pose_t[self.ref_kf]
        R_rel = frame.R @ Rr.T
        t_rel = frame.t - R_rel @ tr
        self.trajectory.append(
            TrajectoryEntry(self.ref_kf, R_rel, t_rel, frame.timestamp, False))
        frame.anchor = self.trajectory[-1]

    def bind_keyframe_anchor(self, frame: Frame, kf: int) -> None:
        """Re-reference this frame's trajectory entry to the keyframe just
        created from it (CreateNewKeyFrame runs before the relative-pose
        bookkeeping, src/Tracking.cc:554-585)."""
        if not self.config.tracker.reanchor_last_frame:
            return
        if not self.trajectory or self.trajectory[-1].lost or frame.R is None:
            return
        Rr = self.map.kf_pose_R[kf]
        tr = self.map.kf_pose_t[kf]
        R_rel = frame.R @ Rr.T
        t_rel = frame.t - R_rel @ tr
        e = TrajectoryEntry(kf, R_rel, t_rel, frame.timestamp, False)
        self.trajectory[-1] = e
        frame.anchor = e

    def _update_last_frame_pose(self) -> None:
        """Re-anchor the last frame's pose through its reference keyframe:
        Tcw_last = Tlr * Tcw_ref(now) (Tracking::UpdateLastFrame,
        src/Tracking.cc:971-980), walking the cull-time-frozen Tcp chain
        when the reference keyframe was culled (src/System.cc:376-380)."""
        if not self.config.tracker.reanchor_last_frame:
            return
        last = self.last_frame
        if last is None or last.R is None:
            return
        e = last.anchor
        if e is None:
            return
        k, R_rel, t_rel = e.ref_kf, e.R_rel, e.t_rel
        hops = 0
        while k >= 0 and not self.map.kf_valid[k] and hops < 64:
            parent = int(self.map.kf_parent[k])
            if parent < 0:
                return
            t_rel = R_rel @ self.map.kf_tcp_t[k] + t_rel
            R_rel = R_rel @ self.map.kf_tcp_R[k]
            k = parent
            hops += 1
        if k < 0 or not self.map.kf_valid[k]:
            return
        last.set_pose(R_rel @ self.map.kf_pose_R[k],
                      R_rel @ self.map.kf_pose_t[k] + t_rel)


def close_depth_points(frame: Frame, cam) -> Tuple[np.ndarray, np.ndarray]:
    """The frame's unbound features with depth, nearest first: at least 100
    or all closer than th_depth (CreateNewKeyFrame, src/Tracking.cc:1335-1392;
    UpdateLastFrame, :1000-1047) -> (their feature indices, their points in
    world coordinates [n, 3])."""
    feats = np.where(frame.valid & (frame.point_ids < 0) & (frame.depth > 0))[0]
    order = feats[np.argsort(frame.depth[feats])]
    n_close = int((frame.depth[order] < cam.baseline * cam.th_depth).sum())
    take = order[: max(min(100, order.size), n_close)]
    zt = frame.depth[take].astype(np.float64)
    x = (frame.xy[take, 0] - cam.cx) / cam.fx * zt
    y = (frame.xy[take, 1] - cam.cy) / cam.fy * zt
    return take, (np.stack([x, y, zt], -1) - frame.t) @ frame.R


# ---------------------------------------------------------------------------
# BA problem assembly from the MapState (shared by the tracker and the
# local mapper)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AssembledBA:
    problem: ba.BAProblem
    kf_ids: np.ndarray       # [K] map keyframe id per problem camera
    point_ids: np.ndarray    # [P] map point id per problem point
    obs_kf: np.ndarray       # [O] map keyframe id per observation
    obs_feat: np.ndarray     # [O] feature index per observation


def _round_up_pow2(n: int, floor: int) -> int:
    """Next power of two >= max(n, floor): the JAX package's shape buckets,
    kept so that both packages solve problems of the same padded shapes."""
    v = max(int(n), int(floor))
    return 1 << (v - 1).bit_length()


def build_ba_problem(
    map_state: MapState,
    free_kfs: np.ndarray,
    fixed_kfs: np.ndarray,
    point_ids: np.ndarray,
    orb_cfg,
    device="cuda",
) -> AssembledBA:
    """Pack a BA problem from the map arrays, on `device` in float32
    (the problem of Optimizer::LocalBundleAdjustment,
    src/Optimizer.cc:596-736). Shapes are padded to powers of two
    (cameras >= 8, points >= 512, observations >= 2048); padded cameras
    are fixed, padded points and observations masked invalid."""
    kf_ids = np.concatenate([free_kfs, fixed_kfs]).astype(int)
    K_real = kf_ids.size
    P_real = point_ids.size
    pt_lookup = np.full(map_state.cfg.max_points, -1, np.int64)
    pt_lookup[point_ids] = np.arange(P_real)

    rows = map_state.kf_point_idx[kf_ids]                  # [K, N]
    local_pt = pt_lookup[np.maximum(rows, 0)]
    sel = (rows >= 0) & (local_pt >= 0)
    cam_idx = np.broadcast_to(np.arange(K_real)[:, None], rows.shape)[sel]
    obs_feat = np.broadcast_to(np.arange(map_state.n_feat)[None, :], rows.shape)[sel]
    obs_kf = np.broadcast_to(kf_ids[:, None], rows.shape)[sel]
    pt_idx = local_pt[sel]
    uv = map_state.kf_xy[obs_kf, obs_feat]
    ur = map_state.kf_ur[obs_kf, obs_feat]
    sigma2 = np.asarray(orb_cfg.level_sigma2())
    octv = np.clip(map_state.kf_octave[obs_kf, obs_feat], 0, sigma2.size - 1)
    is_st = ur >= 0
    uvr = np.concatenate([uv, np.where(is_st, ur, 0.0)[:, None]], axis=1)
    inv_s2 = 1.0 / sigma2[octv]

    O_real = cam_idx.size
    K = _round_up_pow2(K_real, 8)
    P = _round_up_pow2(P_real, 512)
    O = _round_up_pow2(O_real, 2048)

    def pad(a, n, fill=0):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    device = resolve_device(device)

    def dev(a):
        return to_device(a, device)

    obs = BAObservations(
        cam_idx=dev(pad(cam_idx.astype(np.int32), O)),
        pt_idx=dev(pad(pt_idx.astype(np.int32), O)),
        uvr=dev(pad(uvr.astype(np.float64), O)),
        inv_sigma2=dev(pad(inv_s2, O)),
        is_stereo=dev(pad(is_st, O)),
        valid=dev(pad(np.ones(O_real, bool), O)),
    )
    fixed = np.ones(K, bool)
    fixed[:free_kfs.size] = False
    fixed[K_real:] = True
    R_pad = np.tile(np.eye(3), (K, 1, 1))
    R_pad[:K_real] = map_state.kf_pose_R[kf_ids]
    t_pad = np.zeros((K, 3))
    t_pad[:K_real] = map_state.kf_pose_t[kf_ids]
    pts_pad = np.zeros((P, 3))
    pts_pad[:P_real] = map_state.pt_pos[point_ids]
    problem = ba.BAProblem(
        R=dev(R_pad), t=dev(t_pad), fixed=dev(fixed), points=dev(pts_pad),
        point_valid=dev(pad(np.ones(P_real, bool), P)), obs=obs,
    )
    return AssembledBA(
        problem=problem,
        kf_ids=kf_ids,
        point_ids=np.asarray(point_ids, int),
        obs_kf=obs_kf.astype(int),
        obs_feat=obs_feat.astype(int),
    )


def write_back_ba(
    map_state: MapState,
    assembled: AssembledBA,
    out_problem: ba.BAProblem,
    result: ba.BAResult,
    erase_outliers: bool = True,
) -> None:
    """Write optimized poses and points back and erase outlier
    observations (src/Optimizer.cc:800-883)."""
    fixed = to_host(out_problem.fixed)
    R = to_host(out_problem.R).astype(np.float64)
    t = to_host(out_problem.t).astype(np.float64)
    for ci, k in enumerate(assembled.kf_ids):
        if not fixed[ci]:
            # Project back to SO(3): float32 retractions leave ~1e-7 skew
            # (utils/rotation.py).
            map_state.kf_pose_R[k] = orthonormalize_rotation(R[ci])
            map_state.kf_pose_t[k] = t[ci]
    n_pts = assembled.point_ids.size
    map_state.pt_pos[assembled.point_ids] = to_host(out_problem.points)[:n_pts]

    if erase_outliers:
        n_obs = assembled.obs_kf.size
        inlier = to_host(result.inlier)[:n_obs]
        touched = set()
        for o in np.where(~inlier)[0]:
            k = assembled.obs_kf[o]
            f = assembled.obs_feat[o]
            if map_state.kf_point_idx[k, f] >= 0:
                map_state.kf_point_idx[k, f] = INVALID
                touched.add(int(k))
        for k in touched:
            map_state.update_covisibility(k)
