"""System facade: the public SLAM API (PyTorch port of slam/system.py;
reference: src/System.cc, include/System.h:63-124).

It builds the map, the tracker and the local mapper, takes frames through
`track_monocular` / `track_rgbd` / `track_stereo`, maps each new keyframe,
and exports the trajectory. A
monocular System extracts twice the features until it has initialized
(the reference's initialization extractor, src/Tracking.cc:121-126), so
its map holds keyframes of the larger width. Every device call runs on the
System's device: the card unless the caller asks for the CPU.

Route choice as in the JAX package (slam/system.py:209-219): on the card
an OK-state frame goes through the fused motion stage and the fused
local-map stage (one call each); on the CPU the staged path runs unless
ORB_TPU_FUSED_TRACK=1 (ORB_TPU_FUSED_TRACK=0 forces the staged path on
the card).

With a vocabulary (the bundled one by default, as the reference always
loads ORBvoc.txt, src/System.cc:61-77) the System keeps the keyframe
database: every keyframe is registered, relocalization takes its BoW
candidates, and loop closing runs after local mapping on each new
keyframe (detection, Sim3, correction, the essential graph, global BA).

Mapping is asynchronous unless the configuration or the caller says
otherwise (config.system.async_mapping, True by default; synthetic_config
turns it off): local mapping and loop closing run on a worker thread fed
by a keyframe queue (slam/async_pipeline.py), global BA after a loop
correction on a thread of its own (slam/global_ba.py), each on its own
CUDA stream on the card, with one coarse map lock (an RLock) between them
and the tracker. `shutdown` drains the queue and joins both threads, and
raises what either of them raised. Synchronous mapping runs both stages on
the caller's thread after each new keyframe, global BA inline.

Each frame holds the frame lock from its entry call to its return, and
`reset` and `load_map` take it too, so a reset requested from another
thread (the viewer's menu) waits for the frame in flight instead of
rebuilding the map under it. A reader on another thread takes
`reader_lock`.

`activate_localization_mode` stops keyframe insertion and map changes;
`load_map` then `activate_localization_mode` is a localization session
against a saved map (the tracker's visual-odometry points ride the gaps).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from orb_slam2_commit_tpu_torch.geometry import pnp, sim3_solver, twoview
from orb_slam2_commit_tpu_torch.interop import resolve_device
from orb_slam2_commit_tpu_torch.models import serialization, vocabulary
from orb_slam2_commit_tpu_torch.models.kf_database import KeyFrameDatabase
from orb_slam2_commit_tpu_torch.models.map_state import MapState
from orb_slam2_commit_tpu_torch.models.vocabulary import default_vocabulary, load_vocabulary
from orb_slam2_commit_tpu_torch.ops import extractor, stereo
from orb_slam2_commit_tpu_torch.optim import ba, pose_graph, pose_opt, sim3_opt
from orb_slam2_commit_tpu_torch.slam import ar, matchers
from orb_slam2_commit_tpu_torch.slam.async_pipeline import MappingWorker
from orb_slam2_commit_tpu_torch.slam.frame import Frame, make_frame, make_stereo_frame
from orb_slam2_commit_tpu_torch.slam.global_ba import GlobalBARunner
from orb_slam2_commit_tpu_torch.slam.local_mapping import LocalMapper, RecentPoint
from orb_slam2_commit_tpu_torch.slam.loop_closing import LoopCloser
from orb_slam2_commit_tpu_torch.slam.tracking import Tracker, TrackingState, close_depth_points
from orb_slam2_commit_tpu_torch.utils import cuda_graph
from orb_slam2_commit_tpu_torch.utils import trajectory as traj
from orb_slam2_commit_tpu_torch.utils.config import SLAMConfig
from orb_slam2_commit_tpu_torch.utils.profiling import Profiler

# The functions the staged tracker's single-dispatch forms capture, keyed
# by their own arguments rather than the System's configuration: the
# staged frame's extraction and stereo front end, the pose LM, the
# matchers, EPnP RANSAC, the two-view bootstrap and the BoW descent.
STAGED_GRAPHED = (extractor.GRAPHED + stereo.GRAPHED + pose_opt.GRAPHED + matchers.GRAPHED
                  + pnp.GRAPHED + twoview.GRAPHED + vocabulary.GRAPHED)
# The same for the loop closer's Sim3 RANSAC and Sim3 LM and the AR
# anchor's plane fit (its matchers are in matchers.GRAPHED).
LOOP_GRAPHED = sim3_solver.GRAPHED + sim3_opt.GRAPHED + ar.GRAPHED

_LOG = logging.getLogger(__name__)


class System:
    def __init__(self, config: SLAMConfig, vocabulary="default",
                 async_mapping: Optional[bool] = None, device="cuda"):
        """vocabulary: a BinaryVocabulary, a path (.npz or the ORBvoc.txt
        layout), "default" (the bundled vocabulary when
        config.system.use_vocabulary, else none), or None / False for no
        place recognition.
        async_mapping: True (mapping and loop closing on a worker thread),
        False (on the caller's thread), or None to take
        config.system.async_mapping.
        device: where every device call runs ("cuda" by default; "cpu"
        runs the kernels' plain versions)."""
        if async_mapping is None:
            async_mapping = config.system.async_mapping
        if isinstance(vocabulary, str) and vocabulary == "default":
            vocabulary = default_vocabulary() if config.system.use_vocabulary else None
        elif isinstance(vocabulary, str):
            vocabulary = load_vocabulary(vocabulary)
        self.vocabulary = None if vocabulary is False else vocabulary
        self.config = config
        if config.sensor == "monocular":
            self.init_config = dataclasses.replace(
                config, orb=dataclasses.replace(config.orb, n_features=2 * config.orb.n_features))
        else:
            self.init_config = config
        self.device = resolve_device(device)
        self._captures_at_start = cuda_graph.n_captures()
        self.profiler = Profiler()
        self.frame_count = 0
        self.kf_database = None
        if self.vocabulary is not None:
            self.kf_database = KeyFrameDatabase(self.vocabulary, config.map.max_keyframes,
                                                self.device)
        self.map_lock = threading.RLock() if async_mapping else None
        self._frame_lock = threading.RLock()
        self.mapping_worker: Optional[MappingWorker] = None
        self._gba: Optional[GlobalBARunner] = None
        self._build()

    def _locked(self):
        return self.map_lock if self.map_lock is not None else contextlib.nullcontext()

    @property
    def reader_lock(self):
        """The lock a reader of the map and the tracker on another thread
        (the viewer) holds while it reads: the map lock with asynchronous
        mapping (the tracker and the mapping worker write under it), else
        the frame lock (every write happens inside a track_* call, reset or
        load_map)."""
        return self.map_lock if self.map_lock is not None else self._frame_lock

    def _build(self) -> None:
        """A fresh map with its tracker, mapper and, with a vocabulary, the
        database (cleared) and loop closer wired to it; with asynchronous
        mapping the worker and the global BA runner rewired to them
        (construction, Reset). The localization-only flag survives."""
        localization_only = self.tracker.localization_only if hasattr(self, "tracker") else False
        n_feat = max(sum(c.orb.features_per_level()) for c in (self.config, self.init_config))
        self.map = MapState.create(self.config.map, n_feat)
        self.tracker = Tracker(self.config, self.map, self.device)
        self.tracker.profiler = self.profiler
        self.tracker.localization_only = localization_only
        self.mapper = LocalMapper(self.config, self.map, self.device)
        self.mapper.profiler = self.profiler
        self.loop_closer = None
        if self.kf_database is not None:
            self.kf_database.clear()
            self._wire_database()
            # The essential graph's covisibility threshold scales with the
            # feature budget (the reference's 100 assumes 1000-2000).
            self.loop_closer = LoopCloser(
                self.config, self.map, self.kf_database,
                essential_min_weight=min(100, max(20, self.config.orb.n_features // 10)),
                device=self.device)
            self.loop_closer.profiler = self.profiler
        if self.map_lock is None:
            return
        self.mapper.map_lock = self.map_lock
        if self.mapping_worker is None:
            self.mapping_worker = MappingWorker(self.mapper, self.loop_closer, self.map_lock,
                                                device=self.device)
        self.mapping_worker.mapper = self.mapper
        self.mapping_worker.loop_closer = self.loop_closer
        self.tracker.mapping_worker = self.mapping_worker
        if self.loop_closer is not None:
            # Global BA after a loop correction runs on its own abortable
            # thread (the reference's GBA thread, src/LoopClosing.cc:801).
            if self._gba is None:
                self._gba = GlobalBARunner(self.config, self.map_lock, device=self.device)
            self.loop_closer.gba_runner = self._gba

    def _wire_database(self) -> None:
        self.kf_database.grow("keyframes", self.map.cfg.max_keyframes)
        self.tracker.kf_database = self.kf_database
        self.map.remove_kf_hooks = [self.kf_database.erase]
        self.map.grow_hooks = [self.kf_database.grow]

    # ------------------------------------------------------------------
    # Per-frame entries (System::TrackMonocular :225-282, TrackRGBD
    # :169-223, TrackStereo :121-167)
    # ------------------------------------------------------------------

    def track_monocular(
        self, image: np.ndarray, timestamp: float
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self.config.sensor != "monocular":
            raise ValueError(f"track_monocular on a {self.config.sensor} System")
        with self._frame_lock:
            return self._track(image, timestamp, depth=None)

    def track_rgbd(
        self, image: np.ndarray, depth: np.ndarray, timestamp: float
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self.config.sensor != "rgbd":
            raise ValueError(f"track_rgbd on a {self.config.sensor} System")
        with self._frame_lock:
            return self._track(image, timestamp, depth=depth)

    def _track(self, image, timestamp, depth):
        """A monocular or RGB-D frame: the fused motion stage when the
        tracker can take it, else the extraction (with the initialization
        config while a monocular System is not initialized) and the staged
        ladder."""
        if self._use_fused_track() and self.tracker.can_fuse_motion():
            with self.profiler.timed("fused_frontend"):
                frame, motion_ok = self.tracker.fused_motion_frame(
                    image, self.frame_count, timestamp, depth_image=depth)
            self.frame_count += 1
            with self.profiler.timed("track"):
                return self._track_frame(frame, motion_ok=motion_ok)
        use_init = self.tracker.state in (TrackingState.NO_IMAGES_YET,
                                          TrackingState.NOT_INITIALIZED)
        cfg = self.init_config if use_init else self.config
        with self.profiler.timed("extract_frame"):
            frame = make_frame(image, self.frame_count, timestamp, cfg, depth,
                               device=self.device)
        self.frame_count += 1
        with self.profiler.timed("track"):
            return self._track_frame(frame)

    def track_stereo(
        self, image_left: np.ndarray, image_right: np.ndarray, timestamp: float
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self.config.sensor != "stereo":
            raise ValueError(f"track_stereo on a {self.config.sensor} System")
        with self._frame_lock:
            return self._track_stereo(image_left, image_right, timestamp)

    def _track_stereo(self, image_left, image_right, timestamp):
        if self._use_fused_track() and self.tracker.can_fuse_motion():
            with self.profiler.timed("fused_frontend"):
                frame, motion_ok = self.tracker.fused_motion_frame(
                    image_left, self.frame_count, timestamp, image_right=image_right)
            self.frame_count += 1
            with self.profiler.timed("track"):
                return self._track_frame(frame, motion_ok=motion_ok)
        with self.profiler.timed("extract_frame"):
            frame = make_stereo_frame(image_left, image_right, self.frame_count,
                                      timestamp, self.config, device=self.device)
        self.frame_count += 1
        with self.profiler.timed("track"):
            return self._track_frame(frame)

    def _use_fused_track(self) -> bool:
        """The fused one-call stages on the card, the staged path on the
        CPU; ORB_TPU_FUSED_TRACK=0/1 overrides either."""
        v = os.environ.get("ORB_TPU_FUSED_TRACK")
        if v is not None:
            return v == "1"
        return self.device.type != "cpu"

    def _track_frame(self, frame: Frame, motion_ok=None):
        """Track the frame and, when it becomes a keyframe, map it here or
        hand it to the mapping worker. With asynchronous mapping the
        tracker's map reads and writes happen under the map lock."""
        kf = None
        with self._locked():
            was_initialized = self.tracker.state in (TrackingState.OK, TrackingState.LOST)
            pose = self.tracker.track(frame, motion_ok=motion_ok)
            reset = self.tracker.request_reset
            if not reset and not was_initialized and self.tracker.state == TrackingState.OK:
                # The map was just created: its keyframes go into the database.
                if self.kf_database is not None:
                    for k in range(self.map.next_kf):
                        if self.map.kf_valid[k] and not self.kf_database.present[k]:
                            self.kf_database.add(k, self.map.kf_desc[k],
                                                 self.map.kf_feat_valid[k])
            elif not reset:
                with self.profiler.timed("track_need_kf"):
                    need_kf = pose is not None and self.tracker.need_new_keyframe(frame)
                if need_kf:
                    kf = self._new_keyframe(frame)
        if reset:
            # Lost right after initialization: restart from scratch
            # (src/Tracking.cc:540-552).
            self.reset()
            return None
        if kf is not None and self.mapping_worker is not None:
            self.mapping_worker.insert_keyframe(kf)
        return pose

    def _new_keyframe(self, frame: Frame) -> int:
        """Make the frame a keyframe and, with synchronous mapping, map it."""
        # The anchor rebind happens before mapping moves the new keyframe
        # (CreateNewKeyFrame before the bookkeeping).
        with self.profiler.timed("keyframe_insert"):
            kf = self._insert_keyframe(frame)
        self.tracker.bind_keyframe_anchor(frame, kf)
        if self.mapping_worker is None:
            with self.profiler.timed("local_mapping"):
                self.mapper.process_keyframe(kf)
            if self.loop_closer is not None:
                with self.profiler.timed("loop_closing"):
                    self.loop_closer.process_keyframe(kf)
        self.tracker.ref_kf = kf
        self.tracker.last_kf_frame_id = frame.frame_id
        return kf

    def _insert_keyframe(self, frame: Frame) -> int:
        """Tracking::CreateNewKeyFrame (src/Tracking.cc:1311-1401): for
        stereo and RGB-D, unbound features with close depth spawn new map
        points, nearest first, at least 100 or all closer than th_depth
        (:1335-1392); a monocular frame has no depth (depth -1)."""
        take, pw = close_depth_points(frame, self.config.camera)
        take = take[: self.map.cfg.max_points - self.map.next_pt]
        if take.size:
            ids = self.map.add_points(pw[: take.size], self.map.next_kf)
            frame.point_ids[take] = ids
            for pid in ids:
                self.mapper.recent_points.append(RecentPoint(int(pid), self.map.next_kf))
        return self.map.add_keyframe(
            frame.R, frame.t, frame.xy, frame.octave, frame.angle, frame.desc,
            frame.valid, frame.point_ids, frame.frame_id, frame.timestamp,
            depth=frame.depth, ur=frame.ur,
        )

    # ------------------------------------------------------------------
    # Mode switches (ActivateLocalizationMode, src/System.cc:284-307;
    # Reset :309-313)
    # ------------------------------------------------------------------

    def activate_localization_mode(self) -> None:
        """Track against the map without changing it: no keyframe, no map
        point (a depth sensor's temporal VO points live one frame)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self) -> None:
        self.tracker.localization_only = False

    def _drain(self) -> None:
        """Abort a global BA in flight and let the worker empty its queue,
        both before the map lock is taken (the runner may wait for it to
        merge)."""
        if self._gba is not None:
            self._gba.abort_and_join()
        if self.mapping_worker is not None:
            self.mapping_worker.wait_idle()

    def reset(self) -> None:
        """Tracking::Reset (src/Tracking.cc:1886-1932): clear the map, the
        keyframe database and the loop closer's state, and restart tracking
        from scratch; the localization-only flag stays as it was. Called
        from another thread, it waits for the frame in flight."""
        with self._frame_lock:
            self._drain()
            with self._locked():
                self._build()

    def save_map(self, path: str) -> None:
        """Write the whole map to an .npz (models/serialization.py), in the
        JAX package's layout."""
        serialization.save_map(self.map, path)

    def load_map(self, path: str) -> None:
        """Load a map and rewire every stage to it: tracking starts LOST
        against its newest keyframe (relocalization takes over), and the
        database is rebuilt from its keyframes' descriptors."""
        with self._frame_lock:
            self._drain()
            with self._locked():
                self._load_map(path)

    def _load_map(self, path: str) -> None:
        self.map = serialization.load_map(path)
        self.tracker.map = self.map
        self.mapper.map = self.map
        valid = np.where(self.map.kf_valid)[0]
        self.tracker.ref_kf = int(valid[-1]) if valid.size else -1
        self.tracker.state = TrackingState.LOST if valid.size else TrackingState.NOT_INITIALIZED
        if self.kf_database is not None:
            self.kf_database.clear()
            self._wire_database()
            serialization.rebuild_database(self.map, self.kf_database)
        if self.loop_closer is not None:
            self.loop_closer.map = self.map

    def shutdown(self) -> None:
        """Drain the keyframe queue, then finish the mapping worker and wait
        for a global BA in flight to merge (System::Shutdown,
        src/System.cc:315-334); raises what a background thread raised.
        Then it releases its CUDA graphs (the tracker's and the mapper's,
        captured under its configurations, the staged tracker's
        (STAGED_GRAPHED), the loop closer's and the AR anchor's
        (LOOP_GRAPHED) and the solvers': BA's and the pose graph's) and
        logs the captures made since it was built."""
        worker = self.mapping_worker
        try:
            if worker is not None:
                worker.wait_idle()
        finally:
            if worker is not None:
                worker.join()
            if self._gba is not None:
                self._gba.join()
            released = cuda_graph.release(self.config, self.init_config, *ba.GRAPHED,
                                          *pose_graph.GRAPHED, *STAGED_GRAPHED,
                                          *LOOP_GRAPHED)
            _LOG.info("System %s: %d CUDA graph captures since it was built, %d graphs "
                      "released", self.config.sensor,
                      cuda_graph.n_captures() - self._captures_at_start, released)

    def map_changed(self) -> int:
        """The map's big-change count: loop corrections and global BAs."""
        return self.map.big_change_idx

    def timings(self):
        """Per-stage timing summary (utils/profiling.Profiler):
        {stage: {count, mean_ms, ema_ms, min_ms, max_ms, total_s}}."""
        return self.profiler.summary()

    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    # ------------------------------------------------------------------
    # Trajectory export (src/System.cc:336-486)
    # ------------------------------------------------------------------

    def _resolve_trajectory(self) -> List[Tuple[float, np.ndarray, np.ndarray]]:
        """Frame poses = relative pose composed with the (possibly
        BA-corrected) reference keyframe pose, walking to the
        spanning-tree parent through each culled keyframe's frozen Tcp
        (src/System.cc:362-384)."""
        out = []
        for e in self.tracker.trajectory:
            k = e.ref_kf
            R_rel, t_rel = e.R_rel, e.t_rel
            hops = 0
            while k >= 0 and not self.map.kf_valid[k] and hops < 64:
                parent = int(self.map.kf_parent[k])
                if parent < 0:
                    break
                t_rel = R_rel @ self.map.kf_tcp_t[k] + t_rel
                R_rel = R_rel @ self.map.kf_tcp_R[k]
                k = parent
                hops += 1
            if k < 0:
                continue
            Rk, tk = self.map.kf_pose_R[k], self.map.kf_pose_t[k]
            out.append((e.timestamp, R_rel @ Rk, R_rel @ tk + t_rel))
        return out

    def save_trajectory_tum(self, path: str) -> None:
        traj.write_tum(path, self._resolve_trajectory())

    def save_trajectory_kitti(self, path: str) -> None:
        traj.write_kitti(path, self._resolve_trajectory())

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        traj.write_tum(path, [
            (float(self.map.kf_timestamp[k]), self.map.kf_pose_R[k], self.map.kf_pose_t[k])
            for k in range(self.map.next_kf) if self.map.kf_valid[k]])

    def trajectory_positions(self) -> np.ndarray:
        """[T, 3] camera centres for evaluation."""
        return np.asarray([-R.T @ t for _, R, t in self._resolve_trajectory()])
