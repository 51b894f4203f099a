"""One run of one cell: the System under test fed frame by frame from a
pool made in set-up, timed over a window, its answers checked after it.

The traffic's `feed` says how frames are handed over. `closed` (the
default): one camera, whose next frame is handed over once the last pose
is returned, as the reference's dataset examples feed frames without
pacing. `paced`: frames fall due at `rate_hz` from the window's start; a
frame is handed over at its due time, and where the System is late the
frames already due but one are dropped and the newest is taken (a live
camera's driver). Set-up (everything before the first timed frame) builds
the System with its configuration, renders the traffic's pool on the card
and copies it to pinned host memory, and runs the warm-up frames through
the same System the window uses: initialization, the first keyframes and
the CUDA graph captures at the cell's shapes. A `localize` traffic maps one
lap of its circuit in set-up, switches the System to localization mode and
drives that lap again and again in the window.

The program gives the benchmark the System, its per-stage Profiler, its
CUDA graph counters and its kernels' names; nothing else of it is read.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from slambench import generator, reference


def build_config(cfg: Dict):
    """The configuration file -> the port's SLAMConfig (every group given
    in the file; a field the file leaves out takes the port's default)."""
    from orb_slam2_commit_tpu_torch.utils import config as C

    groups = {"camera": C.CameraConfig, "orb": C.ORBConfig, "matcher": C.MatcherConfig,
              "tracker": C.TrackerConfig, "map": C.MapConfig, "system": C.SystemConfig}
    return C.SLAMConfig(sensor=cfg["sensor"],
                        **{k: cls(**cfg[k]) for k, cls in groups.items() if k in cfg})


@dataclasses.dataclass
class Window:
    """What the window measured: per-frame latencies (s) of the frames whose
    call returned inside it, frames fed and failed, its length (s), the
    counters' differences over it, and its end (host clock)."""

    latencies: List[float]
    attempted: int
    failed: int
    seconds: float
    exhausted: bool
    keyframes: int
    captures: int
    stages: Dict[str, Dict[str, float]]
    t_end: float = 0.0          # the window's end on the host clock
    dropped: int = 0            # frames a paced feed dropped, late


def frames_per_s(w: Window) -> float:
    """Frames returned inside the window over the window's whole length."""
    return len(w.latencies) / w.seconds


def p95_ms(latencies: List[float]) -> float:
    """The 95th percentile of every frame's latency, ms (statistics'
    exclusive method over all frames, never over chunks)."""
    if len(latencies) < 2:
        return float(latencies[0]) * 1e3 if latencies else float("nan")
    return statistics.quantiles(latencies, n=20)[-1] * 1e3


class Cell:
    """A System and its traffic for one run."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device="cuda"):
        from orb_slam2_commit_tpu_torch.slam.system import System
        from orb_slam2_commit_tpu_torch.slam.tracking import TrackingState

        self.cfg_json, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.config = build_config(cfg)
        self.sensor = cfg["sensor"]
        self.fps = float(cfg["camera"]["fps"])
        t0 = time.perf_counter()
        self.pool = generator.make_pool(traffic, cfg, seed, self.device,
                                        pin=self.device.type == "cuda")
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            # The peak is the System's: the pool's rendering is freed.
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        self.system = System(self.config, async_mapping=False, device=device)
        if self.config.system.use_vocabulary and self.system.vocabulary is None:
            raise RuntimeError("the configuration loads the bundled vocabulary; "
                               "the System found none")
        self.setup_parts = {"pool_s": t1 - t0, "system_s": time.perf_counter() - t1}
        self.mode = traffic["mode"]
        self.lap = len(self.pool) if self.mode == "localize" else None
        self.k = 0                      # frames fed so far (timestamps)
        self.rng = np.random.default_rng([self.seed % (2 ** 63), 0x5EED])
        self.frame_answers: List[reference.Answer] = []
        self.kf_answers: List[reference.Answer] = []
        self.failed = 0                 # the window's frames not tracked
        self._matches: Optional[reference.Matches] = None
        self.depth_samples: List[Dict] = []
        self.lens_samples: List[Dict] = []
        self.distorted = generator.camera_from_config(cfg).distorted
        self._sample_next = False
        self._pending: Optional[reference.Answer] = None
        self.lap_stages: Dict[str, float] = {}
        self._ok = TrackingState.OK
        self._wrap_tracker()

    # -- feeding ----------------------------------------------------------

    def pool_index(self, k: int) -> int:
        return k % self.lap if self.lap else k

    def feed(self) -> bool:
        """Hand the next frame to the System; -> whether it tracked."""
        i = self.pool_index(self.k)
        ts = self.k / self.fps
        p = self.pool
        s = self.system
        if self.sensor == "stereo":
            pose = s.track_stereo(p.left[i].numpy(), p.right[i].numpy(), ts)
        elif self.sensor == "rgbd":
            pose = s.track_rgbd(p.left[i].numpy(), p.depth_image(i), ts)
        else:
            pose = s.track_monocular(p.left[i].numpy(), ts)
        self.k += 1
        return pose is not None and s.tracker.state == self._ok

    def frames_left(self) -> Optional[int]:
        return None if self.lap else len(self.pool) - self.k

    def set_up(self) -> None:
        """The untimed frames: the mapping lap and the switch to
        localization mode (`localize`), then the warm-up frames."""
        t0 = time.perf_counter()
        if self.mode == "localize":
            for _ in range(self.lap):
                self.feed()
            self.system.activate_localization_mode()
            stages = self.system.profiler.summary()
            self.lap_stages = {k: stages[k]["total_s"] for k in
                               sorted(stages, key=lambda k: -stages[k]["total_s"])[:8]}
        t1 = time.perf_counter()
        for _ in range(self.traffic["warmup_frames"]):
            self.feed()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_parts.update(mapping_lap_s=t1 - t0, warmup_s=time.perf_counter() - t1)

    # -- the answers the check reads --------------------------------------

    def _wrap_tracker(self) -> None:
        """Keep, for a sampled frame, what its pose was solved from, once
        the tracker has its pose and before a keyframe made from it changes
        the map. In localization mode the tracker drops the frame's
        one-frame visual-odometry points at the end of its call, after the
        pose was solved with them: the answer is taken just before that."""
        from orb_slam2_commit_tpu_torch.slam import jit_frontend

        tracker = self.system.tracker
        track = tracker.track
        optimize = tracker._optimize_pose
        fused_core = tracker._fused_local_map_core
        fused_call = jit_frontend.fused_local_map_track_jit
        clear = getattr(tracker, "_clear_temporal_vo_points", None)
        max_cand = self.config.tracker.max_local_points

        # All the matches the frame's last pose solve was given, and those
        # it kept: on the staged path the bindings before and after the
        # solve; on the card's fused local-map stage the bindings before it
        # and its per-feature output (binding into the candidates, inlier),
        # copied before the next replay reuses its buffer.
        def optimized(frame, *args, **kwargs):
            before = frame.point_ids.copy() if self._sample_next else None
            out = optimize(frame, *args, **kwargs)
            if before is not None:
                self._matches = self._matches_of(frame, before, frame.point_ids >= 0)
            return out

        def fused(frame, cand, *args, **kwargs):
            if not self._sample_next:
                return fused_core(frame, cand, *args, **kwargs)
            before = frame.point_ids.copy()
            perfeat = []

            def call(*a, **k):
                out = fused_call(*a, **k)
                perfeat.append(out[1].cpu().numpy())
                return out

            jit_frontend.fused_local_map_track_jit = call
            try:
                n_in = fused_core(frame, cand, *args, **kwargs)
            finally:
                jit_frontend.fused_local_map_track_jit = fused_call
            if perfeat:
                m_c = min(cand.size, max_cand)
                binding = perfeat[-1][:, 0].astype(np.int64)
                new = (binding >= 0) & (binding < m_c)
                ids = np.where(new, cand[np.clip(binding, 0, max(m_c - 1, 0))], before)
                self._matches = self._matches_of(frame, ids, perfeat[-1][:, 1] > 0.5)
            return n_in

        def tracked(frame, *args, **kwargs):
            self._pending = None
            self._matches = None
            out = track(frame, *args, **kwargs)
            if self._sample_next and out is not None:
                self._keep_frame(frame, self._pending)
            return out

        def cleared(frame):
            if self._sample_next and frame.R is not None:
                self._pending = self._answer(frame)
            return clear(frame)

        tracker.track = tracked
        tracker._optimize_pose = optimized
        tracker._fused_local_map_core = fused
        if clear is not None:
            tracker._clear_temporal_vo_points = cleared

    def _matches_of(self, f, ids: np.ndarray, kept: np.ndarray) -> reference.Matches:
        given = (ids >= 0) & f.valid
        pos = self.system.map.pt_pos[ids[given]].astype(np.float64)
        return reference.Matches(pos, f.xy[given].astype(np.float64),
                                 f.ur[given].astype(np.float64), f.octave[given].copy(),
                                 kept[given])

    def _answer(self, f) -> reference.Answer:
        m = self.system.map
        bound = f.point_ids >= 0
        return reference.Answer(
            "frame", int(f.frame_id), np.array(f.R, np.float64), np.array(f.t, np.float64),
            m.pt_pos[f.point_ids[bound]].astype(np.float64), f.xy[bound].astype(np.float64),
            f.ur[bound].astype(np.float64), f.octave[bound].copy(),
            frame=self.pool_index(self.k), matches=self._matches)

    def _keep_frame(self, f, answer: Optional[reference.Answer] = None) -> None:
        self.frame_answers.append(answer if answer is not None else self._answer(f))
        if self.sensor == "rgbd":
            self.depth_samples.append({
                "xy_raw": f.xy_raw[f.valid].copy(), "depth": f.depth[f.valid].copy(),
                "depth_image": self.pool.depth_image(self.pool_index(self.k))})
        if self.distorted:
            self.lens_samples.append({"xy_raw": f.xy_raw[f.valid].copy(),
                                      "xy": f.xy[f.valid].copy()})

    def _keep_keyframe(self, kf: int, frame: int) -> None:
        m = self.system.map
        if not m.kf_valid[kf]:
            return
        ids = m.kf_point_idx[kf]
        bound = (ids >= 0) & m.pt_valid[np.maximum(ids, 0)]
        self.kf_answers.append(reference.Answer(
            "keyframe", int(kf), m.kf_pose_R[kf].astype(np.float64),
            m.kf_pose_t[kf].astype(np.float64), m.pt_pos[ids[bound]].astype(np.float64),
            m.kf_xy[kf][bound].astype(np.float64), m.kf_ur[kf][bound].astype(np.float64),
            m.kf_octave[kf][bound].copy(), frame=frame))

    # -- the window -------------------------------------------------------

    def window(self, seconds: float, sample_share: float,
               max_frames: Optional[int] = None,
               between: Optional[Callable[[float], None]] = None) -> Window:
        """Feed frames for `seconds` (or, in the CPU tests, until
        `max_frames` are fed), back to back or paced as the traffic's `feed`
        says; each frame's latency is from its call to its pose in hand. A
        frame is sampled for the check with
        probability `sample_share` (drawn from the seed); every keyframe
        the window makes is kept. `between(seconds left)` runs between
        frames (the traced run starts its trace there)."""
        from orb_slam2_commit_tpu_torch.utils import cuda_graph

        s = self.system
        s.profiler.reset()
        kf0 = s.map.next_kf
        cap0 = cuda_graph.totals["captures"]
        lat: List[float] = []
        attempted = failed = dropped = due = 0
        exhausted = False
        feed = self.traffic.get("feed", {"mode": "closed"})
        period = 1.0 / float(feed["rate_hz"]) if feed["mode"] == "paced" else None
        sample = self.rng.random(1 << 16) < sample_share
        lba_seen = 0.0
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while True:
            left = self.frames_left()
            if left is not None and left <= 0:
                exhausted = True
                break
            self._sample_next = bool(sample[attempted % sample.size])
            next_kf = s.map.next_kf
            if period is not None:
                # Wait for the next frame's due time; where it is past, drop
                # all but the newest frame due.
                t_due = t_start + due * period
                now = time.perf_counter()
                if t_due >= t_end:
                    break
                if now < t_due:
                    time.sleep(t_due - now)
                else:
                    skip = int((now - t_start) / period) - due
                    if left is not None:
                        skip = min(skip, left - 1)
                    if skip > 0:
                        self.k += skip
                        due += skip
                        dropped += skip
                due += 1
            t0 = time.perf_counter()
            if t0 >= t_end or attempted == max_frames:
                break
            if between is not None:
                between(t_end - t0)
                t0 = time.perf_counter()
            ok = self.feed()
            t1 = time.perf_counter()
            attempted += 1
            failed += not ok
            if t1 <= t_end:
                lat.append(t1 - t0)
            self._sample_next = False
            if s.map.next_kf > next_kf:
                # A keyframe is judged by its local BA: the mapper skips BA
                # on a map of two keyframes or on too few points.
                lba = s.profiler.summary().get("map_lba", {}).get("count", 0.0)
                if lba > lba_seen:
                    self._keep_keyframe(s.map.next_kf - 1, self.pool_index(self.k - 1))
                lba_seen = lba
            if t1 > t_end:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        early = exhausted or attempted == max_frames
        length = (time.perf_counter() - t_start) if early else seconds
        stages = {k: {"count": v["count"], "total_s": v["total_s"]}
                  for k, v in s.profiler.summary().items()}
        self.failed = failed
        return Window(lat, attempted, failed, length, exhausted, s.map.next_kf - kf0,
                      cuda_graph.totals["captures"] - cap0, stages, t_start + length, dropped)

    # -- the check --------------------------------------------------------

    def numbers(self, dtype=torch.float64, device="cpu") -> Dict[str, Optional[float]]:
        """The compared numbers: the window's frames not tracked; the
        largest gap (in standard deviations of the estimate) over the
        sampled frames' poses and over the window's keyframes' poses; the
        largest inlier-count gap over the sampled frames; the keyframes'
        largest drift from the ground truth (% of the distance, from
        `drift_min_m` of the traffic's `check` on) and their steps' median
        error against it (%); for RGB-D the largest
        relative depth gap; for a lens with distortion the largest
        undistortion gap. With dtype below float64, the control's."""
        cam = self.cfg_json["camera"]
        sf = float(self.cfg_json["orb"]["scale_factor"])
        out: Dict[str, Optional[float]] = {"failed_frames": float(self.failed)}
        g = reference.pose_gaps(self.frame_answers, cam, sf, dtype, device)
        out["pose_gap_sigma"] = float(g.max()) if g.size else None
        g = reference.inlier_gaps(self.frame_answers, cam, sf, dtype, device)
        out["inlier_gap"] = float(g.max()) if g.size else None
        if self.mode != "localize":
            g = reference.pose_gaps(self.kf_answers, cam, sf, dtype, device)
            out["kf_gap_sigma"] = float(g.max()) if g.size else None
            poses = None if dtype == torch.float64 else [
                reference.solve_pose(a, cam, sf, dtype, device) for a in self.kf_answers]
            g = reference.drift_pcts(self.kf_answers, self.pool.poses,
                                     float(self.traffic["check"]["drift_min_m"]), poses)
            out["drift_pct"] = float(g.max()) if g.size else None
            g = reference.step_errors_pct(self.kf_answers, self.pool.poses, poses)
            out["step_err_pct"] = float(np.median(g)) if g.size else None
        if self.sensor == "rgbd":
            g = reference.depth_gaps(self.depth_samples,
                                     float(self.cfg_json["camera"]["depth_map_factor"]), dtype)
            out["depth_gap"] = float(g.max()) if g.size else None
        if self.distorted:
            g = reference.undistort_gaps(self.lens_samples, cam, dtype)
            out["undistort_gap_px"] = float(g.max()) if g.size else None
        return out

    def close(self) -> None:
        """Release the System's graphs (it runs no thread when synchronous)."""
        self.system.shutdown()
