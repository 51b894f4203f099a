"""Headless visualization and observability (the port's copy of
slam/viewer.py; reference: src/Viewer.cc, src/FrameDrawer.cc,
src/MapDrawer.cc).

It renders the surfaces of the reference's Pangolin viewer into numpy
images: the current frame with its keypoints and a status bar
(FrameDrawer::DrawFrame :38-142, DrawTextInfo :144-180) and a top-down map
view with keyframes, the covisibility graph, the spanning tree, loop edges
and points (MapDrawer::DrawMapPoints :44, DrawKeyFrames :84); a metrics
dict gives the reference's tracking-state getters (src/System.cc:488-504).
Everything here is host numpy over the numpy fields of the port's Frame
and MapState: the viewer never touches a tensor, so its thread puts no
work on the card.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

import numpy as np

from orb_slam2_commit_tpu_torch.models.map_state import MapState
from orb_slam2_commit_tpu_torch.slam.frame import Frame
from orb_slam2_commit_tpu_torch.slam.tracking import Tracker
from orb_slam2_commit_tpu_torch.utils.png import write_png
from orb_slam2_commit_tpu_torch.utils.profiling import Profiler


def draw_frame(
    frame: Frame, image: np.ndarray, state_name: str, map_state: MapState
) -> np.ndarray:
    """Current-frame overlay [H, W, 3] uint8 (oracle: FrameDrawer)."""
    h, w = image.shape
    canvas = np.stack([image] * 3, axis=-1).astype(np.uint8)

    def box(u, v, half, color):
        u, v = int(round(u)), int(round(v))
        u0, u1 = max(u - half, 0), min(u + half, w - 1)
        v0, v1 = max(v - half, 0), min(v + half, h - 1)
        canvas[v0:v1 + 1, u0] = color
        canvas[v0:v1 + 1, u1] = color
        canvas[v0, u0:u1 + 1] = color
        canvas[v1, u0:u1 + 1] = color

    green = np.array([0, 255, 0], np.uint8)     # tracked map point
    blue = np.array([80, 160, 255], np.uint8)   # detected only
    for i in np.where(frame.valid)[0]:
        u, v = frame.xy_raw[i]
        if frame.point_ids[i] >= 0:
            box(u, v, 3, green)
        else:
            box(u, v, 2, blue)

    # Status bar: the reference prints "SLAM MODE | KFs | MPs | Matches";
    # the counts go to the metrics dict and a bar shows the tracked share.
    n_tracked = int((frame.point_ids >= 0).sum())
    bar_h = 12
    canvas[:bar_h] = 32
    frac = min(n_tracked / 200.0, 1.0)
    canvas[:bar_h, : int(frac * w)] = np.array([0, 180, 0], np.uint8)
    return canvas


def draw_map_topdown(
    map_state: MapState,
    current_pose: Optional[tuple] = None,
    size: int = 512,
    margin: float = 1.2,
    loop_edges: Optional[list] = None,
    follow: bool = False,
    follow_radius: float = 5.0,
) -> np.ndarray:
    """Top-down (x-z) map view [size, size, 3] uint8 (oracle: MapDrawer):
    map points (white), keyframes (blue), covisibility edges (gray),
    spanning tree (dark green), loop edges (red, pass [(a, b), ...]),
    current camera with a view-direction frustum wedge (green).

    follow=True centres the view on the current camera at a fixed
    follow_radius instead of framing the whole map: the reference
    Viewer's "Follow Camera" menu toggle (src/Viewer.cc:70,99-120)."""
    canvas = np.zeros((size, size, 3), np.uint8)
    pts = map_state.pt_pos[map_state.pt_valid]
    kfs = np.where(map_state.kf_valid)[0]
    centers = np.stack(
        [-map_state.kf_pose_R[k].T @ map_state.kf_pose_t[k] for k in kfs]
    ) if kfs.size else np.zeros((0, 3))

    all_xz = np.concatenate(
        [pts[:, [0, 2]] if pts.size else np.zeros((0, 2)),
         centers[:, [0, 2]] if centers.size else np.zeros((0, 2))]
    )
    if all_xz.shape[0] == 0:
        return canvas
    if follow and current_pose is not None:
        R_cur, t_cur = current_pose
        c_cur = -np.asarray(R_cur).T @ np.asarray(t_cur)
        center = c_cur[[0, 2]]
        scale = (size / 2 - 8) / (margin * follow_radius)
    else:
        lo = all_xz.min(0) - 1e-3
        hi = all_xz.max(0) + 1e-3
        center = (lo + hi) / 2
        scale = (size / 2 - 8) / (margin * max((hi - lo).max() / 2, 1e-6))

    def to_px(xz):
        p = (xz - center) * scale
        return (
            np.clip(p[..., 0] + size / 2, 0, size - 1).astype(int),
            np.clip(size / 2 - p[..., 1], 0, size - 1).astype(int),
        )

    if pts.size:
        u, v = to_px(pts[:, [0, 2]])
        canvas[v, u] = [200, 200, 200]

    kf_row = {int(a): i for i, a in enumerate(kfs)}

    def line(pa, pb, color):
        ua, va = to_px(pa)
        ub, vb = to_px(pb)
        n = max(abs(int(ub) - int(ua)), abs(int(vb) - int(va)), 1)
        us = np.linspace(ua, ub, n + 1).astype(int)
        vs = np.linspace(va, vb, n + 1).astype(int)
        canvas[vs, us] = color

    # Covisibility edges of at least the map's weight threshold
    # (MapDrawer::DrawKeyFrames' graph pass, src/MapDrawer.cc:126-160).
    th = map_state.cfg.covisibility_min_weight
    for a_i, a in enumerate(kfs):
        for b_i, b in enumerate(kfs):
            if b <= a or map_state.cov_weight[a, b] < th:
                continue
            line(centers[a_i, [0, 2]], centers[b_i, [0, 2]], [90, 90, 90])

    # Spanning tree (drawn in the same pass, :150-160).
    for a_i, a in enumerate(kfs):
        p = int(map_state.kf_parent[a])
        if p in kf_row:
            line(centers[a_i, [0, 2]], centers[kf_row[p], [0, 2]], [40, 140, 60])

    # Loop edges (red; :163-176), the map's own by default.
    if loop_edges is None:
        loop_edges = map_state.loop_edges
    for (a, b) in (loop_edges or []):
        if int(a) in kf_row and int(b) in kf_row:
            line(centers[kf_row[int(a)], [0, 2]], centers[kf_row[int(b)], [0, 2]],
                 [255, 60, 60])

    if centers.size:
        u, v = to_px(centers[:, [0, 2]])
        for ui, vi in zip(np.atleast_1d(u), np.atleast_1d(v)):
            canvas[max(vi - 2, 0):vi + 3, max(ui - 2, 0):ui + 3] = [60, 120, 255]

    if current_pose is not None:
        R, t = current_pose
        c = -np.asarray(R).T @ np.asarray(t)
        u, v = to_px(np.asarray([c[0], c[2]]))
        canvas[max(v - 3, 0):v + 4, max(u - 3, 0):u + 4] = [0, 255, 0]
        # Frustum wedge: the optical axis +z and the two horizontal rays in
        # world coordinates (MapDrawer::DrawCurrentCamera :189-236).
        Rwc = np.asarray(R).T
        for ang in (-0.4, 0.0, 0.4):
            d = Rwc @ np.array([np.sin(ang), 0.0, np.cos(ang)])
            tip = c + 0.8 * d
            line(np.asarray([c[0], c[2]]), np.asarray([tip[0], tip[2]]), [0, 255, 0])
    return canvas


def collect_metrics(tracker: Tracker, map_state: MapState) -> Dict[str, float]:
    """Observability counters (the reference's System getters and
    FrameDrawer's status text, src/FrameDrawer.cc:144-180)."""
    return {
        "state": tracker.state.name,
        "n_keyframes": map_state.n_keyframes(),
        "n_points": map_state.n_points(),
        "n_inliers": tracker.n_inliers,
        "ref_kf": tracker.ref_kf,
        "big_change_idx": map_state.big_change_idx,
        "n_trajectory_entries": len(tracker.trajectory),
    }


def save_png(path: str, image: np.ndarray) -> None:
    """An [H, W, 3] uint8 image (or [H, W] gray) as a PNG file."""
    write_png(path, image)


class ViewerLoop:
    """Live render loop on its own thread: the reference Viewer thread
    (src/Viewer.cc:55-243). It redraws the frame overlay and the map view
    at the camera's fps (:46-52, :58), with the Pangolin panel's menu
    (:64-71) as toggles:

      follow_camera       menuFollowCamera (:66, :99-120)
      show_points/graph   menuShowPoints/menuShowGraph (:67-68)
      set_localization_mode(bool)  menuLocalizationMode (:69, :122-133)
      request_reset()     menuReset (:70, :135-152)
      request_finish/is_finished/request_stop/is_stopped/release
                          the thread protocol (:180-243)

    The latest surfaces are kept in .frame_view / .map_view (numpy) for
    any sink: tests, PNG streaming into stream_dir, an external UI. The
    tracking side calls update(frame, image) after each tracked frame, as
    FrameDrawer::Update. A render reads the map under system.reader_lock:
    the asynchronous System's map lock, the synchronous System's frame
    lock (the JAX package's viewer takes no lock there and reads the map
    while the tracker writes it). A render that raises does not end the
    loop: it is counted in n_errors and kept in last_error. `timings` (a Profiler) times each render's wait for the
    map lock ("lock_wait"), its drawing under the lock ("draw") and its PNG
    file ("png")."""

    def __init__(self, system, fps: float = 30.0, map_size: int = 512,
                 stream_dir: Optional[str] = None):
        self.system = system
        self.period = 1.0 / max(fps, 1e-3)
        self.map_size = map_size
        self.stream_dir = stream_dir
        self.follow_camera = True
        self.show_points = True
        self.show_graph = True
        self._latest = None          # (frame, image) from the tracker
        self._lock = threading.Lock()
        self.frame_view: Optional[np.ndarray] = None
        self.map_view: Optional[np.ndarray] = None
        self.metrics: Dict[str, float] = {}
        self.n_rendered = 0
        self.n_errors = 0
        self.last_error: Optional[BaseException] = None
        self.timings = Profiler()
        self._finish_requested = False
        self._finished = False
        self._stop_requested = False  # the reference's mbStopRequested
        self._stopped = False        # paused, acknowledged by the loop (mbStopped)
        self._reset_requested = False
        self._thread = threading.Thread(target=self._run, name="viewer", daemon=True)

    # -- tracking-side hook ---------------------------------------------

    def update(self, frame, image: np.ndarray) -> None:
        """Publish the newest tracked frame (FrameDrawer::Update)."""
        with self._lock:
            self._latest = (frame, np.asarray(image))

    # -- menu -----------------------------------------------------------

    def set_localization_mode(self, on: bool) -> None:
        if on:
            self.system.activate_localization_mode()
        else:
            self.system.deactivate_localization_mode()

    def request_reset(self) -> None:
        """Queued: the viewer thread runs System.reset at its next period,
        as the reference handles menuReset (src/Viewer.cc:135-152)."""
        self._reset_requested = True

    # -- thread protocol (reference :180-243) ---------------------------

    def start(self) -> "ViewerLoop":
        self._thread.start()
        return self

    def request_finish(self) -> None:
        self._finish_requested = True

    def is_finished(self) -> bool:
        return self._finished

    def request_stop(self) -> None:
        """Asynchronous pause request. The loop acknowledges it at its next
        period boundary; a render in flight may still complete. Poll
        is_stopped() before relying on a frozen render count (the
        reference's RequestStop -> Stop -> isStopped handshake,
        src/Viewer.cc:203-227)."""
        self._stop_requested = True

    def is_stopped(self) -> bool:
        """True once the loop has acknowledged request_stop; it renders
        nothing more until release() (the reference's isStopped)."""
        return self._stopped

    def release(self) -> None:
        self._stop_requested = False
        self._stopped = False

    def join(self, timeout: Optional[float] = None) -> None:
        self.request_finish()
        self._thread.join(timeout)

    # -- render loop ----------------------------------------------------

    def _render_once(self) -> None:
        with self._lock:
            latest = self._latest
        sys_ = self.system
        t0 = time.perf_counter()
        with sys_.reader_lock:
            t1 = time.perf_counter()
            self.timings.record("lock_wait", t1 - t0)
            tracker = sys_.tracker
            cur = None
            if tracker.last_frame is not None and tracker.last_frame.R is not None:
                cur = (tracker.last_frame.R.copy(), tracker.last_frame.t.copy())
            self.map_view = draw_map_topdown(
                sys_.map, current_pose=cur, size=self.map_size,
                follow=self.follow_camera and cur is not None,
            ) if self.show_points or self.show_graph else None
            if latest is not None:
                frame, image = latest
                self.frame_view = draw_frame(frame, image, tracker.state.name, sys_.map)
            self.metrics = collect_metrics(tracker, sys_.map)
            self.timings.record("draw", time.perf_counter() - t1)
        self.n_rendered += 1
        if self.stream_dir is not None and self.frame_view is not None:
            with self.timings.timed("png"):
                save_png(os.path.join(self.stream_dir, f"frame_{self.n_rendered:05d}.png"),
                         self.frame_view)

    def _run(self) -> None:
        while not self._finish_requested:
            t0 = time.perf_counter()
            if self._reset_requested:
                self._reset_requested = False
                self.system.reset()
            if self._stop_requested:
                self._stopped = True
            else:
                self._stopped = False
                try:
                    self._render_once()
                except Exception as e:   # a draw race must not end the loop
                    self.n_errors += 1
                    self.last_error = e
            dt = time.perf_counter() - t0
            if dt < self.period:
                time.sleep(self.period - dt)
        self._finished = True
