"""A transient, abortable global-BA thread with a spanning-tree merge
(PyTorch port of slam/global_ba.py).

The reference starts a thread for global bundle adjustment after each loop
correction (src/LoopClosing.cc:801) running RunGlobalBundleAdjustment
(:884-1020): the solve runs while tracking and mapping go on, a new loop
aborts it (mbStopGBA and the mnFullBAIdx generation token, :556-572,
:892-905), and a finished solve is merged under the map lock, its pose
corrections carried through the spanning tree to keyframes made while it
ran (:924-973) and through their reference keyframes to points made
meanwhile (:976-1006).

Here the BA problem is packed from the map under the lock
(tracking.build_ba_problem), solved outside it in segments of
`segment_iters` LM iterations (ba.bundle_adjust_jit: on the card a run of
CUDA graph replays, the observation tables made once for every segment;
the generation is checked between segments, and the damping restarts in
each), and merged under the
lock after the generation is checked again. On the card the runner's
thread solves on a CUDA stream of its own; the problem is built and read
back on that thread. An exception on the thread is kept and raised again
by `join`.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.interop import resolve_device, to_host
from orb_slam2_commit_tpu_torch.models.map_state import MapState
from orb_slam2_commit_tpu_torch.optim import ba
from orb_slam2_commit_tpu_torch.slam.tracking import build_ba_problem
from orb_slam2_commit_tpu_torch.utils.config import SLAMConfig
from orb_slam2_commit_tpu_torch.utils.rotation import orthonormalize_rotation


class GlobalBARunner:
    """At most one global BA in flight (the reference's transient GBA
    thread)."""

    def __init__(self, config: SLAMConfig, map_lock=None, segment_iters: int = 5,
                 device="cuda"):
        self.config = config
        self.map_lock = map_lock if map_lock is not None else contextlib.nullcontext()
        self.segment_iters = max(1, segment_iters)
        self.device = resolve_device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # Generation token (mnFullBAIdx, src/LoopClosing.cc:561): a bump
        # invalidates the run in flight, even one that has solved and waits
        # to merge. It is the only abort channel: a flag cleared for a
        # relaunch would race with the old thread's checks, and a stale
        # generation cannot come back.
        self.full_ba_idx = 0
        self._thread: Optional[threading.Thread] = None
        self.n_merged = 0
        self.n_aborted = 0
        self.error: Optional[BaseException] = None

    # -- control (isRunningGBA :200-207, the abort :556-572) ---------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def request_abort(self) -> None:
        """Abort without waiting: the run in flight gives up before it
        merges. Safe under the map lock (the thread checks the generation
        again once it holds the lock)."""
        if self.running:
            self.full_ba_idx += 1

    def abort_and_join(self, timeout: float = 120.0) -> None:
        """Abort and wait for the thread. Not under the map lock: the
        thread may be waiting for it."""
        self.request_abort()
        self.join(timeout)

    def join(self, timeout: float = 300.0) -> None:
        """Wait for the thread; raises what it raised."""
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        if self.error is not None:
            raise RuntimeError("the global BA runner failed") from self.error

    # -- launch -------------------------------------------------------------

    def launch(self, map_state: MapState, anchor_kf: int, n_iters: int = 10,
               blocking: bool = False) -> None:
        """A global BA over the current map, the anchor keyframe fixed. A
        run still in flight is aborted (a new loop does that, :556-572).
        blocking=True solves on the calling thread.

        Callable under the map lock: the previous thread is not joined here
        (it may wait for that lock); the generation bump invalidates it, and
        the new thread joins it before it starts, so one solve runs at a
        time."""
        prev = self._thread if self.running else None
        if prev is not None:
            self.full_ba_idx += 1
        gen = self.full_ba_idx
        if blocking:
            if prev is not None:
                prev.join()
            self._run(map_state, int(anchor_kf), int(n_iters), gen)
            return

        def run():
            if prev is not None:
                prev.join()
            stream = (torch.cuda.stream(self.stream) if self.stream is not None
                      else contextlib.nullcontext())
            try:
                with stream:
                    self._run(map_state, int(anchor_kf), int(n_iters), gen)
            except BaseException as e:   # kept, raised again on join
                self.error = e

        self._thread = threading.Thread(target=run, daemon=True, name="global-ba")
        self._thread.start()

    # -- the thread ---------------------------------------------------------

    def _run(self, m: MapState, anchor_kf: int, n_iters: int, gen: int) -> None:
        cam = self.config.camera
        with self.map_lock:
            if gen != self.full_ba_idx:
                self.n_aborted += 1
                return
            if m.n_keyframes() < 3 or not m.kf_valid[anchor_kf]:
                return
            valid_kfs = np.where(m.kf_valid)[0]
            assembled = build_ba_problem(
                m, free_kfs=np.asarray([int(k) for k in valid_kfs if k != anchor_kf]),
                fixed_kfs=np.asarray([anchor_kf]), point_ids=np.where(m.pt_valid)[0],
                orb_cfg=self.config.orb, device=self.device)
            snap_next_kf, snap_next_pt = m.next_kf, m.next_pt

        # The solve, outside the lock, in abortable segments.
        problem = assembled.problem
        segs = ba.obs_segments(problem, 1024)
        remaining = n_iters
        while remaining > 0:
            if gen != self.full_ba_idx:
                self.n_aborted += 1
                return
            seg = min(self.segment_iters, remaining)
            problem, _ = ba.bundle_adjust_jit(problem, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                                              n_iters=seg, point_chunk=1024, segs=segs)
            remaining -= seg
        problem = problem._replace(R=to_host(problem.R), t=to_host(problem.t),
                                   points=to_host(problem.points))

        with self.map_lock:
            # A loop correction that began during the solve has made this
            # result stale (:892-905).
            if gen != self.full_ba_idx:
                self.n_aborted += 1
                return
            self._merge(m, assembled, problem, snap_next_kf, snap_next_pt)
            self.n_merged += 1
            m.big_change_idx += 1

    # -- the merge (:906-1007) ----------------------------------------------

    def _merge(self, m: MapState, assembled, out_problem, snap_next_kf: int,
               snap_next_pt: int) -> None:
        """Write the solution (out_problem's R, t and points, host arrays)
        back. A keyframe made during the solve keeps its pose
        relative to its spanning-tree parent (Tchild_w' = Tchild_parent
        Tparent_w', :944-963); a point made meanwhile keeps its position in
        its reference keyframe's camera frame (:984-1004)."""
        sol_R, sol_t, sol_pts = (np.asarray(a, np.float64) for a in (
            out_problem.R, out_problem.t, out_problem.points))
        old_R = m.kf_pose_R.copy()
        old_t = m.kf_pose_t.copy()
        solved: Dict[int, Tuple[np.ndarray, np.ndarray]] = {
            int(k): (sol_R[ci], sol_t[ci]) for ci, k in enumerate(assembled.kf_ids)}
        new_pose: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

        def resolve(k: int) -> Tuple[np.ndarray, np.ndarray]:
            # Walk the spanning tree to the nearest solved ancestor.
            chain = []
            cur = k
            while cur not in new_pose:
                if cur in solved:
                    new_pose[cur] = solved[cur]
                    break
                parent = int(m.kf_parent[cur])
                if parent < 0 or len(chain) > 4096:
                    new_pose[cur] = (old_R[cur], old_t[cur])
                    break
                chain.append(cur)
                cur = parent
            for cur in reversed(chain):
                parent = int(m.kf_parent[cur])
                Rp, tp = new_pose[parent]
                R_kp = old_R[cur] @ old_R[parent].T
                t_kp = old_t[cur] - R_kp @ old_t[parent]
                new_pose[cur] = (R_kp @ Rp, R_kp @ tp + t_kp)
            return new_pose[k]

        for k in np.where(m.kf_valid)[0]:
            R_n, t_n = resolve(int(k))
            m.kf_pose_R[k] = orthonormalize_rotation(R_n)
            m.kf_pose_t[k] = t_n

        # The solved points, but those culled meanwhile.
        n_pts = assembled.point_ids.size
        still = m.pt_valid[assembled.point_ids]
        m.pt_pos[assembled.point_ids[still]] = sol_pts[:n_pts][still]

        # Points made during the solve follow their reference keyframe.
        for pid in range(snap_next_pt, m.next_pt):
            if not m.pt_valid[pid]:
                continue
            ref = int(m.pt_first_kf[pid])
            if ref < 0 or ref >= old_R.shape[0]:
                continue
            p_cam = old_R[ref] @ m.pt_pos[pid] + old_t[ref]
            R_n, t_n = new_pose.get(ref, (old_R[ref], old_t[ref]))
            m.pt_pos[pid] = R_n.T @ (p_cam - t_n)
        m.refresh_point_stats()
