"""Loop closing: detection, Sim3 alignment, map correction, global BA
(PyTorch port of slam/loop_closing.py; reference: src/LoopClosing.cc).

A per-keyframe stage the System runs after local mapping, on the caller's
thread or, with asynchronous mapping, on the mapping worker's
(slam/async_pipeline.py), under the map lock:

  detect_loop    BoW candidates above the covisible keyframes' lowest
                 score, with covisibility-group temporal consistency >= 3
                 (:115-257)
  compute_sim3   descriptor matches (K7, every candidate in one launch)
                 -> Sim3 RANSAC -> SearchBySim3 (K6, one launch a
                 direction) -> Sim3 LM -> the loop neighbourhood's points
                 projected into the keyframe (K6) (:287-534)
  correct_loop   the corrected Sim3 through the covisible neighbourhood,
                 its points moved, the loop's matches bound, the essential
                 graph, global BA (:545-880, :884-1020): inline, or with a
                 `gba_runner` (slam/global_ba.py) on its own thread, the
                 run in flight aborted as a correction starts

Device work (the matchers' kernels, the RANSAC, both LMs, the BA) runs on
the closer's device; the map and the decisions stay on the host, as in
the JAX package. RANSAC sample sets come from `self.sampler`
(geometry/ransac.RansacSampler, seeded), drawn on the host: one call per
candidate that reaches the RANSAC.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist

from orb_slam2_commit_tpu_torch.geometry import sim3_solver
from orb_slam2_commit_tpu_torch.geometry.ransac import RansacSampler
from orb_slam2_commit_tpu_torch.interop import resolve_device, to_device, to_host
from orb_slam2_commit_tpu_torch.models.kf_database import KeyFrameDatabase
from orb_slam2_commit_tpu_torch.models.map_state import MapState
from orb_slam2_commit_tpu_torch.optim import ba, pose_graph, sim3_opt
from orb_slam2_commit_tpu_torch.parallel import distributed_ba as dba
from orb_slam2_commit_tpu_torch.parallel import multihost
from orb_slam2_commit_tpu_torch.slam import matchers
from orb_slam2_commit_tpu_torch.slam.tracking import (
    _round_up_pow2, build_ba_problem, write_back_ba)
from orb_slam2_commit_tpu_torch.utils.config import SLAMConfig
from orb_slam2_commit_tpu_torch.utils.rotation import orthonormalize_rotation

COVISIBILITY_CONSISTENCY_TH = 3   # reference :43
MIN_SIM3_MATCHES = 20             # reference :320, :433
MIN_TOTAL_MATCHES = 40            # reference :517


def use_distributed_gba() -> bool:
    """Shard global BA over the process group (parallel/distributed_ba.py)
    when ORB_DISTRIBUTED_GBA=1 (over multihost.initialize's group: a world
    of one on one card), never when it is 0; unset, only when an
    initialized group spans more than one rank."""
    v = os.environ.get("ORB_DISTRIBUTED_GBA")
    if v is not None:
        return v == "1"
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _pad(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    """a [m, ...] padded to n rows of fill."""
    a = np.asarray(a)
    return np.concatenate([a, np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)])


@dataclasses.dataclass
class ConsistentGroup:
    keyframes: Set[int]
    consistency: int


class LoopCloser:
    def __init__(self, config: SLAMConfig, map_state: MapState, database: KeyFrameDatabase,
                 essential_min_weight: int = 100, device="cuda"):
        self.config = config
        self.map = map_state
        self.db = database
        self.device = resolve_device(device)
        # Covisibility weight of essential-graph edges (the reference's 100
        # at 1000-2000 features, src/Optimizer.cc:1008; the System scales
        # it with the feature budget).
        self.essential_min_weight = essential_min_weight
        self.consistent_groups: List[ConsistentGroup] = []
        self.last_loop_kf: int = -(10 ** 9)
        self.n_loops_closed = 0
        self.sampler = RansacSampler(seed=7)
        # Pad the Sim3 pairs to a power of two (_pair_tensors): on the
        # card, where each pair count would be a CUDA graph of its own.
        self.pad_pairs = self.device.type == "cuda"
        # One record per closure: {kf, loop_kf, n_keyframes, n_points,
        # correct_s}.
        self.correction_stats: List[dict] = []
        # The asynchronous System's global BA runner (slam/global_ba.py);
        # None runs global BA inline.
        self.gba_runner = None
        # Optional stage profiler (set by the System). Stages: loop_detect,
        # loop_sim3, loop_correct (loop_essential_graph and loop_gba
        # inside it).
        self.profiler = None

    def _timed(self, stage: str):
        if self.profiler is None:
            return contextlib.nullcontext()
        return self.profiler.timed(stage)

    def _dev(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    # ------------------------------------------------------------------

    def process_keyframe(self, kf: int) -> bool:
        """True if a loop was closed. The keyframe goes into the database
        afterwards either way (reference :93, :255, :276)."""
        closed = False
        if self.map.n_keyframes() > 10 and kf - self.last_loop_kf > 10:
            with self._timed("loop_detect"):
                candidates = self.detect_loop(kf)
            if candidates:
                with self._timed("loop_sim3"):
                    ok, loop_kf, s_cw, R_cw, t_cw, matches = self.compute_sim3(kf, candidates)
                if ok:
                    t0 = time.perf_counter()
                    with self._timed("loop_correct"):
                        self.correct_loop(kf, loop_kf, s_cw, R_cw, t_cw, matches)
                    self.correction_stats.append({
                        "kf": int(kf), "loop_kf": int(loop_kf),
                        "n_keyframes": int(self.map.n_keyframes()),
                        "n_points": int(self.map.pt_valid.sum()),
                        "correct_s": time.perf_counter() - t0,
                    })
                    self.last_loop_kf = kf
                    self.n_loops_closed += 1
                    closed = True
        self.db.add(kf, self.map.kf_desc[kf], self.map.kf_feat_valid[kf])
        return closed

    # ------------------------------------------------------------------

    def detect_loop(self, kf: int) -> List[int]:
        """DetectLoop (src/LoopClosing.cc:115-257)."""
        covis = self.map.covisible_keyframes(kf, None, min_weight=15)
        if not self.db.present[kf]:
            self.db.add(kf, self.map.kf_desc[kf], self.map.kf_feat_valid[kf])
        uw, wt = self.db.kf_bow(kf)
        min_score = 1.0              # the covisible keyframes' lowest (:136-156)
        for c in covis:
            if self.db.present[c]:
                min_score = min(min_score, self.db.voc.sparse_score(uw, wt, *self.db.kf_bow(c)))

        candidates = self.db.detect_loop_candidates(self.map, kf, min_score)
        if not candidates:
            self.consistent_groups = []
            return []

        # Temporal consistency over covisibility groups (:172-257).
        enough: List[int] = []
        new_groups: List[ConsistentGroup] = []
        for cand in candidates:
            group = {cand} | {int(x) for x in self.map.covisible_keyframes(cand, None, 1)}
            best_consistency = 0
            matched_prev = False
            for prev in self.consistent_groups:
                if group & prev.keyframes:
                    matched_prev = True
                    best_consistency = max(best_consistency, prev.consistency + 1)
            new_groups.append(ConsistentGroup(group, best_consistency if matched_prev else 0))
            if best_consistency >= COVISIBILITY_CONSISTENCY_TH:
                enough.append(cand)
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------

    def compute_sim3(self, kf: int, candidates: List[int]):
        """ComputeSim3 (src/LoopClosing.cc:287-534) -> (ok, loop_kf, s_cw,
        R_cw, t_cw, point matches {feature of kf: point id}). The
        candidates' descriptor matches come from one K7 launch; they are
        taken in candidate order, and the first accepted wins."""
        cfg = self.config
        cam = cfg.camera
        fix_scale = cfg.sensor != "monocular"
        m = self.map

        # The candidates padded to a power of two (>= 4), the padding's
        # flags False: one graph per bucket on the card.
        C = len(candidates)
        Cp = _round_up_pow2(C, 4)
        cands = np.asarray(candidates, np.int64)
        kf_ok = (m.kf_point_idx[kf] >= 0) & m.kf_feat_valid[kf]
        n_feat = m.kf_desc.shape[1]
        cd_desc = np.zeros((Cp, n_feat, 8), m.kf_desc.dtype)
        cd_angle = np.zeros((Cp, n_feat), m.kf_angle.dtype)
        cd_ok = np.zeros((Cp, n_feat), bool)
        cd_desc[:C] = m.kf_desc[cands]
        cd_angle[:C] = m.kf_angle[cands]
        cd_ok[:C] = (m.kf_point_idx[cands] >= 0) & m.kf_feat_valid[cands]
        bf = matchers.match_brute_force_jit(
            self._dev(m.kf_desc[kf]), self._dev(m.kf_angle[kf]), self._dev(kf_ok),
            self._dev(cd_desc), self._dev(cd_angle), self._dev(cd_ok))
        idx_all = to_host(bf.idx)                                    # [Cp, N]

        for c, cand in enumerate(candidates):
            idx = idx_all[c]
            rows = np.where(idx >= 0)[0]
            if rows.size < MIN_SIM3_MATCHES:
                continue
            feat1, feat2 = rows, idx[rows]
            n_real = feat1.size
            pairs = self._pair_tensors(kf, cand, feat1, feat2)

            res = sim3_solver.sim3_ransac_jit(
                self._dev(self.sampler.sim3(np.ones(n_real, bool))).long(),
                pairs["x1"], pairs["x2"], pairs["valid"], pairs["uv1"], pairs["uv2"],
                pairs["s2_1"], pairs["s2_2"], cam.fx, cam.fy, cam.cx, cam.cy,
                fix_scale=fix_scale, min_inliers=MIN_SIM3_MATCHES)
            ok, s12, R12, t12, inliers = (to_host(v) for v in (
                res.ok, res.s12, res.R12, res.t12, res.inliers))
            if not bool(ok):
                continue

            # SearchBySim3 (src/ORBmatcher.cc:1238-1487, called at
            # src/LoopClosing.cc:393): each side's bound points through the
            # RANSAC Sim3 into the other keyframe, the mutually consistent
            # new pairs added before the Sim3 LM.
            new1, new2 = self._search_by_sim3(kf, cand, float(s12), R12, t12, feat1, feat2)
            valid0 = inliers[:n_real]
            if new1.size:
                feat1 = np.concatenate([feat1, new1])
                feat2 = np.concatenate([feat2, new2])
                valid0 = np.concatenate([valid0, np.ones(new1.size, bool)])
                pairs = self._pair_tensors(kf, cand, feat1, feat2)

            opt = sim3_opt.optimize_sim3_jit(
                res.s12, res.R12, res.t12, pairs["x1"], pairs["x2"], pairs["uv1"],
                pairs["uv2"], pairs["inv1"], pairs["inv2"],
                self._dev(_pad(valid0, pairs["x1"].shape[0])), cam.fx, cam.fy, cam.cx, cam.cy,
                fix_scale=fix_scale)
            n_in, s12, R12, t12, opt_inl = (to_host(v) for v in (
                opt.n_inliers, opt.s12, opt.R12, opt.t12, opt.inliers))
            opt_inl = opt_inl[:feat1.size]
            if int(n_in) < MIN_SIM3_MATCHES:
                continue

            # S_cw = S_c,cand T_cand,w (the reference's mScw = gScm gSmw :480).
            s12 = float(s12)
            R2, t2 = m.kf_pose_R[cand], m.kf_pose_t[cand]
            s_cw = s12
            R_cw = R12 @ R2
            t_cw = s12 * R12 @ t2 + t12

            # The Sim3 LM's inliers seed the matches (:468-476); the
            # projection below keeps existing entries (:497-517).
            inl = opt_inl & (m.kf_point_idx[cand][feat2] >= 0)
            matches = {int(f): int(m.kf_point_idx[cand][g])
                       for f, g in zip(feat1[inl], feat2[inl])}

            # Widen: the loop neighbourhood's points through S_cw into the
            # current keyframe (:497-517, SearchByProjection).
            neigh = [cand] + [int(x) for x in m.covisible_keyframes(cand, 10, 1)]
            loop_pts = np.unique(np.concatenate([m.kf_point_idx[n] for n in neigh]))
            loop_pts = loop_pts[loop_pts >= 0]
            loop_pts = loop_pts[m.pt_valid[loop_pts]]
            pc = s_cw * (m.pt_pos[loop_pts] @ R_cw.T) + t_cw
            z = pc[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                u = cam.fx * pc[:, 0] / z + cam.cx
                vv = cam.fy * pc[:, 1] / z + cam.cy
            in_img = (z > 0) & (u >= 0) & (u < cam.width) & (vv >= 0) & (vv < cam.height)
            if in_img.sum() >= 1:
                # The JAX package's shape bucket (>= 256, a power of two).
                n_real = loop_pts.size
                P = _round_up_pow2(n_real, 256)

                def padv(a, fill=0):
                    return np.concatenate([a, np.full((P - n_real,) + a.shape[1:], fill,
                                                      a.dtype)])

                proj = np.where(in_img[:, None], np.stack([u, vv], -1), 0.0)
                m2 = matchers.match_fuse_jit(
                    matchers.FrustumInfo(
                        visible=self._dev(padv(in_img)), proj=self._dev(padv(proj)),
                        pred_octave=torch.zeros(P, dtype=torch.int32, device=self.device),
                        view_cos=torch.ones(P, device=self.device)),
                    self._dev(padv(m.pt_desc[loop_pts])), self._dev(m.kf_xy[kf]),
                    self._dev(m.kf_desc[kf]), self._dev(m.kf_octave[kf]),
                    self._dev(m.kf_feat_valid[kf]), th=8.0,
                    n_levels=cfg.orb.n_levels, scale=cfg.orb.scale_factor)
                i2 = to_host(m2.idx)[:n_real]
                r2 = np.where(i2 >= 0)[0]
                for f, p in zip(i2[r2].tolist(), loop_pts[r2].tolist()):
                    matches.setdefault(int(f), int(p))
            if len(matches) < MIN_TOTAL_MATCHES:
                continue
            return True, cand, s_cw, R_cw, t_cw, matches
        return False, -1, 1.0, np.eye(3), np.zeros(3), {}

    def _pair_arrays(self, kf: int, cand: int, feat1: np.ndarray, feat2: np.ndarray):
        """Camera-frame points, pixels and octave variances of matched
        feature pairs (feat1 in kf, feat2 in cand): the Sim3Solver's inputs
        (src/Sim3Solver.cc:37-125)."""
        m, cfg = self.map, self.config
        pid1 = m.kf_point_idx[kf][feat1]
        pid2 = m.kf_point_idx[cand][feat2]
        x1 = m.pt_pos[pid1] @ m.kf_pose_R[kf].T + m.kf_pose_t[kf]
        x2 = m.pt_pos[pid2] @ m.kf_pose_R[cand].T + m.kf_pose_t[cand]
        sig = np.asarray(cfg.orb.level_sigma2())
        n_lv = cfg.orb.n_levels
        s2_1 = sig[np.clip(m.kf_octave[kf][feat1], 0, n_lv - 1)]
        s2_2 = sig[np.clip(m.kf_octave[cand][feat2], 0, n_lv - 1)]
        return x1, x2, m.kf_xy[kf][feat1], m.kf_xy[cand][feat2], s2_1, s2_2

    def _pair_tensors(self, kf: int, cand: int, feat1: np.ndarray, feat2: np.ndarray):
        """_pair_arrays on the device: the RANSAC's and the LM's inputs ->
        {x1, x2, uv1, uv2, s2_1, s2_2, inv1, inv2 (the inverse variances),
        valid}. With pad_pairs (the card's default), padded to a power of
        two (>= 64) with `valid` False on the padding (zero points and
        pixels, unit variances); otherwise the count stays exact, as in the
        JAX package (which compiles each count). The padding moves the
        refit's and the LM's float sums by a few ulps (their reduction
        trees follow the length); tests/test_torch_loop_closing.py holds
        the padded closure to the JAX package's."""
        x1, x2, uv1, uv2, s2_1, s2_2 = self._pair_arrays(kf, cand, feat1, feat2)
        n = _round_up_pow2(feat1.size, 64) if self.pad_pairs else feat1.size
        out = {k: self._dev(_pad(a, n, fill)) for k, a, fill in (
            ("x1", x1, 0.0), ("x2", x2, 0.0), ("uv1", uv1, 0.0), ("uv2", uv2, 0.0),
            ("s2_1", s2_1, 1.0), ("s2_2", s2_2, 1.0), ("inv1", 1.0 / s2_1, 1.0),
            ("inv2", 1.0 / s2_2, 1.0))}
        out["valid"] = self._dev(_pad(np.ones(feat1.size, bool), n))
        return out

    def _search_by_sim3(self, kf: int, cand: int, s12: float, R12: np.ndarray,
                        t12: np.ndarray, feat1: np.ndarray, feat2: np.ndarray):
        """Both directions of SearchBySim3 with the mutual check
        (src/ORBmatcher.cc:1238-1487). S12 maps the candidate's camera
        points into the current keyframe's: p1 = s12 R12 p2 + t12. ->
        (new_feat1, new_feat2), the pairs not matched yet."""
        m, cam, cfg = self.map, self.config.camera, self.config
        n_feat = m.kf_xy.shape[1]
        matched1 = np.zeros(n_feat, bool)
        matched1[feat1] = True
        matched2 = np.zeros(n_feat, bool)
        matched2[feat2] = True
        b1 = (m.kf_point_idx[kf] >= 0) & m.kf_feat_valid[kf] & ~matched1
        b2 = (m.kf_point_idx[cand] >= 0) & m.kf_feat_valid[cand] & ~matched2
        if not b1.any() or not b2.any():
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        # Full tables: unbound rows read point 0 and are masked invalid.
        pid1 = np.where(b1, m.kf_point_idx[kf], 0)
        pid2 = np.where(b2, m.kf_point_idx[cand], 0)
        # The candidate's points into the current keyframe (S12), and the
        # keyframe's back through S21 = S12^-1: both directions and the
        # mutual check (:1442-1455) in one call.
        pc2 = m.pt_pos[pid2] @ m.kf_pose_R[cand].T + m.kf_pose_t[cand]
        pc1 = m.pt_pos[pid1] @ m.kf_pose_R[kf].T + m.kf_pose_t[kf]

        def points(pc, pid, ok):
            return (self._dev(pc), self._dev(m.pt_desc[pid]), self._dev(m.pt_min_dist[pid]),
                    self._dev(m.pt_max_dist[pid]), self._dev(ok & m.pt_valid[pid]))

        def features(k):
            return (self._dev(m.kf_xy[k]), self._dev(m.kf_desc[k]), self._dev(m.kf_octave[k]),
                    self._dev(m.kf_feat_valid[k]))

        mutual = to_host(matchers.search_by_sim3_jit(
            *points(((pc1 - t12) @ R12) / s12, pid1, b1),
            *points(s12 * (pc2 @ R12.T) + t12, pid2, b2), *features(kf), *features(cand),
            cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width), float(cam.height),
            n_levels=cfg.orb.n_levels, scale=cfg.orb.scale_factor).idx)
        a = np.where(mutual >= 0)[0]
        return a.astype(np.int64), mutual[a].astype(np.int64)

    # ------------------------------------------------------------------

    def correct_loop(self, kf: int, loop_kf: int, s_cw: float, R_cw: np.ndarray,
                     t_cw: np.ndarray, matches: Dict[int, int]) -> None:
        """CorrectLoop (src/LoopClosing.cc:545-880)."""
        m = self.map
        fix_scale = self.config.sensor != "monocular"
        # A global BA still in flight for an earlier loop is stale now:
        # abort it before the map moves (:556-572). It does not wait: the
        # runner checks its generation again under the map lock.
        if self.gba_runner is not None:
            self.gba_runner.request_abort()
        # The essential graph measures old edges on the poses before the
        # correction (NonCorrectedSim3, :604-633).
        poses_R_old = m.kf_pose_R.copy()
        poses_t_old = m.kf_pose_t.copy()

        # 1. The corrected Sim3 of the keyframe's covisible neighbourhood
        #    (:599-701): S_iw = S_ic S_cw with S_ic the current relative pose.
        neighborhood = [kf] + [int(x) for x in m.covisible_keyframes(kf, None, 15)]
        R_c, t_c = m.kf_pose_R[kf], m.kf_pose_t[kf]
        corrected: Dict[int, Tuple[float, np.ndarray, np.ndarray]] = {}
        for i in neighborhood:
            R_ic = m.kf_pose_R[i] @ R_c.T
            t_ic = m.kf_pose_t[i] - R_ic @ t_c
            corrected[i] = (s_cw, R_ic @ R_cw, s_cw * (R_ic @ t_cw) + t_ic)

        # 2. The neighbourhood's points: p' = S_corr^-1(T_old(p)), each
        #    through its first corrected observer (:637-675).
        done_pts = np.zeros(m.cfg.max_points, bool)
        for i in neighborhood:
            s_i, R_i, t_i = corrected[i]
            pids = m.kf_point_idx[i]
            pids = np.unique(pids[pids >= 0])
            if pids.size:
                pids = pids[m.pt_valid[pids] & ~done_pts[pids]]
            if not pids.size:
                continue
            p_cam = m.pt_pos[pids] @ m.kf_pose_R[i].T + m.kf_pose_t[i]
            m.pt_pos[pids] = ((p_cam - t_i) @ R_i) / s_i
            done_pts[pids] = True

        # 3. Back to SE3: R = R_corr, t = t_corr / s (:681-696).
        for i in neighborhood:
            s_i, R_i, t_i = corrected[i]
            m.kf_pose_R[i] = orthonormalize_rotation(R_i)
            m.kf_pose_t[i] = t_i / s_i

        # 4. Bind or replace the loop's point matches (:703-728).
        for feat, pid in matches.items():
            existing = int(m.kf_point_idx[kf, feat])
            if existing >= 0 and m.pt_valid[existing] and existing != pid:
                m.replace_point(existing, int(pid))
            else:
                m.kf_point_idx[kf, feat] = pid
        m.update_covisibility(kf)

        # 5. The essential graph, the loop keyframe fixed (:785), then the
        #    loop edge kept both ways (AddLoopEdge :792-793).
        with self._timed("loop_essential_graph"):
            self._optimize_essential_graph(kf, loop_kf, fix_scale, poses_R_old, poses_t_old,
                                           set(neighborhood))
        m.add_loop_edge(kf, loop_kf)

        # 6. Global BA (RunGlobalBundleAdjustment, :801): on the runner's
        #    thread, which packs the map once the correction lets the lock
        #    go, or inline.
        with self._timed("loop_gba"):
            if self.gba_runner is not None:
                self.gba_runner.launch(m, anchor_kf=loop_kf)
            else:
                self.run_global_ba(anchor_kf=loop_kf)
        m.refresh_point_stats()
        m.big_change_idx += 1

    # ------------------------------------------------------------------

    def _optimize_essential_graph(self, kf: int, loop_kf: int, fix_scale: bool,
                                  poses_R_old: np.ndarray, poses_t_old: np.ndarray,
                                  corrected_set: Set[int]) -> None:
        """OptimizeEssentialGraph (src/Optimizer.cc:888-1218). Edges: the
        spanning tree, covisibility >= essential_min_weight, earlier loop
        edges and the new one. Vertices start at the current (corrected)
        poses; edges measure the poses before the correction, except the
        loop edge and edges inside the corrected neighbourhood (the
        reference's CorrectedSim3 / NonCorrectedSim3 split, :933-1054)."""
        m = self.map
        valid_kfs = np.where(m.kf_valid)[0]
        remap = np.full(m.cfg.max_keyframes, -1, np.int64)
        remap[valid_kfs] = np.arange(valid_kfs.size)

        ei, ej, raw_pairs = [], [], []
        seen = set()

        def add_edge(a, b):
            a, b = int(a), int(b)
            if a == b or (min(a, b), max(a, b)) in seen or remap[a] < 0 or remap[b] < 0:
                return
            seen.add((min(a, b), max(a, b)))
            ei.append(int(remap[a]))
            ej.append(int(remap[b]))
            raw_pairs.append((a, b))

        for k in valid_kfs:
            parent = m.kf_parent[k]
            if parent >= 0 and m.kf_valid[parent]:
                add_edge(k, parent)
            for c in m.covisible_keyframes(int(k), None, min_weight=self.essential_min_weight):
                add_edge(k, c)
        for (a, b) in (m.loop_edges or []):
            add_edge(a, b)
        add_edge(kf, loop_kf)
        if not ei:
            return

        Kv, E = valid_kfs.size, len(ei)
        mR, mt = [], []
        for (a, b) in raw_pairs:
            if (a in corrected_set and b in corrected_set) or {a, b} == {kf, loop_kf}:
                Ra, ta, Rb, tb = m.kf_pose_R[a], m.kf_pose_t[a], m.kf_pose_R[b], m.kf_pose_t[b]
            else:
                Ra, ta = poses_R_old[a], poses_t_old[a]
                Rb, tb = poses_R_old[b], poses_t_old[b]
            Rab = Ra @ Rb.T
            mR.append(Rab)
            mt.append(ta - Rab @ tb)

        # The JAX package's shape buckets (powers of two, >= 8): padded
        # vertices fixed, padded edges invalid.
        Kp = max(8, 1 << (Kv - 1).bit_length())
        Ep = max(8, 1 << (E - 1).bit_length())
        R_p = np.tile(np.eye(3), (Kp, 1, 1))
        R_p[:Kv] = m.kf_pose_R[valid_kfs]
        t_p = np.zeros((Kp, 3))
        t_p[:Kv] = m.kf_pose_t[valid_kfs]
        fixed_p = np.ones(Kp, bool)
        fixed_p[:Kv] = False
        fixed_p[remap[loop_kf]] = True
        ei_p = np.zeros(Ep, np.int64)
        ei_p[:E] = ei
        ej_p = np.zeros(Ep, np.int64)
        ej_p[:E] = ej
        mR_p = np.tile(np.eye(3), (Ep, 1, 1))
        mR_p[:E] = np.stack(mR)
        mt_p = np.zeros((Ep, 3))
        mt_p[:E] = np.stack(mt)
        valid_p = np.zeros(Ep, bool)
        valid_p[:E] = True
        dev = self.device
        graph = pose_graph.Sim3Graph(
            s=self._dev(np.ones(Kp)), R=self._dev(R_p), t=self._dev(t_p),
            fixed=self._dev(fixed_p),
            edge_i=torch.from_numpy(ei_p).to(dev), edge_j=torch.from_numpy(ej_p).to(dev),
            meas_s=self._dev(np.ones(Ep)), meas_R=self._dev(mR_p), meas_t=self._dev(mt_p),
            edge_valid=self._dev(valid_p))
        out = pose_graph.optimize_sim3_graph_jit(graph, n_iters=20, fix_scale=fix_scale)
        s_out = to_host(out.s)[:Kv].astype(np.float64)
        R_out = to_host(out.R)[:Kv].astype(np.float64)
        t_out = to_host(out.t)[:Kv].astype(np.float64)
        # Each point through its first valid observer's Sim3 change
        # (:1174-1199), then the poses back to SE3.
        done_mask = np.zeros(m.cfg.max_points, bool)
        for local, k in enumerate(valid_kfs):
            pids = m.kf_point_idx[k]
            pids = np.unique(pids[pids >= 0])
            if pids.size:
                pids = pids[m.pt_valid[pids] & ~done_mask[pids]]
            if pids.size:
                p_cam = m.pt_pos[pids] @ m.kf_pose_R[k].T + m.kf_pose_t[k]
                m.pt_pos[pids] = ((p_cam - t_out[local]) @ R_out[local]) / s_out[local]
                done_mask[pids] = True
        for local, k in enumerate(valid_kfs):
            m.kf_pose_R[k] = orthonormalize_rotation(R_out[local])
            m.kf_pose_t[k] = t_out[local] / s_out[local]

    # ------------------------------------------------------------------

    def run_global_ba(self, anchor_kf: int = 0, n_iters: int = 10) -> None:
        """Full-map BA, the anchor keyframe fixed (RunGlobalBundleAdjustment,
        src/LoopClosing.cc:884-1020; GlobalBundleAdjustemnt,
        src/Optimizer.cc:41-284). Sharded over the process group's ranks
        when use_distributed_gba(): the observations split between them,
        the Hessian blocks all-reduced (every rank runs the same System on
        the same frames, SPMD)."""
        m = self.map
        cam = self.config.camera
        valid_kfs = np.where(m.kf_valid)[0]
        if valid_kfs.size < 3:
            return
        assembled = build_ba_problem(
            m, free_kfs=np.asarray([int(k) for k in valid_kfs if k != anchor_kf]),
            fixed_kfs=np.asarray([anchor_kf]), point_ids=np.where(m.pt_valid)[0],
            orb_cfg=self.config.orb, device=self.device)
        if use_distributed_gba():
            multihost.initialize(device=self.device)
            group = multihost.global_group()
            prob = assembled.problem._replace(obs=dba.shard_observations(
                assembled.problem.obs, dist.get_world_size(group)))
            out, result = dba.distributed_bundle_adjust(
                prob, group, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, n_iters=n_iters)
        else:
            out, result = ba.bundle_adjust_jit(
                assembled.problem, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                n_iters=n_iters, point_chunk=1024)
        write_back_ba(m, assembled, out, result, erase_outliers=False)
