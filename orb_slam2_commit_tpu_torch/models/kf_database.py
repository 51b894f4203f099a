"""Keyframe database: BoW place recognition for loop detection and
relocalization (PyTorch port of models/kf_database.py; reference:
src/KeyFrameDatabase.cc).

Each keyframe's BoW vector is stored sparse, a row of sorted word ids and
L1-normalized TF-IDF weights padded to the widest row, so shared-word
counts and L1 scores against every keyframe are one vectorized sorted
intersection (numpy, on the host, as in the JAX package: the candidate
lists must come out in its order). The descriptors' tree descent runs on
the database's device (models/vocabulary.transform).

  detect_loop_candidates: exclude covisible keyframes, keep > 0.8 x the
  most common words and score >= min_score, accumulate over covisibility
  groups (top 10), return the best of each group above 0.75 x the best
  accumulated score (:86-216).

  detect_relocalization_candidates: the same without the covisibility
  exclusion, the 10 best scores (:219-341).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from orb_slam2_commit_tpu_torch.interop import resolve_device
from orb_slam2_commit_tpu_torch.models.vocabulary import BinaryVocabulary


class KeyFrameDatabase:
    def __init__(self, vocabulary: BinaryVocabulary, max_keyframes: int, device="cuda"):
        self.voc = vocabulary
        self.device = resolve_device(device)
        self.present = np.zeros(max_keyframes, bool)
        # Sparse rows, allocated at the first add, widened as needed.
        self.word_ids: np.ndarray | None = None   # [K, Wcap] int64, -1 pad
        self.weights: np.ndarray | None = None    # [K, Wcap] float32, 0 pad

    def _ensure_cols(self, wcap: int) -> None:
        k = self.present.shape[0]
        if self.word_ids is None:
            self.word_ids = np.full((k, max(wcap, 1)), -1, np.int64)
            self.weights = np.zeros((k, max(wcap, 1)), np.float32)
        elif wcap > self.word_ids.shape[1]:
            extra = wcap - self.word_ids.shape[1]
            self.word_ids = np.concatenate(
                [self.word_ids, np.full((k, extra), -1, np.int64)], axis=1)
            self.weights = np.concatenate(
                [self.weights, np.zeros((k, extra), np.float32)], axis=1)

    def bow(self, desc, valid) -> Tuple[np.ndarray, np.ndarray]:
        """Sparse BoW of a descriptor table, descended on the device."""
        words, _ = self.voc.transform(desc, valid, device=self.device)
        return self.voc.sparse_bow(words)

    def add(self, kf_id: int, desc, valid: np.ndarray) -> None:
        uw, wt = self.bow(desc, valid)
        self._ensure_cols(uw.size)
        self.word_ids[kf_id] = -1
        self.weights[kf_id] = 0.0
        self.word_ids[kf_id, : uw.size] = uw
        self.weights[kf_id, : uw.size] = wt
        self.present[kf_id] = True

    def grow(self, kind: str, new_capacity: int) -> None:
        """MapState grow hook: follow the map's keyframe capacity."""
        if kind != "keyframes" or new_capacity <= self.present.shape[0]:
            return
        extra = new_capacity - self.present.shape[0]
        if self.word_ids is not None:
            wcap = self.word_ids.shape[1]
            self.word_ids = np.concatenate(
                [self.word_ids, np.full((extra, wcap), -1, np.int64)])
            self.weights = np.concatenate([self.weights, np.zeros((extra, wcap), np.float32)])
        self.present = np.concatenate([self.present, np.zeros(extra, bool)])

    def erase(self, kf_id: int) -> None:
        self.present[kf_id] = False
        if self.word_ids is not None:
            self.word_ids[kf_id] = -1
            self.weights[kf_id] = 0.0

    def clear(self) -> None:
        self.present[:] = False
        if self.word_ids is not None:
            self.word_ids[:] = -1
            self.weights[:] = 0.0

    def kf_bow(self, kf_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """A stored keyframe's sparse BoW, unpadded (sorted, as the
        searchsorted scoring needs)."""
        m = self.word_ids[kf_id] >= 0
        return self.word_ids[kf_id][m], self.weights[kf_id][m]

    def score_between(self, kf_a: int, kf_b: int) -> float:
        return self.voc.sparse_score(self.word_ids[kf_a], self.weights[kf_a],
                                     self.word_ids[kf_b], self.weights[kf_b])

    def _common_words_and_scores(self, q_uw: np.ndarray, q_wt: np.ndarray):
        """Shared-word count and L1 score of the query against every row."""
        k = self.present.shape[0]
        if self.word_ids is None or q_uw.size == 0:
            return np.zeros(k, np.float32), np.zeros(k, np.float32)
        W = self.word_ids
        idx = np.clip(np.searchsorted(q_uw, W), 0, q_uw.size - 1)
        match = (q_uw[idx] == W) & (W >= 0)
        common = match.sum(axis=1).astype(np.float32)
        wq = np.where(match, q_wt[idx], 0.0)
        wk = np.where(match, self.weights, 0.0)
        row_sum = self.weights.sum(axis=1)
        l1 = (q_wt.sum() - wq.sum(axis=1)) + (row_sum - wk.sum(axis=1)) \
            + np.abs(wq - wk).sum(axis=1)
        scores = np.where(row_sum > 0, 1.0 - 0.5 * l1, 0.0)
        return common, scores.astype(np.float32)

    def detect_loop_candidates(self, map_state, kf_id: int, min_score: float) -> List[int]:
        """DetectLoopCandidates (src/KeyFrameDatabase.cc:76-216)."""
        common, scores = self._common_words_and_scores(*self.kf_bow(kf_id))
        connected = set(int(x) for x in map_state.covisible_keyframes(kf_id, None, 1))
        eligible = self.present.copy()
        eligible[kf_id] = False
        for c in connected:
            eligible[c] = False
        if not eligible.any():
            return []
        max_common = common[eligible].max()
        if max_common == 0:
            return []
        cand = np.where(eligible & (common > 0.8 * max_common) & (scores >= min_score))[0]
        if cand.size == 0:
            return []

        # Accumulated scores over covisibility groups (:159-192).
        cand_set = set(int(c) for c in cand)
        best_acc = 0.0
        groups = []
        for c in cand:
            group = [int(c)] + [int(x) for x in map_state.covisible_keyframes(int(c), 10, 1)]
            acc = 0.0
            best_kf, best_s = int(c), scores[c]
            for g in group:
                if g in cand_set:
                    acc += scores[g]
                    if scores[g] > best_s:
                        best_kf, best_s = g, scores[g]
            groups.append((acc, best_kf))
            best_acc = max(best_acc, acc)

        th = 0.75 * best_acc
        out, seen = [], set()
        for acc, best_kf in groups:
            if acc > th and best_kf not in seen:
                seen.add(best_kf)
                out.append(best_kf)
        return out

    def detect_relocalization_candidates(self, frame) -> List[int]:
        """DetectRelocalizationCandidates (src/KeyFrameDatabase.cc:219-341)
        for a Frame, its descriptors descended on the device."""
        common, scores = self._common_words_and_scores(*self.bow(frame.desc, frame.valid))
        eligible = self.present
        if not eligible.any():
            return []
        max_common = common[eligible].max()
        if max_common == 0:
            return []
        cand = np.where(eligible & (common > 0.8 * max_common))[0]
        if cand.size == 0:
            return []
        order = np.argsort(-scores[cand])
        return [int(c) for c in cand[order][:10]]
