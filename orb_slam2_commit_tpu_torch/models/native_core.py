"""The map core's covisibility and observation counts in numpy (the port's
copy of models/native_core.py's operations; native/map_core.cpp computes
the same three, and binding it to the port is still to come).

Each gives exactly what the C++ core gives over the observation table
kf_point_idx [K, N] (-1 = no observation): an observation counts once per
feature, so a keyframe that binds one point to two features counts it
twice.
"""

from __future__ import annotations

import numpy as np


def _observed(kf_point_idx: np.ndarray, kf_valid: np.ndarray,
              max_points: int) -> np.ndarray:
    """[K, N] bool: a valid keyframe's observation of a point in range."""
    return ((kf_point_idx >= 0) & (kf_point_idx < max_points)
            & np.asarray(kf_valid, bool)[:, None])


def covis_row(kf_point_idx: np.ndarray, kf_valid: np.ndarray,
              max_points: int, k: int) -> np.ndarray:
    """[K] int32: for every other valid keyframe j, how many of its
    observations are of a point that keyframe k observes."""
    K = kf_point_idx.shape[0]
    out = np.zeros(K, np.int32)
    if not kf_valid[k]:
        return out
    obs = _observed(kf_point_idx, kf_valid, max_points)
    mark = np.zeros(max_points, bool)
    mark[kf_point_idx[k][obs[k]]] = True
    hit = obs & mark[np.clip(kf_point_idx, 0, max_points - 1)]
    out[:] = hit.sum(axis=1)
    out[k] = 0
    return out


def obs_counts(kf_point_idx: np.ndarray, kf_valid: np.ndarray,
               max_points: int) -> np.ndarray:
    """[max_points] int32: observations of each point by valid keyframes."""
    obs = _observed(kf_point_idx, kf_valid, max_points)
    return np.bincount(kf_point_idx[obs], minlength=max_points).astype(np.int32)


def covis_matrix(kf_point_idx: np.ndarray, kf_valid: np.ndarray,
                 max_points: int) -> np.ndarray:
    """[K, K] int32: for each point, every pair of its observations (a, b)
    in different rows adds one to out[ka, kb] and out[kb, ka]; the
    diagonal gathers the pairs within one keyframe."""
    K = kf_point_idx.shape[0]
    obs = _observed(kf_point_idx, kf_valid, max_points)
    ks, fs = np.nonzero(obs)
    # Point x keyframe incidence counts C [P, K]; C^T C counts pairs.
    C = np.zeros((max_points, K), np.int64)
    np.add.at(C, (kf_point_idx[ks, fs], ks), 1)
    used = C.any(axis=1)
    C = C[used]
    out = C.T @ C
    # Pairs (a, b) with a < b: off-diagonal counts each pair once per
    # ordering; on the diagonal, n(n-1)/2 pairs each counted twice.
    diag = (C * (C - 1)).sum(axis=0)
    np.fill_diagonal(out, diag)
    return out.astype(np.int32)
