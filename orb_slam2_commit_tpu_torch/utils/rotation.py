"""Host-side SO(3) hygiene.

Device optimizers iterate in float32: each exp-retraction product and each
host-side pose composition (velocity model, re-anchoring chains, BA
write-back) leaves ~1e-7 of skew in a stored rotation. Left alone, the
per-frame chain of 4-5 such products compounds geometrically (measured
~x4.6 per keyframe round on the synthetic sweep, reaching 1e-2 within ten
frames) — the round-1 "fresh keyframe local BA instability" was exactly
this. Every host boundary that stores a rotation projects it back onto
SO(3) with this helper.
"""

from __future__ import annotations

import numpy as np


def orthonormalize_rotation(R: np.ndarray) -> np.ndarray:
    """Nearest SO(3) matrix (polar decomposition via SVD)."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt))
    return U @ S @ Vt
