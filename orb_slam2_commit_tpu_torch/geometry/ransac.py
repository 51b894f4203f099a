"""RANSAC sample sets, drawn on the host.

The JAX package draws its minimal sets on the device with
`jax.random.choice(key, n, (k,), replace=False, p=valid / sum(valid))`
(geometry/twoview.py:_ransac_samples, geometry/pnp.py:epnp_ransac). The
port cannot reproduce those draws, so its RANSAC functions take the sample
sets as an input, and this sampler draws them from an explicit
`np.random.Generator` with the same distribution: each set is k distinct
indices, drawn one by one without replacement with probability
proportional to the weights (the exponential race: the k smallest of
E_i / w_i, E_i ~ Exp(1), in order). Drawing on the host gives the card and
the CPU the same sets.

The tracker keeps one sampler (`Tracker.sampler`) and the loop closer
another (`LoopCloser.sampler`); a test may replace either with any object
that has the same methods. `first_argmax` picks the winning round as
jnp.argmax does, on every device.
"""

from __future__ import annotations

import numpy as np
import torch


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum over the last axis (jnp.argmax's tie
    rule; torch.argmax does not promise it on the card). A row with no
    maximum (all NaN) gives its last index."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    hit = x == x.amax(dim=-1, keepdim=True)
    return torch.clamp_max(torch.where(hit, idx, n).amin(dim=-1), n - 1)


def weighted_samples(rng: np.random.Generator, weights: np.ndarray, n_iters: int,
                     size: int) -> np.ndarray:
    """weights [..., n] >= 0 -> [..., n_iters, size] int64 indices, each set
    drawn without replacement, proportionally to the weights. Where fewer
    than `size` weights are positive, a set ends in zero-weight indices
    (such a set only degrades its own round)."""
    w = np.asarray(weights, np.float64)
    if size > w.shape[-1]:
        raise ValueError(f"sets of {size} from {w.shape[-1]} indices")
    shape = w.shape[:-1] + (n_iters, w.shape[-1])
    race = rng.standard_exponential(shape)
    with np.errstate(divide="ignore"):
        keys = np.where(w[..., None, :] > 0, race / w[..., None, :], np.inf)
    if size < w.shape[-1]:
        part = np.argpartition(keys, size - 1, axis=-1)[..., :size]
    else:
        part = np.broadcast_to(np.arange(size), keys.shape[:-1] + (size,))
    # The k smallest in increasing order of their keys, ties to the lower
    # index.
    sub = np.take_along_axis(keys, part, axis=-1)
    order = np.lexsort((part, sub), axis=-1)
    return np.take_along_axis(part, order, axis=-1).astype(np.int64)


class RansacSampler:
    """The tracker's source of RANSAC sample sets, from a fixed seed."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def twoview(self, valid: np.ndarray, n_iters: int = 200, size: int = 8) -> np.ndarray:
        """valid [N] -> [n_iters, size] sets for initialize_two_view."""
        return weighted_samples(self.rng, np.asarray(valid, bool), n_iters, size)

    def pnp(self, valid: np.ndarray, n_iters: int = 128, size: int = 4) -> np.ndarray:
        """valid [C, N] -> [C, n_iters, size] sets for epnp_ransac_many."""
        return weighted_samples(self.rng, np.asarray(valid, bool), n_iters, size)

    def sim3(self, valid: np.ndarray, n_iters: int = 128, size: int = 3) -> np.ndarray:
        """valid [n] -> [n_iters, size] sets for sim3_ransac."""
        return weighted_samples(self.rng, np.asarray(valid, bool), n_iters, size)
