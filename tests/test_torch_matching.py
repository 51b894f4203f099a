"""Port's matching primitives and the motion-model projection matcher on
the CPU against the JAX package: exact indices and distances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import matching as jmatching
from orb_slam2_commit_tpu.slam import matchers as jmatchers
from orb_slam2_commit_tpu_torch.ops import matching
from orb_slam2_commit_tpu_torch.slam import jit_frontend, matchers

torch.set_num_threads(1)


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)


def _t_desc(d):
    return torch.from_numpy(d.view(np.int32).copy())


def _same(got, ref):
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))


def test_hamming_distance_matrix():
    rng = np.random.default_rng(0)
    a, b = _desc(rng, 37), _desc(rng, 53)
    b[:5] = a[:5]                         # zero distances
    b[5] = ~a[5]                          # distance 256
    ref = np.asarray(jmatching.hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = matching.hamming_distance_matrix(_t_desc(a), _t_desc(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("ratio,octave_rule", [(1.0, False), (0.9, False), (0.8, True)])
def test_best_match_with_ratio(ratio, octave_rule):
    rng = np.random.default_rng(1)
    dist = rng.integers(0, 120, (40, 60)).astype(np.int32)   # many ties
    mask = rng.random((40, 60)) < 0.3
    octave_b = rng.integers(0, 3, 60).astype(np.int32)
    ref = jmatching.best_match_with_ratio(
        jnp.asarray(dist), jnp.asarray(mask), 100, ratio,
        octave_b=jnp.asarray(octave_b) if octave_rule else None)
    got = matching.best_match_with_ratio(
        torch.from_numpy(dist), torch.from_numpy(mask), 100, ratio,
        octave_b=torch.from_numpy(octave_b) if octave_rule else None)
    _same(got, ref)


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_rotation_consistency_filter_with_tied_bins(seed):
    rng = np.random.default_rng(seed)
    m, n = 60, 80
    # Angle differences drawn from a few bins with equal counts, so the
    # top-3 ranking is decided by ties (lowest bin first).
    angle_b = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    idx = rng.integers(-1, n, m).astype(np.int32)
    bins = np.repeat(rng.choice(30, 5, replace=False), m // 5)
    rot = (bins + 0.5) * (2 * np.pi / 30)
    angle_a = (angle_b[np.maximum(idx, 0)] + rot).astype(np.float32)
    dist = rng.integers(0, 100, m).astype(np.int32)
    ref = jmatching.rotation_consistency_filter(
        jmatching.MatchResult(jnp.asarray(idx), jnp.asarray(dist)),
        jnp.asarray(angle_a), jnp.asarray(angle_b))
    got = matching.rotation_consistency_filter(
        matching.MatchResult(torch.from_numpy(idx), torch.from_numpy(dist)),
        torch.from_numpy(angle_a), torch.from_numpy(angle_b))
    _same(got, ref)


def test_resolve_duplicate_targets():
    rng = np.random.default_rng(5)
    idx = rng.integers(-1, 12, 50).astype(np.int32)      # many claimants
    dist = rng.integers(0, 4, 50).astype(np.int32)       # and equal dists
    ref = jmatching.resolve_duplicate_targets(
        jmatching.MatchResult(jnp.asarray(idx), jnp.asarray(dist)), 12)
    got = matching.resolve_duplicate_targets(
        matching.MatchResult(torch.from_numpy(idx), torch.from_numpy(dist)), 12)
    _same(got, ref)


def _projection_problem(seed, m=120, n=150):
    rng = np.random.default_rng(seed)
    fx = fy = 256.0
    cx, cy, width, height = 160.0, 120.0, 320.0, 240.0
    pts = np.stack([rng.uniform(-3, 3, m), rng.uniform(-2, 2, m),
                    rng.uniform(3, 9, m)], -1).astype(np.float32)
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.02, -0.01, 0.05], np.float32)
    pc = pts @ R.T + t
    uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
    # Current frame: noisy copies of some projections + clutter.
    src = rng.choice(m, n // 2, replace=False)
    xy = np.concatenate([uv[src] + rng.normal(0, 2.0, (n // 2, 2)),
                         rng.uniform(0, [width, height], (n - n // 2, 2))]).astype(np.float32)
    pt_desc = _desc(rng, m)
    desc = _desc(rng, n)
    flips = rng.integers(0, 2 ** 32, (n // 2, 8), dtype=np.uint32) & np.uint32(0x01010101)
    desc[: n // 2] = pt_desc[src] ^ flips
    octave = rng.integers(0, 4, n).astype(np.int32)
    octave[: n // 2] = np.clip(rng.integers(0, 4, n // 2), 0, 7)
    pt_octave = np.zeros(m, np.int32)
    pt_octave[src] = np.clip(octave[: n // 2] + rng.integers(-1, 2, n // 2), 0, 7)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    pt_angle = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    pt_angle[src] = angle[: n // 2] + 0.3
    pt_valid = rng.random(m) < 0.9
    valid = rng.random(n) < 0.95
    arrays = (pts, pt_desc, pt_octave, pt_angle, pt_valid, R, t, xy, desc,
              angle, octave, valid)
    return arrays, (fx, fy, cx, cy, width, height)


@pytest.mark.parametrize("seed", [6, 7])
def test_match_projection_last_frame(seed):
    arrays, cam = _projection_problem(seed)
    ref = jmatchers.match_projection_last_frame.__wrapped__(
        *(jnp.asarray(a) for a in arrays), *cam, th=15.0)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    targs[1] = _t_desc(arrays[1])
    targs[8] = _t_desc(arrays[8])
    got = matchers.match_projection_last_frame(*targs, *cam, th=15.0)
    assert int(got.count()) > 10
    _same(got, ref)


def test_bind_last_write_matches_xla_scatter():
    """Feature 0 receives -1 from every unmatched point; the last write in
    row order wins, as XLA's scatter does on the JAX side."""
    rng = np.random.default_rng(8)
    n_feat = 20
    idx = np.full(30, -1, np.int32)
    idx[rng.choice(30, 12, replace=False)] = rng.choice(n_feat, 12, replace=False)
    idx[3] = 0                                  # a real match to feature 0

    def jax_bind(idx):
        safe = jnp.maximum(idx, 0)
        rows = jnp.where(idx >= 0, jnp.arange(idx.shape[0], dtype=jnp.int32), -1)
        return jnp.full((n_feat,), -1, jnp.int32).at[safe].set(rows)

    for case in (idx, np.where(np.arange(30) > 3, np.maximum(idx, 1), idx)):
        case = case.astype(np.int32)
        ref = np.asarray(jax.jit(jax_bind)(jnp.asarray(case)))
        got = jit_frontend.bind_last_write(torch.from_numpy(case), n_feat)
        np.testing.assert_array_equal(got.numpy(), ref)
