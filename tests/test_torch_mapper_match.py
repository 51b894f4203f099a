"""The port's mapper-side matchers and its batched mapper functions on the
CPU against the JAX package's, on the same seeded two-view problems.

A problem: 3D points seen by two keyframes (noisy pixel projections, a
descriptor per point with a few bits flipped in the second view,
orientations turned by a common in-plane angle, octaves 0-3) plus
distractor features in each image. Held:
- ops/matching.epipolar_mask in both orientations of F (F12 maps image-1
  points to lines in image 2, and its transpose the other way): equal
  masks; and the true correspondences lie in the band of the right
  orientation, not of the transposed one on a rotation-heavy pair;
- match_brute_force, match_for_triangulation and match_fuse: equal
  indices and distances, every row;
- fused_triangulation_jit with B = 1, B = 3 and a pair with nothing free
  (and a padded pair), and fused_fuse_forward_jit with B = 1 and B = 3
  (and a padded target): equal gate masks and match indices, points
  within 1e-4 relative (plus 1e-5 m, for coordinates near 0) where the
  gate holds (float32 eigensolves on both sides). The JAX functions run
  in 32-bit mode, the port's precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import lie as jlie
from orb_slam2_commit_tpu.ops import matching as jmatching
from orb_slam2_commit_tpu.slam import jit_mapper as jjm
from orb_slam2_commit_tpu.slam import matchers as jmatchers
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.ops import matching
from orb_slam2_commit_tpu_torch.slam import jit_mapper, matchers
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

W, H, N_FEAT = 400, 300, 256
PTS_RTOL, PTS_ATOL = 1e-4, 1e-5   # relative, and m for coordinates near 0


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before


def _cams():
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    return cfg, j_synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")


def _pose(w, c):
    """Tcw from a rotation vector and a camera centre."""
    R = np.asarray(jlie.so3_exp(jnp.asarray(np.asarray(w, np.float64))))
    return R, -R @ np.asarray(c, np.float64)


def _keyframe(rng, cam, R, t, X, desc, angle0, n_feat=N_FEAT, flip_bits=4,
              rot=0.0):
    """A keyframe's feature table: the points' noisy projections (those in
    the image), then distractors; returns (xy, desc, angle, octave, valid,
    feature index per point or -1)."""
    pc = X @ R.T + t
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                   cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], 1)
    uv += rng.normal(0, 0.3, uv.shape)
    inside = (pc[:, 2] > 0) & (uv[:, 0] > 5) & (uv[:, 0] < W - 5) \
        & (uv[:, 1] > 5) & (uv[:, 1] < H - 5)
    rows = np.where(inside)[0][:n_feat - 40]
    n = rows.size
    xy = rng.uniform(0, [W, H], (n_feat, 2))
    d = rng.integers(0, 2 ** 32, (n_feat, 8), dtype=np.uint32)
    ang = rng.uniform(0, 2 * np.pi, n_feat)
    octave = rng.integers(0, 4, n_feat).astype(np.int32)
    xy[:n] = uv[rows]
    d[:n] = desc[rows]
    for _ in range(flip_bits):
        d[:n, rng.integers(0, 8)] ^= np.uint32(1) << rng.integers(0, 32, n).astype(np.uint32)
    ang[:n] = np.mod(angle0[rows] + rot, 2 * np.pi)
    valid = np.ones(n_feat, bool)
    valid[-5:] = False
    feat_of_pt = np.full(X.shape[0], -1)
    feat_of_pt[rows] = np.arange(n)
    return xy, d, ang.astype(np.float32), octave, valid, feat_of_pt


def _two_views(seed, yaw=0.25):
    rng = np.random.default_rng(seed)
    cfg, _ = _cams()
    cam = cfg.camera
    X = np.stack([rng.uniform(-3, 3, 300), rng.uniform(-2, 2, 300),
                  rng.uniform(4, 9, 300)], 1)
    desc = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
    angle0 = rng.uniform(0, 2 * np.pi, 300)
    R1, t1 = _pose([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    R2, t2 = _pose([0.02, yaw, 0.01], [0.6, 0.05, 0.2])
    kf1 = _keyframe(rng, cam, R1, t1, X, desc, angle0)
    kf2 = _keyframe(rng, cam, R2, t2, X, desc, angle0, rot=0.1)
    return cfg, X, (R1, t1), (R2, t2), kf1, kf2


def _fundamental(cam, pose1, pose2):
    """LocalMapper._fundamental_from_poses: l2 = F @ x1."""
    K = np.asarray(cam.k_matrix)
    (R1, t1), (R2, t2) = pose1, pose2
    R21 = R2 @ R1.T
    t21 = -R21 @ t1 + t2
    tx = np.array([[0, -t21[2], t21[1]], [t21[2], 0, -t21[0]], [-t21[1], t21[0], 0]])
    Kinv = np.linalg.inv(K)
    return Kinv.T @ tx @ R21 @ Kinv


def _epipole(cam, pose1, pose2):
    (R1, t1), (R2, t2) = pose1, pose2
    c1_in_2 = R2 @ (-R1.T @ t1) + t2
    return np.array([cam.fx * c1_in_2[0] / c1_in_2[2] + cam.cx,
                     cam.fy * c1_in_2[1] / c1_in_2[2] + cam.cy])


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    a = np.asarray(a)
    return jnp.asarray(a.astype(np.float32) if a.dtype == np.float64 else a)


def _assert_match_equal(got, want):
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))


@pytest.mark.parametrize("orientation", ["F12", "F21"])
def test_epipolar_mask_both_orientations(orientation):
    cfg, _, p1, p2, kf1, kf2 = _two_views(1)
    F = _fundamental(cfg.camera, p1, p2)
    xa, xb = (kf1[0], kf2[0]) if orientation == "F12" else (kf2[0], kf1[0])
    Fo = F if orientation == "F12" else F.T
    sig2 = np.asarray(cfg.orb.level_sigma2(), np.float32)[kf2[3] if orientation == "F12"
                                                          else kf1[3]]
    with jax.enable_x64(False):
        want = np.asarray(jmatching.epipolar_mask(_j(xa), _j(xb), _j(Fo), _j(sig2)))
    got = matching.epipolar_mask(_t(xa), _t(xb), _t(Fo), _t(sig2)).numpy()
    np.testing.assert_array_equal(got, want)
    # The true pairs pass under the right orientation; under the wrong one
    # (a transposed F, rotation-heavy pair) most of them fail.
    pa, pb = (kf1[5], kf2[5]) if orientation == "F12" else (kf2[5], kf1[5])
    both = (pa >= 0) & (pb >= 0)
    assert got[pa[both], pb[both]].mean() > 0.9
    wrong = matching.epipolar_mask(_t(xa), _t(xb), _t(Fo.T), _t(sig2)).numpy()
    assert wrong[pa[both], pb[both]].mean() < 0.5


def test_match_brute_force_matches_jax():
    _, _, _, _, kf1, kf2 = _two_views(2)
    args = (kf1[1], kf1[2], kf1[4], kf2[1], kf2[2], kf2[4])
    with jax.enable_x64(False):
        want = jmatchers.match_brute_force(*(_j(a) for a in args))
    got = matchers.match_brute_force(*(_t(a) for a in args))
    _assert_match_equal(got, want)
    assert int((got.idx >= 0).sum()) > 100


@pytest.mark.parametrize("seed, free_share", [(3, 1.0), (4, 0.6)])
def test_match_for_triangulation_matches_jax(seed, free_share):
    cfg, _, p1, p2, kf1, kf2 = _two_views(seed)
    rng = np.random.default_rng(seed)
    free1 = kf1[4] & (rng.random(N_FEAT) < free_share)
    free2 = kf2[4] & (rng.random(N_FEAT) < free_share)
    F = _fundamental(cfg.camera, p1, p2)
    ep = _epipole(cfg.camera, p1, p2)
    args = (kf1[0], kf1[1], kf1[2], free1, kf2[0], kf2[1], kf2[2], free2, F, kf2[3], ep,
            np.float32(100.0))
    with jax.enable_x64(False):
        want = jmatchers.match_for_triangulation(*(_j(a) for a in args))
    got = matchers.match_for_triangulation(*(_t(a) for a in args))
    _assert_match_equal(got, want)
    assert int((got.idx >= 0).sum()) > 50


def _map_points(cfg, X, pose, kf):
    """The map points a keyframe's features observe: pos, normal, dmin,
    dmax as refresh_point_stats makes them, and their descriptors."""
    R, t = pose
    rows = np.where(kf[5] >= 0)[0]
    c = -R.T @ t
    po = X[rows] - c
    dist = np.linalg.norm(po, axis=1)
    dmax = dist * cfg.orb.scale_factor ** kf[3][kf[5][rows]]
    dmin = dmax / cfg.orb.scale_factor ** (cfg.orb.n_levels - 1)
    return X[rows], po / dist[:, None], dmin, dmax, kf[1][kf[5][rows]]


def test_match_fuse_matches_jax():
    cfg, X, p1, p2, kf1, kf2 = _two_views(5)
    cam = cfg.camera
    pos, normal, dmin, dmax, desc = _map_points(cfg, X, p1, kf1)
    valid = np.ones(pos.shape[0], bool)
    fr = (pos, normal, dmin, dmax, valid, p2[0], p2[1])
    kw = dict(n_levels=cfg.orb.n_levels, scale=cfg.orb.scale_factor)
    cam_args = (cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width), float(cam.height))
    tgt = (kf2[0], kf2[1], kf2[3], kf2[4])
    with jax.enable_x64(False):
        info = jmatchers.frustum_check(*(_j(a) for a in fr), *cam_args, **kw)
        want = jmatchers.match_fuse(info, _j(desc), *(_j(a) for a in tgt), **kw)
    info = matchers.frustum_check(*(_t(a) for a in fr), *cam_args, **kw)
    got = matchers.match_fuse(info, _t(desc), *(_t(a) for a in tgt), **kw)
    _assert_match_equal(got, want)
    assert int((got.idx >= 0).sum()) > 50


def _tri_inputs(seeds, empty=(), pad_to=None):
    """fused_triangulation_jit's packed inputs for keyframe 1 of the first
    seed's problem against keyframe 2 of each seed's problem (the same
    first keyframe; neighbours from their own scenes where the seed
    differs), with `empty` pairs having nothing free, padded to pad_to
    pairs."""
    cfg, _, p1, _, kf1, _ = _two_views(seeds[0])
    cam = cfg.camera
    K = np.asarray(cam.k_matrix)
    R1, t1 = p1
    c1 = -R1.T @ t1
    B = pad_to or len(seeds)
    kf_f32 = jit_mapper._pack_feats(kf1[0], kf1[2], kf1[3], kf1[4])
    nb_f32 = np.zeros((B, N_FEAT, jit_mapper.TRI_FEAT_COLS), np.float32)
    nb_desc = np.zeros((B, N_FEAT, 8), np.uint32)
    pair = np.zeros((B, jit_mapper.TRI_PAIR_COLS), np.float32)
    for b, seed in enumerate(seeds):
        _, _, _, p2, _, kf2 = _two_views(seed)
        if seed != seeds[0]:
            # A neighbour of the same keyframe: its scene is seed 0's.
            _, _, _, p2, _, kf2 = _two_views(seeds[0], yaw=0.1 * b)
        R2, t2 = p2
        free2 = kf2[4] & (b not in empty)
        nb_f32[b] = jit_mapper._pack_feats(kf2[0], kf2[2], kf2[3], free2)
        nb_desc[b] = kf2[1]
        pair[b, 0:9] = _fundamental(cam, p1, p2).reshape(-1)
        pair[b, 9:11] = _epipole(cam, p1, p2)
        pair[b, 11:23] = (K @ np.concatenate([R2, t2[:, None]], 1)).reshape(-1)
        pair[b, 23:26] = R2[2]
        pair[b, 26] = t2[2]
        pair[b, 27:30] = -R2.T @ t2
        pair[b, 30] = 1.0
    meta = np.zeros(jit_mapper.TRI_META_LEN, np.float32)
    meta[0:12] = (K @ np.concatenate([R1, t1[:, None]], 1)).reshape(-1)
    meta[12:15] = c1
    meta[15] = np.cos(np.radians(cfg.tracker.tri_min_parallax_deg))
    meta[16] = 1.5 * cfg.orb.scale_factor
    return (kf_f32, kf1[1], nb_f32, nb_desc, pair, meta)


@pytest.mark.parametrize("case", ["B1", "B3", "B3_empty_pair_padded"])
def test_fused_triangulation_matches_jax(case):
    seeds, empty, pad = {"B1": ([6], (), None), "B3": ([6, 7, 8], (), None),
                         "B3_empty_pair_padded": ([6, 7, 8], (1,), 4)}[case]
    args = _tri_inputs(seeds, empty, pad)
    _, jcfg = _cams()
    cfg, _ = _cams()
    with jax.enable_x64(False):
        want_pts, want_flags = (np.asarray(a) for a in jjm.fused_triangulation_jit(
            *(jnp.asarray(a) for a in args), jcfg))
    got_pts, got_flags = (a.numpy() for a in jit_mapper.fused_triangulation_jit(
        *(_t(a) for a in args), cfg))
    np.testing.assert_array_equal(got_flags, want_flags)
    good = want_flags[..., 0] > 0.5
    assert good.sum() > 30
    if empty:
        assert not good[list(empty)].any() and not (want_flags[list(empty), :, 1] >= 0).any()
    if pad:
        assert not good[len(seeds):].any()
    np.testing.assert_allclose(got_pts[good], want_pts[good], rtol=PTS_RTOL,
                               atol=PTS_ATOL)


def _fuse_inputs(n_targets, pad_to=None):
    cfg, X, p1, _, kf1, _ = _two_views(9)
    pos, normal, dmin, dmax, desc = _map_points(cfg, X, p1, kf1)
    P = 256
    n = pos.shape[0]
    pt_f32 = np.zeros((P, jit_mapper.FUSE_PT_COLS), np.float32)
    pt_f32[:n, 0:3], pt_f32[:n, 3:6] = pos, normal
    pt_f32[:n, 6], pt_f32[:n, 7], pt_f32[:n, 8] = dmin, dmax, 1.0
    pt_desc = np.zeros((P, 8), np.uint32)
    pt_desc[:n] = desc
    B = pad_to or n_targets
    tgt_feat = np.zeros((B, N_FEAT, jit_mapper.FUSE_FEAT_COLS), np.float32)
    tgt_desc = np.zeros((B, N_FEAT, 8), np.uint32)
    tgt_meta = np.zeros((B, jit_mapper.FUSE_TGT_COLS), np.float32)
    for b in range(n_targets):
        _, _, _, p2, _, kf2 = _two_views(9, yaw=0.05 + 0.1 * b)
        tgt_feat[b, :, 0:2], tgt_feat[b, :, 2], tgt_feat[b, :, 3] = kf2[0], kf2[3], kf2[4]
        tgt_desc[b] = kf2[1]
        tgt_meta[b, 0:9], tgt_meta[b, 9:12], tgt_meta[b, 12] = p2[0].reshape(-1), p2[1], 1.0
    return (pt_f32, pt_desc, tgt_feat, tgt_desc, tgt_meta), n


@pytest.mark.parametrize("n_targets, pad_to", [(1, None), (3, None), (3, 4)])
def test_fused_fuse_forward_matches_jax(n_targets, pad_to):
    args, n = _fuse_inputs(n_targets, pad_to)
    cfg, jcfg = _cams()
    with jax.enable_x64(False):
        want = np.asarray(jjm.fused_fuse_forward_jit(*(jnp.asarray(a) for a in args), jcfg))
    got = jit_mapper.fused_fuse_forward_jit(*(_t(a) for a in args), cfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[:n_targets, :n] >= 0).sum(axis=1).min() > 30
    assert (want[:, n:] < 0).all()
    if pad_to:
        assert (want[n_targets:] < 0).all()


def test_triangulation_functions_match_jax():
    """geometry/triangulation.py against the JAX package's, in float32:
    projection matrices, DLT points of the true correspondences (within the
    points' tolerance; their median error against the scene under 10 cm at
    0.3 px noise, a 0.6 m baseline and 4-9 m depth),
    reprojection errors, depths and parallax cosines."""
    from orb_slam2_commit_tpu.geometry import triangulation as jtri
    from orb_slam2_commit_tpu_torch.geometry import triangulation as tri

    cfg, X, p1, p2, kf1, kf2 = _two_views(10)
    K = np.asarray(cfg.camera.k_matrix)
    both = (kf1[5] >= 0) & (kf2[5] >= 0)
    uv1, uv2 = kf1[0][kf1[5][both]], kf2[0][kf2[5][both]]
    with jax.enable_x64(False):
        P = [np.asarray(jtri.projection_matrix(_j(K), _j(R), _j(t))) for R, t in (p1, p2)]
        pts = np.asarray(jtri.triangulate_dlt(_j(uv1), _j(uv2), _j(P[0]), _j(P[1])))
        e2 = np.asarray(jtri.reprojection_error_sq(_j(pts), _j(uv2), _j(P[1])))
        z2 = np.asarray(jtri.depths(_j(pts), _j(p2[0]), _j(p2[1])))
        c1, c2 = (-R.T @ t for R, t in (p1, p2))
        cos = np.asarray(jtri.cos_parallax(_j(pts), _j(c1), _j(c2)))
    gP = [tri.projection_matrix(_t(K), _t(R), _t(t)) for R, t in (p1, p2)]
    for g, w in zip(gP, P):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    gpts = tri.triangulate_dlt(_t(uv1), _t(uv2), _t(P[0]), _t(P[1]))
    np.testing.assert_allclose(gpts.numpy(), pts, rtol=PTS_RTOL, atol=PTS_ATOL)
    assert np.median(np.linalg.norm(gpts.numpy() - X[both], axis=1)) < 0.1
    # Squared errors of ~0.1 px from differences of ~300 px coordinates:
    # float32 rounding of the projection (3e-5 px) moves them by ~1e-4 px^2.
    np.testing.assert_allclose(tri.reprojection_error_sq(_t(pts), _t(uv2), _t(P[1])).numpy(),
                               e2, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tri.depths(_t(pts), _t(p2[0]), _t(p2[1])).numpy(), z2,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tri.cos_parallax(_t(pts), _t(c1), _t(c2)).numpy(), cos,
                               rtol=1e-6, atol=1e-6)
