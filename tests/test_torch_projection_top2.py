"""Port's projection matching on the CPU against the JAX package: K6's
plain version equal to the Pallas kernel in interpret mode (VPU and MXU
bodies) in all four outputs, index fallbacks included, with one window
and with two (each window against its own Pallas call); match_from_top2,
frustum_check and match_local_map equal to the JAX functions. The K6
cases are interop's, on which chip_smoke.py holds the kernel to the same
plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import matching as jmatching
from orb_slam2_commit_tpu.ops import pallas_matching as jpm
from orb_slam2_commit_tpu.slam import matchers as jmatchers
from orb_slam2_commit_tpu_torch.interop import TOP2_CASES as CASES, top2_problem
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.kernels import matching as kmatching
from orb_slam2_commit_tpu_torch.ops import matching
from orb_slam2_commit_tpu_torch.slam import matchers

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before



def _desc(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _windows(args, *radii):
    """K6's arguments in the port's order: the radii as one tuple."""
    return (*args[:2], radii, *args[3:])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mxu", [False, True])
def test_plain_top2_equals_pallas(case, mxu):
    args = top2_problem(**CASES[case])
    ref = jpm.projection_hamming_top2(*(jnp.asarray(a) for a in args),
                                      interpret=True, mxu=mxu)
    args = [_t(a) for a in args]
    got, = kmatching.projection_hamming_top2(*_windows(args, args[2]))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if case == "masked":
        assert (got[0].numpy() == matching.BIG_DIST).sum() >= 8


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mxu", [False, True])
def test_two_window_top2_equals_pallas(case, mxu):
    """Radii (r, 2 r) (the motion stage's retry window): each window's
    four outputs equal to the Pallas kernel's call at that radius."""
    args = top2_problem(**CASES[case])
    radius2 = (2 * args[2]).astype(np.float32)
    targs = [_t(a) for a in args]
    got = kmatching.projection_hamming_top2(*_windows(targs, targs[2], _t(radius2)))
    assert len(got) == 2
    for r, top in zip((args[2], radius2), got):
        ref = jpm.projection_hamming_top2(
            *(jnp.asarray(a) for a in (*args[:2], r, *args[3:])), interpret=True, mxu=mxu)
        for g, w in zip(top, ref):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case in ("64x200", "257x513"):   # the wide window finds more
        assert (got[1][0] <= 256).sum() > (got[0][0] <= 256).sum()


def test_radius2_checks():
    """The second window's radii are checked as the first's are, and any
    two radii give each window's own answer (the scan filters by the wider
    one), a second window narrower than the first included."""
    args = [_t(a) for a in top2_problem(**CASES["64x200"])]
    m, r = args[0].shape[0], args[2]
    with pytest.raises(ValueError):      # one or two windows
        kmatching.projection_hamming_top2(*_windows(args, r, r, r))
    with pytest.raises(ValueError):
        kmatching.projection_hamming_top2(*_windows(args))
    with pytest.raises(ValueError):      # one value per row
        kmatching.projection_hamming_top2(*_windows(args, r, torch.ones(m + 1)))
    with pytest.raises(TypeError):
        kmatching.projection_hamming_top2(*_windows(args, r, r.double()))
    with pytest.raises(ValueError):      # on the rows' device
        kmatching.projection_hamming_top2(*_windows(args, r, torch.ones(m, device="meta")))
    narrow = 0.5 * r
    both = kmatching.projection_hamming_top2(*_windows(args, r, narrow))
    for got, radius in zip(both, (r, narrow)):
        want, = kmatching.projection_hamming_top2(*_windows(args, radius))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (both[1][0] <= 256).sum() < (both[0][0] <= 256).sum()


def test_match_from_top2_equals_jax():
    args = top2_problem(9, 120, 300)
    top2 = [np.array(x) for x in jpm.projection_hamming_top2(
        *(jnp.asarray(a) for a in args), interpret=True, mxu=False)]
    octave = args[8]
    for ratio, rule in [(1.0, False), (0.9, False), (0.8, True)]:
        for max_dist in (50, 100):
            ref = jmatching.match_from_top2(
                *(jnp.asarray(x) for x in top2), max_dist, ratio,
                octave_b=jnp.asarray(octave) if rule else None)
            got = matching.match_from_top2(
                *(torch.from_numpy(x) for x in top2), max_dist, ratio,
                octave_b=torch.from_numpy(octave) if rule else None)
            np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
            np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))


CAM = (256.0, 256.0, 160.0, 120.0, 320.0, 240.0)


def _local_map_problem(seed, m=300, n=400):
    """Map points seen from a camera near the origin, with normals and a
    distance band from a first view, and a frame of noisy projections plus
    clutter whose descriptors are near copies of the points'."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, w, h = CAM
    X = np.stack([rng.uniform(-4, 4, m), rng.uniform(-3, 3, m),
                  rng.uniform(2, 14, m)], -1).astype(np.float32)
    c0 = np.array([0.1, -0.05, -0.2])
    po = X - c0
    dist = np.linalg.norm(po, axis=1)
    normal = (po / dist[:, None]).astype(np.float32)
    normal[::7] = -normal[::7]                       # facing away: fail the angle gate
    oct_src = rng.integers(0, 8, m)
    max_dist = (dist * 1.2 ** oct_src).astype(np.float32)
    min_dist = (max_dist / 1.2 ** 7).astype(np.float32)
    pt_valid = rng.random(m) < 0.95
    w3 = np.array([0.01, -0.02, 0.015])
    th = np.linalg.norm(w3)
    K = np.array([[0, -w3[2], w3[1]], [w3[2], 0, -w3[0]], [-w3[1], w3[0], 0]]) / th
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)
    t = np.array([0.05, -0.02, 0.1], np.float32)
    pc = X @ R.T + t
    uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
    src = rng.choice(m, n // 2, replace=False)
    xy = np.concatenate([uv[src] + rng.normal(0, 1.5, (n // 2, 2)),
                         rng.uniform(0, [w, h], (n - n // 2, 2))]).astype(np.float32)
    pt_desc = _desc(rng, m)
    desc = _desc(rng, n)
    flips = rng.integers(0, 2 ** 32, (n // 2, 8), dtype=np.uint32) & np.uint32(0x00010001)
    desc[: n // 2] = pt_desc[src] ^ flips
    octave = rng.integers(0, 8, n).astype(np.int32)
    valid = rng.random(n) < 0.95
    taken = rng.random(n) < 0.2
    return (X, normal, min_dist, max_dist, pt_valid, R, t, pt_desc,
            xy, desc, octave, valid, taken)


@pytest.mark.parametrize("seed", [1, 2])
def test_frustum_check_and_match_local_map_equal_jax(seed):
    (X, normal, dmin, dmax, pt_valid, R, t, pt_desc,
     xy, desc, octave, valid, taken) = _local_map_problem(seed)
    fx, fy, cx, cy, w, h = CAM
    th = np.float32(3.0)
    with jax.enable_x64(False):
        jinfo = jmatchers.frustum_check.__wrapped__(
            *(jnp.asarray(a) for a in (X, normal, dmin, dmax, pt_valid, R, t)),
            fx, fy, cx, cy, w, h)
        jm = jmatchers.match_local_map.__wrapped__(
            jinfo, jnp.asarray(pt_desc), jnp.asarray(xy), jnp.asarray(desc),
            jnp.asarray(octave), jnp.asarray(valid), jnp.asarray(taken),
            th=jnp.asarray(th))
        jinfo = [np.asarray(x) for x in jinfo]
        jm = [np.asarray(x) for x in jm]
    info = matchers.frustum_check(
        *(_t(a) for a in (X, normal, dmin, dmax, pt_valid, R, t)), fx, fy, cx, cy, w, h)
    m = matchers.match_local_map(
        info, _t(pt_desc), _t(xy), _t(desc), _t(octave), _t(valid), _t(taken),
        th=torch.tensor(th))
    np.testing.assert_array_equal(info.visible.numpy(), jinfo[0])
    np.testing.assert_array_equal(info.proj.numpy(), jinfo[1])
    np.testing.assert_array_equal(info.pred_octave.numpy(), jinfo[2])
    np.testing.assert_array_equal(info.view_cos.numpy(), jinfo[3])
    assert 50 < int(info.visible.sum()) < X.shape[0]
    np.testing.assert_array_equal(m.idx.numpy(), jm[0])
    np.testing.assert_array_equal(m.dist.numpy(), jm[1])
    assert int((m.idx >= 0).sum()) > 20


@pytest.mark.parametrize("tz_rel", [0.5, -0.5, 0.0])
def test_stereo_octave_rule_equals_jax(tz_rel):
    """match_projection_last_frame's forward/backward octave rule."""
    (X, _, _, _, pt_valid, R, t, pt_desc,
     xy, desc, octave, valid, _) = _local_map_problem(3)
    rng = np.random.default_rng(3)
    pt_oct = rng.integers(0, 8, X.shape[0]).astype(np.int32)
    pt_angle = rng.uniform(-np.pi, np.pi, X.shape[0]).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, xy.shape[0]).astype(np.float32)
    arrays = (X, pt_desc, pt_oct, pt_angle, pt_valid, R, t, xy, desc, angle,
              octave, valid)
    kw = dict(th=15.0, mono=False, baseline=0.3)
    with jax.enable_x64(False):
        ref = jmatchers.match_projection_last_frame.__wrapped__(
            *(jnp.asarray(a) for a in arrays), *CAM, tz_rel=jnp.float32(tz_rel), **kw)
        ref = [np.asarray(x) for x in ref]
    got = matchers.match_projection_last_frame(
        *(_t(a) for a in arrays), *CAM, tz_rel=torch.tensor(tz_rel), **kw)
    np.testing.assert_array_equal(got.idx.numpy(), ref[0])
    np.testing.assert_array_equal(got.dist.numpy(), ref[1])
    assert int((got.idx >= 0).sum()) > 10


@pytest.mark.parametrize("mono", [True, False])
def test_last_frame_two_windows_equal_two_searches(monkeypatch, mono):
    """th = (th, 2 th): one K6 call gives each search's MatchResult, equal
    to a search of its own at that th."""
    (X, _, _, _, pt_valid, R, t, pt_desc, xy, desc, octave, valid, _) = _local_map_problem(4)
    rng = np.random.default_rng(4)
    pt_oct = rng.integers(0, 8, X.shape[0]).astype(np.int32)
    pt_angle = rng.uniform(-np.pi, np.pi, X.shape[0]).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, xy.shape[0]).astype(np.float32)
    arrays = [_t(a) for a in (X, pt_desc, pt_oct, pt_angle, pt_valid, R, t, xy, desc,
                              angle, octave, valid)]
    kw = dict(mono=mono, baseline=0.3, tz_rel=torch.tensor(0.5))
    calls = []
    top2 = kmatching.projection_hamming_top2
    monkeypatch.setattr(kmatching, "projection_hamming_top2",
                        lambda *a, **k: calls.append((a, top2(*a, **k))) or calls[-1][1])
    both = matchers.match_projection_last_frame(*arrays, *CAM, th=(5.0, 10.0), **kw)
    assert len(calls) == 1 and len(calls[0][0][2]) == 2
    for th, got in zip((5.0, 10.0), both):
        want = matchers.match_projection_last_frame(*arrays, *CAM, th=th, **kw)
        assert torch.equal(got.idx, want.idx) and torch.equal(got.dist, want.dist)
    narrow, wide = calls[0][1]
    assert int(both[0].count()) > 0 and not torch.equal(narrow[2], wide[2])


def _batch(seeds, m, n, invalid=()):
    """B one-window K6 problems of one shape: the first problem's row
    descriptors shared by all, the rest per problem, stacked; the problems
    in `invalid` have every row invalid."""
    probs = [top2_problem(seed, m, n) for seed in seeds]
    stacked = [np.stack(parts) for parts in zip(*probs)]
    stacked[5][list(invalid)] = False
    return probs[0][0], stacked


@pytest.mark.parametrize("seeds, m, n, invalid", [
    ((21,), 64, 200, ()),
    ((22, 23, 24), 96, 150, (1,)),
    ((25, 26, 27, 28), 40, 300, (0, 3)),
])
def test_batched_plain_equals_vmapped_pallas(seeds, m, n, invalid):
    """K6 with a leading batch axis (its plain version here; shared row
    descriptors, one window per problem) against jax.vmap of the Pallas
    kernel (interpret mode), and each problem against the single-problem
    form, with one window and with two."""
    desc_a, st = _batch(seeds, m, n, invalid)
    with jax.enable_x64(False):
        ref = jax.vmap(
            lambda *a: jpm.projection_hamming_top2(jnp.asarray(desc_a), *a, interpret=True))(
            *(jnp.asarray(a) for a in st[1:]))
        ref = [np.asarray(r) for r in ref]
    targs = [_t(a) for a in st]
    got, = kmatching.projection_hamming_top2(_t(desc_a), targs[1], (targs[2],), *targs[3:])
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and tuple(g.shape) == (len(seeds), m)
        np.testing.assert_array_equal(g.numpy(), r)
    wide = 1.5 * targs[2]
    both = kmatching.projection_hamming_top2(
        _t(desc_a), targs[1], (targs[2], wide), *targs[3:])
    for b in range(len(seeds)):
        per = [t[b] for t in targs[1:]]
        single, = kmatching.projection_hamming_top2(_t(desc_a), per[0], (per[1],), *per[2:])
        for g, s in zip(got, single):
            np.testing.assert_array_equal(g[b].numpy(), s.numpy())
        singles = kmatching.projection_hamming_top2(
            _t(desc_a), per[0], (per[1], wide[b]), *per[2:])
        for window, single in zip(both, singles):
            for g, s in zip(window, single):
                np.testing.assert_array_equal(g[b].numpy(), s.numpy())
    for b in invalid:
        assert (got[0][b].numpy() == matching.BIG_DIST).all()
    # Per-problem row descriptors ([B, M, 8]) give the same as shared ones.
    again, = kmatching.projection_hamming_top2(
        _t(np.tile(desc_a[None], (len(seeds), 1, 1))), targs[1], (targs[2],), *targs[3:])
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g.numpy(), a.numpy())


def test_batched_wrapper_checks_its_inputs():
    desc_a, st = _batch((1, 2), 8, 12)
    targs = [_t(a) for a in st]
    with pytest.raises(ValueError):
        kmatching.projection_hamming_top2(_t(desc_a[:7]), targs[1], (targs[2],), *targs[3:])
    with pytest.raises(ValueError):
        kmatching.projection_hamming_top2(
            _t(desc_a[None]), targs[1], (targs[2],), *targs[3:])
    with pytest.raises(ValueError):
        kmatching.projection_hamming_top2(
            _t(desc_a), targs[1], (targs[2],), *targs[3:6], targs[6][:1].contiguous(),
            *targs[7:])
    with pytest.raises(ValueError):
        kmatching.projection_hamming_top2(
            _t(desc_a), targs[1][None], (targs[2][None],), *(t[None] for t in targs[3:]))
    with pytest.raises(TypeError):
        kmatching.projection_hamming_top2(
            _t(desc_a), targs[1], (targs[2].double(),), *targs[3:])
