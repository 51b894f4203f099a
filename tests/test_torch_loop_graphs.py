"""The loop closer's, the staged mapper's and the AR anchor's
single-dispatch forms on the CPU: the Sim3 RANSAC
(geometry/sim3_solver.sim3_ransac_jit), the Sim3 LM
(optim/sim3_opt.optimize_sim3_jit), the matchers' forms
(slam/matchers.search_by_sim3_jit, match_fuse_jit,
match_for_triangulation_jit, search_fuse_jit, and match_brute_force_jit
over padded loop candidates) and the plane fit
(slam/ar.fit_plane_ransac_jit):

- each form's parameters are its eager function's, by name and in order,
  and System.shutdown's owners hold every function the forms capture;
- on CPU tensors each form makes no graph and launches nothing
  (torch.cuda.CUDAGraph and torch.cuda.graph raise if touched), and its
  outputs equal its eager function's bit for bit;
- padded against unpadded (the card's shape buckets: Sim3 pairs to a
  power of two >= 64 with `valid` False, loop candidates to a power of two
  >= 4 with their flags False, fuse points to >= 256 invisible): integer
  outputs exact (ok, inlier counts and flags, match indices), the floats
  within tests/test_torch_sim3.py's tolerances (the refit's and the LM's
  sums follow the length; the CPU loop closer keeps the exact count);
- sim3_ransac_jit on JAX's own sample sets against JAX's sim3_ransac_jit,
  and optimize_sim3_jit against JAX's optimize_sim3_jit, at
  tests/test_torch_sim3.py's tolerances with the integer outputs exact;
- search_by_sim3_jit against JAX's two match_by_sim3 calls and
  mutual_consistency, and the loop closer's compute_sim3 against JAX's,
  on tests/test_torch_loop_closing.py's two-keyframe map
  (tests/test_loop_closing.py's TestSearchBySim3Augmentation map);
- fit_plane_ransac_jit against the eager fit on tests/test_torch_ar.py's
  clouds, also in a 65,536-slot table (the map's, as the JAX package fits
  it);
- the call sites call the forms.
The sharded global BA's loop form is held to its early-exit form in
tests/test_torch_distributed_ba.py's gloo world.
"""

import inspect
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from orb_slam2_commit_tpu.geometry import sim3_solver as jsim3
from orb_slam2_commit_tpu.models.kf_database import KeyFrameDatabase as JDatabase
from orb_slam2_commit_tpu.models.vocabulary import BinaryVocabulary as JVocabulary
from orb_slam2_commit_tpu.optim import sim3_opt as jopt
from orb_slam2_commit_tpu.slam import loop_closing as jloop
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.geometry import sim3_solver
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.models.kf_database import KeyFrameDatabase
from orb_slam2_commit_tpu_torch.models.vocabulary import BinaryVocabulary
from orb_slam2_commit_tpu_torch.optim import sim3_opt
from orb_slam2_commit_tpu_torch.slam import ar, local_mapping, loop_closing, matchers, system
from orb_slam2_commit_tpu_torch.utils import cuda_graph
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

sys.path.insert(0, str(Path(__file__).parent))
import test_loop_closing  # noqa: E402
from test_sim3 import CX, CY, FX, FY, make_sim3_pair  # noqa: E402
from test_torch_ar import CLOUDS, _plane_cloud  # noqa: E402
from test_torch_loop_closing import Sim3Sampler  # noqa: E402
from test_torch_sim3 import OPT_TOL, RANSAC_TOL, _close_sim3, _jax_sim3_samples  # noqa: E402

torch.set_num_threads(1)

# (module, form, its eager function).
FORMS = [
    (sim3_solver, "sim3_ransac_jit", "sim3_ransac"),
    (sim3_opt, "optimize_sim3_jit", "optimize_sim3"),
    (matchers, "search_by_sim3_jit", "search_by_sim3"),
    (matchers, "match_fuse_jit", "match_fuse"),
    (matchers, "match_for_triangulation_jit", "match_for_triangulation"),
    (matchers, "search_fuse_jit", "search_fuse"),
    (ar, "fit_plane_ransac_jit", "fit_plane_ransac"),
]
W, H, N_FEAT = 320, 240, 200


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """One thread; on the CPU nothing launches and no graph is made."""
    torch.set_num_threads(1)

    def no_graph(*args, **kwargs):
        raise AssertionError("a CUDA graph was made on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph", no_graph)
    before, graphs = dict(_build.launches), dict(cuda_graph.graphs)
    yield
    assert _build.launches == before
    assert cuda_graph.graphs == graphs


def same_bits(a, b):
    """Two results (tensors, or trees of them) equal bit for bit, floats
    compared as integers of their width."""
    xs, ys = tree_leaves(a), tree_leaves(b)
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.view(ints.get(x.dtype, x.dtype)), y.view(ints.get(y.dtype, y.dtype)))
        for x, y in zip(xs, ys))


def _t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pad(a, n, fill=0):
    a = np.asarray(a)
    return np.concatenate([a, np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)])


@pytest.mark.parametrize("module, form, eager", FORMS, ids=[f[1] for f in FORMS])
def test_parameters_are_the_eager_functions(module, form, eager):
    port = list(inspect.signature(getattr(module, form)).parameters)
    want = list(inspect.signature(getattr(module, eager)).parameters)
    assert port == want


def test_shutdown_releases_every_loop_form():
    """System.shutdown's owners hold every function the forms capture."""
    owners = set(system.LOOP_GRAPHED + system.STAGED_GRAPHED)
    for module in (sim3_solver, sim3_opt, matchers, ar):
        assert set(module.GRAPHED) <= owners


def test_call_sites_call_the_forms():
    """The staged mapper's triangulation and fuse, and the AR anchor, call
    the forms (the loop closer's are spied on in test_compute_sim3)."""
    tri = inspect.getsource(local_mapping.LocalMapper._create_new_points_staged)
    fuse = inspect.getsource(local_mapping.LocalMapper._fuse_neighbors)
    assert "matchers.match_for_triangulation_jit(" in tri
    assert "matchers.search_fuse_jit(" in fuse and "matchers.frustum_check(" not in fuse
    assert "fit_plane_ransac_jit(" in inspect.getsource(ar.ARAnchor.update)


# ---------------------------------------------------------------------------
# The Sim3 RANSAC and LM
# ---------------------------------------------------------------------------

def _ransac_case(seed, fix_scale, outlier_frac):
    """tests/test_torch_sim3.py's RANSAC case -> (numpy inputs, JAX's
    sample sets, JAX's result)."""
    rng = np.random.default_rng(seed)
    n = 80
    x1, x2, uv1, uv2, *_ = make_sim3_pair(rng, n=n, noise=0.3, outlier_frac=outlier_frac,
                                          s_true=1.0 if fix_scale else 1.3)
    valid = np.ones(n, bool)
    valid[::11] = False
    s2_1 = np.asarray(1.2 ** (2 * rng.integers(0, 3, n)), np.float32)
    s2_2 = np.asarray(1.2 ** (2 * rng.integers(0, 3, n)), np.float32)
    arrays = [np.asarray(a, np.float32) for a in (x1, x2)] + [valid] + [
        np.asarray(a, np.float32) for a in (uv1, uv2, s2_1, s2_2)]
    with jax.enable_x64(False):
        key = jax.random.key(seed)
        samples = _jax_sim3_samples(key, valid)
        want = jsim3.sim3_ransac_jit(key, *(jnp.asarray(a) for a in arrays), FX, FY, CX, CY,
                                     fix_scale=fix_scale)
        want = want._replace(**{k: np.asarray(v) for k, v in want._asdict().items()})
    return arrays, samples, want


def _padded_pairs(arrays, n):
    """The RANSAC's pair arrays padded to n rows as the card's loop closer
    pads them (zero points and pixels, unit variances, valid False)."""
    fills = (0.0, 0.0, False, 0.0, 0.0, 1.0, 1.0)
    return [_pad(a, n, f) for a, f in zip(arrays, fills)]


RANSAC_CASES = [(3, False, 0.25), (9, True, 0.4)]


@pytest.mark.parametrize("seed,fix_scale,outlier_frac", RANSAC_CASES)
def test_sim3_ransac_jit(seed, fix_scale, outlier_frac):
    """The form equals the eager function bit for bit, unpadded and padded
    to 128 pairs; padded against unpadded: inliers, count and ok exact,
    the transform within RANSAC_TOL; against JAX's sim3_ransac_jit on its
    own sample sets: the same integers, the transform within RANSAC_TOL."""
    arrays, samples, want = _ransac_case(seed, fix_scale, outlier_frac)
    s = torch.from_numpy(samples.astype(np.int64))
    kw = dict(fix_scale=fix_scale)
    n = arrays[0].shape[0]
    runs = {}
    for rows in (n, 128):
        args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _padded_pairs(arrays, rows)]
        got = sim3_solver.sim3_ransac_jit(s, *args, FX, FY, CX, CY, **kw)
        assert same_bits(got, sim3_solver.sim3_ransac(s, *args, FX, FY, CX, CY, **kw))
        runs[rows] = got
    exact, padded = runs[n], runs[128]
    assert not padded.inliers[n:].any()
    assert torch.equal(padded.inliers[:n], exact.inliers)
    assert int(padded.n_inliers) == int(exact.n_inliers) and bool(padded.ok) == bool(exact.ok)
    _close_sim3(padded[1:4], exact[1:4], RANSAC_TOL)
    np.testing.assert_array_equal(exact.inliers.numpy(), want.inliers)
    assert int(exact.n_inliers) == int(want.n_inliers) and bool(exact.ok) == bool(want.ok)
    _close_sim3(exact[1:4], [want.s12, want.R12, want.t12], RANSAC_TOL)


def _lm_case(seed, fix_scale):
    """tests/test_torch_sim3.py's optimize_sim3 case -> (numpy inputs)."""
    rng = np.random.default_rng(seed)
    n = 60
    x1, x2, uv1, uv2, s, R, t, _ = make_sim3_pair(rng, n=n, noise=0.2,
                                                  s_true=1.0 if fix_scale else 1.3)
    uv1[:3] += 40.0
    w = rng.normal(0, 0.02, 3)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    dR = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    init = [np.float32(s * (1.0 if fix_scale else 1.05)), (dR @ R).astype(np.float32),
            (t + 0.05).astype(np.float32)]
    inv1 = np.asarray(1.0 / 1.2 ** (2 * rng.integers(0, 2, n)), np.float32)
    valid = np.ones(n, bool)
    valid[-2:] = False
    pairs = [np.asarray(a, np.float32) for a in (x1, x2, uv1, uv2)] + [
        inv1, np.ones(n, np.float32), valid]
    return init, pairs


@pytest.mark.parametrize("seed,fix_scale", [(0, False), (1, True)])
def test_optimize_sim3_jit(seed, fix_scale):
    """The form equals the eager function bit for bit, unpadded and padded
    to 64 pairs; padded against unpadded: the inliers and their count
    exact, the transform within OPT_TOL; against JAX's optimize_sim3_jit:
    the same inliers, the transform within OPT_TOL."""
    init, pairs = _lm_case(seed, fix_scale)
    n = pairs[0].shape[0]
    kw = dict(fix_scale=fix_scale)
    s0 = [torch.from_numpy(np.asarray(a)) for a in init]
    runs = {}
    for rows in (n, 64):
        fills = (0.0, 0.0, 0.0, 0.0, 1.0, 1.0, False)
        args = [torch.from_numpy(np.ascontiguousarray(_pad(a, rows, f)))
                for a, f in zip(pairs, fills)]
        got = sim3_opt.optimize_sim3_jit(*s0, *args, FX, FY, CX, CY, **kw)
        assert same_bits(got, sim3_opt.optimize_sim3(*s0, *args, FX, FY, CX, CY, **kw))
        runs[rows] = got
    exact, padded = runs[n], runs[64]
    assert torch.equal(padded.inliers[:n], exact.inliers) and not padded.inliers[n:].any()
    assert int(padded.n_inliers) == int(exact.n_inliers)
    _close_sim3(padded[:3], exact[:3], OPT_TOL)
    with jax.enable_x64(False):
        want = jopt.optimize_sim3_jit(*(jnp.asarray(a) for a in init),
                                      *(jnp.asarray(a) for a in pairs), FX, FY, CX, CY, **kw)
        want = [np.asarray(a) for a in want]
    np.testing.assert_array_equal(exact.inliers.numpy(), want[3])
    assert int(exact.n_inliers) == int(want[4])
    _close_sim3(exact[:3], want[:3], OPT_TOL)


# ---------------------------------------------------------------------------
# The loop closer on tests/test_torch_loop_closing.py's two-keyframe map
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair_map():
    case = test_loop_closing.TestSearchBySim3Augmentation()
    jcfg, jm, kf_a, kf_b = case._build_two_kf_map()
    train = np.random.default_rng(5).integers(0, 2 ** 32, size=(500, 8), dtype=np.uint32)
    jcloser = jloop.LoopCloser(jcfg, jm, JDatabase(JVocabulary.train(train, k=4, levels=2,
                                                                     seed=2),
                                                   jm.cfg.max_keyframes))
    pm = interop.map_state_from_numpy(interop.map_state_to_numpy(jm))
    cfg = synthetic_config(width=640, height=480, n_features=case.N)
    pcloser = loop_closing.LoopCloser(cfg, pm, KeyFrameDatabase(BinaryVocabulary.train(
        train, k=4, levels=2, seed=2), pm.cfg.max_keyframes, device="cpu"), device="cpu")
    pcloser.sampler = Sim3Sampler(jax.random.key(7))
    return jcloser, pcloser, kf_a, kf_b


def test_search_by_sim3_jit(pair_map):
    """Both directions at the true relative pose: the form equals the
    eager function bit for bit, and JAX's two match_by_sim3 calls with
    their mutual check (the JAX closer's _search_by_sim3) find the same
    pairs."""
    jcloser, pcloser, kf_a, kf_b = pair_map
    m = pcloser.map
    R12 = m.kf_pose_R[kf_a] @ m.kf_pose_R[kf_b].T
    t12 = m.kf_pose_t[kf_a] - R12 @ m.kf_pose_t[kf_b]
    seen = []
    form = matchers.search_by_sim3_jit

    def spy(*args, **kwargs):
        got = form(*args, **kwargs)
        assert same_bits(got, matchers.search_by_sim3(*args, **kwargs))
        seen.append(got)
        return got

    seed1 = np.arange(5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(matchers, "search_by_sim3_jit", spy)
        got = pcloser._search_by_sim3(kf_a, kf_b, 1.0, R12, t12, seed1, seed1)
    assert len(seen) == 1
    with jax.enable_x64(False):
        want = jcloser._search_by_sim3(kf_a, kf_b, 1.0, R12, t12, seed1, seed1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].size >= 40


def test_compute_sim3(pair_map):
    """compute_sim3 through the forms (each called, spied on) against the
    JAX closer's: accepted against the same keyframe with the same point
    matches, S_cw within OPT_TOL; every form's result bit for bit its
    eager function's."""
    jcloser, pcloser, kf_a, kf_b = pair_map
    pcloser.sampler = Sim3Sampler(jax.random.key(7))
    forms = {(matchers, "match_brute_force_jit", "match_brute_force"),
             (sim3_solver, "sim3_ransac_jit", "sim3_ransac"),
             (matchers, "search_by_sim3_jit", "search_by_sim3"),
             (sim3_opt, "optimize_sim3_jit", "optimize_sim3"),
             (matchers, "match_fuse_jit", "match_fuse")}
    calls = {}

    def spy(module, form, eager):
        fn = getattr(module, form)

        def call(*args, **kwargs):
            got = fn(*args, **kwargs)
            assert same_bits(got, getattr(module, eager)(*args, **kwargs)), form
            calls[form] = calls.get(form, 0) + 1
            return got
        return call

    with pytest.MonkeyPatch.context() as mp:
        for module, form, eager in forms:
            mp.setattr(module, form, spy(module, form, eager))
        p_ok, p_kf, s_cw, R_cw, t_cw, p_matches = pcloser.compute_sim3(kf_a, [kf_b])
    assert set(calls) == {form for _, form, _ in forms}
    with jax.enable_x64(False):
        jcloser._rng_key = jax.random.key(7)
        j_ok, j_kf, js, jR, jt, j_matches = jcloser.compute_sim3(kf_a, [kf_b])
    assert p_ok == j_ok is True and p_kf == j_kf == kf_b
    assert p_matches == j_matches
    _close_sim3((s_cw, R_cw, t_cw), (js, jR, jt), OPT_TOL)


def test_loop_candidates_padded():
    """The loop closer's brute force over 3 candidates padded to 4 (their
    flags False): the form equals the eager function bit for bit, and the
    real candidates' matches equal the unpadded call's."""
    rng = np.random.default_rng(0)
    n, C = 120, 3
    desc_a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    desc_b = np.repeat(desc_a[None], C, 0)
    desc_b[:, ::3] = rng.integers(0, 2 ** 32, (C, (n + 2) // 3, 8), dtype=np.uint32)
    angle_a = rng.uniform(0, 360, n).astype(np.float32)
    angle_b = np.repeat(angle_a[None], C, 0) + rng.normal(0, 2, (C, n)).astype(np.float32)
    ok_a = rng.uniform(size=n) < 0.9
    ok_b = rng.uniform(size=(C, n)) < 0.8

    def call(fn, rows):
        return fn(_t(desc_a), torch.from_numpy(angle_a), torch.from_numpy(ok_a),
                  _t(_pad(desc_b, rows)), torch.from_numpy(_pad(angle_b, rows)),
                  torch.from_numpy(_pad(ok_b, rows)))

    padded = call(matchers.match_brute_force_jit, 4)
    assert same_bits(padded, call(matchers.match_brute_force, 4))
    exact = call(matchers.match_brute_force, C)
    assert torch.equal(padded.idx[:C], exact.idx) and torch.equal(padded.dist[:C], exact.dist)
    assert (padded.idx[C:] < 0).all() and (exact.idx >= 0).sum() > 20


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


# ---------------------------------------------------------------------------
# The projection matchers: random features in a 320x240 image
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def features():
    """A keyframe's features and map points seen from it (the points'
    descriptors its features' with a few bits flipped)."""
    rng = np.random.default_rng(4)
    xy = np.stack([rng.uniform(0, W, N_FEAT), rng.uniform(0, H, N_FEAT)], -1)
    octave = rng.integers(0, 4, N_FEAT).astype(np.int32)
    desc = rng.integers(0, 2 ** 32, (N_FEAT, 8), dtype=np.uint32)
    valid = rng.uniform(size=N_FEAT) < 0.9
    depth = rng.uniform(2.0, 6.0, N_FEAT)
    fx = fy = 250.0
    cx, cy = W / 2, H / 2
    pc = np.stack([(xy[:, 0] - cx) / fx * depth, (xy[:, 1] - cy) / fy * depth, depth], -1)
    flips = rng.integers(0, 2 ** 32, (N_FEAT, 8), dtype=np.uint32) & rng.integers(
        0, 2 ** 32, (N_FEAT, 8), dtype=np.uint32) & rng.integers(
        0, 2 ** 32, (N_FEAT, 8), dtype=np.uint32)
    return dict(xy=xy.astype(np.float32), octave=octave, desc=desc, valid=valid,
                pc=(pc + rng.normal(0, 0.005, pc.shape)).astype(np.float32),
                pt_desc=desc ^ flips, cam=(fx, fy, cx, cy), depth=depth)


def test_match_fuse_jit(features):
    """The loop's widening: points already projected, padded to 256 rows
    invisible: the form equals the eager function bit for bit, the real
    rows' matches equal the unpadded call's."""
    f = features
    fx, fy, cx, cy = f["cam"]
    proj = np.stack([fx * f["pc"][:, 0] / f["pc"][:, 2] + cx,
                     fy * f["pc"][:, 1] / f["pc"][:, 2] + cy], -1).astype(np.float32)

    def call(fn, rows):
        info = matchers.FrustumInfo(
            visible=torch.from_numpy(_pad(np.ones(N_FEAT, bool), rows)),
            proj=torch.from_numpy(_pad(proj, rows)),
            pred_octave=torch.zeros(rows, dtype=torch.int32), view_cos=torch.ones(rows))
        return fn(info, _t(_pad(f["pt_desc"], rows)), torch.from_numpy(f["xy"]),
                  _t(f["desc"]), torch.from_numpy(f["octave"]), torch.from_numpy(f["valid"]),
                  th=8.0)

    padded = call(matchers.match_fuse_jit, 256)
    assert same_bits(padded, call(matchers.match_fuse, 256))
    exact = call(matchers.match_fuse, N_FEAT)
    assert torch.equal(padded.idx[:N_FEAT], exact.idx) and (padded.idx[N_FEAT:] < 0).all()
    assert (exact.idx >= 0).sum() > N_FEAT // 4


def test_search_fuse_jit(features):
    """The staged mapper's fuse: the form equals the eager function bit
    for bit, and equals frustum_check then match_fuse; the bucket's
    padding (rows invalid) leaves the real rows' matches."""
    f = features
    fx, fy, cx, cy = f["cam"]
    pos = f["pc"].astype(np.float32)
    normal = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    dist = np.linalg.norm(pos, axis=1)
    R, t = torch.eye(3), torch.zeros(3)

    def args(rows):
        return ([torch.from_numpy(_pad(a, rows, 1.0 if k in (2, 3) else 0)) for k, a in
                 enumerate((pos, normal.astype(np.float32), (dist / 1.5).astype(np.float32),
                            (dist * 1.5).astype(np.float32)))]
                + [torch.from_numpy(_pad(np.ones(N_FEAT, bool), rows)), R, t,
                   fx, fy, cx, cy, float(W), float(H), _t(_pad(f["pt_desc"], rows)),
                   torch.from_numpy(f["xy"]), _t(f["desc"]), torch.from_numpy(f["octave"]),
                   torch.from_numpy(f["valid"])])

    a = args(256)
    got = matchers.search_fuse_jit(*a)
    assert same_bits(got, matchers.search_fuse(*a))
    info = matchers.frustum_check(*a[:13])
    assert same_bits(got, matchers.match_fuse(info, *a[13:]))
    exact = matchers.search_fuse(*args(N_FEAT))
    assert torch.equal(got.idx[:N_FEAT], exact.idx) and (got.idx[N_FEAT:] < 0).all()
    assert (exact.idx >= 0).sum() > N_FEAT // 4


def test_match_for_triangulation_jit(features):
    """One neighbour pair under the epipolar band: the form equals the
    eager function bit for bit, with the epipole distance as a tensor and
    as a float."""
    f = features
    fx, fy, cx, cy = f["cam"]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    t2 = np.array([-0.3, 0.02, 0.05])
    pc2 = f["pc"] + t2
    xy2 = np.stack([fx * pc2[:, 0] / pc2[:, 2] + cx, fy * pc2[:, 1] / pc2[:, 2] + cy], -1)
    tx = np.array([[0, -t2[2], t2[1]], [t2[2], 0, -t2[0]], [-t2[1], t2[0], 0]])
    Kinv = np.linalg.inv(K)
    F12 = (Kinv.T @ tx @ Kinv).T
    ep = K @ t2
    args = [torch.from_numpy(f["xy"]), _t(f["desc"]),
            torch.zeros(N_FEAT), torch.from_numpy(f["valid"]),
            _t32(xy2), _t(f["pt_desc"]), torch.zeros(N_FEAT),
            torch.from_numpy(f["valid"]), _t32(F12), torch.from_numpy(f["octave"]),
            _t32(ep[:2] / ep[2])]
    for d2 in (torch.tensor(100.0), 100.0):
        got = matchers.match_for_triangulation_jit(*args, d2)
        assert same_bits(got, matchers.match_for_triangulation(*args, d2))
    assert (got.idx >= 0).sum() > 0


# ---------------------------------------------------------------------------
# The AR plane fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["even, some invalid", "odd, all valid"])
def test_fit_plane_ransac_jit(name):
    """tests/test_torch_ar.py's clouds: the form equals the eager fit bit
    for bit, on the cloud and in a 65,536-slot table (the rest invalid,
    the sample sets drawn over every slot, as ARAnchor draws them)."""
    seed, n_plane, n_out, every = CLOUDS[name]
    pts, _ = _plane_cloud(np.random.default_rng(seed), n_plane, n_out)
    valid = np.ones(len(pts), bool)
    if every:
        valid[::every] = False
    for rows in (len(pts), 65536):
        p, v = torch.from_numpy(_pad(pts, rows)), torch.from_numpy(_pad(valid, rows))
        gen = torch.Generator().manual_seed(seed)
        idx = ar.sample_indices(rows, 128, gen)
        if rows != len(pts):
            # A few sample sets of the cloud's own points, so a plane is found.
            idx[:16] = ar.sample_indices(len(pts), 16, gen)
        got = ar.fit_plane_ransac_jit(p, v, idx=idx)
        assert same_bits(got, ar.fit_plane_ransac(p, v, idx=idx))
        assert int(got.n_inliers) >= n_plane // 2
