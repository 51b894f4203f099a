"""The staged tracker's single-dispatch forms on the CPU: the extraction
(ops/extractor.extract_features_jit), the stereo front end
(ops/stereo.stereo_frontend_jit), the pose LM
(optim/pose_opt.pose_optimization_jit), the matchers' `*_jit` twins
(slam/matchers.py), EPnP RANSAC (geometry/pnp.epnp_ransac_many_jit), the
two-view bootstrap (geometry/twoview.initialize_two_view_jit) and the BoW
descent (models/vocabulary._descend_jit):

- each form's parameters are its eager function's, by name and in order;
- on CPU tensors each form makes no graph and launches nothing
  (torch.cuda.CUDAGraph and torch.cuda.graph raise if touched), and its
  outputs equal its eager function's bit for bit, at the small sizes of
  the existing parity files: 320x240 and 400 features
  (tests/test_torch_fused.py's stereo example), 3 relocalization
  candidates padded to 4, the two-view cases of
  tests/test_torch_twoview.py and the EPnP candidates of
  tests/test_torch_pnp.py;
- initialize_two_view_jit and epnp_ransac_many_jit once each against
  their JAX namesakes on the same numpy inputs and sample sets, at those
  files' tolerances;
- the descent's graph key holds the vocabulary's tables by identity, not
  as inputs.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from orb_slam2_commit_tpu.geometry import pnp as jpnp
from orb_slam2_commit_tpu.geometry import twoview as jtwoview
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.geometry import pnp, twoview
from orb_slam2_commit_tpu_torch.geometry.ransac import RansacSampler
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.models import vocabulary
from orb_slam2_commit_tpu_torch.ops import extractor as ext
from orb_slam2_commit_tpu_torch.ops import lie
from orb_slam2_commit_tpu_torch.ops import stereo
from orb_slam2_commit_tpu_torch.optim import pose_opt
from orb_slam2_commit_tpu_torch.optim.residuals import BAObservations
from orb_slam2_commit_tpu_torch.slam import matchers, system
from orb_slam2_commit_tpu_torch.utils import cuda_graph

torch.set_num_threads(1)

W, H, N_FEAT, N_PTS = 320, 240, 400, 256
# (module, form, its eager function).
FORMS = [
    (ext, "extract_features_jit", "extract_features"),
    (stereo, "stereo_frontend_jit", "stereo_frontend"),
    (pose_opt, "pose_optimization_jit", "pose_optimization"),
    (matchers, "match_for_initialization_jit", "match_for_initialization"),
    (matchers, "match_projection_last_frame_jit", "match_projection_last_frame"),
    (matchers, "match_brute_force_jit", "match_brute_force"),
    (matchers, "search_local_points_jit", "search_local_points"),
    (pnp, "epnp_ransac_many_jit", "epnp_ransac_many"),
    (twoview, "initialize_two_view_jit", "initialize_two_view"),
    (vocabulary, "_descend_jit", "_descend"),
]
# tests/test_torch_twoview.py's and tests/test_torch_pnp.py's tolerances.
TV_ROT_DEG, TV_T, TV_PTS_RTOL = 1e-3, 1e-4, 1e-3
PNP_ROT_DEG, PNP_T, MASK_SLACK = 0.5, 0.05, 3
FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0
K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1.0]])


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
    compared as integers of their width (NaNs too)."""
    xs, ys = tree_leaves(a), tree_leaves(b)
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.view(ints.get(x.dtype, x.dtype)), y.view(ints.get(y.dtype, y.dtype)))
        for x, y in zip(xs, ys))


def _t(a):
    a = np.array(a, order="C")
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def rot_deg(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return np.degrees(2 * np.arcsin(min(1.0, d / (2 * np.sqrt(2)))))


@pytest.fixture(scope="module")
def example():
    """The stereo example at the small size: config, its arrays, and both
    images' features (eager, packed route)."""
    config, a = interop.fused_example_arrays(W, H, N_FEAT, N_PTS, 512, device="cpu",
                                             sensor="stereo")
    cam = config.camera
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORB_TPU_FORCE_PACKED", "1")
        feats = [ext.extract_features(_t(a[k]), config.orb, cam.height, cam.width)
                 for k in ("image", "image_r")]
    return config, a, feats


@pytest.mark.parametrize("module, form, eager", FORMS, ids=[f[1] for f in FORMS])
def test_parameters_are_the_eager_functions(module, form, eager):
    port = list(inspect.signature(getattr(module, form)).parameters)
    want = list(inspect.signature(getattr(module, eager)).parameters)
    assert port == want


def test_shutdown_releases_every_staged_form():
    """System.shutdown's owners hold every function the forms capture."""
    for module in (ext, stereo, pose_opt, matchers, pnp, twoview, vocabulary):
        assert set(module.GRAPHED) <= set(system.STAGED_GRAPHED)


@pytest.mark.parametrize("packed", ["1", "0"])
def test_extraction(example, monkeypatch, packed):
    """Both extraction routes (the route is read at the call)."""
    config, a, _ = example
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", packed)
    image = _t(a["image"])
    cam = config.camera
    want = ext.extract_features(image, config.orb, cam.height, cam.width)
    got = ext.extract_features_jit(image, config.orb, cam.height, cam.width)
    assert same_bits(got, want) and int(got.valid.sum()) > 100


def test_stereo_frontend(example, monkeypatch):
    config, a, _ = example
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "1")
    cam = config.camera
    args = (_t(a["image"]), _t(a["image_r"]), config.orb, cam.height, cam.width, cam.bf,
            cam.baseline)
    got = stereo.stereo_frontend_jit(*args)
    assert same_bits(got, stereo.stereo_frontend(*args))
    assert int(got[2].valid.sum()) > 50


def _pose_problem(example):
    """The last-frame points seen from frame 1 with 0.5 px noise, stereo
    on every third row, from a perturbed pose."""
    config, a, _ = example
    cam = config.camera
    rng = np.random.default_rng(0)
    pts = a["pt_f32"][:, 0:3].astype(np.float64)
    R, t = a["meta_f32"][0:9].reshape(3, 3).astype(np.float64), a["meta_f32"][9:12]
    pc = pts @ R.T + t
    z = np.maximum(pc[:, 2], 1e-3)
    u = cam.fx * pc[:, 0] / z + cam.cx + rng.normal(0, 0.5, z.shape)
    v = cam.fy * pc[:, 1] / z + cam.cy + rng.normal(0, 0.5, z.shape)
    stereo_rows = np.arange(z.size) % 3 == 0
    obs = BAObservations(
        cam_idx=torch.zeros(z.size, dtype=torch.int32),
        pt_idx=torch.arange(z.size, dtype=torch.int32),
        uvr=_t(np.stack([u, v, np.where(stereo_rows, u - cam.bf / z, 0.0)], 1)
               .astype(np.float32)),
        inv_sigma2=torch.ones(z.size),
        is_stereo=_t(stereo_rows),
        valid=_t(a["pt_f32"][:, 5] > 0.5))
    R0 = lie.so3_exp(torch.tensor([0.01, -0.02, 0.005], dtype=torch.float64)).numpy() @ R
    return (_t(R0.astype(np.float32)), _t((t + 0.05).astype(np.float32)),
            _t(pts.astype(np.float32)), obs, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)


def test_pose_optimization(example):
    args = _pose_problem(example)
    got = pose_opt.pose_optimization_jit(*args)
    assert same_bits(got, pose_opt.pose_optimization(*args)) and int(got.n_inliers) > 50


def _frame(feats):
    return feats.xy, feats.desc, feats.angle, feats.octave, feats.valid


def test_match_for_initialization(example):
    _, _, (left, right) = example
    xy1, d1, a1, o1, v1 = _frame(left)
    xy2, d2, a2, o2, v2 = _frame(right)
    args = (xy1, d1, a1, o1, v1, xy2, d2, a2, o2, v2)
    got = matchers.match_for_initialization_jit(*args)
    assert same_bits(got, matchers.match_for_initialization(*args))
    assert int((got.idx >= 0).sum()) > 20


@pytest.mark.parametrize("mono", [True, False])
def test_match_projection_last_frame(example, mono):
    """Both radii from one call (the motion stage's retry), with the
    stereo octave rule or the monocular band."""
    config, a, (left, _) = example
    cam = config.camera
    pt, meta = a["pt_f32"], a["meta_f32"]
    xy, desc, angle, octave, valid = _frame(left)
    args = (_t(pt[:, 0:3]), _t(a["pt_desc"]), _t(pt[:, 3].astype(np.int32)), _t(pt[:, 4]),
            _t(pt[:, 5] > 0.5), _t(meta[0:9].reshape(3, 3)), _t(meta[9:12]),
            xy, desc, angle, octave, valid, cam.fx, cam.fy, cam.cx, cam.cy,
            float(cam.width), float(cam.height))
    kw = dict(th=(7.0, 14.0), tz_rel=float(meta[12]), mono=mono, baseline=float(cam.baseline),
              n_levels=config.orb.n_levels, scale=config.orb.scale_factor)
    got = matchers.match_projection_last_frame_jit(*args, **kw)
    assert same_bits(got, matchers.match_projection_last_frame(*args, **kw))
    assert int((got[1].idx >= 0).sum()) > 20


def _candidates(a, n_cand=3, cp=4):
    """n_cand keyframe tables from the last-frame points (rolled and with
    a few descriptor bits flipped), padded to cp rows of no valid row."""
    rng = np.random.default_rng(1)
    desc = np.zeros((cp, N_PTS, 8), np.uint32)
    angle = np.zeros((cp, N_PTS), np.float32)
    valid = np.zeros((cp, N_PTS), bool)
    for c in range(n_cand):
        flip = rng.integers(0, 2, (N_PTS, 8)).astype(np.uint32) << rng.integers(0, 32, (N_PTS, 8)
                                                                               ).astype(np.uint32)
        desc[c] = np.roll(a["pt_desc"], 17 * c, axis=0) ^ (flip * (c > 0))
        angle[c] = np.roll(a["pt_f32"][:, 4], 17 * c)
        valid[c] = np.roll(a["pt_f32"][:, 5] > 0.5, 17 * c)
    return _t(desc), _t(angle), _t(valid)


@pytest.mark.parametrize("batched", [False, True], ids=["reference keyframe",
                                                        "relocalization"])
def test_match_brute_force(example, batched):
    _, a, (left, _) = example
    if batched:
        side_a = _candidates(a)
    else:
        side_a = (_t(a["pt_desc"]), _t(a["pt_f32"][:, 4]), _t(a["pt_f32"][:, 5] > 0.5))
    args = side_a + (left.desc, left.angle, left.valid)
    got = matchers.match_brute_force_jit(*args)
    assert same_bits(got, matchers.match_brute_force(*args))
    assert int((got.idx >= 0).sum()) > 20


@pytest.mark.parametrize("th", [3.0, 10.0])
def test_search_local_points(example, th):
    """The local map's candidates into frame 1, a third of the features
    already bound (th 3: the local map's radius, 10: relocalization's
    wide search)."""
    config, a, (left, _) = example
    cam = config.camera
    cf, meta = a["cand_f32"], a["meta_f32"]
    xy, desc, _, octave, valid = _frame(left)
    args = (_t(cf[:, 0:3]), _t(cf[:, 3:6]), _t(cf[:, 6]), _t(cf[:, 7]), _t(cf[:, 8] > 0.5),
            _t(meta[0:9].reshape(3, 3)), _t(meta[9:12]), cam.fx, cam.fy, cam.cx, cam.cy,
            float(cam.width), float(cam.height), _t(a["cand_desc"]), xy, desc, octave, valid,
            torch.arange(N_FEAT) % 3 == 0)
    kw = dict(th=th, n_levels=config.orb.n_levels, scale=config.orb.scale_factor)
    got = matchers.search_local_points_jit(*args, **kw)
    assert same_bits(got, matchers.search_local_points(*args, **kw))
    assert int(got[0].visible.sum()) > 20 and int((got[1].idx >= 0).sum()) > 10


# tests/test_torch_twoview.py's correspondence pairs (name, seed, arguments).
TV_CASES = [("general", 1, {}), ("planar", 2, dict(planar=True)),
            ("pure_rotation", 6, dict(baseline=0.0, yaw=0.08, noise=0.2, outlier_frac=0.0))]


def make_pair(rng, n=200, planar=False, noise=0.3, outlier_frac=0.1, baseline=0.5,
              yaw=0.05):
    """tests/test_twoview.py's correspondence pair."""
    x = rng.uniform(-3, 3, n)
    y = rng.uniform(-2, 2, n)
    z = np.full(n, 6.0) + 0.3 * x if planar else rng.uniform(4, 10, n)
    pts = np.stack([x, y, z], -1)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R21 = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
    t21 = np.array([-baseline, 0.02, 0.01])

    def proj(P, R, t):
        pc = P @ R.T + t
        return (pc[:, :2] / pc[:, 2:3]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]

    uv1 = proj(pts, np.eye(3), np.zeros(3)) + rng.normal(0, noise, (n, 2))
    uv2 = proj(pts, R21, t21) + rng.normal(0, noise, (n, 2))
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv2[idx] = rng.uniform([0, 0], [640, 480], size=(n_out, 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), np.ones(n, bool)


@pytest.mark.parametrize("name, seed, kwargs", TV_CASES, ids=[c[0] for c in TV_CASES])
def test_initialize_two_view(name, seed, kwargs):
    uv1, uv2, valid = make_pair(np.random.default_rng(seed), **kwargs)
    args = (_t(RansacSampler(seed).twoview(valid)), _t(uv1), _t(uv2), _t(valid),
            _t(K.astype(np.float32)))
    got = twoview.initialize_two_view_jit(*args)
    assert same_bits(got, twoview.initialize_two_view(*args))
    assert bool(got.ok) == (name != "pure_rotation")


def test_initialize_two_view_jit_against_jax():
    """The general case on JAX's own sample sets (its key 0). Against
    JAX's initialize_two_view, tests/test_torch_twoview.py's reference,
    at that file's tolerances; against its jitted namesake, whose float32
    rounding differs from that reference's by up to 1.4e-4 in t21 here
    (XLA's fusions; more than the file's 1e-4), the discrete outputs equal
    and R21, t21 and the points within the file's tolerances plus the gap
    between JAX's two routes on this input."""
    uv1, uv2, valid = make_pair(np.random.default_rng(1))
    with jax.enable_x64(False):
        k = jax.random.key(0)
        args = (jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid))
        samples = np.asarray(jtwoview._ransac_samples(k, args[2], jtwoview.N_RANSAC))
        K32 = jnp.asarray(K, jnp.float32)
        jits = jax.tree_util.tree_map(np.asarray, jtwoview.initialize_two_view_jit(
            k, *args, K32))
        ref = jax.tree_util.tree_map(np.asarray, jtwoview.initialize_two_view(k, *args, K32))
    pr = twoview.initialize_two_view_jit(_t(samples), _t(uv1), _t(uv2), _t(valid),
                                         _t(K.astype(np.float32)))
    good = pr.good.numpy()
    assert bool(pr.ok) and good.any()
    for jr in (ref, jits):
        assert bool(pr.ok) == bool(jr.ok)
        assert bool(pr.used_homography) == bool(jr.used_homography)
        np.testing.assert_array_equal(good, jr.good)
    gap = {f: np.abs(getattr(jits, f) - getattr(ref, f)) for f in ("t21", "points")}
    gap_deg = rot_deg(jits.R21, ref.R21)
    for jr, slack, slack_deg in ((ref, 0.0, 0.0), (jits, 1.0, 1.0)):
        assert rot_deg(pr.R21.numpy(), jr.R21) < TV_ROT_DEG + slack_deg * gap_deg
        assert (np.abs(pr.t21.numpy() - jr.t21) <= TV_T + slack * gap["t21"]).all()
        p, j = pr.points.numpy()[good], jr.points[good]
        bound = TV_PTS_RTOL * (np.abs(j) + np.abs(j).max()) + slack * gap["points"][good]
        assert (np.abs(p - j) <= bound).all()


def _pnp_problem():
    """tests/test_torch_pnp.py's four candidates against one frame: a
    scene's points with every row valid, with only its first 40 rows
    valid, garbage points, and a padded candidate with no valid row."""
    from orb_slam2_commit_tpu_torch.ops.lie import so3_exp

    rng = np.random.default_rng(3)
    n = 100
    X0 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1)
    R = lie.so3_exp(torch.from_numpy(rng.normal(0, 0.3, 3))).numpy()
    t = rng.normal(0, 0.5, 3) + np.array([0, 0, 0.5])
    pc = X0 @ R.T + t
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    out_idx = rng.choice(n, 30, replace=False)
    uv[out_idx] += rng.uniform(30, 120, (30, 2)) * rng.choice([-1, 1], (30, 2))
    X = np.stack([X0, X0, np.random.default_rng(8).uniform(-3, 3, (n, 3)) + [0, 0, 6],
                  np.tile(X0[:1], (n, 1))]).astype(np.float32)
    valid = np.ones((4, n), bool)
    valid[1, 40:] = False
    valid[3] = False
    return X, uv.astype(np.float32), valid, np.linspace(1.0, 2.0, n).astype(np.float32)


def test_epnp_ransac_many():
    X, uv, valid, sigma2 = _pnp_problem()
    args = (_t(RansacSampler(2).pnp(valid)), _t(X), _t(uv), _t(valid), _t(sigma2),
            FX, FY, CX, CY)
    got = pnp.epnp_ransac_many_jit(*args)
    assert same_bits(got, pnp.epnp_ransac_many(*args))
    np.testing.assert_array_equal(got.ok.numpy(), [True, True, False, False])


def test_epnp_ransac_many_jit_against_jax():
    """JAX's vmapped twin with its keys split as the tracker splits them,
    the port on the index sets those keys draw, at
    tests/test_torch_pnp.py's tolerances."""
    X, uv, valid, sigma2 = _pnp_problem()
    n = X.shape[1]
    with jax.enable_x64(False):
        keys = jax.random.split(jax.random.key(9), 4)
        jres = jpnp.epnp_ransac_many_jit(keys, jnp.asarray(X), jnp.asarray(uv),
                                         jnp.asarray(valid), jnp.asarray(sigma2),
                                         FX, FY, CX, CY)

        def draws(key, v):
            p = jnp.asarray(v, jnp.float32)
            p = p / jnp.maximum(jnp.sum(p), 1.0)
            return np.asarray(jax.vmap(lambda kk: jax.random.choice(
                kk, n, shape=(4,), replace=False, p=p))(jax.random.split(key, 128)))

        samples = np.stack([draws(keys[c], valid[c]) for c in range(4)])
    res = pnp.epnp_ransac_many_jit(_t(samples), _t(X), _t(uv), _t(valid), _t(sigma2),
                                   FX, FY, CX, CY)
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(jres.ok))
    assert (np.abs(res.n_inliers.numpy() - np.asarray(jres.n_inliers)) <= MASK_SLACK).all()
    flips = (res.inliers.numpy() != np.asarray(jres.inliers)).sum(-1)
    assert (flips <= MASK_SLACK).all(), flips
    for c in (0, 1):
        assert rot_deg(res.R[c].numpy(), np.asarray(jres.R[c])) < PNP_ROT_DEG
        np.testing.assert_allclose(res.t[c].numpy(), np.asarray(jres.t[c]), atol=PNP_T)


@pytest.fixture(scope="module")
def small_vocabulary(example):
    """A 4-branch, 3-level tree trained on both images' descriptors."""
    _, _, feats = example
    desc = np.concatenate([f.desc.numpy()[f.valid.numpy()] for f in feats]).view(np.uint32)
    return vocabulary.BinaryVocabulary.train(desc, k=4, levels=3, seed=0)


def test_descent(example, small_vocabulary):
    """The descent through its form, and transform (which calls it)
    against the eager descent."""
    _, _, (left, _) = example
    voc = small_vocabulary
    tables = voc.device_tables("cpu")
    got = vocabulary._descend_jit(left.desc, *tables, voc.levels, 1)
    want = vocabulary._descend(left.desc, *tables, voc.levels, 1)
    assert same_bits(got, want)
    words, nodes = voc.transform(left.desc, left.valid.numpy(), levels_up=1, device="cpu")
    v = left.valid.numpy()
    np.testing.assert_array_equal(words[v], want[0].numpy()[v])
    np.testing.assert_array_equal(nodes[v], want[1].numpy()[v])
    assert (words[~v] == -1).all() and np.unique(words[v]).size > 10


def test_descent_key_holds_the_tables_in_place(example, small_vocabulary):
    """The descent's graph key: the descriptors are its only tensor input;
    the tables are in its configuration by identity (the same tensors
    give the same key, another vocabulary's tables another key)."""
    _, _, (left, _) = example
    voc = small_vocabulary
    tables = voc.device_tables("cpu")

    def key(t):
        return cuda_graph.key(vocabulary._descend_tables, (left.desc,),
                              (vocabulary.DeviceTables(*t), voc.levels, 1))

    assert key(tables) == key(tuple(tables)) and hash(key(tables)) == hash(key(tables))
    other = vocabulary.BinaryVocabulary.train(
        left.desc.numpy()[left.valid.numpy()].view(np.uint32), k=4, levels=3, seed=1)
    assert key(other.device_tables("cpu")) != key(tables)
    assert key(tables)[-1] == (((N_FEAT, 8), torch.int32),)
