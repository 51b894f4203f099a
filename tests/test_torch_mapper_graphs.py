"""The mapper's and the loop closer's single-dispatch forms on the CPU:
`optim/ba.py`'s device-loop form (`bundle_adjust_loop`, behind
`bundle_adjust_jit` on the card), `optim/pose_graph.py`'s block-replay
form (`optimize_sim3_graph_blocks`, behind `optimize_sim3_graph_jit`), the
mapper's two `*_jit` forms (`slam/jit_mapper.py`), and the padded segment
tables (`optim/segment.py`) that key their CUDA graphs.

- The device-loop form runs every LM iteration and every CG iteration
  with nothing read on the host (an iteration past the exit test keeps
  the carry by selects); it equals the early-exit form (`bundle_adjust`)
  bit for bit: dense and PCG, robust and not, a problem that converges
  early, the stalled problem of tests/test_torch_ba.py (no valid
  observation), a failed solve, a singular preconditioner block, and
  local BA's two stages. Against the JAX package's bundle_adjust_jit at
  tests/test_torch_ba.py's tolerances.
- The pose graph's block-replay form (the CG in blocks, a carried count
  masking iterations past the cap) equals the eager loop bit for bit on
  tests/test_torch_sim3.py's 12-vertex loop with scale drift, dense and
  PCG, and matches the JAX package's optimize_sim3_graph_jit there at
  tests/test_torch_loop_closing.py's tolerances.
- Each new `*_jit` form's parameters are its JAX namesake's, and on CPU
  tensors it calls its eager function and makes no CUDA graph.
- A padded table's width is the least power of two over its longest
  segment, its sums equal index_add_'s, and two problems whose widths
  fall in one bucket share a graph key.
Each JAX function is compiled once. Nothing launches a kernel here.
"""

import inspect
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.optim import ba as jba
from orb_slam2_commit_tpu.optim import pose_graph as jpg
from orb_slam2_commit_tpu.optim.residuals import BAObservations as JObs
from orb_slam2_commit_tpu.slam import jit_mapper as jjm
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.optim import ba, pose_graph, segment
from orb_slam2_commit_tpu_torch.optim.residuals import BAObservations
from orb_slam2_commit_tpu_torch.slam import jit_mapper
from orb_slam2_commit_tpu_torch.utils import cuda_graph

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_ba import CX, CY, FX, FY, _problem, assert_close, make_problem  # noqa: E402
from test_torch_loop_closing import ROT_DEG_TOL, T_TOL  # noqa: E402
from test_torch_sim3 import _centres, _scale_drift_graph, _to32  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """One thread; on the CPU nothing launches and no graph is made."""
    torch.set_num_threads(1)

    def no_graph(*args, **kwargs):
        raise AssertionError("a CUDA graph was made on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    before, graphs = dict(_build.launches), dict(cuda_graph.graphs)
    yield
    assert _build.launches == before
    assert cuda_graph.graphs == graphs


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits (floats as integers of their width: NaNs compare)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def assert_same_bits(a, b):
    (pa, ra), (pb, rb) = a, b
    for name, x, y in [(f"problem.{k}", getattr(pa, k), getattr(pb, k))
                       for k in ("R", "t", "points")] + \
            [("obs.valid", pa.obs.valid, pb.obs.valid)] + \
            [(f"result.{k}", getattr(ra, k), getattr(rb, k)) for k in ra._fields]:
        assert x.dtype == y.dtype and torch.equal(bits(x), bits(y)), name


def _nan_first_step(monkeypatch):
    """_solve_step returns a NaN step at its first call of each solve
    form (tests/test_torch_ba.py's failed solve)."""
    solve, calls = ba._solve_step, []

    def failing_first(*args, **kwargs):
        delta_c, delta_p = solve(*args, **kwargs)
        calls.append(1)
        if len(calls) == 1:
            return torch.full_like(delta_c, torch.nan), torch.full_like(delta_p, torch.nan)
        return delta_c, delta_p

    monkeypatch.setattr(ba, "_solve_step", failing_first)
    return calls


def _singular_block(monkeypatch):
    """_schur_pcg gets camera 3's damped block zeroed: its preconditioner
    block is singular."""
    pcg = ba._schur_pcg

    def singular(Hcc_d, *args, **kwargs):
        Hcc_d = Hcc_d.clone()
        Hcc_d[3] = 0.0
        return pcg(Hcc_d, *args, **kwargs)

    monkeypatch.setattr(ba, "_schur_pcg", singular)


# case -> (make_problem's arguments, the solve's, a patch or None)
LOOP_CASES = {
    "dense_robust": (dict(seed=2, noise=0.3), dict(n_iters=12, point_chunk=128,
                                                   solver="dense"), None),
    "dense_plain": (dict(seed=2, noise=0.3), dict(n_iters=12, point_chunk=128, solver="dense",
                                                  use_robust=False), None),
    "pcg_robust": (dict(seed=22, n_cams=8), dict(n_iters=12, point_chunk=64, solver="pcg"),
                   None),
    "pcg_stereo_plain": (dict(seed=4, noise=0.2, stereo_bf=40.0),
                         dict(n_iters=10, solver="pcg", use_robust=False), None),
    "converges_early": (dict(seed=0), dict(n_iters=40, point_chunk=64, solver="dense"), None),
    "stalled": (dict(seed=6, noise=0.2), dict(n_iters=40, point_chunk=64, solver="dense"),
                "stalled"),
    "failed_solve": (dict(seed=6, noise=0.2), dict(n_iters=4, solver="dense"), _nan_first_step),
    "singular_block": (dict(seed=22, n_cams=8), dict(n_iters=3, solver="pcg"), _singular_block),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_device_loop_equals_early_exit(case, monkeypatch):
    make_kw, kw, patch = LOOP_CASES[case]
    a, _, _ = make_problem(**make_kw)
    if patch == "stalled":
        a = dict(a, valid=np.zeros_like(a["valid"]))
    problem = _problem(ba, BAObservations, a, torch.from_numpy)
    bf = make_kw.get("stereo_bf", 0.0)
    iters = []
    step = ba._lm_iteration

    def counted(*args, **kwargs):
        iters[-1] += 1
        return step(*args, **kwargs)

    monkeypatch.setattr(ba, "_lm_iteration", counted)
    out = {}
    for form in ("bundle_adjust", "bundle_adjust_loop"):
        calls = patch(monkeypatch) if callable(patch) else None
        iters.append(0)
        out[form] = getattr(ba, form)(problem, FX, FY, CX, CY, bf, **kw)
        if calls is not None:
            assert len(calls) >= 1
    assert_same_bits(out["bundle_adjust"], out["bundle_adjust_loop"])
    early, looped = iters
    assert looped == kw["n_iters"]
    result = out["bundle_adjust"][1]
    if case == "converges_early":
        assert early < kw["n_iters"]
    elif case == "stalled":
        # Every step rejected until the damping passes 1e8 (20 steps).
        assert early < kw["n_iters"] and float(result.cost) == 0.0
        for k in ("R", "t", "points"):
            assert torch.equal(getattr(out["bundle_adjust"][0], k), getattr(problem, k))
    elif case in ("failed_solve", "singular_block"):
        assert torch.isfinite(out["bundle_adjust"][0].R).all()
        assert float(result.cost) > 0


def test_local_bundle_adjust_stages_equal(monkeypatch):
    """Local BA's two stages, through the early-exit form (the CPU's) and
    through the device-loop form, on the stages' shared tables."""
    a, _, bad = make_problem(seed=3, noise=0.2, outliers=0.05)
    problem = _problem(ba, BAObservations, a, torch.from_numpy)
    early = ba.local_bundle_adjust(problem, FX, FY, CX, CY, 0.0, point_chunk=128)
    monkeypatch.setattr(ba, "bundle_adjust_jit", ba.bundle_adjust_loop)
    looped = ba.local_bundle_adjust(problem, FX, FY, CX, CY, 0.0, point_chunk=128)
    assert_same_bits(early, looped)
    assert not early[1].inlier.numpy()[bad].any()


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_device_loop_matches_jax(solver):
    make_kw, kw = ((dict(seed=2, noise=0.3), dict(n_iters=12, point_chunk=128))
                   if solver == "dense" else
                   (dict(seed=22, n_cams=8, n_pts=200), dict(n_iters=12, point_chunk=64)))
    a, _, _ = make_problem(**make_kw)
    with jax.enable_x64(False):
        jout, jres = jba.bundle_adjust_jit(_problem(jba, JObs, a, jnp.asarray), FX, FY, CX, CY,
                                           0.0, solver=solver, **kw)
        want = {k: np.asarray(v) for k, v in (("R", jout.R), ("t", jout.t),
                                              ("points", jout.points),
                                              ("inlier", jres.inlier), ("cost", jres.cost))}
    out, res = ba.bundle_adjust_loop(_problem(ba, BAObservations, a, torch.from_numpy),
                                     FX, FY, CX, CY, 0.0, solver=solver, **kw)
    got = {k: v.numpy() for k, v in (("R", out.R), ("t", out.t), ("points", out.points),
                                     ("inlier", res.inlier), ("cost", res.cost))}
    tols = {} if solver == "dense" else dict(rot_tol=5e-3, t_tol=2e-3, pt_tol=5e-3)
    assert_close(got, want, a, **tols)


@pytest.fixture(scope="module")
def scale_graph():
    """tests/test_torch_sim3.py's 12-vertex loop with scale drift, float32
    numpy leaves."""
    jgraph, _, _ = _scale_drift_graph()
    return _to32(jgraph)


def _torch_graph(g32):
    return pose_graph.Sim3Graph(*(
        torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a) for a in g32))


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_block_form_equals_eager_loop(scale_graph, solver):
    graph = _torch_graph(scale_graph)
    eager = pose_graph.optimize_sim3_graph(graph, n_iters=6, solver=solver)
    blocks = pose_graph.optimize_sim3_graph_blocks(graph, n_iters=6, solver=solver)
    # K = 12: the cap is 176 CG iterations, three blocks of 64 run 192.
    assert pose_graph.CG_BLOCK * 3 > 4 * 12 + 128
    for k in ("s", "R", "t"):
        assert torch.equal(bits(getattr(eager, k)), bits(getattr(blocks, k))), k
    assert not torch.equal(eager.t, graph.t)


def test_block_form_matches_jax(scale_graph):
    with jax.enable_x64(False):
        out = jpg.optimize_sim3_graph_jit(jpg.Sim3Graph(*(jnp.asarray(a) for a in scale_graph)),
                                          n_iters=25, fix_scale=False, solver="dense")
        want = [np.asarray(a, np.float64) for a in (out.s, out.R, out.t)]
    got = pose_graph.optimize_sim3_graph_blocks(_torch_graph(scale_graph), n_iters=25,
                                                fix_scale=False, solver="dense")
    s, R, t = (getattr(got, k).numpy().astype(np.float64) for k in ("s", "R", "t"))
    for k in range(R.shape[0]):
        c = np.clip((np.trace(R[k].T @ want[1][k]) - 1) / 2, -1, 1)
        assert np.degrees(np.arccos(c)) < ROT_DEG_TOL, k
    # Sim3 poses: the translation's scale is the vertex's, so compare the
    # camera centres and the scales.
    assert np.abs(_centres(R, t / s[:, None]) - _centres(want[1], want[2] / want[0][:, None])
                  ).max() < T_TOL
    np.testing.assert_allclose(s, want[0], atol=T_TOL, rtol=0)
    assert np.abs(_centres(R, t) - _centres(scale_graph.R, scale_graph.t)).max() > 0.1


# form -> (the port's module, the JAX package's)
FORMS = {"bundle_adjust_jit": (ba, jba), "optimize_sim3_graph_jit": (pose_graph, jpg),
         "fused_triangulation_jit": (jit_mapper, jjm),
         "fused_fuse_forward_jit": (jit_mapper, jjm)}


@pytest.mark.parametrize("form", list(FORMS))
def test_parameters_are_the_jax_namesakes(form):
    """JAX's parameters in JAX's order; bundle_adjust_jit adds one
    keyword-only parameter of its own (segs: the tables a caller made)."""
    port_mod, jax_mod = FORMS[form]
    params = inspect.signature(getattr(port_mod, form)).parameters.values()
    jax_fn = getattr(jax_mod, form)
    jax_params = list(inspect.signature(getattr(jax_fn, "__wrapped__", jax_fn)).parameters)
    assert [p.name for p in params if p.kind != p.KEYWORD_ONLY] == jax_params
    assert [p.name for p in params if p.kind == p.KEYWORD_ONLY] == (
        ["segs"] if form == "bundle_adjust_jit" else [])


def _mapper_args(form):
    """Small CPU arguments of a mapper form (zeros in JAX's layouts)."""
    n, b, p = 64, 4, 256
    if form == "fused_triangulation_jit":
        return (torch.zeros(n, jit_mapper.TRI_FEAT_COLS), torch.zeros(n, 8, dtype=torch.int32),
                torch.zeros(b, n, jit_mapper.TRI_FEAT_COLS),
                torch.zeros(b, n, 8, dtype=torch.int32), torch.zeros(b, jit_mapper.TRI_PAIR_COLS),
                torch.zeros(jit_mapper.TRI_META_LEN))
    return (torch.zeros(p, jit_mapper.FUSE_PT_COLS), torch.zeros(p, 8, dtype=torch.int32),
            torch.zeros(b, n, jit_mapper.FUSE_FEAT_COLS), torch.zeros(b, n, 8, dtype=torch.int32),
            torch.zeros(b, jit_mapper.FUSE_TGT_COLS))


@pytest.mark.parametrize("form", list(FORMS))
def test_cpu_form_is_the_eager_function(form, monkeypatch, scale_graph):
    """On CPU tensors a form calls its eager function once, on the very
    arguments it was given, and returns that call's result itself."""
    module = FORMS[form][0]
    eager = {"bundle_adjust_jit": "bundle_adjust",
             "optimize_sim3_graph_jit": "optimize_sim3_graph"}.get(form, form[:-4])
    calls, result = [], object()

    def spy(*a, **kw):
        calls.append((a, kw))
        return result

    monkeypatch.setattr(module, eager, spy)
    if form == "bundle_adjust_jit":
        a, _, _ = make_problem(seed=0)
        args = (_problem(ba, BAObservations, a, torch.from_numpy), FX, FY, CX, CY, 0.0)
    elif form == "optimize_sim3_graph_jit":
        args = (_torch_graph(scale_graph),)
    else:
        args = _mapper_args(form) + (object(),)
    assert getattr(module, form)(*args) is result
    assert len(calls) == 1
    got = calls[0][0]
    assert all(x is y for x, y in zip(got, args)) and len(got) >= len(args)


@pytest.mark.parametrize("width", [1, 3, 4, 5, 100, 128, 129])
def test_padded_table_width_and_sums(width):
    """Ids with a longest segment of `width` rows (and rows left out): the
    table's width is the least power of two >= width, its padded columns
    gather the zero row, its sums equal index_add_'s, and neither a wider
    table nor zero rows kept in it change a bit."""
    rng = np.random.default_rng(width)
    idx = np.concatenate([np.zeros(width, int), rng.integers(1, 9, 3 * width)])
    include = np.ones(idx.size, bool)
    include[width:] = rng.random(3 * width) < 0.3
    idx, include = torch.from_numpy(idx), torch.from_numpy(include)
    vals = torch.from_numpy(rng.normal(size=(idx.numel(), 6)))
    seg = segment.segments(idx, 9, include, ordered=True)
    L = seg.gather.shape[1]
    assert L == 1 << (width - 1).bit_length() and L >= width and L < 2 * width + 1
    assert int((seg.gather[0] < idx.numel()).sum()) == width
    want = torch.zeros(9, 6, dtype=torch.float64).index_add_(0, idx[include], vals[include])
    got = segment.segment_sum(vals, seg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12, rtol=0)
    # A running sum along the rows: more padded columns, or a dropped row
    # kept in place (it gathers a zero), change no bit.
    wide = seg._replace(gather=torch.cat([seg.gather, torch.full((9, L), idx.numel())], 1))
    assert torch.equal(segment.segment_sum(vals, wide), got)
    zeroed = torch.where(torch.rand(idx.numel(), generator=torch.Generator().manual_seed(width))
                         [:, None] < 0.2, 0.0, vals)
    kept = segment.segments(idx, 9, include, ordered=True)
    dropped = segment.segments(idx, 9, include & (zeroed != 0).any(1), ordered=True)
    assert torch.equal(segment.segment_sum(zeroed, kept), segment.segment_sum(zeroed, dropped))


def test_widths_in_one_bucket_share_a_key():
    """One padded BA problem's PCG tables with camera 0's segment cut to
    100, 90 and 60 rows (the other cameras' to 50): the first two fall in
    one bucket and share the graph key of an LM iteration, the third does
    not."""
    a, _, _ = make_problem(seed=5, noise=0.2, pad=(2, 56, 300))
    problem = _problem(ba, BAObservations, a, torch.from_numpy)
    cfg = ba._solve_config(problem, FX, FY, CX, CY, 0.0, True, 1024, 1e-4, "pcg", early=False)
    obs = problem.obs
    K, P = problem.R.shape[0], problem.points.shape[0]
    state = ba._lm_init(problem, None, cfg)

    def key_of(n0):
        keep = obs.valid.clone()
        for k in range(K):
            rows = torch.where((obs.cam_idx == k) & obs.valid)[0]
            keep[rows[n0 if k == 0 else 50:]] = False
        segs = ba.ObsSegments(segment.segments(obs.cam_idx, K, keep, ordered=True),
                              segment.segments(obs.pt_idx, P, obs.valid, ordered=True), ())
        return cuda_graph.key(ba._lm_iteration, (state, problem, segs), cfg), \
            segs.cam.gather.shape[1]

    (k1, w1), (k2, w2), (k3, w3) = key_of(100), key_of(90), key_of(60)
    assert (w1, w2, w3) == (128, 128, 64)
    assert k1 == k2 and hash(k1) == hash(k2) and k3 != k1


def test_release_drops_the_graphs_of_a_function(monkeypatch):
    """release(owner, ...) drops the graphs captured for a function (the
    solvers' graphs carry no SLAMConfig) as well as under a configuration,
    and leaves the others."""
    x = (torch.zeros(2),)
    cfg = object()
    keys = [cuda_graph.key(fn, x, c) for fn, c in ((ba._lm_init, None), (ba._lm_iteration, None),
                                                   (pose_graph._init, None),
                                                   (jit_mapper.fused_fuse_forward, cfg))]
    monkeypatch.setattr(cuda_graph, "graphs", {k: object() for k in keys})
    assert cuda_graph.release(*ba.GRAPHED) == 2
    assert list(cuda_graph.graphs) == keys[2:]
    assert cuda_graph.release(cfg, *pose_graph.GRAPHED) == 2 and not cuda_graph.graphs
