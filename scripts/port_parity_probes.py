"""CPU probes of the PyTorch port against the JAX package, for the records
in PERF.md and ROADMAP.md. Each prints what it measured; none needs a card.

    python scripts/port_parity_probes.py arc-ba      # ~1 min
    python scripts/port_parity_probes.py sim3-sums   # ~5 min
    python scripts/port_parity_probes.py systems     # ~3 min
    python scripts/port_parity_probes.py ring-640    # ~10 min
    python scripts/port_parity_probes.py init-carried  # ~3 min

arc-ba: the initial map's BA on the rotation-dominant arc of
    tests/test_robustness.py::TestRotationDominant. The port's System runs
    the arc up to its initialization and hands over its map just before
    the BA; that problem then goes through the port's LM iteration by
    iteration, once as the port solves it (the float64 step where the
    damping is under float32's epsilon, optim/ba.py _solve_step) and once
    with the float32 step at every iteration, and through the JAX
    package's LM in 32-bit mode: cost, damping, accept and step norm per
    iteration, then each solve's outcome (inliers, depth range), the JAX
    package's 64-bit solve's too.
sim3-sums: the loop closer's Sim3 sums on the closure that
    tests/test_torch_loop_closing.py carries across (the JAX closer's state
    just before its closing keyframe), on the unpadded route and with the
    pairs padded as the card pads them (LoopCloser.pad_pairs), under three
    designs of the sums in geometry/sim3_solver._horn_cov and
    optim/sim3_opt._optimize (cost, J^T J, J^T r): the library's (as the
    port ships them), float64 contractions rounded once, and a pairwise
    halving tree over a power of two. Per design: whether the two routes
    give the same bits, and each route's keyframe poses and points after
    the closure's global BA against the JAX closer's (max rotation in
    degrees, max |t|, max |point|; that test's bounds are 0.1 / 0.01 /
    0.03), and the whole 24-keyframe run's.
systems: the port's System on the three runs of the JAX tests that it
    lacked, at their sizes: the arc (also with the float32 step at every
    iteration of its BAs, as before the repair), the kidnap with the bundled
    vocabulary, the noisy monocular sweep rendered by the port's
    render_sequence(photo=...); frames tracked, points, ATE over the span
    and seconds (one thread, synchronous).
ring-640: the ring survey of tests/test_loop_pipeline.py
    (render_loop_sequence(frac=1.35, seed=4), 132 frames) at 640x480 and
    1000 features, no vocabulary, synchronous, through the JAX package's
    System and the port's: the first frame each initializes at, if any.
init-carried: tests/test_torch_system_mono.py's initialization on the JAX
    run's carried frames (the sweep; the JAX package's draws), the port's
    map after its initial BA against the JAX run's (max rotation in
    degrees, max |t|, max |point| over the largest |coordinate|), with the
    port's step and with the float32 step at every iteration (the parent's).
"""

import dataclasses
import inspect
import os
import sys
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
os.environ["ORB_DISTRIBUTED_GBA"] = "0"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from orb_slam2_commit_tpu_torch import interop  # noqa: E402
from orb_slam2_commit_tpu_torch.optim import ba  # noqa: E402
from orb_slam2_commit_tpu_torch.slam.system import System  # noqa: E402
from orb_slam2_commit_tpu_torch.slam.tracking import Tracker, build_ba_problem  # noqa: E402
from orb_slam2_commit_tpu_torch.utils import synthetic, trajectory  # noqa: E402
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config  # noqa: E402

torch.set_num_threads(1)


def arc_config():
    cfg = synthetic_config(width=400, height=300, n_features=500)
    return dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, min_matches_init=60))


def arc_pre_ba():
    """The port's map just before the arc's initial BA -> (assembled problem, config)."""
    cfg = arc_config()
    images, _, _ = synthetic.render_loop_sequence(cfg.camera, n_frames=60, frac=0.6, seed=4)
    rec = {}
    initial_ba = Tracker._initial_global_ba

    def spy(self, kf0, kf1, n_iters=20):
        rec.setdefault("pre", (interop.map_state_to_numpy(self.map), kf0, kf1))
        return initial_ba(self, kf0, kf1, n_iters)

    Tracker._initial_global_ba = spy
    try:
        sys_ = System(cfg, vocabulary=None, async_mapping=False, device="cpu")
        for i in range(60):
            sys_.track_monocular(images[i], i / 30.0)
            if "pre" in rec:
                print(f"initialized at frame {i}")
                break
    finally:
        Tracker._initial_global_ba = initial_ba
    pre, kf0, kf1 = rec["pre"]
    m = interop.map_state_from_numpy(pre)
    return build_ba_problem(m, np.array([kf1]), np.array([kf0]), np.where(m.pt_valid)[0],
                            cfg.orb, device="cpu"), cfg


def jax_problem(problem, dtype):
    from orb_slam2_commit_tpu.optim import ba as jba
    from orb_slam2_commit_tpu.optim.residuals import BAObservations as JObs

    def leaf(t):
        a = t.numpy()
        return jnp.asarray(a.astype(dtype) if a.dtype == np.float32 else a)

    return jba.BAProblem(R=leaf(problem.R), t=leaf(problem.t), fixed=leaf(problem.fixed),
                         points=leaf(problem.points), point_valid=leaf(problem.point_valid),
                         obs=JObs(*(leaf(getattr(problem.obs, f)) for f in JObs._fields)))


def outcome(name, R, t, points, inlier, cost, n_obs, n_pts):
    R, t, pts = (np.asarray(a, np.float64) for a in (R, t, points))
    depth = np.concatenate([(pts[:n_pts] @ R[k].T + t[k])[:, 2] for k in range(2)])
    print(f"{name}: cost {float(cost):.6g}, inliers {int(np.asarray(inlier)[:n_obs].sum())} "
          f"of {n_obs}, depths in both keyframes {depth.min():.4f} to {depth.max():.4f} "
          f"(median {np.median(depth):.4f}), keyframe 1's t {t[0]}")


def arc_ba():
    from orb_slam2_commit_tpu.optim import ba as jba
    from orb_slam2_commit_tpu.optim.residuals import CHI2_MONO, CHI2_STEREO

    asm, cfg = arc_pre_ba()
    P = asm.problem
    cam = cfg.camera
    cp = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    n_obs, n_pts = asm.obs_kf.size, asm.point_ids.size
    print(f"the initial BA: {n_pts} points, {n_obs} observations; float32's epsilon "
          f"{torch.finfo(torch.float32).eps:.4g}")
    wide = ba._solve_config(P, *cp, True, 512, 1e-4, "auto", n_iters=20)
    narrow = wide._replace(wide=False)
    segs = ba.obs_segments(P, wide.point_chunk, wide.solver)
    states = {"port": ba._lm_init(P, segs, wide), "port, float32 step": ba._lm_init(P, segs, wide)}
    with jax.enable_x64(False):
        jp = jax_problem(P, np.float32)
        ss = jba._make_segsums(jp.obs)
        delta2 = jnp.where(jp.obs.is_stereo, CHI2_STEREO, CHI2_MONO)

        def jcost(p):
            _, _, chi2, _, _, z = jba._evaluate(p, cp, True, p.obs.valid)
            return jba._robust_total_cost(chi2, delta2, p.obs.valid & (z > 0), True)

        jstate = [jp, jcost(jp), jnp.float32(1e-4)]
        for it in range(20):
            row = [f"it {it:2d}"]
            for name, cfg_ in (("port", wide), ("port, float32 step", narrow)):
                s = states[name]
                p = P._replace(R=s.R, t=s.t, points=s.points)
                dc, _ = ba._solve_step(p, segs, cp, True, P.obs.valid, s.lam, 512, "dense",
                                       wide=cfg_.wide)
                new = ba._lm_iteration(s, P, segs, cfg_)
                row.append(f"{name}: cost {float(s.cost):.6g} lam {float(s.lam):.3g} |dc| "
                           f"{float(dc.norm()):.4g} accept {bool(new.cost < s.cost)}")
                states[name] = new
            p, c, lam = jstate
            jdc, jdp = jba._solve_step(p, cp, True, p.obs.valid, lam, 512, None, "dense", ss,
                                       False)
            p_new = jba._apply_step(p, jdc, jdp)
            c_new = jcost(p_new)
            acc = bool(c_new < c)
            row.append(f"JAX 32-bit: cost {float(c):.6g} lam {float(lam):.3g} |dc| "
                       f"{float(jnp.linalg.norm(jdc)):.4g} accept {acc}")
            jstate = [p_new, c_new, lam * 0.5] if acc else [p, c, lam * 4.0]
            print(" | ".join(row))
    for name, cfg_ in (("port", wide), ("port, float32 step", narrow)):
        out, res = ba._result(states[name], P)
        outcome(name, out.R, out.t, out.points, res.inlier, res.cost, n_obs, n_pts)
    for x64, dtype in ((False, np.float32), (True, np.float64)):
        with jax.enable_x64(x64):
            out, res = jba.bundle_adjust_jit(jax_problem(P, dtype), *cp, n_iters=20,
                                             point_chunk=512)
            outcome(f"JAX {'64' if x64 else '32'}-bit", out.R, out.t, out.points, res.inlier,
                    res.cost, n_obs, n_pts)


# ----------------------------------------------------------------------------
# The Sim3 sums
# ----------------------------------------------------------------------------

def tree_sum(x, dim):
    """x summed along dim in a pairwise halving tree over the least power of
    two >= its length (zeros appended)."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    width = 1 << (n - 1).bit_length() if n > 1 else 1
    if width > n:
        x = torch.cat([x, x.new_zeros((width - n,) + x.shape[1:])])
    while x.shape[0] > 1:
        x = x[:x.shape[0] // 2] + x[x.shape[0] // 2:]
    return x[0]


def horn_cov_wide(x1, x2, weights=None):
    """_horn_cov with its contractions in float64, rounded once."""
    dtype = x1.dtype
    if weights is None:
        weights = torch.ones(x1.shape[:-1], dtype=dtype, device=x1.device)
    x1, x2, w = x1.double(), x2.double(), weights.double()
    wsum = torch.clamp_min(torch.sum(w, dim=-1), 1e-9)
    c1 = torch.sum(x1 * w[..., None], dim=-2) / wsum[..., None]
    c2 = torch.sum(x2 * w[..., None], dim=-2) / wsum[..., None]
    y1 = (x1 - c1[..., None, :]) * w[..., None]
    y2 = (x2 - c2[..., None, :]) * w[..., None]
    return tuple(a.to(dtype) for a in (y1.transpose(-1, -2) @ y2, c1, c2,
                                       torch.sum(y1 * y1, dim=(-1, -2)),
                                       torch.sum(y2 * y2, dim=(-1, -2))))


def horn_cov_tree(x1, x2, weights=None):
    """_horn_cov with its sums over the pairs in tree_sum."""
    if weights is None:
        weights = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    wsum = torch.clamp_min(tree_sum(weights, -1), 1e-9)
    c1 = tree_sum(x1 * weights[..., None], -2) / wsum[..., None]
    c2 = tree_sum(x2 * weights[..., None], -2) / wsum[..., None]
    y1 = (x1 - c1[..., None, :]) * weights[..., None]
    y2 = (x2 - c2[..., None, :]) * weights[..., None]

    def sq(y):
        return y[..., 0] * y[..., 0] + y[..., 1] * y[..., 1] + y[..., 2] * y[..., 2]

    return (tree_sum(y1[..., :, None] * y2[..., None, :], -3), c1, c2,
            tree_sum(sq(y1), -1), tree_sum(sq(y2), -1))


# The lines of sim3_opt._optimize each design replaces.
OPTIMIZE_SUMS = {
    "wide": {"return torch.sum(torch.where(active, c1 + c2, 0.0), dim=-1)":
             "return torch.sum(torch.where(active, c1 + c2, 0.0).double(), dim=-1).to(dtype)",
             "H = J.T @ J": "H = (J.double().T @ J.double()).to(dtype)",
             "g = J.T @ r0": "g = (J.double().T @ r0.double()).to(dtype)"},
    "tree": {"return torch.sum(torch.where(active, c1 + c2, 0.0), dim=-1)":
             "return tree_sum(torch.where(active, c1 + c2, 0.0), -1)",
             "H = J.T @ J": "H = tree_sum(J[:, :, None] * J[:, None, :], 0)",
             "g = J.T @ r0": "g = tree_sum(J * r0[:, None], 0)"},
}


def optimize_variant(design):
    """sim3_opt._optimize with its three sums replaced by the design's."""
    from orb_slam2_commit_tpu_torch.optim import sim3_opt

    src = textwrap.dedent(inspect.getsource(sim3_opt._optimize))
    for old, new in OPTIMIZE_SUMS[design].items():
        if old not in src:
            raise SystemExit(f"sim3_opt._optimize no longer holds {old!r}")
        src = src.replace(old, new)
    scope = dict(vars(sim3_opt), tree_sum=tree_sum)
    exec(compile(src, sim3_opt.__file__, "exec"), scope)
    return scope["_optimize"]


def sim3_sums():
    import test_torch_loop_closing as T
    from orb_slam2_commit_tpu_torch.geometry import sim3_solver
    from orb_slam2_commit_tpu_torch.optim import sim3_opt
    from orb_slam2_commit_tpu_torch.slam.loop_closing import LoopCloser

    shipped = (sim3_solver._horn_cov, sim3_opt._optimize)
    designs = {"library (shipped)": shipped,
               "float64 contractions": (horn_cov_wide, optimize_variant("wide")),
               "halving tree": (horn_cov_tree, optimize_variant("tree"))}

    def gaps(got, want, n):
        rot = max(T.rot_angle(got["kf_pose_R"][k], want["kf_pose_R"][k]) for k in range(n))
        pts = np.where(want["pt_valid"])[0]
        return (round(rot, 4), round(float(np.abs(got["kf_pose_t"][:n]
                                                  - want["kf_pose_t"][:n]).max()), 4),
                round(float(np.abs(got["pt_pos"][pts] - want["pt_pos"][pts]).max()), 4))

    for name, (horn_cov, optimize) in designs.items():
        sim3_solver._horn_cov, sim3_opt._optimize = horn_cov, optimize
        try:
            runs = T._loop_runs()
            c = runs["carried"]
            whole = gaps(interop.map_state_to_numpy(runs["pm"]),
                         interop.map_state_to_numpy(runs["jm"]), T.K_KF)
            routes = {}
            for pad in (False, True):
                calls = []
                forms = (sim3_solver.sim3_ransac_jit, sim3_opt.optimize_sim3_jit)

                def spy(fn):
                    def call(*a, **k):
                        calls.append(fn(*a, **k))
                        return calls[-1]
                    return call

                sim3_solver.sim3_ransac_jit, sim3_opt.optimize_sim3_jit = map(spy, forms)
                try:
                    pm = interop.map_state_from_numpy(c["map"])
                    closer = LoopCloser(runs["pcloser"].config, pm, interop.database_from_numpy(
                        c["db"], runs["pcloser"].db.voc, device="cpu"), device="cpu")
                    interop.loop_closer_state_into(closer, c["closer"])
                    closer.sampler = T.Sim3Sampler(c["key"])
                    closer.pad_pairs = pad
                    assert closer.process_keyframe(c["kf"])
                finally:
                    sim3_solver.sim3_ransac_jit, sim3_opt.optimize_sim3_jit = forms
                routes[pad] = (calls, gaps(interop.map_state_to_numpy(pm), c["after"],
                                           c["kf"] + 1))
        finally:
            sim3_solver._horn_cov, sim3_opt._optimize = shipped
        same = len(routes[False][0]) == len(routes[True][0])
        for a, b in zip(routes[False][0], routes[True][0]):
            for f in a._fields:
                x, y = getattr(a, f), getattr(b, f)
                same &= torch.equal(x, y[:x.shape[0]] if x.dim() else y)
        print(f"{name}: RANSAC and LM outputs of the two routes bit-identical: {same}; after "
              f"global BA against JAX (deg, |t|, |point|): unpadded {routes[False][1]}, "
              f"padded {routes[True][1]}; the whole run (unpadded) {whole}", flush=True)


def systems():
    from orb_slam2_commit_tpu_torch.slam.tracking import TrackingState

    def run(name, cfg, images, poses_gt, span_of, vocabulary, blank=()):
        t0 = time.perf_counter()
        sys_ = System(cfg, vocabulary=vocabulary, async_mapping=False, device="cpu")
        poses, states = [], []
        flat = np.full_like(images[0], 96.0)
        for i in range(images.shape[0]):
            poses.append(sys_.track_monocular(flat if i in blank else images[i], i / 30.0))
            states.append(sys_.tracker.state)
        seconds = time.perf_counter() - t0
        est = sys_.trajectory_positions()
        lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
        gt = np.asarray([-R.T @ t for R, t in poses_gt])
        rmse = trajectory.ate_rmse(est[~lost], gt[len(gt) - len(est):][~lost], align_scale=True)
        extra = ""
        if blank:
            extra = (f", LOST in the blank frames {TrackingState.LOST in states[22:27]}, "
                     f"last relocalization at frame {sys_.tracker.last_reloc_frame_id}")
        print(f"{name}: {sum(p is not None for p in poses)} of {len(poses)} frames tracked, "
              f"final state {states[-1].name}, {sys_.map.n_points()} points, ATE / span "
              f"{rmse / span_of(gt):.5f}{extra}, {seconds:.1f} s", flush=True)

    cfg = arc_config()
    images, poses, _ = synthetic.render_loop_sequence(cfg.camera, n_frames=60, frac=0.6, seed=4)
    run("arc", cfg, images, poses, lambda gt: np.abs(gt).max() * 2, None)
    config = ba._solve_config
    ba._solve_config = lambda *a, **k: config(*a, **k)._replace(wide=False)
    try:
        run("arc, the float32 step at every iteration", cfg, images, poses,
            lambda gt: np.abs(gt).max() * 2, None)
    finally:
        ba._solve_config = config
    cfg = synthetic_config(width=400, height=300, n_features=1000)
    sweep = dict(n_points=500, seed=3, step=0.025, motion="sweep", depth_range=(1.5, 4.0),
                 spread=2.0)
    images, poses, _ = synthetic.render_sequence(cfg.camera, n_frames=40, **sweep)
    run("kidnap, bundled vocabulary", cfg, images, poses,
        lambda gt: np.linalg.norm(gt[-1] - gt[0]), "default", blank=range(22, 27))
    photo = synthetic.Photometry(noise_sigma=3.0, shot_noise=2.0, gain_range=(0.8, 1.2),
                                 bias_range=(-6.0, 6.0), motion_blur_frac=0.5,
                                 motion_blur_max_px=4.0)
    images, poses, _ = synthetic.render_sequence(cfg.camera, n_frames=60, photo=photo, **sweep)
    run("noisy sweep, bundled vocabulary", cfg, images, poses,
        lambda gt: np.linalg.norm(gt[-1] - gt[0]), "default")


def ring_640():
    from orb_slam2_commit_tpu.slam.system import System as JSystem
    from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config

    for name, make, config in (
            ("JAX", lambda c: JSystem(c, vocabulary=None, async_mapping=False),
             j_synthetic_config),
            ("port", lambda c: System(c, vocabulary=None, async_mapping=False, device="cpu"),
             synthetic_config)):
        cfg = config(width=640, height=480, n_features=1000)
        images, _, _ = synthetic.render_loop_sequence(cfg.camera, n_frames=132, frac=1.35,
                                                      seed=4)
        t0 = time.perf_counter()
        sys_ = make(cfg)
        first = None
        for i in range(images.shape[0]):
            sys_.track_monocular(images[i], i / 30.0)
            if first is None and sys_.map.n_keyframes() > 0:
                first = i
        print(f"{name}: {images.shape[0]} frames at 640x480 / 1000 features, initialized at "
              f"frame {first}, {sys_.map.n_keyframes()} keyframes at the end, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def init_carried():
    import test_torch_system_mono as T
    from orb_slam2_commit_tpu_torch.models.map_state import MapState
    from orb_slam2_commit_tpu_torch.slam.tracking import TrackingState

    _, _, rec, _ = T.jax_run.__wrapped__()
    want = rec["init_out"]
    cfg = synthetic_config(width=T.W, height=T.H, n_features=T.N_FEAT)
    config = ba._solve_config
    for name, narrow in (("port", False), ("float32 step", True)):
        ba._solve_config = ((lambda *a, **k: config(*a, **k)._replace(wide=False)) if narrow
                            else config)
        try:
            ms = MapState.create(cfg.map, 2 * T.N_FEAT)
            tracker = Tracker(cfg, ms, device="cpu")
            tracker.sampler = T.JaxSampler(rec["init_in"]["key"])
            tracker.state = TrackingState.NOT_INITIALIZED
            tracker.init_ref_frame = interop.frame_from_numpy(rec["init_in"]["ref"], device="cpu")
            assert tracker._try_initialize_mono(
                interop.frame_from_numpy(rec["init_in"]["frame"], device="cpu"))
        finally:
            ba._solve_config = config
        got = interop.map_state_to_numpy(ms)
        valid = want["pt_valid"]
        w = want["pt_pos"][valid]
        rot = max(T.rot_angle(got["kf_pose_R"][k], want["kf_pose_R"][k])
                  for k in range(want["next_kf"]))
        dt = np.abs(got["kf_pose_t"][:want["next_kf"]] - want["kf_pose_t"][:want["next_kf"]]).max()
        dp = np.abs(got["pt_pos"][valid] - w).max() / np.abs(w).max()
        print(f"{name}: after the initial BA against JAX's: rotation {rot:.3g} deg, |t| "
              f"{dt:.3g}, |point| {dp:.3g} of the largest coordinate", flush=True)


if __name__ == "__main__":
    probes = {"init-carried": init_carried, "arc-ba": arc_ba, "sim3-sums": sim3_sums, "systems": systems,
              "ring-640": ring_640}
    if len(sys.argv) != 2 or sys.argv[1] not in probes:
        raise SystemExit(f"usage: {sys.argv[0]} {{{','.join(probes)}}}")
    probes[sys.argv[1]]()
