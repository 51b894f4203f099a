"""K7 under a candidate test (kernels/matching.valid_hamming_top2,
window_hamming_top2 and epipolar_hamming_top2, their plain versions on CPU
tensors) against the JAX package's Pallas kernel `masked_hamming_top2` in
interpret mode, under the mask that the JAX matcher of each test builds:
match_brute_force's validity product (slam/matchers.py), match_for_
initialization's flags and window mask, and match_for_triangulation's
flags, far_from_epipole and ops/matching.epipolar_mask, all in float32.
All four outputs are held equal, index fallbacks included, on
interop.CANDIDATE_CASES: single problems, B problems with the row or the
column tables shared, ties, and the edges (rows with no candidate and with
one, the window's and the band's exact edges, degenerate and overflowing
epipolar lines, NaN coordinates under every clear flag). The port's own
mask expressions equal JAX's, and each wrapper equals masked_hamming_top2
under its mask; the flags and tests that match_for_triangulation and
match_for_initialization hand to the kernel equal the masks they built
before (triangulation_mask, the window mask). The three matchers reach K7
through these wrappers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import matching as jmatching
from orb_slam2_commit_tpu.ops import pallas_matching as jpm
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.kernels import matching as kmatching
from orb_slam2_commit_tpu_torch.ops import matching
from orb_slam2_commit_tpu_torch.slam import matchers

torch.set_num_threads(1)

# match_for_triangulation's epipole gate, with epipoles in the image so
# that it rejects some columns.
MIN_EPIPOLE_DIST2 = 60.0 ** 2

WRAPPERS = {"valid": kmatching.valid_hamming_top2,
            "window": kmatching.window_hamming_top2,
            "epipolar": kmatching.epipolar_hamming_top2}


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before


def _t(a):
    if isinstance(a, float):
        return a
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _problem(kw):
    """The case's wrapper arguments (numpy), with the epipolar cases'
    column flags through the JAX triangulation matcher's epipole gate, and
    B (0: one problem)."""
    args = list(interop.candidate_problem(**kw))
    if kw["test"] == "epipolar":
        col_ok, xy_b = args[3], args[5]
        rng = np.random.default_rng(kw["seed"] + 100)
        epi = rng.uniform(100, 400, (2,) if xy_b.ndim == 2 else (xy_b.shape[0], 2))
        args.append(epi.astype(np.float32))
    return args, kw.get("b", 0)


def _jax_far(xy_b, epipole):
    """JAX match_for_triangulation's far_from_epipole (32-bit)."""
    de = jnp.asarray(xy_b) - jnp.asarray(epipole)[None]
    return np.asarray(jnp.sum(de * de, axis=1) >= MIN_EPIPOLE_DIST2)


def _pick(a, i, batched):
    return a[i] if batched else a


def _jax_reference(test, args, b):
    """Per problem: the JAX matcher's mask and the Pallas kernel's four
    outputs under it -> (masks [B?, M, N], outputs [B?, M] each)."""
    da, db, row_ok, col_ok = args[:4]
    masks, outs = [], []
    with jax.enable_x64(False):
        for i in range(max(b, 1)):
            def p(a, rank):
                return _pick(a, i, b and a.ndim > rank)
            ra, cb, rk, ck = p(da, 2), p(db, 2), p(row_ok, 1), p(col_ok, 1)
            if test == "valid":
                mask = jnp.asarray(rk)[:, None] & jnp.asarray(ck)[None, :]
            elif test == "window":
                xa, xb = p(args[4], 2), p(args[5], 2)
                mask = (jnp.asarray(rk)[:, None] & jnp.asarray(ck)[None, :]
                        & jmatching.window_mask(jnp.asarray(xa), jnp.asarray(xb), args[6]))
            else:
                xa, xb, F, s2, epi = (p(args[4], 2), p(args[5], 2), p(args[6], 2),
                                      p(args[7], 1), p(args[8], 1))
                far = _jax_far(xb, epi)
                mask = (jnp.asarray(rk)[:, None] & jnp.asarray(ck & far)[None, :]
                        & jmatching.epipolar_mask(jnp.asarray(xa), jnp.asarray(xb),
                                                  jnp.asarray(F), jnp.asarray(s2)))
            mask = np.asarray(mask)
            masks.append(mask)
            outs.append([np.asarray(o) for o in jpm.masked_hamming_top2(
                jnp.asarray(ra), jnp.asarray(cb), jnp.asarray(mask), interpret=True)])
    if not b:
        return masks[0], outs[0]
    return np.stack(masks), [np.stack(o) for o in zip(*outs)]


def _port_args(test, args):
    """The wrapper's tensors; the epipolar test's column flags through the
    port's triangulation gate (matchers._triangulation_terms)."""
    t = [_t(a) for a in args]
    if test == "epipolar":
        xy_b, epi = t[5], t.pop()
        _, far = matchers._triangulation_terms(
            xy_b, torch.zeros(xy_b.shape[:-1], dtype=torch.int32), epi,
            torch.tensor(MIN_EPIPOLE_DIST2, dtype=torch.float32), 8, 1.2)
        t[3] = t[3] & far
    return t


def _port_mask(test, t):
    """The port matcher's mask expression on the wrapper's arguments."""
    row_ok, col_ok = t[2], t[3]
    mask = row_ok[..., :, None] & col_ok[..., None, :]
    if test == "window":
        mask = mask & matching.window_mask(t[4], t[5], t[6])
    elif test == "epipolar":
        mask = mask & matching.epipolar_mask(t[4], t[5], t[6], t[7])
    return mask


@pytest.mark.parametrize("case", sorted(interop.CANDIDATE_CASES))
def test_wrapper_equals_pallas_under_the_jax_mask(case):
    kw = interop.CANDIDATE_CASES[case]
    test = kw["test"]
    args, b = _problem(kw)
    want_mask, want = _jax_reference(test, args, b)
    t = _port_args(test, args)
    got = WRAPPERS[test](*t)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    # The port's mask is JAX's, and the form equals K7 under that mask.
    mask = _port_mask(test, t).expand(want_mask.shape)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    under_mask = kmatching.masked_hamming_top2(t[0], t[1], mask.contiguous())
    for g, w in zip(got, under_mask):
        assert torch.equal(g, w)
    n_cand = want_mask.sum(-1)
    assert (n_cand == 0).any() or not kw.get("edges")
    if kw.get("edges"):
        # Rows with no candidate (problem 0's first two but under "valid")
        # and rows with one.
        n0 = n_cand[0] if b else n_cand
        assert n0[0] == 0 and (n_cand == 1).any() and (test == "valid" or n0[1] == 0)
        best, bidx, second, sidx = (g.numpy()[0] if b else g.numpy() for g in got)
        assert (best[0], bidx[0], second[0], sidx[0]) == (matching.BIG_DIST, 0,
                                                          matching.BIG_DIST, 1)


@pytest.mark.parametrize("test", sorted(WRAPPERS))
def test_wrapper_checks_its_inputs(test):
    kw = dict(interop.CANDIDATE_CASES[f"{test}_B3"])
    args, _ = _problem(kw)
    t = _port_args(test, args)
    fn = WRAPPERS[test]

    def call(i, value):
        return fn(*[value if j == i else a for j, a in enumerate(t)])

    with pytest.raises(TypeError):
        call(2, t[2].to(torch.int32))                  # flags must be bool
    with pytest.raises(ValueError):
        call(2, t[2][:, :-1].contiguous())             # M rows
    with pytest.raises(ValueError):
        call(3, t[3][:2].contiguous())                 # one B for every table
    with pytest.raises(ValueError):
        call(0, t[0].transpose(0, 1))                  # contiguous
    with pytest.raises(ValueError):
        call(1, t[1][:, :0].contiguous())              # 1 <= N
    if test != "valid":
        with pytest.raises(TypeError):
            call(4, t[4].double())
        with pytest.raises(ValueError):
            call(5, t[5][..., :1].contiguous())
    if test == "epipolar":
        with pytest.raises(ValueError):
            call(6, t[6][:, :2].contiguous())          # F12 [B, 3, 3]
        with pytest.raises(TypeError):
            call(7, t[7].double())


def test_matchers_reach_k7_through_the_candidate_tests(monkeypatch):
    """match_brute_force (one problem, and candidates on either side),
    match_for_initialization and match_for_triangulation call the new
    forms, each once a call, and never K7 under a mask."""
    calls = []

    def spy(name):
        fn = getattr(kmatching, name)

        def call(*args):
            calls.append(name)
            return fn(*args)
        return call

    def refuse(*args):
        raise AssertionError("a matcher built a mask for masked_hamming_top2")

    for name in ("valid_hamming_top2", "window_hamming_top2", "epipolar_hamming_top2"):
        monkeypatch.setattr(kmatching, name, spy(name))
    monkeypatch.setattr(kmatching, "masked_hamming_top2", refuse)
    rng = np.random.default_rng(5)
    n = 64
    da, _, va, _ = (_t(a) for a in interop.candidate_problem("valid", 1, n, n, b=3,
                                                             shared="cols"))
    db, vb = _t(interop.candidate_problem("valid", 2, n, n)[1]), torch.ones(n, dtype=torch.bool)
    ang = torch.from_numpy(rng.uniform(0, 6.28, (3, n)).astype(np.float32))
    matchers.match_brute_force(da[0], ang[0], va[0], db, ang[0], vb)
    m = matchers.match_brute_force(da, ang, va, db, ang[0], vb)
    assert tuple(m.idx.shape) == (3, n)
    m = matchers.match_brute_force(db, ang[0], vb, da, ang, va)
    assert tuple(m.idx.shape) == (3, n)
    xy = torch.from_numpy(rng.uniform(0, 400, (2, n, 2)).astype(np.float32))
    octave = torch.from_numpy(rng.integers(0, 2, (2, n)).astype(np.int32))
    matchers.match_for_initialization(xy[0], da[0], ang[0], octave[0], vb,
                                      xy[1], da[1], ang[1], octave[1], vb)
    F = torch.from_numpy(np.stack([interop._fundamental(rng) for _ in range(3)])
                         .astype(np.float32))
    matchers.match_for_triangulation(
        xy[0], db, ang[0], va, xy[1].expand(3, -1, -1).contiguous(), da, ang,
        va, F, octave[1].expand(3, -1).contiguous(),
        torch.full((3, 2), 200.0), torch.tensor(100.0))
    assert calls == ["valid_hamming_top2"] * 3 + ["window_hamming_top2",
                                                  "epipolar_hamming_top2"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matcher_tests_equal_their_mask_routes(seed):
    """The flags and tests the matchers hand to the kernel equal the masks
    they built before: match_for_triangulation's (triangulation_mask,
    batched over neighbour pairs, the keyframe's table shared) and
    match_for_initialization's (level-0 flags and window_mask), each
    through masked_hamming_top2."""
    rng = np.random.default_rng(seed)
    b, n1, n2 = 3, 90, 120
    desc1 = _t(rng.integers(0, 2 ** 32, (n1, 8), dtype=np.uint32))
    desc2 = _t(rng.integers(0, 2 ** 32, (b, n2, 8), dtype=np.uint32))
    xy1 = torch.from_numpy(rng.uniform(0, 400, (n1, 2)).astype(np.float32))
    xy2 = torch.from_numpy(rng.uniform(0, 300, (b, n2, 2)).astype(np.float32))
    free1 = torch.from_numpy(rng.random((b, n1)) < 0.7)
    free2 = torch.from_numpy(rng.random((b, n2)) < 0.7)
    octave2 = torch.from_numpy(rng.integers(0, 8, (b, n2)).astype(np.int32))
    F12 = torch.from_numpy(np.stack([interop._fundamental(rng) for _ in range(b)])
                           .astype(np.float32))
    epipole2 = torch.from_numpy(rng.uniform(50, 350, (b, 2)).astype(np.float32))
    min_d2 = torch.tensor(40.0 ** 2)
    sig2, far = matchers._triangulation_terms(xy2, octave2, epipole2, min_d2, 8, 1.2)
    got = kmatching.epipolar_hamming_top2(desc1, desc2, free1, free2 & far, xy1, xy2, F12,
                                          sig2)
    mask = matchers.triangulation_mask(xy1, free1, xy2, free2, F12, octave2, epipole2,
                                       min_d2)
    assert mask.any() and not mask.all()
    for g, w in zip(got, kmatching.masked_hamming_top2(desc1, desc2, mask.contiguous())):
        assert torch.equal(g, w)
    valid = torch.from_numpy(rng.random((2, n1)) < 0.9)
    octave = torch.from_numpy(rng.integers(0, 2, (2, n1)).astype(np.int32))
    xy = torch.from_numpy(rng.uniform(0, 400, (2, n1, 2)).astype(np.float32))
    got = kmatching.window_hamming_top2(desc1, desc2[0, :n1].contiguous(),
                                        valid[0] & (octave[0] == 0),
                                        valid[1] & (octave[1] == 0), xy[0], xy[1], 100.0)
    mask = ((valid[0] & (octave[0] == 0))[:, None] & (valid[1] & (octave[1] == 0))[None, :]
            & matching.window_mask(xy[0], xy[1], 100.0))
    assert mask.any() and not mask.all()
    for g, w in zip(got, kmatching.masked_hamming_top2(desc1, desc2[0, :n1].contiguous(),
                                                       mask.contiguous())):
        assert torch.equal(g, w)
