"""K7's plain version (kernels/matching.masked_hamming_top2 on CPU tensors)
against the JAX package's Pallas kernel `masked_hamming_top2` in interpret
mode: all four outputs equal, index fallbacks included, on the shapes of
tests/test_pallas_matching.py, rows with no candidate or one, an
all-masked column in the transposed use (the stereo matcher's mutual
check), and equal-distance ties. best/best_idx also agree with the dense
route the JAX stereo matcher takes (`best_match_with_ratio`,
`jnp.argmin(..., axis=0)`). With a leading batch axis: against jax.vmap of
the Pallas kernel, with per-problem tables and with the row or the column
table shared by the problems."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import matching as jmatching
from orb_slam2_commit_tpu.ops import pallas_matching as jpm
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.kernels import matching as kmatching
from orb_slam2_commit_tpu_torch.ops import matching

torch.set_num_threads(1)

BIG = matching.BIG_DIST


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)


def _problem(seed, m, n, density=0.3, ties=False, edits=False):
    """(desc_a, desc_b, mask). edits: row 0 has no candidate, row 1 one at
    its last column, row 2 one at column 0, and column 3 has none."""
    rng = np.random.default_rng(seed)
    da, db = _desc(rng, m), _desc(rng, n)
    if ties:
        # Few distinct descriptors: many equal distances per row.
        da = da[rng.integers(0, 3, m)]
        db = db[rng.integers(0, 3, n)]
    mask = rng.random((m, n)) < density
    if edits:
        mask[0] = False
        mask[1] = False
        mask[1, n - 1] = True
        mask[2] = False
        mask[2, 0] = True
        mask[:, 3] = False
    return da, db, mask


CASES = {
    "64x100": dict(seed=7, m=64, n=100),
    "128x128": dict(seed=7, m=128, n=128),
    "300x517": dict(seed=7, m=300, n=517),
    "1x1": dict(seed=7, m=1, n=1),
    "1x1_masked": dict(seed=8, m=1, n=1, density=0.0),
    "edits": dict(seed=3, m=40, n=90, edits=True),
    "ties": dict(seed=4, m=96, n=200, density=0.5, ties=True),
    "sparse": dict(seed=5, m=200, n=150, density=0.01),
}


def _jax_top2(da, db, mask):
    with jax.enable_x64(False):
        out = jpm.masked_hamming_top2(jnp.asarray(da), jnp.asarray(db),
                                      jnp.asarray(mask), interpret=True)
        return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def reference():
    """Each case's problem and the Pallas kernel's outputs, on the mask
    and on its transpose."""
    out = {}
    for name, kw in CASES.items():
        da, db, mask = _problem(**kw)
        out[name] = (da, db, mask, _jax_top2(da, db, mask),
                     _jax_top2(db, da, np.ascontiguousarray(mask.T)))
    return out


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("transposed", [False, True])
def test_plain_top2_equals_pallas(reference, case, transposed):
    da, db, mask, ref, ref_t = reference[case]
    if transposed:
        da, db, mask, ref = db, da, mask.T, ref_t
    got = kmatching.masked_hamming_top2(_t(da), _t(db), _t(mask))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), r)
    if case == "edits":
        best, bidx, second, sidx = (g.numpy() for g in got)
        if not transposed:
            # No candidate: BIG twice, best index 0, second index 1.
            assert (best[0], bidx[0], second[0], sidx[0]) == (BIG, 0, BIG, 1)
            # One candidate: the second index is the lowest other column.
            assert bidx[1] == mask.shape[1] - 1 and (second[1], sidx[1]) == (BIG, 0)
            assert bidx[2] == 0 and (second[2], sidx[2]) == (BIG, 1)
        else:
            # Column 3 of the mask has no candidate.
            assert (best[3], bidx[3]) == (BIG, 0)


@pytest.mark.parametrize("case", ["300x517", "edits", "ties", "sparse"])
def test_best_equals_the_dense_route(reference, case):
    """What the stereo matcher reads: best/best_idx through
    match_from_top2 against best_match_with_ratio on the dense matrix,
    and the transposed best index against argmin over axis 0 (0 for a
    column with no candidate)."""
    da, db, mask, ref, ref_t = reference[case]
    got = kmatching.masked_hamming_top2(_t(da), _t(db), _t(mask))
    got_t = kmatching.masked_hamming_top2(_t(db), _t(da), _t(np.ascontiguousarray(mask.T)))
    octave_b = np.random.default_rng(0).integers(0, 3, db.shape[0]).astype(np.int32)
    with jax.enable_x64(False):
        dist = jmatching.hamming_distance_matrix(jnp.asarray(da), jnp.asarray(db))
        col_best = np.asarray(jnp.argmin(jnp.where(jnp.asarray(mask), dist, BIG), axis=0))
        for max_dist, ratio, rule in [(75, 1.0, False), (256, 1.0, False), (100, 0.8, True)]:
            ref_m = jmatching.best_match_with_ratio(
                dist, jnp.asarray(mask), max_dist, ratio,
                octave_b=jnp.asarray(octave_b) if rule else None)
            m = matching.match_from_top2(
                *got, max_dist, ratio, octave_b=_t(octave_b) if rule else None)
            np.testing.assert_array_equal(m.idx.numpy(), np.asarray(ref_m.idx))
            np.testing.assert_array_equal(m.dist.numpy(), np.asarray(ref_m.dist))
    np.testing.assert_array_equal(got_t[1].numpy(), col_best)
    if case == "edits":
        assert col_best[3] == 0


def test_wrapper_checks_its_inputs():
    da, db, mask = (_t(a) for a in _problem(1, 4, 6))
    with pytest.raises(TypeError):
        kmatching.masked_hamming_top2(da, db, mask.to(torch.int32))
    with pytest.raises(ValueError):
        kmatching.masked_hamming_top2(da, db, mask[:, :5].contiguous())
    with pytest.raises(ValueError):
        kmatching.masked_hamming_top2(da, db, mask.t())
    with pytest.raises(ValueError):
        kmatching.masked_hamming_top2(da, db[:0], mask[:, :0].contiguous())


def _batch(seed, b, m, n, empty=(), **kw):
    """B problems of one shape stacked: [B, M, 8], [B, N, 8], [B, M, N];
    the pairs in `empty` have no candidate at all."""
    probs = [_problem(seed + i, m, n, **kw) for i in range(b)]
    da, db, mask = (np.stack(parts) for parts in zip(*probs))
    mask[list(empty)] = False
    return da, db, mask


BATCH_CASES = {
    "B1": dict(seed=11, b=1, m=64, n=100),
    "B3_empty_pair": dict(seed=12, b=3, m=120, n=90, empty=(1,)),
    "B4_ties_sparse": dict(seed=13, b=4, m=50, n=70, density=0.05, ties=True, empty=(3,)),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batched_plain_equals_vmapped_pallas(case):
    """K7 with a leading batch axis (its plain version here) against
    jax.vmap of the Pallas kernel (interpret mode), each problem against
    the [M, N] form, and row descriptors shared by the problems ([M, 8])
    against each problem with those rows."""
    da, db, mask = _batch(**BATCH_CASES[case])
    with jax.enable_x64(False):
        ref = jax.vmap(lambda a, b, m: jpm.masked_hamming_top2(a, b, m, interpret=True))(
            jnp.asarray(da), jnp.asarray(db), jnp.asarray(mask))
        ref = [np.asarray(r) for r in ref]
    got = kmatching.masked_hamming_top2(_t(da), _t(db), _t(mask))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and tuple(g.shape) == mask.shape[:2]
        np.testing.assert_array_equal(g.numpy(), r)
    shared = kmatching.masked_hamming_top2(_t(da[0]), _t(db), _t(mask))
    for b in range(da.shape[0]):
        single = kmatching.masked_hamming_top2(_t(da[b]), _t(db[b]), _t(mask[b]))
        for g, s in zip(got, single):
            np.testing.assert_array_equal(g[b].numpy(), s.numpy())
        single = kmatching.masked_hamming_top2(_t(da[0]), _t(db[b]), _t(mask[b]))
        for g, s in zip(shared, single):
            np.testing.assert_array_equal(g[b].numpy(), s.numpy())
    for b in BATCH_CASES[case].get("empty", ()):
        assert (got[0][b].numpy() == BIG).all() and (got[1][b].numpy() == 0).all()


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batched_shared_columns_equal_vmapped_pallas(case):
    """Column descriptors shared by the problems ([N, 8]; relocalization's
    candidate keyframes against one frame) against jax.vmap of the Pallas
    kernel with that table unbatched, and each problem against the [M, N]
    form."""
    da, db, mask = _batch(**BATCH_CASES[case])
    with jax.enable_x64(False):
        ref = jax.vmap(lambda a, m: jpm.masked_hamming_top2(a, jnp.asarray(db[0]), m,
                                                             interpret=True))(
            jnp.asarray(da), jnp.asarray(mask))
        ref = [np.asarray(r) for r in ref]
    got = kmatching.masked_hamming_top2(_t(da), _t(db[0]), _t(mask))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and tuple(g.shape) == mask.shape[:2]
        np.testing.assert_array_equal(g.numpy(), r)
    for b in range(da.shape[0]):
        single = kmatching.masked_hamming_top2(_t(da[b]), _t(db[0]), _t(mask[b]))
        for g, s in zip(got, single):
            np.testing.assert_array_equal(g[b].numpy(), s.numpy())


def test_batched_wrapper_checks_its_inputs():
    da, db, mask = (_t(a) for a in _batch(1, 2, 4, 6))
    with pytest.raises(ValueError):
        kmatching.masked_hamming_top2(da, db, mask[None])
    with pytest.raises(ValueError):
        kmatching.masked_hamming_top2(da[:1].contiguous(), db, mask)
    with pytest.raises(ValueError):
        kmatching.masked_hamming_top2(da, db[:1].contiguous(), mask)
    with pytest.raises(ValueError):
        kmatching.masked_hamming_top2(da, db, mask[:, :, :5].contiguous())
    with pytest.raises(TypeError):
        kmatching.masked_hamming_top2(da, db, mask.to(torch.int32))
