"""Port's per-cell top-k (K3) on the CPU, where the wrappers run their plain
versions, against the Pallas kernel run by its interpreter: exact values
and indices, ties to the lowest index. The map form (`cell_topk_map`,
which reads the score map in place on the card) is held against the
Pallas kernel on the cell matrix that the JAX package's packed_select
lays out: a 640-wide map, a width that is not a multiple of 32 (zero
columns) and cell size 30 (S = 900, -inf padding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import fast as jfast
from orb_slam2_commit_tpu.ops import pallas_select
from orb_slam2_commit_tpu_torch.kernels import _build, select

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before


def _check(x, k):
    want_v, want_a = (np.asarray(a) for a in pallas_select.cell_topk(
        jnp.asarray(x), k, interpret=True))
    got_v, got_a = select.cell_topk(torch.from_numpy(x), k)
    assert got_v.dtype == torch.float32 and got_a.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_a.numpy(), want_a)


@pytest.mark.parametrize("shape,k", [
    ((7, 1024), 8),
    ((200, 1024), 8),
    ((64, 900), 4),      # S not a multiple of 128 (cell_size=30)
    ((1, 256), 1),
])
def test_cell_topk_matches_pallas(shape, k):
    c, s = shape
    rng = np.random.default_rng(c * 10000 + s + k)
    x = rng.uniform(0, 50, (c, s)).astype(np.float32)
    x *= rng.uniform(size=x.shape) < 0.03
    for row in range(0, c, 3):   # exact ties inside rows
        x[row, rng.choice(s, size=4, replace=False)] = 41.5
    _check(x, k)


def test_cell_topk_integer_ties_and_zero_rows():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (48, 1024)).astype(np.float32)
    x *= rng.uniform(size=x.shape) < 0.01
    x[::4] = 0.0                  # all-zero rows
    _check(x, 8)


def test_cell_topk_fewer_entries_than_k():
    """k larger than the row: -inf padding decides, as in the Pallas kernel."""
    x = np.array([[3.0, 1.0, 3.0], [0.0, 0.0, 0.0]], np.float32)
    _check(x, 8)
    # Plain version of the iterative top-k equals JAX's on the same rows.
    v, a = jfast.topk_iterative(jnp.asarray(x), 3)
    tv, ta = select.fast.topk_iterative(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(a))


def _jax_cells(score, cell_size):
    """The JAX package's cell matrix (ops/packed_extractor.packed_select):
    the width zero-padded to whole cells, cells in raster order."""
    hc, w = score.shape
    wp = -(-w // cell_size) * cell_size
    sp = jnp.pad(jnp.asarray(score), ((0, 0), (0, wp - w)))
    n_cy, n_cx = hc // cell_size, wp // cell_size
    cells = sp.reshape(n_cy, cell_size, n_cx, cell_size)
    return cells.transpose(0, 2, 1, 3).reshape(n_cy * n_cx, cell_size * cell_size)


def _score_map(seed, hc, w):
    """A sparse map of NMS-like scores, with exact ties and empty cells."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 80, (hc, w)).astype(np.float32)
    x *= rng.uniform(size=x.shape) < 0.02
    x[rng.integers(0, hc, 40), rng.integers(0, w, 40)] = 63.0   # ties
    x[:, : w // 4] = 0.0                                         # empty cells
    x[-(hc // 4):, -7:] = rng.integers(1, 4, (hc // 4, 7))       # a few values
    return x


@pytest.mark.parametrize("hc,w,cell,k", [
    (96, 640, 32, 8),     # the main canvas's width
    (64, 600, 32, 8),     # 600 = 18.75 cells: the last cell's columns read 0
    (64, 598, 32, 8),     # a width that is not a multiple of 4
    (90, 640, 30, 8),     # cell size 30: rows of 900, -inf past them
    (60, 100, 30, 4),
])
def test_cell_topk_map_matches_pallas(hc, w, cell, k):
    score = _score_map(hc * w + cell, hc, w)
    want_v, want_a = (np.asarray(a) for a in pallas_select.cell_topk(
        _jax_cells(score, cell), k, interpret=True))
    got_v, got_a = select.cell_topk_map(torch.from_numpy(score), cell, k)
    assert got_v.shape == (hc // cell * -(-w // cell), k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    # The port's own cell matrix is the JAX package's.
    np.testing.assert_array_equal(select.cell_matrix(torch.from_numpy(score), cell).numpy(),
                                  np.asarray(_jax_cells(score, cell)))


def test_cell_topk_map_checks_its_inputs():
    score = torch.zeros((64, 640))
    with pytest.raises(ValueError):
        select.cell_topk_map(score[:48], 32, 8)      # rows not whole cells
    with pytest.raises(ValueError):
        select.cell_topk_map(score, 32, 0)
    with pytest.raises(TypeError):
        select.cell_topk_map(score.double(), 32, 8)
    with pytest.raises(ValueError):
        select.cell_topk_map(score[:, :320], 32, 8)  # not contiguous
