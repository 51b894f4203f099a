"""Port's per-cell top-k (K3) on the CPU, where the wrapper runs its plain
version, against the Pallas kernel run by its interpreter: exact values
and indices, ties to the lowest index."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import fast as jfast
from orb_slam2_commit_tpu.ops import pallas_select
from orb_slam2_commit_tpu_torch.kernels import select

torch.set_num_threads(1)


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
