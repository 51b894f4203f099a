"""The port's binding of the native C++ map core (models/native_core.py)
against numpy, on tests/test_native_core.py's three cases.

The core is built with g++ into the port's build directory, never into
native/ (the JAX package's build); a machine without g++ falls back to
the plain versions, so the library must load here for these cases to
test the binding. Each operation through the library equals the JAX
test's numpy oracle and the port's plain version, integer for integer,
also with a keyframe that binds one point to two features.
"""

import numpy as np
import pytest

from orb_slam2_commit_tpu_torch.models import native_core


@pytest.fixture(scope="module")
def lib():
    lib = native_core.get_lib()
    assert lib is not None, "g++ is on this machine: the map core must build and load"
    assert native_core.library_path().parent == native_core.BUILD_DIR
    return lib


def random_obs(rng, K=12, N=40, P=200, density=0.6, duplicate=False):
    kf_point_idx = np.full((K, N), -1, np.int32)
    for k in range(K):
        n_obs = int(density * N)
        kf_point_idx[k, :n_obs] = rng.choice(P, n_obs, replace=False)
    if duplicate:
        kf_point_idx[5, -1] = kf_point_idx[5, 0]
    kf_valid = np.ones(K, bool)
    kf_valid[3] = False
    return kf_point_idx, kf_valid


@pytest.mark.parametrize("duplicate", [False, True])
class TestNativeCore:
    def test_covis_row_matches_numpy(self, lib, duplicate):
        rng = np.random.default_rng(0)
        kpi, kv = random_obs(rng, duplicate=duplicate)
        P = 200
        for k in [0, 5, 11]:
            got = native_core.covis_row(kpi, kv, P, k)
            np.testing.assert_array_equal(got, native_core.covis_row_plain(kpi, kv, P, k))
            if duplicate:
                continue
            for j in range(kpi.shape[0]):
                if j == k or not kv[j]:
                    want = 0
                else:
                    a = kpi[k][kpi[k] >= 0]
                    b = kpi[j][kpi[j] >= 0]
                    want = np.intersect1d(a, b).size
                assert got[j] == want, (k, j)

    def test_obs_counts_matches_numpy(self, lib, duplicate):
        rng = np.random.default_rng(1)
        kpi, kv = random_obs(rng, duplicate=duplicate)
        P = 200
        got = native_core.obs_counts(kpi, kv, P)
        want = np.zeros(P, np.int64)
        obs = kpi[kv]
        obs = obs[obs >= 0]
        np.add.at(want, obs, 1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, native_core.obs_counts_plain(kpi, kv, P))

    def test_covis_matrix_matches_rows(self, lib, duplicate):
        rng = np.random.default_rng(2)
        kpi, kv = random_obs(rng, duplicate=duplicate)
        P = 200
        M = native_core.covis_matrix(kpi, kv, P)
        np.testing.assert_array_equal(M, native_core.covis_matrix_plain(kpi, kv, P))
        np.testing.assert_array_equal(M, M.T)
        if duplicate:
            assert M[5, 5] == 2       # the point bound twice makes one pair within KF 5
            return
        for k in range(kpi.shape[0]):
            row = native_core.covis_row(kpi, kv, P, k)
            np.testing.assert_array_equal(M[k], row)
        assert (np.diag(M) == 0).all()
