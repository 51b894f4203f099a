"""Port's patch gather (K4) on the CPU, where the wrapper runs its plain
version, against the Pallas kernel run by its interpreter (its lane
padding cut off): exact, border keypoints included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import pallas_patches
from orb_slam2_commit_tpu_torch.kernels import patches

torch.set_num_threads(1)


@pytest.mark.parametrize("patch", [31, 39])
def test_extract_patches_matches_pallas(patch):
    rng = np.random.default_rng(patch)
    h, w = 96, 140
    img = rng.normal(size=(h, w)).astype(np.float32)
    yx = np.concatenate([
        np.array([[0, 0], [h - 1, w - 1], [3, w - 2], [h - 4, 1],
                  [-5, 7], [h + 3, w + 9]]),      # centres outside clamp
        np.stack([rng.integers(0, h, 10), rng.integers(0, w, 10)], -1),
    ]).astype(np.int32)
    ref = np.asarray(pallas_patches.extract_patches(
        jnp.asarray(img), jnp.asarray(yx), patch, interpret=True, k_tile=4))
    got = patches.extract_patches(torch.from_numpy(img), torch.from_numpy(yx),
                                  patch)
    assert got.shape == (yx.shape[0], patch, patch)
    np.testing.assert_array_equal(got.numpy(), ref[:, :patch, :patch])


def test_extract_patches_checks_inputs():
    img = torch.zeros((16, 16))
    with pytest.raises(TypeError):
        patches.extract_patches(img, torch.zeros((3, 2), dtype=torch.int64), 31)
    with pytest.raises(ValueError):
        patches.extract_patches(img, torch.zeros((3, 2), dtype=torch.int32), 30)
