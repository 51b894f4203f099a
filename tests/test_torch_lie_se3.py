"""The port's SO3 / SE3 half of ops/lie.py on the CPU against the JAX
package's, on the same float64 inputs from a seed: so3_log, the inverse
left Jacobian, se3_log / compose / inverse / apply / matrix /
from_matrix, and the quaternion pair. Both run in float64 (x64 is on in
the suite); held to 1e-12 absolute, 1e-9 on so3_log's near-pi branch (on
rotations built to hit it; the small scales hit its near-zero branch).
The quaternion of a rotation is unique up to sign, and both pick the same
candidate, so it is compared as is."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import lie as jlie
from orb_slam2_commit_tpu_torch.ops import lie

torch.set_num_threads(1)

TOL = 1e-12


def _rotations(seed, n=64, scale=1.0):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, scale, (n, 3))
    return w, np.asarray(jlie.so3_exp(jnp.asarray(w)))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.5, 2.0])
def test_so3_log_and_jacobian_inverse(scale):
    w, R = _rotations(1, scale=scale)
    _close(lie.so3_log(_t(R)), jlie.so3_log(jnp.asarray(R)))
    _close(lie._so3_left_jacobian_inv(_t(w)), jlie._so3_left_jacobian_inv(jnp.asarray(w)))


def test_so3_log_near_pi():
    rng = np.random.default_rng(2)
    axes = rng.normal(0, 1, (16, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    w = axes * (np.pi - rng.uniform(0, 1e-6, (16, 1)))
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    # Rounding near the branch point: the axis comes from a square root.
    _close(lie.so3_log(_t(R)), jlie.so3_log(jnp.asarray(R)), tol=1e-9)


def test_se3_log_compose_inverse_apply():
    rng = np.random.default_rng(3)
    _, Ra = _rotations(4, n=32)
    _, Rb = _rotations(5, n=32)
    ta, tb = rng.normal(0, 1, (32, 3)), rng.normal(0, 1, (32, 3))
    x = rng.normal(0, 2, (32, 3))
    J = [jnp.asarray(a) for a in (Ra, ta, Rb, tb, x)]
    T = [_t(a) for a in (Ra, ta, Rb, tb, x)]
    _close(lie.se3_log(T[0], T[1]), jlie.se3_log(J[0], J[1]))
    for got, want in zip(lie.se3_compose(*T[:4]), jlie.se3_compose(*J[:4])):
        _close(got, want)
    for got, want in zip(lie.se3_inverse(T[0], T[1]), jlie.se3_inverse(J[0], J[1])):
        _close(got, want)
    _close(lie.se3_apply(T[0], T[1], T[4]), jlie.se3_apply(J[0], J[1], J[4]))
    M = lie.se3_matrix(T[0], T[1])
    _close(M, jlie.se3_matrix(J[0], J[1]))
    for got, want in zip(lie.se3_from_matrix(M), (Ra, ta)):
        _close(got, want)
    # exp(log(T)) returns T, to the 1e-8 guard in the left Jacobian's
    # coefficient (theta^3 + 1e-8), which both packages carry.
    R2, t2 = lie.se3_exp(lie.se3_log(T[0], T[1]))
    _close(R2, Ra, tol=1e-9)
    _close(t2, ta, tol=1e-7)


@pytest.mark.parametrize("seed, scale", [(6, 0.3), (7, 3.0)])
def test_quaternions(seed, scale):
    _, R = _rotations(seed, scale=scale)
    q = lie.rotation_to_quaternion(_t(R))
    _close(q, jlie.rotation_to_quaternion(jnp.asarray(R)))
    _close(lie.quaternion_to_rotation(q), jlie.quaternion_to_rotation(jnp.asarray(q.numpy())))
    _close(lie.quaternion_to_rotation(q), R, tol=1e-9)
