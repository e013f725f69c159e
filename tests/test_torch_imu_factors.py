"""The port's copy of the host float64 IMU pair factor
(dmvio_tpu_torch/models/imu_factors.py) against dmvio_tpu's, on the random
cases of tests/test_imu_factors.py: residuals and analytic Jacobians,
scalar and batched, must agree EXACTLY (the same NumPy code on the same
inputs); the port's Jacobian also passes the reference test's
finite-difference gate on its own.
"""

import numpy as np
import pytest
import torch

from dmvio_tpu.models import delayed as jdl
from dmvio_tpu.models import imu_factors as jf
from dmvio_tpu_torch.models import delayed as tdl
from dmvio_tpu_torch.models import imu_factors as tf
from test_imu_factors import _apply_z, _rand_pre, _rand_state

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)


def case(seed):
    rng = np.random.default_rng(seed)
    sti, stj = _rand_state(rng), _rand_state(rng)
    pre = _rand_pre(rng)
    return (sti, stj, pre, rng.normal(0.2, 0.3), rng.normal(0, 0.1, 2),
            jf._exp_so3(rng.normal(0, 1.0, 3)), rng.normal(0, 0.1, 3))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_linearize_pair_is_the_reference_copy(seed):
    sti, stj, pre, s_log, g2, R_cb, t_cb = case(seed)
    r_t, J_t = tf.linearize_pair(sti, stj, pre, s_log, g2, R_cb, t_cb)
    r_j, J_j = jf.linearize_pair(sti, stj, pre, s_log, g2, R_cb, t_cb)
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_array_equal(J_t, J_j)


def test_port_jacobian_matches_finite_differences():
    sti, stj, pre, s_log, g2, R_cb, t_cb = case(5)
    _, J = tf.linearize_pair(sti, stj, pre, s_log, g2, R_cb, t_cb)
    eps = 1e-7
    J_fd = np.zeros((15, 33))
    for k in range(33):
        out = []
        for sgn in (1.0, -1.0):
            z = np.zeros(33)
            z[k] = sgn * eps
            ai, aj, asl, ag = _apply_z(sti, stj, s_log, g2, z)
            out.append(tf.linearize_pair(ai, aj, pre, asl, ag, R_cb,
                                         t_cb)[0])
        J_fd[:, k] = (out[0] - out[1]) / (2 * eps)
    err = np.abs(J - J_fd).max() / max(np.abs(J_fd).max(), 1.0)
    assert err < 5e-6, err


def test_batched_linearization_and_weights_are_the_reference_copy():
    rng = np.random.default_rng(11)
    K, N = 9, 24
    states = [_rand_state(rng) for _ in range(K)]
    pres = [_rand_pre(rng, dt=float(rng.uniform(0.05, 0.4)))
            for _ in range(N)]
    ii = rng.integers(0, K, N)
    jj = (ii + 1 + rng.integers(0, K - 1, N)) % K
    stack = [np.stack([getattr(s, f) for s in states])
             for f in ("R_cw", "t_cw", "v", "bg", "ba")]
    args = (0.17, np.array([0.03, -0.08]), tf._exp_so3(
        np.array([0.2, -0.4, 1.1])), np.array([0.05, 0.02, -0.08]))
    out = []
    for F_, D_ in ((tf, tdl), (jf, jdl)):
        W9, Wb = D_.pair_weights_batch(pres)
        out.append((W9, Wb) + F_.linearize_pairs_batch(
            F_.PairBatch(pres, ii, jj, W9, Wb), *stack, *args))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
