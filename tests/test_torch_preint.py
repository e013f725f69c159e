"""Parity of the port's IMU preintegration (dmvio_tpu_torch/ops/preint.py)
with dmvio_tpu/ops/preint.py, on the cases of tests/test_preint.py.

Tolerances:
* preintegrate (device f32 loop vs the reference's f32 scan): the rotation
  and velocity to 1e-5 and the position to 1e-6 absolute over 1 s of 200 Hz
  samples (f32 products accumulated in another order), the covariance and
  bias Jacobians to 1e-4 of their largest entry;
* imu_residual on identical inputs: 1e-6 absolute plus 1e-5 of the
  largest entry (the residual of near-consistent states is a difference of
  unit-magnitude rotations, whose f32 rounding floor is ~1e-7);
* sqrt_information, bias_walk_sqrt_info: 1e-5 / 1e-6 of the largest entry;
* preintegrate_np / preintegrate_np_ref (copied host float64): exactly
  equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.ops import preint as jp
from dmvio_tpu_torch import convert
from dmvio_tpu_torch.ops import preint as tp
from test_preint import simulate

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def near(got, ref, rel, atol=0.0):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        got, ref, rtol=0, atol=atol + rel * max(np.abs(ref).max(), 1e-12))


def T(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("bias", [np.zeros(6, np.float32),
                                  np.array([0.004, -0.003, 0.002, 0.03,
                                            -0.02, 0.04], np.float32)])
def test_preintegrate_matches_reference(bias):
    accs, gyrs, dts, _ = simulate(bias=bias)
    # Padding rows (dt = 0) must be exact no-ops on both sides.
    pad = np.random.default_rng(1).normal(size=(7, 3)).astype(np.float32)
    accs = np.concatenate([accs, pad])
    gyrs = np.concatenate([gyrs, pad])
    dts = np.concatenate([dts, np.zeros(7, np.float32)])
    j = jp.preintegrate_jit(jnp.asarray(accs), jnp.asarray(gyrs),
                            jnp.asarray(dts), jnp.asarray(bias))
    t = tp.preintegrate(T(accs), T(gyrs), T(dts), T(bias))
    np.testing.assert_allclose(t.dR.numpy(), np.asarray(j.dR), atol=1e-5)
    np.testing.assert_allclose(t.dv.numpy(), np.asarray(j.dv), atol=1e-5)
    np.testing.assert_allclose(t.dp.numpy(), np.asarray(j.dp), atol=1e-6)
    assert float(t.dt) == pytest.approx(float(j.dt), rel=1e-6)
    for name in ("dR_dbg", "dv_dbg", "dv_dba", "dp_dbg", "dp_dba", "cov"):
        near(getattr(t, name), getattr(j, name), 1e-4)


def test_residual_and_weights_match_reference():
    true_bias = np.array([0.004, -0.003, 0.002, 0.03, -0.02, 0.04],
                         np.float32)
    accs, gyrs, dts, states = simulate(bias=true_bias)
    pre_np = tp.preintegrate_np(accs, gyrs, dts, np.zeros(6))
    jpre = jp.state_from_np(pre_np)
    tpre = tp.state_from_np(pre_np, CPU)
    R0, p0, v0 = states[0]
    R1, p1, v1 = states[-1]
    args = [np.asarray(a, np.float32) for a in (R0, p0, v0, R1, p1, v1)]
    for bias in (np.zeros(6, np.float32), true_bias):
        r_j = jp.imu_residual(jpre, *map(jnp.asarray, args),
                              jnp.asarray(bias))
        r_t = tp.imu_residual(tpre, *map(T, args), T(bias))
        near(r_t, r_j, 1e-5, 1e-6)
    near(tp.sqrt_information(tpre), jp.sqrt_information(jpre), 1e-5)
    near(tp.bias_walk_sqrt_info(tpre.dt), jp.bias_walk_sqrt_info(jpre.dt),
         1e-6)
    # Batched: the port's residual broadcasts over a leading pair axis.
    tb = convert.preint_state(
        {k: np.stack([pre_np[k]] * 2) for k in pre_np}, CPU)
    rb = tp.imu_residual(tb, *(torch.stack([T(a)] * 2) for a in args),
                         torch.stack([T(true_bias)] * 2))
    near(rb[1], jp.imu_residual(jpre, *map(jnp.asarray, args),
                                jnp.asarray(true_bias)), 1e-5, 1e-6)


def test_identity_preint_matches_reference():
    j = jp.identity_preint(jnp.zeros(6))
    t = tp.identity_preint(torch.zeros(6))
    for name in jp.PreintState._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))


@pytest.mark.parametrize("n", [0, 1, 9, 131])
def test_host_preintegration_is_the_reference_copy(n):
    """The copied host float64 preintegration agrees exactly, in both its
    vectorized and its loop form."""
    rng = np.random.default_rng(7 + n)
    acc = rng.normal(0, 2.0, (n, 3)) + np.array([0, 0, 9.8])
    gyr = rng.normal(0, 0.8, (n, 3))
    dts = rng.uniform(0.003, 0.008, n)
    if n > 5:
        dts[3] = 0.0
    bias = rng.normal(0, 0.05, 6)
    for fn in ("preintegrate_np", "preintegrate_np_ref"):
        a = getattr(tp, fn)(acc, gyr, dts, bias)
        b = getattr(jp, fn)(acc, gyr, dts, bias)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


def test_noise_model_is_set_per_package():
    """Both packages keep a process-wide noise model; set_noise of the port
    changes the port's covariance as the reference's changes its own."""
    accs, gyrs, dts, _ = simulate(n=50)
    base = tp.preintegrate_np(accs, gyrs, dts, np.zeros(6))["cov"]
    old = tp.NOISE.sigma_gyro, tp.NOISE.sigma_acc
    try:
        tp.set_noise(sigma_gyro=2 * old[0], sigma_acc=2 * old[1])
        c2 = tp.preintegrate_np(accs, gyrs, dts, np.zeros(6))["cov"]
    finally:
        tp.set_noise(sigma_gyro=old[0], sigma_acc=old[1])
    np.testing.assert_allclose(c2, 4.0 * base, rtol=1e-6, atol=1e-20)
