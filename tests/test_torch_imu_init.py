"""Parity of the port's coarse IMU initializer (dmvio_tpu_torch/models/
imu_init.py) with dmvio_tpu/models/imu_init.py, on `build_case` of
tests/test_imu_init.py (30 fixed poses of a simulated metric trajectory in
a scaled, gravity-rotated DSO world, 200 Hz IMU, a 100-slot window).

Tolerances:
* gravity_from_accel: 1e-6 (a few f32 ops);
* the stacked residual and its Jacobian at the start point: 1e-4 of their
  largest entry (f32 forward-mode chains; the sqrt-information weights
  reach ~1e2);
* optimize (25 LM iterations, each an accept/reject on f32 energies):
  scale to 1e-3, gravity to 1e-3, bias to 1e-3, velocities to 1e-2 in
  m/s, the scale marginal variance to 2% relative; the reference test's
  recovery gates on the port's own result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.models import imu_init as jii
from dmvio_tpu.utils import lie as jlie
from dmvio_tpu_torch import convert
from dmvio_tpu_torch.models import imu_init as tii
from test_imu_init import N_POSES, build_case
from test_vio_ba import G2_GT, S_GT

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def to_port(st):
    return tii.CoarseInitState(
        R_cw=convert.tensor(np.asarray(st.R_cw), CPU),
        t_cw=convert.tensor(np.asarray(st.t_cw), CPU),
        pre=convert.preint_state(jax.device_get(st.pre), CPU),
        valid=convert.tensor(np.asarray(st.valid), CPU))


def start():
    return dict(s_log0=0.0, g20=np.zeros(2, np.float32),
                bias0=np.zeros(6, np.float32),
                v0=np.zeros((jii.N_MAX, 3), np.float32))


def run_both(bias_gt=np.zeros(6), **kw):
    st, v_gt = build_case(bias_gt=bias_gt)
    x0 = start()
    x0.update(kw)
    jres = jii.optimize_jit(st, jnp.eye(3), jnp.zeros(3),
                            **{k: jnp.asarray(v, jnp.float32)
                               for k, v in x0.items()})
    tres = tii.optimize(to_port(st), torch.eye(3), torch.zeros(3),
                        **{k: torch.as_tensor(np.asarray(v, np.float32))
                           for k, v in x0.items()})
    return jres, tres, v_gt


@pytest.fixture(scope="module")
def clean():
    return run_both()


def test_gravity_from_accel():
    R_g = jlie.so3_exp(jnp.asarray([G2_GT[0], G2_GT[1], 0.0]))
    acc = np.asarray(R_g @ jnp.array([0.0, 0.0, 1.0])) * 9.8082
    for a in (acc, np.array([0.3, -0.2, 9.7]), np.array([0.0, 0.0, 9.8])):
        a = a.astype(np.float32)
        np.testing.assert_allclose(
            tii.gravity_from_accel(torch.as_tensor(a)).numpy(),
            np.asarray(jii.gravity_from_accel(jnp.asarray(a))), atol=1e-6)


def test_residual_and_jacobian_match_reference():
    st, _ = build_case()
    N = jii.N_MAX
    rng = np.random.default_rng(4)
    x = np.concatenate([[np.log(S_GT) + 0.1], G2_GT + 0.02,
                        rng.normal(0, 0.01, 6),
                        rng.normal(0, 0.3, 3 * N)]).astype(np.float32)
    r_j = jii._residual_all(jnp.asarray(x), st, jnp.eye(3), jnp.zeros(3), N)
    J_j = jax.jacfwd(lambda y: jii._residual_all(
        y, st, jnp.eye(3), jnp.zeros(3), N))(jnp.asarray(x))
    r_t, J_t = tii._linearize(torch.as_tensor(x), to_port(st), torch.eye(3),
                              torch.zeros(3), True)
    r_j, J_j = np.asarray(r_j), np.asarray(J_j)
    assert np.abs(J_j).max() > 10.0
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=0,
                               atol=1e-4 * np.abs(r_j).max())
    np.testing.assert_allclose(J_t.numpy(), J_j, rtol=0,
                               atol=1e-4 * np.abs(J_j).max())
    # Pairs past the valid prefix carry exact zeros on both sides.
    assert not J_t[9 * (N_POSES - 1):].any()


def test_optimize_matches_reference(clean):
    jres, tres, _ = clean
    assert bool(tres.ok) and bool(jres.ok)
    assert float(tres.s_log) == pytest.approx(float(jres.s_log), abs=1e-3)
    np.testing.assert_allclose(tres.g2.numpy(), np.asarray(jres.g2),
                               atol=1e-3)
    np.testing.assert_allclose(tres.bias.numpy(), np.asarray(jres.bias),
                               atol=1e-3)
    np.testing.assert_allclose(tres.v.numpy()[:N_POSES],
                               np.asarray(jres.v)[:N_POSES], atol=1e-2)
    assert float(tres.s_var) == pytest.approx(float(jres.s_var), rel=0.02)


def test_coarse_init_recovers_scale_gravity_velocities(clean):
    _, res, v_gt = clean
    s_est = float(np.exp(res.s_log))
    assert abs(s_est - S_GT) / S_GT < 0.02, s_est
    assert np.linalg.norm(res.g2.numpy() - G2_GT) < 0.01, res.g2
    v_err = np.linalg.norm(res.v.numpy()[:N_POSES] - v_gt[:N_POSES], axis=1)
    assert np.median(v_err) < 0.03, np.median(v_err)
    assert float(res.s_var) < 1.0


def test_coarse_init_estimates_bias():
    bias_gt = np.array([0.004, -0.006, 0.003, 0.05, -0.08, 0.06], np.float32)
    jres, tres, _ = run_both(bias_gt=bias_gt, s_log0=np.log(S_GT),
                             g20=G2_GT)
    b = tres.bias.numpy()
    assert np.abs(b[:3] - bias_gt[:3]).max() < 2e-3, b
    assert np.abs(b[3:] - bias_gt[3:]).max() < 0.03, b
    np.testing.assert_allclose(b, np.asarray(jres.bias), atol=1e-3)
