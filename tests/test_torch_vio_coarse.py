"""Parity of the port's coarse IMU filter (dmvio_tpu_torch/models/
vio_coarse.py, host float64) and of the tracker's IMU prior branch
(dmvio_tpu_torch/models/coarse_tracker.py) with dmvio_tpu, on the setup of
tests/test_vio_coarse.py (a simulated metric trajectory rendered at 96x128
in a scaled, gravity-rotated DSO world, 200 Hz IMU, 10 Hz frames).

Tolerances:
* init_from_ba / predict / fuse_visual / make_tracker_prior: the same
  NumPy float64 code on identical inputs, so to 1e-12 of each quantity's
  largest entry (the prior's tensors exactly equal);
* track_multi with a CoarsePrior (17-dof joint LM per level, each step an
  accept/reject on f32 energies, over 4 candidates and 4 levels): the
  selected candidate and validity equal, pose to 2e-4, velocity and bias
  to 1e-3, brightness to 1e-3, finest energy to 1e-3 relative;
* without a prior the tracker keeps its visual-only result bit for bit
  (the port's own run, with and without the new arguments at None).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.models import coarse_tracker as jct
from dmvio_tpu.models import vio_coarse as jvc
from dmvio_tpu.ops import preint as jp
from dmvio_tpu.ops import pyramid as jpyr
from dmvio_tpu.utils import synthetic as jsyn
from dmvio_tpu_torch import convert
from dmvio_tpu_torch.models import coarse_tracker as tct
from dmvio_tpu_torch.models import vio_coarse as tvc
from dmvio_tpu_torch.ops import preint as tp
from test_vio_ba import G2_GT, S_GT
from test_vio_coarse import setup

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

CPU = torch.device("cpu")
LEVELS = 4


def same(a, b, rel=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * max(np.abs(b).max(), 1e-300))


def same_state(t, j):
    for f in ("R_cw", "t_cw", "v", "bias", "H", "g2"):
        same(getattr(t, f), getattr(j, f))
    assert t.s_log == j.s_log


@pytest.fixture(scope="module")
def world():
    return setup()


def chunks(world, k):
    _, _, accs, gyrs, _, _, _, spf, dt = world
    s0, s1 = (k - 1) * spf, k * spf
    return accs[s0:s1], gyrs[s0:s1], np.full(s1 - s0, dt)


def test_filter_matches_reference(world):
    """init_from_ba, four predict + fuse_visual cycles through a rotated
    rig, and the tracker prior built from the belief."""
    _, _, _, _, states, poses_dso, _, spf, _ = world
    R0, t0 = (np.asarray(x, np.float64) for x in poses_dso[0])
    v0 = states[0][2]
    R_cb = jvc._exp_so3(np.array([0.2, -0.4, 1.1]))
    t_cb = np.array([0.05, 0.02, -0.08])
    bias = np.array([0.001, -0.002, 0.0005, 0.02, -0.01, 0.03])
    jst = jvc.init_from_ba(R0, t0, v0, bias, np.log(S_GT), G2_GT)
    tst = tvc.init_from_ba(R0, t0, v0, bias, np.log(S_GT), G2_GT)
    same_state(tst, jst)
    H_vis = np.eye(8) * 5e3
    for k in range(1, 5):
        pre = jp.preintegrate_np(*chunks(world, k), np.zeros(6))
        jst = jvc.predict(jst, pre, R_cb, t_cb)
        tst = tvc.predict(tst, tp.preintegrate_np(*chunks(world, k),
                                                  np.zeros(6)), R_cb, t_cb)
        same_state(tst, jst)
        R_k, t_k = (np.asarray(x, np.float64) for x in poses_dso[k])
        v_k = states[k * spf][2]
        jst = jvc.fuse_visual(jst, H_vis, R_k, t_k, v_k, bias)
        tst = tvc.fuse_visual(tst, H_vis, R_k, t_k, v_k, bias)
        same_state(tst, jst)
    jpr = jvc.make_tracker_prior(jst, R0, t0, 0.1, -2.0)
    tpr = tvc.make_tracker_prior(tst, R0, t0, 0.1, -2.0, CPU)
    for f in jct.CoarsePrior._fields:
        np.testing.assert_array_equal(getattr(tpr, f).numpy(),
                                      np.asarray(getattr(jpr, f)), err_msg=f)
    # The converted state is the same belief.
    same_state(convert.coarse_imu_state(jst), jst)


@pytest.fixture(scope="module")
def track_inputs(world):
    """The rescue case of tests/test_vio_coarse.py: reference cloud at GT
    depth in frame 0, the filter's prediction and prior for frame 1."""
    calib, scene, _, _, states, poses_dso, images, spf, _ = world
    pyr0 = tuple(jpyr.build_pyramid(images[0], levels=LEVELS))
    pyr1 = tuple(jpyr.build_pyramid(images[1], levels=LEVELS))
    rng = np.random.default_rng(0)
    u = rng.uniform(8, 128 - 8, 256).astype(np.float32)
    v = rng.uniform(8, 96 - 8, 256).astype(np.float32)
    R0, t0 = poses_dso[0]
    idep = jsyn.gt_idepth(scene, R0, t0, calib, jnp.asarray(u),
                          jnp.asarray(v))
    jref = jct.make_tracker_ref(pyr0, calib, jnp.asarray(u), jnp.asarray(v),
                                idep, jnp.ones(256, bool))
    st = jvc.init_from_ba(np.asarray(R0), np.asarray(t0), states[0][2],
                          np.zeros(6), np.log(S_GT), G2_GT)
    st = jvc.predict(st, jp.preintegrate_np(*chunks(world, 1), np.zeros(6)),
                     np.eye(3), np.zeros(3))
    R0n, t0n = np.asarray(R0, np.float64), np.asarray(t0, np.float64)
    R_pred = st.R_cw @ R0n.T
    t_pred = st.t_cw - R_pred @ t0n
    # Candidate ladder [prediction, prediction nudged, identity, zero]:
    # identity/zero start far from the motion and must lose to it.
    R_c = np.stack([R_pred, jvc._exp_so3(np.array([0.01, -0.01, 0.0]))
                    @ R_pred, np.eye(3), np.eye(3)]).astype(np.float32)
    t_c = np.stack([t_pred, t_pred + 0.01, np.zeros(3),
                    np.zeros(3)]).astype(np.float32)
    mask = np.array([True, True, True, False])
    tref = convert.tracker_ref(dict(
        pyr=[np.asarray(p) for p in jref.pyr],
        clouds=[{f: np.asarray(getattr(c, f)) for f in c._fields}
                for c in jref.clouds]), CPU)
    return (calib, jref, tref, pyr1, st, R0n, t0n, R_c, t_c, mask, states,
            poses_dso, spf)


def _run(inputs, with_prior):
    (calib, jref, tref, pyr1, st, R0n, t0n, R_c, t_c, mask, _, _,
     _) = inputs
    jkw, tkw = {}, {}
    if with_prior:
        jkw = dict(prior=jvc.make_tracker_prior(st, R0n, t0n, 0.0, 0.0),
                   v_init=jnp.asarray(st.v, jnp.float32),
                   bias_init=jnp.asarray(st.bias, jnp.float32))
        tkw = dict(prior=tvc.make_tracker_prior(st, R0n, t0n, 0.0, 0.0, CPU),
                   v_init=torch.as_tensor(st.v, dtype=torch.float32),
                   bias_init=torch.as_tensor(st.bias, dtype=torch.float32))
    jres, jpk = jct.track_multi_jit(
        jref, pyr1, calib, jnp.asarray(R_c), jnp.asarray(t_c),
        jnp.asarray(mask), jnp.asarray(0.0), jnp.asarray(0.0),
        jnp.asarray(50.0), levels=LEVELS, **jkw)
    tres, tpk = tct.track_multi(
        tref, tuple(convert.tensor(np.asarray(p), CPU) for p in pyr1),
        convert.calib(calib, CPU), torch.as_tensor(R_c),
        torch.as_tensor(t_c), torch.as_tensor(mask), torch.tensor(0.0),
        torch.tensor(0.0), torch.tensor(50.0), levels=LEVELS, **tkw)
    return (tct.PackedTrack(tpk.numpy(), LEVELS),
            jct.PackedTrack(np.asarray(jpk), LEVELS), tres)


def test_track_multi_with_prior_matches_reference(track_inputs):
    tp_, jp_, tres = _run(track_inputs, with_prior=True)
    assert jp_.any_valid and tp_.any_valid
    assert tp_.sel == jp_.sel
    np.testing.assert_allclose(tp_.R, jp_.R, atol=2e-4)
    np.testing.assert_allclose(tp_.t, jp_.t, atol=2e-4)
    np.testing.assert_allclose(tp_.v, jp_.v, atol=1e-3)
    np.testing.assert_allclose(tp_.bias, jp_.bias, atol=1e-3)
    assert tp_.rho == pytest.approx(jp_.rho, abs=1e-3)
    assert tp_.b_aff == pytest.approx(jp_.b_aff, abs=1e-3)
    assert tp_.level_energy[0] == pytest.approx(jp_.level_energy[0],
                                                rel=1e-3)
    np.testing.assert_allclose(tp_.H_vis, jp_.H_vis, rtol=0,
                               atol=1e-3 * np.abs(jp_.H_vis).max())
    # The reference test's gate on the port: the joint solve lands at GT.
    _, _, _, _, _, R0n, t0n, _, _, _, states, poses_dso, spf = track_inputs
    R1, t1 = (np.asarray(x, np.float64) for x in poses_dso[1])
    R_rel = R1 @ R0n.T
    t_rel = t1 - R_rel @ t0n
    assert np.linalg.norm(tp_.t - t_rel) < 2e-3
    assert np.linalg.norm(jvc._log_so3(tp_.R @ R_rel.T)) < 2e-3
    assert np.linalg.norm(tres.v.numpy() - states[spf][2]) < 0.1


def test_track_without_prior_is_unchanged(track_inputs):
    """Without a prior the joint branch is off: v and bias stay zero, the
    visual-only result equals the reference's, and passing the inertial
    starts without a prior leaves the pose bit for bit as it was."""
    tp_, jp_, tres = _run(track_inputs, with_prior=False)
    assert tp_.sel == jp_.sel
    np.testing.assert_allclose(tp_.R, jp_.R, atol=2e-4)
    np.testing.assert_allclose(tp_.t, jp_.t, atol=2e-4)
    assert not tp_.v.any() and not tp_.bias.any()
    (calib, _, tref, pyr1, st, _, _, R_c, t_c, mask, _, _, _) = track_inputs
    args = (tref, tuple(convert.tensor(np.asarray(p), CPU) for p in pyr1),
            convert.calib(calib, CPU), torch.as_tensor(R_c),
            torch.as_tensor(t_c), torch.as_tensor(mask), torch.tensor(0.0),
            torch.tensor(0.0), torch.tensor(50.0))
    _, a = tct.track_multi(*args, levels=LEVELS)
    _, b = tct.track_multi(*args, levels=LEVELS, prior=None)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a[:14], torch.as_tensor(
        np.concatenate([tp_.R.reshape(-1), tp_.t, [tp_.rho, tp_.b_aff]]),
        dtype=torch.float32), rtol=0, atol=0)
