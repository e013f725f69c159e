"""Parity of the port's visual-inertial BA (dmvio_tpu_torch/models/vio_ba.py)
with dmvio_tpu/models/vio_ba.py, on the `vio_problem` fixture of
tests/test_vio_ba.py (4 keyframes of a rendered plane, 192 points, three
preintegrated IMU pairs, perturbed poses, scale and gravity), carried into
the port with dmvio_tpu_torch.convert.

Tolerances (each stage is fed identical inputs, so they do not compound):
* imu_factor_system: rows and residuals to 2e-4 of their largest entry
  (forward-mode Jacobians of f32 Lie-group chains; the sqrt-information
  weights reach 1e4, so the rows span ~1e6); rows of invalid pairs exactly
  zero;
* vio_delta / embed_vis / frame_marg_mask: 1e-6 / exact;
* optimize, 2 LM iterations: the same iteration count, poses to 1e-4,
  scale and gravity to 1e-4, velocities to 1e-3, idepths to 1e-3
  relative, outlier masks equal; 20 iterations: the reference test's
  metric-recovery gates;
* vio_marg_fused: victims, point masks equal; the point-marginalization
  increment and the pair fold to 1e-4 of their largest entry;
* schur_out_np (host float64 copy): to 1e-9 of the largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.models import vio_ba as jvb
from dmvio_tpu_torch import convert
from dmvio_tpu_torch.models import ba as tba
from dmvio_tpu_torch.models import vio_ba as tvb
from test_vio_ba import F, vio_problem  # noqa: F401

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def near(got, ref, rel):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-12))


def to_port(jprob):
    """A dmvio_tpu VIOProblem as the port's, field by field."""
    b = jprob.base
    T = lambda x: convert.tensor(np.asarray(x), CPU)  # noqa: E731
    base = tba.BAProblem(
        frames=convert.frames(b.frames, CPU),
        points=convert.points(b.points, CPU),
        calib=convert.calib(b.calib, CPU),
        calib0=T(b.calib0), HM=T(b.HM), bM0=T(b.bM0),
        prior_diag=T(b.prior_diag),
        pair_mask=T(b.pair_mask).to(torch.bool))
    return tvb.VIOProblem(
        base=base, states=convert.vio_states(jprob.states, CPU),
        pairs=convert.imu_pairs(jprob.pairs, CPU), HM=T(jprob.HM),
        bM0=T(jprob.bM0), prior_diag=T(jprob.prior_diag), R_cb=T(jprob.R_cb),
        t_cb=T(jprob.t_cb), imu_on=bool(jprob.imu_on))


@pytest.fixture(scope="module")
def pair(vio_problem):  # noqa: F811
    jprob, images, v_gt, p_gt, R_gt_body = vio_problem
    return jprob, images, to_port(jprob), convert.tensor(
        np.asarray(images), CPU), (v_gt, p_gt, R_gt_body)


@pytest.mark.parametrize("at_current", [False, True])
def test_imu_factor_system(pair, at_current):
    jprob, _, tprob, _, _ = pair
    jf, js = jprob.base.frames, jprob.states
    tf, ts = tprob.base.frames, tprob.states
    if at_current:
        jf, js = jvb.at_current(jf, js)
        tf, ts = tvb.at_current(tf, ts)
    jr, jres, je = jvb.imu_factor_system(jf, js, jprob.pairs, jprob.R_cb,
                                         jprob.t_cb, F)
    tr, tres, te = tvb.imu_factor_system(tf, ts, tprob.pairs, tprob.R_cb,
                                         tprob.t_cb, F)
    assert np.abs(np.asarray(jr)).max() > 1e3
    near(tr, jr, 2e-4)
    near(tres, jres, 2e-4)
    assert float(te) == pytest.approx(float(je), rel=1e-3)


def test_invalid_pairs_give_zero_rows(pair):
    """A padded pair (identity preint, slot 0 to slot 0, valid False), as
    the window's fixed-capacity pair stack carries, holds zero rows."""
    jprob, _, tprob, _, _ = pair
    p = tprob.pairs
    pre = p.pre._replace(
        dR=p.pre.dR.clone(), cov=p.pre.cov.clone(), dt=p.pre.dt.clone())
    pre.dR[-1] = torch.eye(3)
    pre.cov[-1] = 0.0
    pre.dt[-1] = 0.0
    pairs = tvb.IMUPairs(pre=pre, i=torch.tensor([0, 1, 0]),
                         j=torch.tensor([1, 2, 0]),
                         valid=torch.tensor([True, True, False]))
    rows, r, _ = tvb.imu_factor_system(tprob.base.frames, tprob.states,
                                       pairs, tprob.R_cb, tprob.t_cb, F)
    assert torch.isfinite(rows).all()
    assert torch.count_nonzero(rows[2]) == 0
    assert torch.count_nonzero(r[2]) == 0
    full, _, _ = tvb.imu_factor_system(tprob.base.frames, tprob.states,
                                       tprob.pairs, tprob.R_cb, tprob.t_cb, F)
    torch.testing.assert_close(rows[:2], full[:2], rtol=0, atol=0)


def test_delta_embed_and_masks(pair):
    jprob, _, tprob, _, _ = pair
    b, tb = jprob.base, tprob.base
    states = jprob.states._replace(v=jprob.states.v + 0.01,
                                   s_log=jprob.states.s_log + 0.02)
    tstates = convert.vio_states(states, CPU)
    near(tvb.vio_delta(tb.frames, tb.calib, tb.calib0, tstates, F),
         jvb.vio_delta(b.frames, b.calib, b.calib0, states, F), 1e-6)
    x = np.random.default_rng(0).normal(size=(4 + 8 * F, 4 + 8 * F))
    near(tvb.embed_vis(torch.tensor(x, dtype=torch.float32), F),
         jvb.embed_vis(jnp.asarray(x, jnp.float32), F), 0)
    near(tvb.embed_vis(torch.tensor(x[0], dtype=torch.float32), F),
         jvb.embed_vis(jnp.asarray(x[0], jnp.float32), F), 0)
    for slot in range(F):
        np.testing.assert_array_equal(
            tvb.frame_marg_mask(slot, F, CPU).numpy(),
            np.asarray(jvb.frame_marg_mask(slot, F)))
    assert tvb.cdim_ext(F) == jvb.cdim_ext(F)
    assert tvb.imu_offset(F, 2) == jvb.imu_offset(F, 2)


def test_dso_to_body(pair):
    jprob, _, tprob, _, _ = pair
    rng = np.random.default_rng(3)
    R_cb = convert.tensor(np.asarray(jvb.lie.so3_exp(jnp.asarray(
        [0.3, -1.2, 0.4]))), CPU)
    t_cb = torch.tensor([0.05, -0.02, 0.08])
    s_log, g2 = 0.3, rng.normal(0, 0.1, 2).astype(np.float32)
    f = tprob.base.frames
    Rb, pb = tvb.dso_to_body(f.R_cw, f.t_cw, torch.tensor(s_log),
                             torch.as_tensor(g2), R_cb, t_cb)
    for k in range(F):
        jR, jp_ = jvb.dso_to_body(
            jprob.base.frames.R_cw[k], jprob.base.frames.t_cw[k],
            jnp.asarray(s_log, jnp.float32), jnp.asarray(g2),
            jnp.asarray(R_cb.numpy()), jnp.asarray(t_cb.numpy()))
        near(Rb[k], jR, 1e-6)
        near(pb[k], jp_, 1e-5)


def test_optimize_two_iterations(pair):
    jprob, jimg, tprob, timg, _ = pair
    jr = jvb.optimize_jit(jprob, jimg, max_iters=2)
    tr = tvb.optimize(tprob, timg, max_iters=2)
    assert int(tr.iters) == int(jr.iters)
    np.testing.assert_allclose(tr.frames.R_cw.numpy(),
                               np.asarray(jr.frames.R_cw), atol=1e-4)
    np.testing.assert_allclose(tr.frames.t_cw.numpy(),
                               np.asarray(jr.frames.t_cw), atol=1e-4)
    assert float(tr.states.s_log) == pytest.approx(float(jr.states.s_log),
                                                   abs=1e-4)
    np.testing.assert_allclose(tr.states.g2.numpy(),
                               np.asarray(jr.states.g2), atol=1e-4)
    np.testing.assert_allclose(tr.states.v.numpy(), np.asarray(jr.states.v),
                               atol=1e-3)
    np.testing.assert_allclose(tr.points.idepth.numpy(),
                               np.asarray(jr.points.idepth), rtol=1e-3)
    np.testing.assert_array_equal(tr.pair_outlier.numpy(),
                                  np.asarray(jr.pair_outlier))
    assert float(tr.energy) == pytest.approx(float(jr.energy), rel=1e-3)
    assert float(tr.imu_energy) == pytest.approx(float(jr.imu_energy),
                                                 rel=1e-3)
    assert float(tr.dyn_weight) == float(jr.dyn_weight) == 1.0


def test_optimize_recovers_metric_scale_and_gravity(pair):
    """The reference test's gates on the port: inter-keyframe metric
    distances, velocity magnitudes, gravity in the body frame, IMU energy."""
    _, _, tprob, timg, (v_gt, p_gt, R_gt_body) = pair
    res = tvb.optimize(tprob, timg, max_iters=20)
    Rb, pb = tvb.dso_to_body(res.frames.R_cw, res.frames.t_cw,
                             res.states.s_log, res.states.g2, torch.eye(3),
                             torch.zeros(3))
    p_est, R_est = pb.numpy(), Rb.numpy()
    for a in range(F):
        for b in range(a + 1, F):
            d_est = np.linalg.norm(p_est[a] - p_est[b])
            d_gt = np.linalg.norm(p_gt[a] - p_gt[b])
            assert abs(d_est - d_gt) / d_gt < 0.04, (a, b, d_est, d_gt)
    v_err = np.abs(np.linalg.norm(res.states.v.numpy(), axis=1)
                   - np.linalg.norm(v_gt, axis=1))
    assert v_err.max() < 0.03, v_err
    for f in range(F):
        g_est = R_est[f].T @ np.array([0.0, 0.0, -1.0])
        g_gt = R_gt_body[f].T @ np.array([0.0, 0.0, -1.0])
        ang = np.degrees(np.arccos(np.clip(g_est @ g_gt, -1, 1)))
        assert ang < 1.0, (f, ang)
    assert float(res.imu_energy) < 200.0, float(res.imu_energy)


def test_imu_off_and_dynamic_weight(pair):
    jprob, jimg, tprob, timg, _ = pair
    res = tvb.optimize(tprob._replace(imu_on=False), timg, max_iters=8)
    assert float(res.states.s_log) == pytest.approx(
        float(tprob.states.s_log), abs=1e-6)
    torch.testing.assert_close(res.states.v, tprob.states.v, rtol=0,
                               atol=1e-6)
    assert float(res.energy) < 2000.0
    rng = np.random.default_rng(0)
    noise = rng.normal(0, 40.0, np.shape(jimg)).astype(np.float32)
    jb = jvb.optimize_jit(jprob, jimg + noise, max_iters=2)
    tb = tvb.optimize(tprob, timg + torch.as_tensor(noise), max_iters=2)
    assert float(tb.vis_rmse) == pytest.approx(float(jb.vis_rmse), rel=1e-4)
    assert float(tb.vis_rmse) > tvb.DYN_RMSE_TH
    assert float(tb.dyn_weight) == pytest.approx(float(jb.dyn_weight),
                                                 rel=1e-4)


def test_vio_marg_fused(pair):
    jprob, jimg, tprob, timg, _ = pair
    age_rank = np.arange(F, dtype=np.int32)
    jo = jvb.vio_marg_fused_jit(jprob, jimg, jnp.asarray(age_rank),
                                jnp.asarray(1, jnp.int32), F - 1)
    to = tvb.vio_marg_fused(tprob, timg, torch.as_tensor(age_rank), 1, F - 1)
    vl, HM, bM, fH, fb, pts, pm, n_pre, n_post = jo
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(vl))
    assert int(np.asarray(vl)[0]) >= 0
    for got, ref in ((to[1], HM), (to[2], bM), (to[3], fH), (to[4], fb)):
        assert np.abs(np.asarray(ref)).max() > 0
        near(got, ref, 1e-4)
    np.testing.assert_array_equal(to[5].mask.numpy(), np.asarray(pts.mask))
    np.testing.assert_array_equal(to[6].numpy(), np.asarray(pm))
    assert float(to[7]) == float(n_pre) and float(to[8]) == float(n_post)


@pytest.mark.parametrize("slot", [0, 2])
def test_schur_out_np(slot):
    rng = np.random.default_rng(11 + slot)
    C = tvb.cdim_ext(F)
    A = rng.normal(size=(C + 7, C)) * np.logspace(0, 4, C)
    HM, bM = A.T @ A, rng.normal(size=C)
    marg = np.asarray(jvb.frame_marg_mask(slot, F))
    jH, jb = jvb.schur_out_np(HM, bM, marg)
    tH, tb = tvb.schur_out_np(HM, bM, marg)
    np.testing.assert_allclose(tH, jH, rtol=0, atol=1e-9 * np.abs(jH).max())
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-9 * np.abs(jb).max())
