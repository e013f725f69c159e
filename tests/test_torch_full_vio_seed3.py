"""End-to-end serial visual-inertial odometry of the port on the fixture of
tests/test_full_vio.py (seed 3, 192x256, 48 frames, Config(f_max=6,
p_max=512, i_max=512, max_frames=4, levels=4, ba_iters=6)), on the CPU:
visual init -> coarse IMU init -> ACTIVE VIO with joint BA, IMU-aided
tracking, extended marginalization, the delayed log and PGBA. Scored
metrically with the reference test's gates.

One step of the slice is also held against dmvio_tpu: the reference runs
the same sequence until the first keyframe completed after the IMU became
ACTIVE; its window, inertial states, pairs and extended prior are carried
into the port with dmvio_tpu_torch.convert, and both run the VIO BA solve
and the fused extended marginalization tail on them. Tolerances of that
step (6 LM iterations, each an accept/reject on f32 energies, on a real
window): the same iteration count, poses to 2e-4, scale and gravity to
2e-4, velocities to 2e-3, idepths to 2e-3 relative, outlier masks equal,
photometric energy to 1e-3 relative; victims and point masks equal, the
prior increments to 1e-4 of their largest entry. The coarse IMU init that
activated the reference is replayed too: its init window (poses relative
to their reference keyframes, frame preintegrations, gravity
accumulator) given to the port's IMUSystem.try_initialize gives the same
decision, scale and gravity to 1e-5, energy and scale variance to 1e-4
relative (25 f32 LM iterations on a 309-dim state).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.models import ba as jba
from dmvio_tpu.models import full_system as jfs
from dmvio_tpu.models import imu_system as jimu
from dmvio_tpu.models import vio_ba as jvb
from dmvio_tpu.models import window as jwin
from dmvio_tpu.utils import synthetic as jsyn
from dmvio_tpu_torch import convert
from dmvio_tpu_torch.models import ba as tba
from dmvio_tpu_torch.models import full_system, imu_system, window
from dmvio_tpu_torch.models import vio_ba as tvb
from dmvio_tpu_torch.utils import synthetic, trajectory

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

CPU = torch.device("cpu")
H, W = 192, 256
N_FRAMES = 48
SEQ = dict(frame_dt=0.05, h=H, w=W, s_dso=1.4, g2=(0.06, -0.04),
           accel_scale=0.8, rot_scale=0.45, seed=3)
CFG = dict(f_max=6, p_max=512, i_max=512, max_frames=4, levels=4,
           ba_iters=6)


def imu_chunk(seq, i):
    if i == 0:
        return None
    spf = seq["steps_per_frame"]
    s0, s1 = (i - 1) * spf, i * spf
    return (seq["acc"][s0:s1], seq["gyr"][s0:s1],
            np.full(s1 - s0, seq["imu_dt"], np.float32))


def run_port(n_frames, **seq_kw):
    """The port's FullSystem with an IMU over the fixture on the CPU."""
    seq = synthetic.generate_vio_sequence(
        n_frames=n_frames, scene=synthetic.default_scene(2.0, device="cpu"),
        **SEQ, **seq_kw)
    fs = full_system.FullSystem(
        seq["calib"], H, W, window.Config(**CFG), device="cpu",
        imu_calib=imu_system.IMUCalib(**{k: v for k, v in seq_kw.items()
                                         if k in ("R_cb", "t_cb")}))
    for i in range(n_frames):
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=imu_chunk(seq, i))
    return fs, seq


def metric_ate(fs, seq, n_frames):
    """(se3, sim3, path length) of metric_trajectory() from first_kf + 5
    on, as tests/test_full_vio.py scores it."""
    est = fs.metric_trajectory()
    assert est is not None
    gt = [(float(seq["timestamps"][i]), np.asarray(seq["R_body"][i]),
           seq["p_gt"][i]) for i in range(n_frames)]
    first_kf = min(fs.kf_poses.keys())
    keep = [k for k, sh in enumerate(fs.shells)
            if sh.frame_id >= first_kf + 5]
    est_t = [est[k] for k in keep]
    gt_t = [gt[k] for k in keep]
    dist = float(np.sum(np.linalg.norm(np.diff(
        np.stack([g[2] for g in gt_t]), axis=0), axis=1)))
    return (trajectory.ate_rmse(est_t, gt_t, with_scale=False),
            trajectory.ate_rmse(est_t, gt_t, with_scale=True), dist)


@pytest.fixture(scope="module")
def vio_run():
    return run_port(N_FRAMES)


def test_vio_activates(vio_run):
    fs, _ = vio_run
    assert fs.initialized
    assert fs.imu.phase == imu_system.ACTIVE, fs.imu.phase
    assert fs.stats_lost_frames <= 2, fs.stats_lost_frames
    assert fs.stats_resets == 0
    assert fs.imu.pgba_count >= 1


def test_vio_metric_scale(vio_run):
    fs, _ = vio_run
    s_est = float(np.exp(fs.imu.states.s_log))
    assert np.isfinite(s_est) and 0.05 < s_est < 20.0


def test_vio_metric_trajectory(vio_run):
    fs, seq = vio_run
    ate_se3, ate_sim3, dist = metric_ate(fs, seq, N_FRAMES)
    assert ate_sim3 < 0.04 * dist + 0.01, (ate_sim3, dist)
    assert ate_se3 < 0.08 * dist + 0.01, (ate_se3, dist)


# ---------------------------------------------------------------------------
# One step of the slice against dmvio_tpu, from the reference's own state.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_step():
    """dmvio_tpu's FullSystem run to the first keyframe completed after
    the IMU became ACTIVE; returns its VIO problem (JAX), the images, the
    victim-selection inputs of its next keyframe tail, its IMU system and
    the recorded inputs and outcomes of its coarse IMU inits."""
    seq = jsyn.generate_vio_sequence(
        n_frames=N_FRAMES, scene=jsyn.default_scene(depth=2.0), **SEQ)
    fs = jfs.FullSystem(seq["calib"], H, W, jwin.Config(**CFG),
                        imu_calib=jimu.IMUCalib())
    init_calls = []
    try_initialize = fs.imu.try_initialize

    def recorded(kf_poses):
        """Record the inputs and outcome of each coarse IMU init."""
        imu = fs.imu
        call = dict(
            poses=copy.deepcopy(imu._init_poses),
            pres=[{f: np.asarray(x)
                   for f, x in zip(p._fields, jax.device_get(p))}
                  for p in imu._init_pres],
            fids=list(imu._init_fids), dts=list(imu._init_dts),
            acc_sum=imu._acc_sum.copy(), acc_n=imu._acc_n,
            warm=(jax.device_get(imu.init_result),
                  getattr(imu, "_last_init_decent", False)),
            kf_poses=copy.deepcopy(kf_poses))
        call["ok"] = try_initialize(kf_poses)
        call["res"] = jax.device_get(imu.init_result)
        init_calls.append(call)
        return call["ok"]

    fs.imu.try_initialize = recorded
    kf_at_activation = None
    for i in range(N_FRAMES):
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=imu_chunk(seq, i))
        if fs._vio_mode():
            if kf_at_activation is None:
                kf_at_activation = fs.stats_kf
            elif fs.stats_kf > kf_at_activation:
                break
    assert fs._vio_mode() and fs.stats_kf > kf_at_activation
    w, imu = fs.win, fs.imu
    base = jba.BAProblem(
        frames=w.frames, points=w.points, calib=w.calib, calib0=w.calib0,
        HM=jnp.asarray(w.HM, jnp.float32), bM0=jnp.asarray(w.bM0, jnp.float32),
        prior_diag=jnp.asarray(w.prior_diag), pair_mask=w.pair_mask)
    problem = jvb.VIOProblem(
        base=base, states=imu.states, pairs=imu.device_pairs(),
        HM=jnp.asarray(imu.HM, jnp.float32),
        bM0=jnp.asarray(imu.bM0, jnp.float32),
        prior_diag=fs._ext_prior_diag(), R_cb=imu.R_cb, t_cb=imu.t_cb,
        imu_on=jnp.asarray(True))
    slots = w.slots_by_age()
    age_rank = np.full(CFG["f_max"], -1, np.int32)
    for r_, s_ in enumerate(slots):
        age_rank[s_] = r_
    return problem, w.images, age_rank, slots[-1], imu, init_calls


def port_problem(jprob, imu):
    """The reference's VIO problem carried across with convert.py: the
    window state and the IMU system's host state, as FullSystem builds it."""
    b = jprob.base
    win = convert.window_state(jax.device_get(dict(
        frames=b.frames, points=b.points, pair_mask=b.pair_mask,
        calib=b.calib, calib0=b.calib0, images=jnp.zeros(1), HM=b.HM,
        bM0=b.bM0, prior_diag=b.prior_diag)), CPU)
    host = convert.imu_host_state(imu)
    T = lambda x: convert.tensor(np.asarray(x), CPU)  # noqa: E731
    base = tba.BAProblem(
        frames=win["frames"], points=win["points"], calib=win["calib"],
        calib0=win["calib0"], HM=T(win["HM"]), bM0=T(win["bM0"]),
        prior_diag=T(win["prior_diag"]), pair_mask=win["pair_mask"])
    return tvb.VIOProblem(
        base=base, states=convert.vio_states(jax.device_get(jprob.states),
                                             CPU),
        pairs=convert.imu_pairs(jax.device_get(jprob.pairs), CPU),
        HM=T(host["HM"]), bM0=T(host["bM0"]), prior_diag=T(jprob.prior_diag),
        R_cb=T(jprob.R_cb), t_cb=T(jprob.t_cb), imu_on=True)


def near(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-12))


def test_vio_step_matches_reference(reference_step):
    jprob, jimg, age_rank, newest, imu, _ = reference_step
    tprob = port_problem(jprob, imu)
    timg = convert.tensor(np.asarray(jimg), CPU)
    assert len(imu.pairs) >= 2 and int(tprob.pairs.valid.sum()) >= 2
    assert np.abs(imu.HM).max() > 0

    jr = jvb.optimize_jit(jprob, jimg, max_iters=CFG["ba_iters"])
    tr = tvb.optimize(tprob, timg, max_iters=CFG["ba_iters"])
    assert int(tr.iters) == int(jr.iters)
    for got, ref in ((tr.frames.R_cw, jr.frames.R_cw),
                     (tr.frames.t_cw, jr.frames.t_cw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    assert float(tr.states.s_log) == pytest.approx(float(jr.states.s_log),
                                                   abs=2e-4)
    np.testing.assert_allclose(tr.states.g2.numpy(), np.asarray(jr.states.g2),
                               atol=2e-4)
    np.testing.assert_allclose(tr.states.v.numpy(), np.asarray(jr.states.v),
                               atol=2e-3)
    m = np.asarray(jprob.base.points.mask)
    np.testing.assert_allclose(tr.points.idepth.numpy()[m],
                               np.asarray(jr.points.idepth)[m], rtol=2e-3)
    np.testing.assert_array_equal(tr.pair_outlier.numpy(),
                                  np.asarray(jr.pair_outlier))
    assert float(tr.energy) == pytest.approx(float(jr.energy), rel=1e-3)

    jo = jvb.vio_marg_fused_jit(jprob, jimg, jnp.asarray(age_rank),
                                jnp.asarray(1, jnp.int32), newest)
    to = tvb.vio_marg_fused(tprob, timg, torch.as_tensor(age_rank), 1,
                            newest)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))
    assert int(np.asarray(jo[0])[0]) >= 0
    for k in (1, 2, 3, 4):
        near(to[k], jo[k], 1e-4)
    np.testing.assert_array_equal(to[5].mask.numpy(), np.asarray(jo[5].mask))
    np.testing.assert_array_equal(to[6].numpy(), np.asarray(jo[6]))
    assert float(to[7]) == float(jo[7]) and float(to[8]) == float(jo[8])


def test_coarse_imu_init_matches_reference(reference_step):
    """The reference's activating coarse IMU init, replayed in the port's
    IMUSystem from the same init window."""
    from dmvio_tpu_torch.models import imu_init as tii

    *_, calls = reference_step
    call = next(c for c in calls if c["ok"])
    imu = imu_system.IMUSystem(imu_system.IMUCalib(), CFG["f_max"], CPU)
    imu._init_poses, imu._init_pres = call["poses"], call["pres"]
    imu._init_fids, imu._init_dts = call["fids"], call["dts"]
    imu._acc_sum, imu._acc_n = call["acc_sum"], call["acc_n"]
    warm, imu._last_init_decent = call["warm"]
    if warm is not None:
        imu.init_result = tii.CoarseInitResult(
            *(np.asarray(getattr(warm, f))
              for f in tii.CoarseInitResult._fields))
    assert imu.try_initialize(call["kf_poses"]) is True
    j, t = call["res"], imu.init_result
    assert float(t.s_log) == pytest.approx(float(j.s_log), abs=1e-5)
    np.testing.assert_allclose(t.g2, np.asarray(j.g2), atol=1e-5)
    assert float(t.s_var) == pytest.approx(float(j.s_var), rel=1e-4)
    assert float(t.energy) == pytest.approx(float(j.energy), rel=1e-4)
