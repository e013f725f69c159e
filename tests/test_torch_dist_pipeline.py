"""The port's sharded BA inside the real pipeline (Config.mesh_devices),
as tests/test_dist_pipeline.py holds the reference.

The seed-3 synthetic VIO sequence (128x160, 48 frames) runs through the
port's FullSystem on the CPU twice: on one device, and with its
point-axis programs (the extended visual-inertial BA, the fused
marginalization tail, the extended point marginalization) over 8 shards
of the CPU. The sharded run must reach ACTIVE with no lost frame and meet
the reference test's sim3 gate (< 0.06 dist + 0.01). On the final window
state of the single run, the sharded VIO BA (max_iters=4) and the fused
tail must equal the single dispatch at the reference test's tolerances:
energy rtol 2e-3, t_cw and s_log atol 2e-4, idepth rtol 5e-3 / atol 1e-4;
the tail's victims and the points' mask exactly, its prior increment to
rtol 5e-3 / atol 5e-3.
"""

import numpy as np
import pytest
import torch

from dmvio_tpu_torch.models import ba, full_system, imu_system, vio_ba
from dmvio_tpu_torch.models import window
from dmvio_tpu_torch.parallel import dist_ba
from dmvio_tpu_torch.utils import synthetic, trajectory

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

H, W = 128, 160
N_FRAMES = 48


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_vio_sequence(
        n_frames=N_FRAMES, frame_dt=0.05, h=H, w=W,
        s_dso=1.4, g2=(0.06, -0.04), accel_scale=0.8, rot_scale=0.45,
        seed=3, scene=synthetic.default_scene(2.0, device="cpu"))


def _run(seq, mesh_devices):
    cfg = window.Config(f_max=6, p_max=256, i_max=256, max_frames=4,
                        levels=4, ba_iters=4, mesh_devices=mesh_devices)
    fs = full_system.FullSystem(seq["calib"], H, W, cfg, device="cpu",
                                imu_calib=imu_system.IMUCalib())
    spf = seq["steps_per_frame"]
    for i in range(N_FRAMES):
        chunk = None
        if i > 0:
            s0, s1 = (i - 1) * spf, i * spf
            chunk = (seq["acc"][s0:s1], seq["gyr"][s0:s1],
                     np.full(s1 - s0, seq["imu_dt"], np.float32))
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=chunk)
    fs.finish()
    return fs


@pytest.fixture(scope="module")
def runs(seq):
    return _run(seq, 0), _run(seq, 8)


def test_mesh_pipeline_activates(runs):
    fs_1, fs_mesh = runs
    assert fs_1.placer is None
    assert fs_mesh.placer is not None and fs_mesh.placer.n_shards == 8
    assert fs_mesh.initialized
    assert fs_mesh.imu.phase == imu_system.ACTIVE, fs_mesh.imu.phase
    assert fs_mesh.stats_lost_frames == 0


def test_sharded_programs_match_on_real_state(runs):
    fs, _ = runs
    w = fs.win
    assert fs.imu.phase == imu_system.ACTIVE
    problem = fs._vio_problem()
    res_1 = vio_ba.optimize(problem, w.images, max_iters=4)
    placer = dist_ba.Placer(dist_ba.make_mesh(8, device="cpu"))
    res_m = placer.gather(vio_ba.optimize(
        placer.place_vio(problem), placer.place_images(w.images),
        max_iters=4))
    np.testing.assert_allclose(float(res_m.energy), float(res_1.energy),
                               rtol=2e-3)
    np.testing.assert_allclose(res_m.frames.t_cw.numpy(),
                               res_1.frames.t_cw.numpy(), atol=2e-4)
    np.testing.assert_allclose(res_m.states.s_log.numpy(),
                               res_1.states.s_log.numpy(), atol=2e-4)
    np.testing.assert_allclose(res_m.points.idepth.numpy(),
                               res_1.points.idepth.numpy(),
                               rtol=5e-3, atol=1e-4)

    # The fused marginalization tail on the same state, visual and
    # extended.
    F = fs.cfg.f_max
    age = np.full(F, -1, np.int32)
    for r_, s_ in enumerate(w.slots_by_age()):
        age[s_] = r_
    age = torch.as_tensor(age)
    m_1 = ba.marg_fused(problem.base, w.images, age, 1, w.newest_slot())
    m_m = placer.gather(ba.marg_fused(
        placer.place_ba(problem.base), placer.place_images(w.images), age,
        1, w.newest_slot()))
    np.testing.assert_array_equal(m_m[0].numpy(), m_1[0].numpy())
    np.testing.assert_allclose(m_m[1].numpy(), m_1[1].numpy(), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_array_equal(m_m[3].mask.numpy(), m_1[3].mask.numpy())
    v_1 = vio_ba.vio_marg_fused(problem, w.images, age, 1, w.newest_slot())
    v_m = placer.gather(vio_ba.vio_marg_fused(
        placer.place_vio(problem), placer.place_images(w.images), age, 1,
        w.newest_slot()))
    np.testing.assert_array_equal(v_m[0].numpy(), v_1[0].numpy())
    for k in (1, 2, 3, 4):
        np.testing.assert_allclose(v_m[k].numpy(), v_1[k].numpy(),
                                   rtol=5e-3, atol=5e-3)
    np.testing.assert_array_equal(v_m[5].mask.numpy(), v_1[5].mask.numpy())
    np.testing.assert_array_equal(v_m[6].numpy(), v_1[6].numpy())


def test_mesh_accuracy_vs_gt(runs, seq):
    """The mesh run on its own merits: metric trajectory against GT."""
    _, fs_m = runs
    est = fs_m.metric_trajectory()
    gt = [(float(seq["timestamps"][i]), np.asarray(seq["R_body"][i]),
           seq["p_gt"][i]) for i in range(N_FRAMES)]
    first_kf = min(fs_m.kf_poses.keys())
    est_t = [e for e, sh in zip(est, fs_m.shells)
             if sh.frame_id >= first_kf + 5]
    gt_t = [g for g, sh in zip(gt, fs_m.shells)
            if sh.frame_id >= first_kf + 5]
    ate = trajectory.ate_rmse(est_t, gt_t, with_scale=True)
    dist = np.sum(np.linalg.norm(np.diff(
        np.stack([g[2] for g in gt_t]), axis=0), axis=1))
    assert ate < 0.06 * dist + 0.01, (ate, dist)
