"""Checkpoint / resume of the port's FullSystem on the CPU, as
tests/test_live_and_aux.py::test_checkpoint_resume_continues_identically
holds the reference's: 96x128, 26 frames of the seed-5 sequence, saved at
frame 18, both the uninterrupted and the resumed system fed frames 18-25;
their trajectories agree to ATE < 5e-3 (on the CPU the port is
deterministic, so they agree exactly), and an attached TrajectoryLogger
received the poses and the status. With an IMU the checkpoint carries the
inertial side state (init window, keyframe-chunk buffers, pending pairs,
the delayed log) and the resumed system continues identically too."""

import os

import numpy as np
import pytest
import torch

from dmvio_tpu_torch.io.output_wrapper import TrajectoryLogger
from dmvio_tpu_torch.models import full_system, imu_system, window
from dmvio_tpu_torch.utils import synthetic, trajectory

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

CPU = torch.device("cpu")
H, W, N = 96, 128, 26


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_vio_sequence(
        n_frames=N, frame_dt=0.05, h=H, w=W, accel_scale=0.8,
        rot_scale=0.45, seed=5, device=CPU)


def _cfg():
    return window.Config(f_max=5, p_max=256, i_max=256, max_frames=3,
                         levels=4, ba_iters=4)


def _feed(fs, seq, lo, hi, imu):
    spf = seq["steps_per_frame"]
    for i in range(lo, hi):
        chunk = None
        if imu and i > 0:
            s0, s1 = (i - 1) * spf, i * spf
            chunk = (seq["acc"][s0:s1], seq["gyr"][s0:s1],
                     np.full(s1 - s0, seq["imu_dt"], np.float32))
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=chunk)


@pytest.mark.parametrize("imu", [False, True], ids=["vo", "vio"])
def test_checkpoint_resume_continues_identically(seq, tmp_path, imu):
    fs = full_system.FullSystem(
        seq["calib"], H, W, _cfg(), device=CPU,
        imu_calib=imu_system.IMUCalib() if imu else None)
    log = TrajectoryLogger()
    fs.output_wrappers.append(log)
    _feed(fs, seq, 0, 18, imu)
    assert fs.initialized

    path = os.path.join(tmp_path, "ckpt.pkl")
    fs.save_checkpoint(path)
    fs2 = full_system.FullSystem.load_checkpoint(path, device="cpu")
    assert fs2.device == CPU and fs2.win.frames.R_cw.device == CPU
    if imu:
        assert fs2.imu.phase == fs.imu.phase
        assert len(fs2.imu._init_poses) == len(fs.imu._init_poses) > 0
        assert len(fs2.imu._kf_dts) == len(fs.imu._kf_dts)
        assert len(fs2.imu._pending_pairs) == len(fs.imu._pending_pairs)

    _feed(fs, seq, 18, N, imu)
    _feed(fs2, seq, 18, N, imu)
    t1 = fs.trajectory()
    t2 = fs2.trajectory()
    assert len(t1) == len(t2) == N
    # Resumed run matches the uninterrupted one closely.
    ate = trajectory.ate_rmse(t1, t2, with_scale=False)
    assert ate < 5e-3, ate
    assert fs2.stats_kf == fs.stats_kf
    # Observer chain received poses and a status.
    assert len(log.poses) > 5
    assert len(log.statuses) >= 1
