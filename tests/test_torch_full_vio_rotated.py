"""End-to-end serial VIO of the port on a 90-degree-rotated camera-IMU rig
(the fixture of tests/test_full_vio.py::test_vio_rotated_rig_metric, on the
CPU): the whole inertial stack - coarse filter, init window, window BA,
delayed log, PGBA - runs through the real T_cam_imu and must still deliver
a metric trajectory, under the reference test's gates (sim3 < 0.04 dist +
0.01, se3 < 0.15 dist + 0.01).
"""

import numpy as np
import torch

from dmvio_tpu_torch.models import imu_system
from dmvio_tpu_torch.models.vio_coarse import _exp_so3
from test_torch_full_vio_seed3 import N_FRAMES, metric_ate, run_port

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)


def test_vio_rotated_rig_metric():
    R_cb = _exp_so3(np.array([np.pi / 2, 0.0, 0.0])).astype(np.float32)
    t_cb = np.array([0.06, -0.03, 0.04], np.float32)
    fs, seq = run_port(N_FRAMES, R_cb=R_cb, t_cb=t_cb)
    assert fs.initialized
    assert fs.imu.phase == imu_system.ACTIVE, fs.imu.phase
    ate_se3, ate_sim3, dist = metric_ate(fs, seq, N_FRAMES)
    assert ate_sim3 < 0.04 * dist + 0.01, (ate_sim3, dist)
    assert ate_se3 < 0.15 * dist + 0.01, (ate_se3, dist)
