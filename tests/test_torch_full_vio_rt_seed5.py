"""The port's realtime visual-inertial odometry on the fixture of
test_torch_full_vio_rt.py with generator seed 5 (a file of its own, so that
the two run in parallel), with the same gates. Measured (realtime,
async_fetch=False, se3 / sim3 in % of path): the reference 8.99 / 2.27,
the port 12.51 / 2.45 (96% of the se3 gate)."""

import pytest
import torch

from test_torch_full_vio_rt import N_FRAMES, check_gates, run_port_rt

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vio_rt():
    return run_port_rt(N_FRAMES, seed=5)


def test_realtime_vio_gates(vio_rt):
    check_gates(*vio_rt, N_FRAMES)
