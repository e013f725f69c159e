"""The port's serial visual odometry against dmvio_tpu, seed 1: the
tests/test_full_system.py frames with sensor noise (sigma 1 intensity
unit) from numpy's default_rng(1). Gates and tolerances as in
test_torch_full_system_seed0.py."""

import pytest
import torch

from test_torch_full_system_seed0 import (check_ate, check_first_tracked,
                                          check_gates, check_initializer,
                                          run_pair)

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

SEED = 1


@pytest.fixture(scope="module")
def run():
    return run_pair(SEED)


def test_port_initializes_and_tracks(run):
    check_gates(run)


def test_port_trajectory_ate(run):
    check_ate(run)


def test_port_initializer_matches_reference(run):
    check_initializer(run)


def test_port_first_tracked_frame_matches_reference(run):
    check_first_tracked(run)
