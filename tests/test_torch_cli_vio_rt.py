"""The port's dataset CLI with the inertial system in the realtime pipeline
on a second seed, as tests/test_cli_e2e.py::test_cli_vio_realtime_second_seed
runs the reference: the port's make_synthetic at its defaults (seed 7,
60 frames, 256x320), run_dataset with useimu=1 preset=1 (realtime) and
async_fetch=0 (deterministic copies), on the CPU, scored by the sim3 ATE
of result.txt and the se3 ATE of resultScaled.txt against gt.csv.

The gates. That test's own (sim3 < 0.04 dist + 0.01 = 0.0711 m, se3 <
0.10 dist + 0.01 = 0.1628 m here) do not hold for the reference itself on
this sequence: the JAX CLI on these very files, clean and with 1e-2
intensity noise from numpy seeds 1 and 2, reads sim3 0.018514 / 0.026192
/ 0.072596 m and se3 0.045040 / 0.196822 / 0.268582 m
(`tools/reference_smoke_ate.py --cli-rt7`, the JAX package on the CPU):
two of its three runs fail the se3 gate and one the sim3 gate. Past frame
~20 the realtime tracker's candidate ladder is bistable: candidates
composed from poses whose rotations have drifted off SO(3) (ROADMAP.md
queue 3) pass the ladder's energy gate or not by fractions of a percent,
and a pass raises the gate for the next frames (`tools/rotation_drift.py
--ladder`). So the gates here are those of the repo's chaotic fixtures
(PERF.md section 2, as the smoke's VIO gates): max(that test's gate, 1.5x
the worst of the three reference runs), sim3 < 0.1089 m and se3 < 0.4029
m; the port's run reads sim3 0.0882 / se3 0.2683 m on the CPU. The
per-keyframe inertial
streams of the run are held to tests/test_full_vio.py::
test_vio_state_streams's checks."""

import os

import numpy as np
import pytest
import torch

from dmvio_tpu_torch import run_dataset
from dmvio_tpu_torch.models import imu_system
from dmvio_tpu_torch.tools import make_synthetic
from dmvio_tpu_torch.utils import trajectory

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

# Worst of the reference's three runs on these files (module docstring).
REF_SIM3 = 0.07259584655983822
REF_SE3 = 0.2685820467239982


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("cli_s7_data"))
    out = str(tmp_path_factory.mktemp("cli_s7_out")) + "/"
    make_synthetic.main([f"out={data}", "seed=7", "device=cpu"])
    summary = run_dataset.run([
        f"files={data}/images", f"calib={data}/camera.txt",
        f"tsFile={data}/times.txt", f"imuFile={data}/imu.txt",
        "useimu=1", "preset=1", f"resultsPrefix={out}", "quiet=1",
        "async_fetch=0", "device=cpu"])
    return data, out, summary


def test_cli_vio_realtime_second_seed(cli_run):
    data, out, summary = cli_run
    assert summary["imu_phase"] == imu_system.ACTIVE
    assert summary["resets"] == 0 and summary["lost_frames"] <= 2
    gt = trajectory.read_tum(os.path.join(data, "gt.csv"))
    dist = trajectory.path_length(np.stack([g[2] for g in gt]))
    est = trajectory.read_tum(out + "result.txt")
    n = min(len(est), len(gt))
    ate_sim3 = trajectory.ate_rmse(est[:n], gt[:n])
    est_s = trajectory.read_tum(out + "resultScaled.txt")
    ns = min(len(est_s), len(gt))
    ate_se3 = trajectory.ate_rmse(est_s[:ns], gt[:ns], with_scale=False)
    assert ate_sim3 < max(0.04 * dist + 0.01, 1.5 * REF_SIM3), \
        (ate_sim3, dist)
    assert ate_se3 < max(0.10 * dist + 0.01, 1.5 * REF_SE3), (ate_se3, dist)


def test_vio_state_streams(cli_run):
    """The per-keyframe inertial streams exist under the reference's file
    names, cover the VIO keyframes, and carry a sane metric scale
    (BAIMULogic.cpp:88-91 parity)."""
    _, out, summary = cli_run
    scales = np.loadtxt(out + "scalesdso.txt", ndmin=2)
    biases = np.loadtxt(out + "babiasdso.txt", ndmin=2)
    vels = np.loadtxt(out + "bavel.txt", ndmin=2)
    grav = np.loadtxt(out + "bagravdir.txt", ndmin=2)
    assert len(scales) >= 3 and len(scales) == len(biases) == len(vels)
    assert biases.shape[1] == 7 and vels.shape[1] == 4
    # Gravity directions are unit vectors.
    assert np.allclose(np.linalg.norm(grav[:, 1:], axis=1), 1.0, atol=1e-5)
    assert np.all(scales[:, 1] > 0) and np.all(np.isfinite(scales[:, 1]))
    # Published scales live in the same regime as the final estimate.
    assert 0.2 < scales[-1, 1] / summary["scale"] < 5.0
