"""The port's realtime visual-inertial odometry on the seed-3 fixture of
tests/test_full_vio.py (192x256, 48 frames), on the CPU, with the
reference test_vio_realtime_pipeline's Config (f_max=6, p_max=512,
i_max=512, max_frames=4, levels=4, ba_iters=6, realtime=True,
async_fetch=False, rt_kf_density=3.0): dispatch-time keyframe decisions,
the IMU preview prior through the in-flight chunks, deferred inertial
keyframes (_make_keyframe_rt_vio / _finalize_kf_vio), the asynchronous
PGBA snapshot and PGBA on its background thread. Gates of the reference
test: ACTIVE, at most 2 lost frames, sim3 < 0.035 dist + 0.01, se3 < 0.12
dist + 0.01 (no reset, at least one PGBA cycle besides).

Measured on this fixture (realtime, async_fetch=False, se3 / sim3 in % of
path): the reference 9.15 / 2.05 clean, 3.22 / 1.84 and 1.63 / 1.05 with
1e-2 intensity noise from numpy seeds 1 and 2; the port 12.63 / 2.23 clean
(97% of the se3 gate), 1.96 / 1.26 and 8.25 / 1.52 with the same noise.
The estimator is chaotic on this short fixture (PERF.md), so the port's
runs land in the same spread, not on the reference's values.

A prefix is held to the reference's own realtime run on the same images:
the reference runs PREFIX frames and finish(); the keyframes it made
(the IMU is not active yet) must be the port's, and every shell from the
initialization to the third realtime keyframe the same reference keyframe
and pose relative to it within 2e-3 per entry. Measured: below 6.7e-4 up
to the third (frame 12), 2.5e-3 at frame 13, where the drift of the
tracked rotations away from orthonormality (in both implementations,
ROADMAP.md queue 3) has grown to 2e-3 and the two runs part in it.
"""

import numpy as np
import pytest
import torch

from dmvio_tpu.models import full_system as jfs
from dmvio_tpu.models import imu_system as jimu
from dmvio_tpu.models import window as jwin
from dmvio_tpu.utils import synthetic as jsyn
from dmvio_tpu_torch.models import full_system, imu_system, window
from dmvio_tpu_torch.utils import synthetic
from test_torch_full_vio_seed3 import H, SEQ, W, imu_chunk, metric_ate

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

N_FRAMES = 48
PREFIX = 16
POSE_ATOL = 2e-3
CFG = dict(f_max=6, p_max=512, i_max=512, max_frames=4, levels=4,
           ba_iters=6, realtime=True, async_fetch=False, rt_kf_density=3.0)


def run_port_rt(n_frames, seed):
    """The port's realtime FullSystem with an IMU over the fixture with
    generator seed `seed`, on the CPU, flushed with finish()."""
    seq = synthetic.generate_vio_sequence(
        n_frames=n_frames, scene=synthetic.default_scene(2.0, device="cpu"),
        **dict(SEQ, seed=seed))
    fs = full_system.FullSystem(seq["calib"], H, W, window.Config(**CFG),
                                device="cpu",
                                imu_calib=imu_system.IMUCalib())
    for i in range(n_frames):
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=imu_chunk(seq, i))
    fs.finish()
    return fs, seq


def check_gates(fs, seq, n_frames):
    assert fs.initialized
    assert fs.imu.phase == imu_system.ACTIVE, fs.imu.phase
    assert fs.stats_lost_frames <= 2, fs.stats_lost_frames
    assert fs.stats_resets == 0
    assert fs.imu.pgba_count >= 1
    ate_se3, ate_sim3, dist = metric_ate(fs, seq, n_frames)
    assert ate_sim3 < 0.035 * dist + 0.01, (ate_sim3, dist)
    assert ate_se3 < 0.12 * dist + 0.01, (ate_se3, dist)


@pytest.fixture(scope="module")
def vio_rt():
    return run_port_rt(N_FRAMES, seed=3)


def test_realtime_vio_gates(vio_rt):
    check_gates(*vio_rt, N_FRAMES)


def test_realtime_vio_prefix_matches_reference(vio_rt):
    port, _ = vio_rt
    seq = jsyn.generate_vio_sequence(
        n_frames=PREFIX, scene=jsyn.default_scene(depth=2.0), **SEQ)
    ref = jfs.FullSystem(seq["calib"], H, W, jwin.Config(**CFG),
                         imu_calib=jimu.IMUCalib())
    for i in range(PREFIX):
        ref.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                      imu_data=imu_chunk(seq, i))
    ref.finish()
    want = [sh.frame_id for sh in ref.shells if sh.is_kf]
    got = [sh.frame_id for sh in port.shells[:PREFIX] if sh.is_kf]
    assert len(want) >= 5, want
    assert got == want
    init = want[1]
    for i in range(init, want[4] + 1):
        a, b = port.shells[i], ref.shells[i]
        assert (a.frame_id, a.ref_kf_id) == (b.frame_id, b.ref_kf_id)
        np.testing.assert_allclose(a.R_c_ref, np.asarray(b.R_c_ref), rtol=0,
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(a.t_c_ref, np.asarray(b.t_c_ref), rtol=0,
                                   atol=POSE_ATOL)
