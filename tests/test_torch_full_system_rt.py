"""The port's realtime visual odometry against dmvio_tpu.

The fixture of tests/test_full_system.py::test_vo_realtime_pipeline (96x128,
30 frames, Config(f_max=6, p_max=512, i_max=512, max_frames=4, levels=4,
ba_iters=6, realtime=True)) goes through the port's FullSystem.add_frame
and finish() on the CPU with async_fetch=False (deterministic: every
result copy lands at submit), on the clean frames and on the frames with
sigma-1 sensor noise of test_torch_full_system_seed1.py, and once more on
the clean frames with consume-time keyframe decisions
(rt_dispatch_kf=False: the keyframe is built when its frame is consumed,
the in-flight frames are re-tracked against it and the immature pool is
rewound). The port must meet the reference test's gates: initialized and
not lost, one pose per frame, sim3 ATE < 0.04.

It is also held to the reference's own realtime run (async_fetch=False)
on the same images, over a prefix: the reference runs PREFIX frames and
finish(); the first three realtime keyframes (after the initializer's)
must have the same frame ids, and every shell from the initialization up
to the third of them the same reference keyframe and the same pose
relative to it within 1e-3 per entry. Measured: below 4.1e-4 in all
three runs, where the initializer's pose agrees to 2e-3 and each keyframe BA
reduces in another order (test_torch_full_system_seed0.py); past ~frame
13 the two runs drift apart in the last bits and only the gates apply.
"""

import numpy as np
import pytest
import torch

from dmvio_tpu.models import full_system as jfs
from dmvio_tpu.models import window as jwin
from dmvio_tpu.utils import lie as jlie
from dmvio_tpu_torch import convert
from dmvio_tpu_torch.models import full_system as tfs
from dmvio_tpu_torch.models import window as twin
from dmvio_tpu_torch.utils import trajectory as ttraj
from test_full_system import H, N_FRAMES, W, make_sequence

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

CFG = dict(f_max=6, p_max=512, i_max=512, max_frames=4, levels=4,
           ba_iters=6, realtime=True, async_fetch=False)
PREFIX = 14
POSE_ATOL = 1e-3


def frames_of(seed):
    calib, images, Rs, ts = make_sequence()
    frames = [np.array(im, np.float32) for im in images]
    if seed:
        rng = np.random.default_rng(seed)
        frames = [(f + rng.normal(0.0, 1.0, f.shape)).astype(np.float32)
                  for f in frames]
    gt = []
    for i in range(N_FRAMES):
        R_wc, t_wc = jlie.se3_inv(Rs[i], ts[i])
        gt.append((i * 0.05, np.asarray(R_wc), np.asarray(t_wc)))
    return calib, frames, gt


def run(fs, frames):
    for i, f in enumerate(frames):
        fs.add_frame(f, timestamp=i * 0.05)
    fs.finish()
    return fs


@pytest.fixture(scope="module", params=[(0, True), (1, True), (0, False)],
                ids=["clean", "noise1", "clean_consume_time"])
def runs(request):
    seed, dispatch_kf = request.param
    calib, frames, gt = frames_of(seed)
    cfg = dict(CFG, rt_dispatch_kf=dispatch_kf)
    port = run(tfs.FullSystem(convert.calib(calib, "cpu"), H, W,
                              twin.Config(**cfg), device="cpu"), frames)
    ref = run(jfs.FullSystem(calib, H, W, jwin.Config(**cfg)),
              frames[:PREFIX])
    return port, ref, gt


def test_realtime_gates(runs):
    port, _, gt = runs
    assert port.initialized and not port.is_lost
    assert port.stats_resets == 0
    est = port.trajectory()
    assert len(est) == N_FRAMES
    ate = ttraj.ate_rmse(est, gt, with_scale=True)
    assert ate < 0.04, ate


def realtime_keyframes(fs, upto):
    """Frame ids of the keyframes made after the initialization."""
    init = min(f for f in fs.kf_poses if f > fs.shells[0].frame_id)
    return init, [sh.frame_id for sh in fs.shells[:upto]
                  if sh.is_kf and sh.frame_id > init]


def test_realtime_prefix_matches_reference(runs):
    port, ref, _ = runs
    init, want = realtime_keyframes(ref, PREFIX)
    assert len(want) >= 3, want
    got_init, got = realtime_keyframes(port, PREFIX)
    assert got_init == init
    assert got[:3] == want[:3]
    for i in range(init, want[2] + 1):
        a, b = port.shells[i], ref.shells[i]
        assert (a.frame_id, a.ref_kf_id, a.is_kf) == \
            (b.frame_id, b.ref_kf_id, b.is_kf)
        np.testing.assert_allclose(a.R_c_ref, np.asarray(b.R_c_ref), rtol=0,
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(a.t_c_ref, np.asarray(b.t_c_ref), rtol=0,
                                   atol=POSE_ATOL)
