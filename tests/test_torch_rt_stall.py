"""The port's realtime pipeline rides through a stalled result channel
(tests/test_rt_stall.py, ported).

The stall is emulated by gating the fetcher's futures: copies submitted
inside the stall window do not land until it ends, which is what a
stalled device-to-host channel looks like to the host. With dispatch-time
keyframe decisions the frame loop keeps dispatching, keyframes keep coming
from the rate-extrapolated score, and the keyframe whose host half is
stuck stretches the interval, up to rt_kf_stretch, past which the decision
blocks once on purpose.

The port runs on the CPU here at 0.1-2.5 s per frame, so the reference's
absolute "fast frame" bound (0.5 s) becomes relative: a frame is fast when
its wall time is below the median frame time before the stall plus 0.5 s.
The stall lasts ten such median frames plus 1 s, and must span at least 6
dispatched frames. Same fixture and Config as the reference test (seed 7,
192x256, 56 frames, realtime with the default rt_* knobs), and the same
assertions: no reset, at most 2 lost frames, at least 4 fast frames inside
the stall, and a keyframe built from a frame dispatched inside it.
"""

import statistics
import time
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import torch

from dmvio_tpu_torch.models import full_system, imu_system, window
from dmvio_tpu_torch.utils import synthetic

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

H, W = 192, 256
N_FRAMES = 56
STALL_START_FID = 28


class _GatedFuture:
    def __init__(self, inner, gate):
        self._inner = inner
        self._gate = gate

    def done(self):
        return time.monotonic() >= self._gate and self._inner.done()

    def result(self, timeout=None):
        dt = self._gate - time.monotonic()
        if dt > 0:
            time.sleep(dt)
        return self._inner.result(timeout)

    def exception(self, timeout=None):
        dt = self._gate - time.monotonic()
        if timeout is not None and dt > timeout:
            time.sleep(timeout)
            raise FutureTimeout()
        if dt > 0:
            time.sleep(dt)
        return self._inner.exception(timeout)


class _StallFetcher:
    """Wraps the real fetcher; futures submitted while stalled do not
    complete until `release_at`."""

    def __init__(self, inner):
        self._inner = inner
        self.release_at = 0.0

    def submit(self, tree):
        f = self._inner.submit(tree)
        if time.monotonic() < self.release_at:
            return _GatedFuture(f, self.release_at)
        return f


def test_pipeline_rides_through_link_stall():
    seq = synthetic.generate_vio_sequence(
        n_frames=N_FRAMES, frame_dt=0.05, h=H, w=W,
        s_dso=1.3, g2=(0.05, -0.03), accel_scale=0.5, rot_scale=0.3,
        seed=7, scene=synthetic.default_scene(depth=2.0, device="cpu"))
    cfg = window.Config(f_max=6, p_max=512, i_max=512, max_frames=4,
                        levels=4, ba_iters=6, realtime=True)
    fs = full_system.FullSystem(seq["calib"], H, W, cfg, device="cpu",
                                imu_calib=imu_system.IMUCalib())
    stall = _StallFetcher(fs._fetcher)
    fs._fetcher = stall

    kf_fids = []
    for name in ("_make_keyframe_rt_vio", "_make_keyframe_rt"):
        orig = getattr(fs, name)

        def wrap(pyr, fid, *a, __orig=orig, **k):
            kf_fids.append(fid)
            return __orig(pyr, fid, *a, **k)

        setattr(fs, name, wrap)

    spf = seq["steps_per_frame"]
    frame_wall = {}
    init_fid = None
    stalled_fids = None
    for i in range(N_FRAMES):
        chunk = None
        if i > 0:
            s0, s1 = (i - 1) * spf, i * spf
            chunk = (seq["acc"][s0:s1], seq["gyr"][s0:s1],
                     np.full(s1 - s0, seq["imu_dt"], np.float32))
        if i == STALL_START_FID:
            assert init_fid is not None and STALL_START_FID - init_fid > 8
            before = statistics.median(
                frame_wall[k] for k in range(init_fid + 1, i))
            stall.release_at = time.monotonic() + 10 * before + 1.0
        in_stall_now = time.monotonic() < stall.release_at
        t0 = time.monotonic()
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=chunk)
        frame_wall[i] = time.monotonic() - t0
        if init_fid is None and fs.initialized:
            init_fid = i
        if in_stall_now:
            stalled_fids = i   # newest frame fed while copies were gated
    fs.finish()

    # The system survived the stall: no reset, still tracking.
    assert fs.initialized
    assert fs.stats_resets == 0
    assert fs.stats_lost_frames <= 2, fs.stats_lost_frames

    # The frame loop kept flowing through the stall; a single bounded
    # block is allowed.
    in_stall = [frame_wall[i]
                for i in range(STALL_START_FID, stalled_fids + 1)]
    assert len(in_stall) >= 6, in_stall
    fast = sum(1 for t in in_stall if t < before + 0.5)
    assert fast >= 4, (fast, before, [round(t, 2) for t in in_stall])

    # A keyframe was built from a frame dispatched inside the stall.
    n_in_stall = sum(1 for f in kf_fids
                     if STALL_START_FID + 1 <= f <= stalled_fids)
    assert n_in_stall >= 1, (kf_fids, STALL_START_FID, stalled_fids)
