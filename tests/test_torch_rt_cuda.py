"""The realtime pipeline on the card.

* The fetcher's pinned asynchronous copy (utils/fetch.py) equals the
  synchronous `.cpu()` of the same tree, also when the copies queue behind
  a busy stream and the source tensors are dropped right after `submit`,
  so that new kernels reuse their memory.
* One realtime keyframe with the IMU active (the deferred dispatch
  `_make_keyframe_rt_vio`, then `_finalize_kf`), with kernel K1 live, on
  the card against the port's own CPU result from the same state. The
  port runs tests/test_full_vio.py's seed-3 fixture (192x256) in realtime
  mode on the CPU (async_fetch=False) until its first dispatch-time
  keyframe with the IMU active and no PGBA running; that state is copied
  to both devices, PGBA runs in the foreground in both, and the keyframe
  is built and finalized. Tolerances as in test_torch_vio_cuda.py (6 LM
  iterations of f32 on two devices, whose reductions and dense solves
  round differently): window poses to 2e-4, scale and gravity to 2e-4,
  velocities to 2e-3, the extended prior to 1e-4 of its largest entry;
  the same slots, victims and point masks.
* The realtime VIO of that fixture end to end on the card with the
  users' asynchronous copies (async_fetch=True), over 60 frames: the PGBA
  snapshot is copied asynchronously and PGBA runs on its background
  thread; the reference realtime test's health gates (ACTIVE, no reset,
  at most 2 lost frames, finite metric poses), K1 live.

This file imports no JAX, so that the machine with the card runs it on
its own:

    python -m pytest tests/test_torch_rt_cuda.py -m cuda --noconftest \\
        -o addopts="" -q
"""

import copy

import numpy as np
import pytest
import torch

from dmvio_tpu_torch.models import full_system, imu_system, vio_ba, window
from dmvio_tpu_torch.ops import patch_sample
from dmvio_tpu_torch.utils import fetch, synthetic, timing
from dmvio_tpu_torch.utils.camera import Calib

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

H, W, N_FRAMES = 192, 256, 48
CFG = dict(f_max=6, p_max=512, i_max=512, max_frames=4, levels=4,
           ba_iters=6, realtime=True, async_fetch=False, rt_kf_density=3.0)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU form)")


@pytest.mark.cuda
def test_fetcher_copy_equals_sync_copy_under_memory_reuse():
    need_card()
    dev = torch.device("cuda")
    st = vio_ba.VIOStates(
        *(torch.arange(24, dtype=torch.float32, device=dev).reshape(8, 3)
          * (k + 1) for k in range(10)))
    four = torch.tensor(4, dtype=torch.int32, device=dev)
    n = 1 << 20
    fetcher = fetch.AsyncFetcher(enabled=True)

    def make_tree():
        big = torch.arange(n, dtype=torch.float32, device=dev) * 3.0
        return (big, (st, None, [big[:7] > 5.0]), big[::2], four)

    # Warm the pinned-memory cache, whose first allocations may wait for
    # the device.
    fetcher.submit(make_tree()).result()
    # Queue the sources behind a busy stream, so that the copies are
    # still pending when their sources are dropped.
    torch.cuda._sleep(1_000_000_000)
    tree = make_tree()
    want = (np.arange(n, dtype=np.float32) * 3.0,)
    fut = fetcher.submit(tree)
    done_at_submit = fut.done()
    del tree
    for _ in range(4):     # reuse the freed memory with other values
        junk = torch.full((n,), -1.0, device=dev)
        junk.mul_(7.0)
    a, (s, none, (flag,)), strided, k = fut.result()
    assert not done_at_submit
    assert none is None and isinstance(s, vio_ba.VIOStates)
    np.testing.assert_array_equal(a, want[0])
    np.testing.assert_array_equal(strided, want[0][::2])
    np.testing.assert_array_equal(flag, want[0][:7] > 5.0)
    assert int(k) == 4
    for j, x in enumerate(s):
        np.testing.assert_array_equal(
            x, np.arange(24, dtype=np.float32).reshape(8, 3) * (j + 1))
    torch.cuda.synchronize()


class _Captured(Exception):
    pass


class _CaptureSystem(full_system.FullSystem):
    """Stops the run at the first dispatch-time keyframe with the IMU
    active and no PGBA thread running, keeping a copy of the state just
    before it and the keyframe's arguments."""

    capture = True

    def _make_keyframe_rt_vio(self, *args, **kwargs):
        if self.capture and self._vio_mode() and self.imu._pgba_bg is None:
            self.capture = False
            self.captured = (copy.deepcopy(self), copy.deepcopy(args),
                             copy.deepcopy(kwargs))
            raise _Captured()
        return super()._make_keyframe_rt_vio(*args, **kwargs)


def _ours(v) -> bool:
    """An object of the port (or of a test's subclass of one)."""
    return hasattr(v, "__dict__") and any(
        c.__module__.startswith("dmvio_tpu_torch") for c in type(v).__mro__)


def move(x, dev):
    """A deep copy of `x` with every tensor (and device) on `dev`."""
    x = copy.deepcopy(x)
    seen = {}

    def go(v):
        if id(v) in seen:
            return seen[id(v)]
        if isinstance(v, torch.Tensor):
            out = v.to(dev)
        elif isinstance(v, torch.device):
            out = dev
        elif isinstance(v, Calib):
            out = v.to(dev)
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            out = type(v)(*(go(a) for a in v))
        elif isinstance(v, (tuple, list)):
            out = type(v)(go(a) for a in v)
        elif isinstance(v, dict):
            out = {k: go(a) for k, a in v.items()}
        elif _ours(v):
            seen[id(v)] = v
            for k, a in vars(v).items():
                setattr(v, k, go(a))
            return v
        else:
            out = v
        seen[id(v)] = out
        return out
    return go(x)


def fixture(n_frames, dev):
    return synthetic.generate_vio_sequence(
        n_frames=n_frames, frame_dt=0.05, h=H, w=W, s_dso=1.4,
        g2=(0.06, -0.04), accel_scale=0.8, rot_scale=0.45, seed=3,
        scene=synthetic.default_scene(2.0, device=dev))


def feed(fs, seq, n_frames):
    spf = seq["steps_per_frame"]
    for i in range(n_frames):
        chunk = None
        if i > 0:
            s0, s1 = (i - 1) * spf, i * spf
            chunk = (seq["acc"][s0:s1], seq["gyr"][s0:s1],
                     np.full(s1 - s0, seq["imu_dt"], np.float32))
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=chunk)


def captured_state():
    seq = fixture(N_FRAMES, "cpu")
    fs = _CaptureSystem(seq["calib"], H, W, window.Config(**CFG),
                        device="cpu", imu_calib=imu_system.IMUCalib())
    try:
        feed(fs, seq, N_FRAMES)
    except _Captured:
        return fs.captured
    raise AssertionError("no realtime VIO keyframe in the fixture")


def tensor_devices(x, seen=None) -> set:
    """Device types of every tensor reachable through the port's objects
    and containers."""
    seen = set() if seen is None else seen
    if id(x) in seen:
        return set()
    seen.add(id(x))
    if isinstance(x, torch.Tensor):
        return {x.device.type}
    if isinstance(x, Calib):
        return {x.device.type}
    if isinstance(x, (tuple, list)):
        items = x
    elif isinstance(x, dict):
        items = x.values()
    elif _ours(x):
        items = vars(x).values()
    else:
        return set()
    out = set()
    for a in items:
        out |= tensor_devices(a, seen)
    return out


def keyframe_step(captured, dev):
    """Build and finalize the captured keyframe on `dev`."""
    state, args, kwargs = move(captured, torch.device(dev))
    assert tensor_devices((state, args, kwargs)) == {dev}
    state.capture = False
    state.imu.pgba_background = False
    state._make_keyframe_rt_vio(*args, **kwargs)
    state._finalize_kf()
    return state


def compare(gpu, cpu):
    assert gpu.win.slot_frame_id == cpu.win.slot_frame_id
    assert gpu._n_active == cpu._n_active
    assert torch.equal(gpu.win.points.mask.cpu(), cpu.win.points.mask)
    assert sorted(gpu.kf_poses) == sorted(cpu.kf_poses)
    for f in cpu.win.slot_frame_id:
        if f is not None:
            for a, b in zip(gpu.kf_poses[f], cpu.kf_poses[f]):
                np.testing.assert_allclose(a, b, rtol=0, atol=2e-4)
    gs, cs = (fetch.to_host(s.imu.states) for s in (gpu, cpu))
    np.testing.assert_allclose(gs.s_log, cs.s_log, rtol=0, atol=2e-4)
    np.testing.assert_allclose(gs.g2, cs.g2, rtol=0, atol=2e-4)
    np.testing.assert_allclose(gs.v, cs.v, rtol=0, atol=2e-3)
    np.testing.assert_allclose(gpu.imu.HM, cpu.imu.HM, rtol=0,
                               atol=1e-4 * np.abs(cpu.imu.HM).max())


@pytest.mark.cuda
def test_realtime_vio_keyframe_on_card_matches_cpu():
    need_card()
    captured = captured_state()
    cpu = keyframe_step(captured, "cpu")
    patch_sample.sample_patch3.launches = 0
    gpu = keyframe_step(captured, "cuda")
    torch.cuda.synchronize()
    assert patch_sample.sample_patch3.launches > 0
    assert gpu._kf_finalize is None and gpu.device.type == "cuda"
    compare(gpu, cpu)


@pytest.mark.cuda
def test_realtime_vio_on_card_runs_pgba_in_background():
    need_card()
    n = 60
    seq = fixture(n, "cuda")
    fs = full_system.FullSystem(
        seq["calib"], H, W, window.Config(**dict(CFG, async_fetch=True)),
        imu_calib=imu_system.IMUCalib())
    timing.reset()
    patch_sample.sample_patch3.launches = 0
    feed(fs, seq, n)
    fs.finish()
    if fs.imu._pgba_bg is not None:
        fs.imu._pgba_bg["thread"].join(timeout=120)
        assert not fs.imu._pgba_bg["thread"].is_alive()
    torch.cuda.synchronize()
    stats = timing.get_stats()
    assert fs.device.type == "cuda"
    assert patch_sample.sample_patch3.launches > 0
    assert fs.imu.phase == imu_system.ACTIVE, fs.imu.phase
    assert fs.stats_resets == 0
    assert fs.stats_lost_frames <= 2, fs.stats_lost_frames
    assert stats["pgba_snapshot"]["n"] >= 1 and stats["pgba_thread"]["n"] >= 1
    est = fs.metric_trajectory()
    assert len(est) == n
    assert all(np.all(np.isfinite(p[1])) and np.all(np.isfinite(p[2]))
               for p in est)
