"""The port's live pipeline on the CPU, as tests/test_live_and_aux.py holds
the reference's: run_with_source's capture thread -> IMUInterpolator ->
FrameContainer -> FullSystem path with adaptive skipping, on a replayed
stream and on an emulated asynchronous sensor (IMU faster than frames,
acc/gyr as separate interleaved callbacks, delivery jitter, a burst that
forces skips), and run_live's source=folder: replay of a dataset written
by the port's make_synthetic."""

import time

import numpy as np
import torch

from dmvio_tpu_torch import run_live
from dmvio_tpu_torch.io import live
from dmvio_tpu_torch.models import full_system, imu_system, window
from dmvio_tpu_torch.utils import synthetic, trajectory
from dmvio_tpu_torch.utils.camera import Calib

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_run_live_replay_pipeline():
    H, W, N = 96, 128, 16
    calib = Calib.create(100.0, 100.0, W / 2 - 0.5, H / 2 - 0.5, device=CPU)
    scene = synthetic.default_scene(depth=2.0, device=CPU)
    imgs = []
    for i in range(N):
        center = torch.tensor([0.035 * i, 0.0, 0.0])
        imgs.append(synthetic.render(scene, torch.eye(3), -center, calib,
                                     H, W).numpy())

    cfg = window.Config(f_max=6, p_max=256, i_max=256, max_frames=4,
                        levels=4, ba_iters=4)
    fs = full_system.FullSystem(calib, H, W, cfg, device=CPU)
    container = live.FrameContainer()
    skipper = live.FrameSkippingStrategy()
    fs.output_wrappers.append(skipper)

    def feed(interp):
        t = 0.0
        for i in range(N):
            for _ in range(5):
                t += 0.01
                interp.add_gyr_data(np.zeros(3), t)
                interp.add_acc_data(np.array([0, 0, 9.81]), t)
            interp.add_image(imgs[i], t)

    n = run_live.run_with_source(feed, fs, container, skipper, quiet=True)
    assert n >= N // 2          # skipping may drop backlog frames
    assert len(fs.shells) == n
    assert fs.initialized


def test_run_with_source_async_sensor():
    H, W, N = 128, 160, 36
    seq = synthetic.generate_vio_sequence(
        n_frames=N, frame_dt=0.05, h=H, w=W,
        s_dso=1.4, g2=(0.06, -0.04), accel_scale=0.8, rot_scale=0.45,
        seed=3, scene=synthetic.default_scene(depth=2.0, device=CPU))
    images = [im.numpy() for im in seq["images"]]
    spf = seq["steps_per_frame"]
    dt_imu = float(seq["imu_dt"])

    def feed(interp):
        # IMU samples stream between frames, acc and gyr as SEPARATE
        # callbacks with different arrival order: the interpolator must
        # pair them.
        for i in range(N):
            if i > 0:
                for k in range((i - 1) * spf, i * spf):
                    ts = float(seq["imu_ts"][k]) + dt_imu
                    if k % 2 == 0:
                        interp.add_gyr_data(seq["gyr"][k], ts)
                        interp.add_acc_data(seq["acc"][k], ts)
                    else:
                        interp.add_acc_data(seq["acc"][k], ts)
                        interp.add_gyr_data(seq["gyr"][k], ts)
            interp.add_image(images[i], float(seq["timestamps"][i]))
            # Delivery jitter; a burst in the middle builds a backlog.
            if 12 <= i < 22:
                continue
            time.sleep(0.002)

    cfg = window.Config(f_max=6, p_max=256, i_max=256, max_frames=4,
                        levels=4, ba_iters=4)
    fs = full_system.FullSystem(seq["calib"], H, W, cfg, device=CPU,
                                imu_calib=imu_system.IMUCalib())
    container = live.FrameContainer()
    skipper = live.FrameSkippingStrategy(
        maxskip_visual_init=0, maxskip_visual_only=1,
        maxskip_vio=2, maxskip_reset=10)
    fs.output_wrappers.append(skipper)
    n_processed = run_live.run_with_source(
        feed, fs, container, skipper, quiet=True)

    assert fs.initialized
    assert fs.stats_kf >= 3
    # The burst may force skips (processed <= delivered), but the skipped
    # frames' IMU chunks are merged, not dropped.
    assert 0 < n_processed <= N
    assert len(fs.shells) == n_processed


def test_run_live_folder_replay(tmp_path):
    """run_live.run(source=folder:...) on a port-written dataset, with the
    stream recorded by the DatasetSaver."""
    from dmvio_tpu_torch.tools import make_synthetic

    data = tmp_path / "data"
    make_synthetic.main([f"out={data}", "n=16", "w=128", "h=96",
                         "accel=0.4", "rot=0.2", "device=cpu"])
    out = str(tmp_path) + "/live_"
    summary = run_live.run([
        f"source=folder:{data}", f"calib={data}/camera.txt",
        f"tsFile={data}/times.txt", f"imuFile={data}/imu.txt", "useimu=1",
        f"resultsPrefix={out}", f"saveDatasetDir={tmp_path}/saved",
        "quiet=1", "f_max=6", "p_max=256", "i_max=256", "max_frames=4",
        "levels=4", "ba_iters=4", "device=cpu"])
    assert 8 <= summary["frames"] <= 16 and summary["initialized"]
    est = trajectory.read_tum(out + "result.txt")
    assert len(est) == summary["frames"]
    assert all(np.all(np.isfinite(e[2])) for e in est)
    saved = sorted((tmp_path / "saved" / "images").iterdir())
    assert len(saved) == summary["frames"]
