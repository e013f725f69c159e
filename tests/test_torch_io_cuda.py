"""The IO slice on the card.

* Undistortion (photometric correction on the host, bilinear remap on the
  device) on the card against the CPU, on a distorted RadTan camera with a
  gamma response and a vignette: to 1e-4 on 0-255 intensities (the same
  float32 gather on two devices).
* A checkpoint saved on the card and loaded on the card continues like the
  uninterrupted card run (96x128, 26 frames of the seed-5 sequence, saved
  at frame 18; trajectories to ATE < 5e-3, as the reference's resume test
  holds its own); the same checkpoint loads onto the CPU and tracks the
  next frame there.
* A small run_dataset run with device=cuda (the port's make_synthetic on
  the card, 36 frames at 192x256, the native loader, the viewers and the
  IMU streams attached): every output file, health and the CLI test
  suite's sim3 gate.

This file imports no JAX, so that the machine with the card runs it on
its own:

    python -m pytest tests/test_torch_io_cuda.py -m cuda --noconftest \\
        -o addopts="" -q
"""

import os

import numpy as np
import pytest
import torch

from dmvio_tpu_torch import run_dataset
from dmvio_tpu_torch.io import dataset as ds
from dmvio_tpu_torch.io import image_rw
from dmvio_tpu_torch.models import full_system, window
from dmvio_tpu_torch.tools import make_synthetic
from dmvio_tpu_torch.utils import synthetic, trajectory

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_undistortion_on_card_matches_cpu(tmp_path):
    need_card()
    cam = tmp_path / "camera.txt"
    cam.write_text("RadTan 0.55 0.62 0.5 0.48 -0.12 0.03 0.001 -0.0015\n"
                   "96 80\ncrop\n64 48\n")
    response = 255.0 * (np.linspace(0, 1, 256) ** 0.7)
    np.savetxt(tmp_path / "pcalib.txt", response[None], fmt="%.6f")
    yy, xx = np.mgrid[0:80, 0:96].astype(np.float64)
    vig = 1.0 - 0.3 * (((xx - 48) / 48) ** 2 + ((yy - 40) / 40) ** 2) / 2
    image_rw.write_png(str(tmp_path / "vignette.png"),
                       (vig * 65535).astype(np.uint16))
    args = (str(cam), str(tmp_path / "pcalib.txt"),
            str(tmp_path / "vignette.png"))
    gpu = ds.load_undistorter(*args)                # device=None: the card
    cpu = ds.load_undistorter(*args, device="cpu")
    assert gpu.K_out.fx.is_cuda
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (80, 96)).astype(np.uint8)
    a = gpu.undistort(raw)
    assert a.is_cuda
    np.testing.assert_allclose(a.cpu().numpy(), cpu.undistort(raw).numpy(),
                               rtol=0, atol=1e-4)


def _seq(dev):
    return synthetic.generate_vio_sequence(
        n_frames=26, frame_dt=0.05, h=96, w=128, accel_scale=0.8,
        rot_scale=0.45, seed=5, device=dev)


def _feed(fs, seq, lo, hi):
    for i in range(lo, hi):
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]))


@pytest.mark.cuda
def test_checkpoint_on_card_resumes_and_loads_on_cpu(tmp_path):
    need_card()
    seq = _seq(torch.device("cuda"))
    cfg = window.Config(f_max=5, p_max=256, i_max=256, max_frames=3,
                        levels=4, ba_iters=4)
    fs = full_system.FullSystem(seq["calib"], 96, 128, cfg)
    _feed(fs, seq, 0, 18)
    assert fs.initialized
    path = str(tmp_path / "ckpt.pkl")
    fs.save_checkpoint(path)
    fs2 = full_system.FullSystem.load_checkpoint(path)
    assert fs2.device.type == "cuda" and fs2.win.frames.R_cw.is_cuda
    _feed(fs, seq, 18, 26)
    _feed(fs2, seq, 18, 26)
    t1, t2 = fs.trajectory(), fs2.trajectory()
    assert len(t1) == len(t2) == 26
    assert trajectory.ate_rmse(t1, t2, with_scale=False) < 5e-3

    fs3 = full_system.FullSystem.load_checkpoint(path, device="cpu")
    assert fs3.device.type == "cpu" and fs3.imm.u.device.type == "cpu"
    assert fs3.calib.fx.device.type == "cpu"
    fs3.add_frame(seq["images"][18].cpu(), float(seq["timestamps"][18]))
    assert len(fs3.shells) == 19 and not fs3.is_lost
    assert np.all(np.isfinite(fs3.trajectory()[-1][2]))


@pytest.mark.cuda
def test_run_dataset_on_card(tmp_path):
    need_card()
    data = str(tmp_path / "data")
    out = str(tmp_path / "out") + "/"
    os.makedirs(out)
    make_synthetic.main([f"out={data}", "n=36", "w=256", "h=192",
                         "accel=0.4", "rot=0.2", "photometric=1"])
    summary = run_dataset.run([
        f"files={data}/images", f"calib={data}/camera.txt",
        f"tsFile={data}/times.txt", f"imuFile={data}/imu.txt", "useimu=1",
        f"gammaCalib={data}/pcalib.txt", f"vignette={data}/vignette.png",
        f"resultsPrefix={out}", "quiet=1", "nogui=0", "viewerPort=0",
        "p_max=1024", "i_max=1024", "device=cuda"])
    assert summary["device"].startswith("cuda")
    assert summary["native_loader"] and summary["initialized"]
    assert summary["resets"] == 0
    for f in ("result.txt", "resultKFs.txt", "timings.txt",
              "usedSettings.txt", "viz/index.html"):
        assert os.path.getsize(out + f) > 0, f
    # The inertial streams exist (rows only once the IMU is active).
    assert os.path.exists(out + "scalesdso.txt")
    est = trajectory.read_tum(out + "result.txt")
    gt = trajectory.read_tum(os.path.join(data, "gt.csv"))
    assert len(est) == 36
    dist = trajectory.path_length(np.stack([g[2] for g in gt]))
    ate = trajectory.ate_rmse(est, gt)
    assert ate < 0.04 * dist + 0.01, (ate, dist)
