"""The port's dataset CLI end to end on the CPU, with the gates of
tests/test_cli_e2e.py: a folder dataset written by the port's
make_synthetic (seed 0, 36 frames, 192x256) -> undistortion -> odometry ->
result.txt / resultKFs.txt / timings.txt / usedSettings.txt, scored
against the generator's ground truth; and the same sequence under a +-30%
exposure sweep. The port's make_synthetic writes the JAX generator's
files: equal text for times, camera, IMU, response and ground truth
(ground truth to its printed precision), equal vignette, and frames whose
8-bit pixels differ by at most one level where the two renderers' float32
rounding straddles a quantization step."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from dmvio_tpu.tools import make_synthetic as jsynth
from dmvio_tpu_torch import run_dataset
from dmvio_tpu_torch.tools import make_synthetic
from dmvio_tpu_torch.utils import trajectory

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

N_FRAMES = 36
SYNTH = [f"n={N_FRAMES}", "w=256", "h=192", "accel=0.4", "rot=0.2",
         "device=cpu"]
RUN = ["quiet=1", "nativeLoader=0", "p_max=1024", "i_max=1024",
       "device=cpu"]


def _run(data, out, extra=()):
    return run_dataset.run([
        f"files={data}/images", f"calib={data}/camera.txt",
        f"tsFile={data}/times.txt", f"resultsPrefix={out}", *RUN, *extra])


def ate_of_run(data, out):
    est = trajectory.read_tum(out + "result.txt")
    gt = trajectory.read_tum(os.path.join(data, "gt.csv"))
    n = min(len(est), len(gt))
    ate = trajectory.ate_rmse(est[:n], gt[:n])
    Q = np.stack([g[2] for g in gt[:n]])
    dist = float(np.sum(np.linalg.norm(np.diff(Q, axis=0), axis=1)))
    return ate, dist


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("cli_data"))
    out = str(tmp_path_factory.mktemp("cli_out")) + "/"
    make_synthetic.main([f"out={data}", *SYNTH])
    summary = _run(data, out)
    return data, out, summary


def test_cli_outputs_exist(cli_run):
    _, out, summary = cli_run
    for f in ("result.txt", "resultKFs.txt", "timings.txt",
              "usedSettings.txt"):
        assert os.path.getsize(out + f) > 0, f
    assert summary["device"] == "cpu" and summary["frames"] == N_FRAMES
    assert summary["resets"] == 0 and summary["native_loader"] is False


def test_cli_trajectory_accuracy(cli_run):
    data, out, _ = cli_run
    assert len(trajectory.read_tum(out + "result.txt")) == N_FRAMES
    ate, dist = ate_of_run(data, out)
    # The reference's gate: ~2% of path measured there, gated at 2x.
    assert ate < 0.04 * dist + 0.01, (ate, dist)


def test_cli_kf_trajectory_subset(cli_run):
    _, out, _ = cli_run
    est = trajectory.read_tum(out + "result.txt")
    kfs = trajectory.read_tum(out + "resultKFs.txt")
    ts_all = {round(e[0], 6) for e in est}
    assert 3 <= len(kfs) < len(est)
    assert all(round(k[0], 6) in ts_all for k in kfs)


def test_cli_exposure_invariance(cli_run, tmp_path):
    """The same sequence with a +-30% shutter sweep (times.txt column 3,
    images scaled accordingly) tracks as well as the constant-exposure
    run: the exposure-relative brightness model."""
    data_c, out_c, _ = cli_run
    data = str(tmp_path / "data")
    out = str(tmp_path) + "/out_"
    make_synthetic.main([f"out={data}", *SYNTH, "exposure_var=0.3"])
    _run(data, out)
    ate_e, dist_e = ate_of_run(data, out)
    ate_c, _ = ate_of_run(data_c, out_c)
    assert ate_e < 0.08 * dist_e + 0.02, (ate_e, dist_e)
    assert ate_e < 2.5 * ate_c + 0.01, (ate_e, ate_c)


def test_make_synthetic_files_match_jax(tmp_path):
    args = ["n=4", "w=128", "h=96", "seed=3", "photometric=1",
            "exposure_var=0.3"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jsynth.main([f"out={jdir}", *args])
    make_synthetic.main([f"out={tdir}", *args, "device=cpu"])
    names = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*"))
    assert names(jdir) == names(tdir)
    for f in ("times.txt", "imu.txt", "pcalib.txt"):
        assert (jdir / f).read_text() == (tdir / f).read_text(), f
    np.testing.assert_array_equal(
        np.loadtxt(jdir / "camera.txt", max_rows=1, usecols=(1, 2, 3, 4)),
        np.loadtxt(tdir / "camera.txt", max_rows=1, usecols=(1, 2, 3, 4)))
    np.testing.assert_allclose(np.loadtxt(jdir / "gt.csv"),
                               np.loadtxt(tdir / "gt.csv"), rtol=0,
                               atol=2e-6)
    zj, zt = np.load(jdir / "meta.npz"), np.load(tdir / "meta.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zj[k], zt[k])
    vig = [np.asarray(Image.open(d / "vignette.png")) for d in (jdir, tdir)]
    np.testing.assert_array_equal(*vig)
    for p in sorted((jdir / "images").iterdir()):
        a = np.asarray(Image.open(p)).astype(np.int32)
        b = np.asarray(Image.open(tdir / "images" / p.name)).astype(np.int32)
        assert a.shape == b.shape and a.dtype == b.dtype
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, p.name
