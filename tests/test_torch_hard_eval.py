"""The reference's hard TUM-VI-shaped evaluation (tests/test_hard_eval.py)
at a CPU cut: its make_synthetic recipe (baked gamma response and
vignette, a +-10% auto-exposure sweep, 6 s of excitation, s_dso 1.4) and
its run_dataset arguments, through both packages.

(a) Dataset parity, 40 frames at 192x256, seed 7: both make_synthetics
    write byte-equal text files (times, camera, IMU, response, gt.csv)
    and meta.npz members (the .npy files inside; the zip headers carry
    the time of writing), equal vignette values, and frames of which at
    most 1e-4 of the pixels differ, each by at most one gray level (where
    the two renderers' float32 rounding straddles a quantization step).

(b) The slice as a whole on identical input: both CLIs read one folder
    written by the reference's make_synthetic (36 frames at 192x256, seed
    7) with gammaCalib=, vignette= and the exposure column, the port on
    the CPU. On this cut the reference parts from itself at once: run
    against itself with 1e-5 intensity noise on every loaded frame (numpy
    seeds 0, 1 and 2), its result.txt positions move by up to 1.8e-5 at
    frame 0, 7.3e-4 at frame 1 and 4.6e-3 at frame 2 (the initializer's
    per-frame estimates at tiny baselines are chaotic), and by 2.3e-2 at
    frame 35. So the per-frame lockstep holds the port's result.txt to the
    reference's at LOCKSTEP_TOL (positions, DSO units) through frame
    LOCKSTEP_FRAMES - 1, the last frame before the reference parts from
    itself by more than that; the keyframe count, which none of those
    noise draws changes (13), must be equal. The port's run must also give
    the reference test's health and pair count (all but 5 frames paired:
    295 of 300 there, 31 of 36 here; ACTIVE, 0 resets, finite poses).
"""

import os
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from dmvio_tpu import run_dataset as jrun
from dmvio_tpu.tools import make_synthetic as jsynth
from dmvio_tpu_torch import run_dataset
from dmvio_tpu_torch.models import imu_system
from dmvio_tpu_torch.tools import make_synthetic
from dmvio_tpu_torch.utils import trajectory

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

# tests/test_hard_eval.py's recipe and arguments, at a CPU cut.
RECIPE = ["w=256", "h=192", "seed=7", "excite=2.0", "excite_until=6.0",
          "accel=0.5", "rot=0.3", "photometric=1", "exposure_var=0.1",
          "s_dso=1.4"]
ARGS = ["useimu=1", "preset=0", "quiet=1"]
TEXT_FILES = ("times.txt", "camera.txt", "imu.txt", "pcalib.txt", "gt.csv")
CLI_FRAMES = 36
LOCKSTEP_TOL = 1e-3
LOCKSTEP_FRAMES = 2
UNPAIRED_MAX = 5


@pytest.fixture(scope="module")
def both_datasets(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("hard_ref")
    tdir = tmp_path_factory.mktemp("hard_port")
    jsynth.main([f"out={jdir}", "n=40", *RECIPE])
    make_synthetic.main([f"out={tdir}", "n=40", *RECIPE, "device=cpu"])
    return jdir, tdir


@pytest.mark.parametrize("name", TEXT_FILES)
def test_dataset_text_files_byte_equal(both_datasets, name):
    jdir, tdir = both_datasets
    assert (jdir / name).read_bytes() == (tdir / name).read_bytes()


def test_dataset_meta_and_vignette_equal(both_datasets):
    jdir, tdir = both_datasets
    zj, zt = (zipfile.ZipFile(d / "meta.npz") for d in (jdir, tdir))
    assert zj.namelist() == zt.namelist()
    for name in zj.namelist():
        assert zj.read(name) == zt.read(name), name
    vig = [np.asarray(Image.open(d / "vignette.png")) for d in (jdir, tdir)]
    assert vig[0].dtype == vig[1].dtype
    np.testing.assert_array_equal(*vig)


def test_dataset_frames_within_one_level(both_datasets):
    jdir, tdir = both_datasets
    names = sorted(p.name for p in (jdir / "images").iterdir())
    assert names == sorted(p.name for p in (tdir / "images").iterdir())
    assert len(names) == 40
    n_diff = n_px = 0
    for name in names:
        a = np.asarray(Image.open(jdir / "images" / name)).astype(np.int32)
        b = np.asarray(Image.open(tdir / "images" / name)).astype(np.int32)
        assert a.shape == b.shape == (192, 256)
        d = np.abs(a - b)
        assert d.max() <= 1, name
        n_diff += int(np.count_nonzero(d))
        n_px += d.size
    assert n_diff <= 1e-4 * n_px, (n_diff, n_px)


def _args(data, out):
    return [f"files={data}/images", f"calib={data}/camera.txt",
            f"gammaCalib={data}/pcalib.txt", f"vignette={data}/vignette.png",
            f"tsFile={data}/times.txt", f"imuFile={data}/imu.txt", *ARGS,
            f"resultsPrefix={out}"]


@pytest.fixture(scope="module")
def both_clis(tmp_path_factory):
    data = tmp_path_factory.mktemp("hard_cli_data")
    jout = str(tmp_path_factory.mktemp("hard_cli_ref")) + "/"
    tout = str(tmp_path_factory.mktemp("hard_cli_port")) + "/"
    jsynth.main([f"out={data}", f"n={CLI_FRAMES}", *RECIPE])
    jsum = jrun.run(_args(data, jout))
    tsum = run_dataset.run(_args(data, tout) + ["device=cpu"])
    return data, (jout, jsum), (tout, tsum)


def test_cli_lockstep_until_reference_parts(both_clis):
    _, (jout, jsum), (tout, tsum) = both_clis
    ref = np.loadtxt(jout + "result.txt")
    port = np.loadtxt(tout + "result.txt")
    assert ref.shape == port.shape == (CLI_FRAMES, 8)
    np.testing.assert_array_equal(port[:, 0], ref[:, 0])
    gap = np.abs(port[:LOCKSTEP_FRAMES, 1:4] - ref[:LOCKSTEP_FRAMES, 1:4])
    assert gap.max() <= LOCKSTEP_TOL, gap.max(axis=1)
    assert tsum["keyframes"] == jsum["keyframes"]


def test_cli_health_and_pairs(both_clis):
    data, _, (tout, tsum) = both_clis
    assert tsum["frames"] == CLI_FRAMES and tsum["device"] == "cpu"
    assert tsum["imu_phase"] == imu_system.ACTIVE
    assert tsum["resets"] == 0
    est = trajectory.read_tum(tout + "resultScaled.txt")
    gt = trajectory.read_tum(os.path.join(data, "gt.csv"))
    gtd = {round(g[0], 6): g for g in gt}
    pairs = [e for e in est if round(e[0], 6) in gtd]
    assert len(pairs) >= CLI_FRAMES - UNPAIRED_MAX, len(pairs)
    assert all(np.all(np.isfinite(e[1])) and np.all(np.isfinite(e[2]))
               for e in est)
