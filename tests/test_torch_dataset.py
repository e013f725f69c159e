"""Dataset IO of the port (dmvio_tpu_torch/io/dataset.py) held to
dmvio_tpu/io/dataset.py on identical files, on the CPU.

Tolerances: output intrinsics to 1e-6 relative (both float32 from the same
float64 arithmetic); remap grids to 1e-5 px (float32 rounding of the same
float64 grid); the undistorted image of a seeded raw frame to 1e-4 on
0-255 intensities (the same bilinear gather in float32 on both sides); the
gamma LUT and the vignette bit for bit; IMU chunks bit for bit (the same
float64 host arithmetic); zip and folder reads of one dataset equal; the
native loader against the Python loader to 1e-3 on the interior (C++
float32 bilinear against PyTorch's, and the native pipeline's own
border rule on the last row and column).
"""

import os
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from dmvio_tpu.io import dataset as jds
from dmvio_tpu_torch.io import dataset as tds
from dmvio_tpu_torch.io import image_rw, native

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

IN_W, IN_H = 96, 80
OUT_W, OUT_H = 64, 48
# Intrinsics relative to the input size, and mild distortion per model.
REL = (0.55, 0.62, 0.5, 0.48)
DIST = {
    "pinhole": (0.0,),
    "radtan": (-0.12, 0.03, 0.001, -0.0015),
    "equidistant": (0.02, -0.01, 0.004, -0.001),
    "kannalabrandt": (-0.015, 0.006, -0.002, 0.0005),
    "fov": (0.9,),
}
MODEL_NAME = {"pinhole": "Pinhole", "radtan": "RadTan",
              "equidistant": "EquiDistant", "kannalabrandt": "KannalaBrandt",
              "fov": "FOV"}


def _camera_txt(path, model, relative, out_mode):
    fx, fy, cx, cy = REL
    if not relative:
        fx, fy = fx * IN_W, fy * IN_H
        cx, cy = cx * IN_W - 0.5, cy * IN_H - 0.5
    d = " ".join(str(x) for x in DIST[model])
    if out_mode == "explicit":
        mode = "0.5 0.6 0.5 0.5 0" if relative else \
            f"{0.5 * OUT_W} {0.6 * OUT_H} {0.5 * OUT_W - 0.5} " \
            f"{0.5 * OUT_H - 0.5} 0"
    else:
        mode = out_mode
    with open(path, "w") as f:
        f.write(f"{MODEL_NAME[model]} {fx} {fy} {cx} {cy} {d}\n")
        f.write(f"{IN_W} {IN_H}\n{mode}\n{OUT_W} {OUT_H}\n")


def _raw(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:IN_H, 0:IN_W]
    smooth = 120 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    return np.clip(smooth + rng.uniform(-20, 20, (IN_H, IN_W)), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("out_mode", ["crop", "explicit"])
@pytest.mark.parametrize("relative", [True, False],
                         ids=["relative", "absolute"])
@pytest.mark.parametrize("model", list(DIST))
def test_undistorter_matches_reference(tmp_path, model, relative, out_mode):
    path = str(tmp_path / "camera.txt")
    _camera_txt(path, model, relative, out_mode)
    ref = jds.load_undistorter(path)
    got = tds.load_undistorter(path, device="cpu")
    assert got.model == ref.model and got.out_size == ref.out_size
    np.testing.assert_array_equal(got.params, ref.params)
    k_ref = np.array([float(ref.K_out.fx), float(ref.K_out.fy),
                      float(ref.K_out.cx), float(ref.K_out.cy)])
    k_got = got.K_out.as_vec().numpy().astype(np.float64)
    np.testing.assert_allclose(k_got, k_ref, rtol=1e-6)
    assert got.K_out.fx.device.type == "cpu"
    np.testing.assert_allclose(got.remap_x, ref.remap_x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.remap_y, ref.remap_y, rtol=0, atol=1e-5)
    raw = _raw()
    img_ref = np.asarray(ref.undistort(raw))
    img_got = got.undistort(raw)
    assert img_got.dtype == torch.float32
    assert tuple(img_got.shape) == (OUT_H, OUT_W)
    np.testing.assert_allclose(img_got.numpy(), img_ref, rtol=0, atol=1e-4)


def _photometric_files(tmp_path, writer):
    """pcalib.txt and a 16-bit vignette.png (written by PIL as the JAX
    generator does, or by the port's image_rw)."""
    response = 255.0 * (np.linspace(0, 1, 256) ** 0.7)
    np.savetxt(tmp_path / "pcalib.txt", response[None], fmt="%.6f")
    yy, xx = np.mgrid[0:IN_H, 0:IN_W].astype(np.float64)
    vig = 1.0 - 0.35 * (((xx - IN_W / 2) / (IN_W / 2)) ** 2
                        + ((yy - IN_H / 2) / (IN_H / 2)) ** 2) / 2.0
    vim = (vig * 65535.0).astype(np.uint16)
    if writer == "pil":
        Image.fromarray(vim).save(tmp_path / "vignette.png")
    else:
        image_rw.write_png(str(tmp_path / "vignette.png"), vim)
    return str(tmp_path / "pcalib.txt"), str(tmp_path / "vignette.png")


@pytest.mark.parametrize("writer", ["pil", "image_rw"])
def test_gamma_lut_and_vignette_match_reference(tmp_path, writer):
    cam = str(tmp_path / "camera.txt")
    _camera_txt(cam, "pinhole", False, "crop")
    gamma, vig = _photometric_files(tmp_path, writer)
    ref = jds.load_undistorter(cam, gamma, vig)
    got = tds.load_undistorter(cam, gamma, vig, device="cpu")
    np.testing.assert_array_equal(got.gamma_inv, ref.gamma_inv)
    np.testing.assert_array_equal(got.vignette, ref.vignette)
    raw = _raw(1)
    np.testing.assert_array_equal(got.correct_photometric_np(raw),
                                  ref.correct_photometric_np(raw))
    np.testing.assert_allclose(got.undistort(raw).numpy(),
                               np.asarray(ref.undistort(raw)), rtol=0,
                               atol=1e-4)


def _write_dataset(root, imu_rows, n=6, frame_dt=0.05):
    """A small DSO folder: PNG frames, times.txt, camera.txt, imu.txt."""
    os.makedirs(root / "images", exist_ok=True)
    rng = np.random.default_rng(3)
    with open(root / "times.txt", "w") as f:
        for i in range(n):
            name = f"{i:05d}"
            img = rng.integers(0, 256, (IN_H, IN_W), dtype=np.uint8)
            Image.fromarray(img).save(root / "images" / f"{name}.png")
            f.write(f"{name} {i * frame_dt:.6f} 1.0\n")
    _camera_txt(str(root / "camera.txt"), "radtan", True, "crop")
    with open(root / "imu.txt", "w") as f:
        for r in imu_rows:
            f.write(" ".join(f"{x:.9f}" for x in r) + "\n")


def _imu_rows(ts, seed=4):
    rng = np.random.default_rng(seed)
    return [[t, *rng.normal(0, 0.1, 3), *rng.normal(0, 1.0, 3)] for t in ts]


@pytest.mark.parametrize("kind", ["dense", "straddle", "none"])
def test_imu_chunks_bit_for_bit(tmp_path, kind):
    """200 Hz samples with boundary interpolation; a 4 Hz IMU whose
    samples straddle frame gaps (the synthesized-sample fallback); and an
    IMU that starts after the last frame (no sample, no straddle)."""
    if kind == "dense":
        ts = np.arange(0.0, 0.3, 0.005) + 0.0013
    elif kind == "straddle":
        ts = np.array([0.0, 0.26, 0.52])
    else:
        ts = np.array([0.5, 0.6])
    _write_dataset(tmp_path, _imu_rows(ts))
    args = (str(tmp_path / "images"), str(tmp_path / "camera.txt"))
    kw = dict(imu_file=str(tmp_path / "imu.txt"),
              ts_file=str(tmp_path / "times.txt"))
    ref = jds.open_dataset(*args, **kw)
    got = tds.open_dataset(*args, device="cpu", **kw)
    np.testing.assert_array_equal(got.imu, ref.imu)
    assert [f.timestamp for f in got.frames] == \
        [f.timestamp for f in ref.frames]
    n_samples = 0
    for i in range(len(ref)):
        for a, b in zip(got.get_imu_chunk(i), ref.get_imu_chunk(i)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        n_samples += len(ref.get_imu_chunk(i)[2])
    assert (n_samples == 0) == (kind == "none")


def test_zip_and_folder_reads_match(tmp_path):
    _write_dataset(tmp_path, _imu_rows([0.0, 0.1]))
    with zipfile.ZipFile(tmp_path / "images.zip", "w") as z:
        for name in sorted(os.listdir(tmp_path / "images")):
            z.write(tmp_path / "images" / name, name)
    cam = str(tmp_path / "camera.txt")
    ts = str(tmp_path / "times.txt")
    folder = tds.open_dataset(str(tmp_path / "images"), cam, ts_file=ts,
                              device="cpu")
    zipped = tds.open_dataset(str(tmp_path / "images.zip"), cam, ts_file=ts,
                              device="cpu")
    ref = jds.open_dataset(str(tmp_path / "images.zip"), cam, ts_file=ts)
    assert len(folder) == len(zipped) == len(ref) == 6
    for i in range(len(folder)):
        a = folder.get_image(i)
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), zipped.get_image(i).numpy())
        np.testing.assert_allclose(a.numpy(), np.asarray(ref.get_image(i)),
                                   rtol=0, atol=1e-4)


def test_native_loader_matches_python_loader(tmp_path):
    """The prefetch pipeline (decode + gamma/vignette + remap in C++)
    against the Python loader on a photometric dataset."""
    _write_dataset(tmp_path, _imu_rows([0.0, 0.1]))
    gamma, vig = _photometric_files(tmp_path, "image_rw")
    rd = tds.open_dataset(str(tmp_path / "images"),
                          str(tmp_path / "camera.txt"), gamma=gamma,
                          vignette=vig, ts_file=str(tmp_path / "times.txt"),
                          device="cpu")
    assert rd.start_native(), native.load_error()
    for i in range(len(rd)):
        nat = rd.get_image(i)
        py = rd._get_image_py(i)
        assert nat.dtype == torch.float32 and nat.device.type == "cpu"
        np.testing.assert_allclose(nat.numpy()[:-1, :-1],
                                   py.numpy()[:-1, :-1], rtol=0, atol=1e-3)
    assert rd._native_next == len(rd)


def test_png_reader_matches_pil(tmp_path):
    """image_rw's reader (native decoder, or the pure-Python fallback)
    reads 8- and 16-bit PNGs as PIL decodes them (16-bit divided by 256)."""
    rng = np.random.default_rng(5)
    g8 = rng.integers(0, 256, (23, 31), dtype=np.uint8)
    g16 = rng.integers(0, 65536, (23, 31), dtype=np.uint16)
    for arr in (g8, g16):
        p = str(tmp_path / f"x{arr.dtype}.png")
        image_rw.write_png(p, arr)
        pil = np.asarray(Image.open(p)).astype(np.float32)
        if arr.dtype == np.uint16:
            pil = pil / 256.0
        np.testing.assert_array_equal(image_rw.read_png_gray(p), pil)
