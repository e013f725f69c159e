"""Dataset reading: DSO-format folders, undistortion, photometric calib.

Counterpart of dmvio_tpu/io/dataset.py, itself the counterpart of DM-VIO's
input stack:
  * ImageFolderReader (src/dso/util/DatasetReader.h:107): images + times.txt
    + imu.txt + gt file, with per-frame IMU association (:250).
  * Undistort (src/dso/util/Undistort.{h,cpp}): geometric models Pinhole /
    RadTan / Equidistant / KannalaBrandt / FOV with "crop" optimal-K
    computation, and photometric correction (gamma response + vignette,
    PhotometricUndistorter::processFrame, Undistort.h:51).

The undistortion remap grid is computed once on the host (NumPy float64)
from the forward distortion and uploaded once to the working device; per
frame the photometrically corrected raw image is uploaded and remapped
there (ops/interp.bilinear plus the reference's border mask). That remap is
plain PyTorch: the JAX package runs it as XLA, not as a Pallas kernel. The
native prefetch pipeline (io/native.py) instead decodes, corrects and
remaps on host worker threads, as in the reference; its host image is
uploaded once per frame. File formats match the reference, so existing
dataset preparations (TUM-VI/EuRoC dso folders) work unchanged.
`load_undistorter` and `open_dataset` take `device=`: None means CUDA and
raises without it.
"""

from __future__ import annotations

import os
import zipfile
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

import dmvio_tpu_torch
from dmvio_tpu_torch.ops import interp
from dmvio_tpu_torch.utils.camera import Calib


# ---------------------------------------------------------------------------
# Geometric models (distort: normalized cam coords -> distorted normalized)
# ---------------------------------------------------------------------------


def _distort(model: str, params: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Apply the forward distortion of `model` to ideal normalized coords.

    Supported models mirror Undistort.h:109-160: pinhole (none), radtan
    (k1 k2 r1 r2), equidistant (k1 k2 k3 k4), kannalabrandt (k0..k3), fov
    (omega)."""
    if model == "pinhole":
        return x, y
    if model == "radtan":
        k1, k2, p1, p2 = params[4:8]
        r2 = x * x + y * y
        rad = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return xd, yd
    if model in ("equidistant", "kannalabrandt"):
        k1, k2, k3, k4 = params[4:8]
        r = np.sqrt(x * x + y * y)
        r = np.maximum(r, 1e-12)
        th = np.arctan(r)
        th2 = th * th
        thd = th * (1 + k1 * th2 + k2 * th2 ** 2 + k3 * th2 ** 3
                    + k4 * th2 ** 4)
        scale = thd / r
        return x * scale, y * scale
    if model == "fov":
        w = params[4]
        r = np.sqrt(x * x + y * y)
        r = np.maximum(r, 1e-12)
        rd = np.arctan(2.0 * r * np.tan(w / 2.0)) / w
        scale = rd / r
        return x * scale, y * scale
    raise ValueError(f"unknown camera model {model}")


def remap(img: torch.Tensor, mx: torch.Tensor,
          my: torch.Tensor) -> torch.Tensor:
    """Bilinear remap of img [H, W] at the grid (mx, my), zero outside the
    reference's border (the reference's _remap_jit)."""
    out = interp.bilinear(img, mx, my)
    h, w = img.shape
    ok = (mx >= 0) & (mx <= w - 1.001) & (my >= 0) & (my <= h - 1.001)
    return torch.where(ok, out, torch.zeros_like(out))


@dataclass
class Undistorter:
    """Precomputed remap from output (ideal pinhole) to input pixels."""

    model: str
    params: np.ndarray          # [fx fy cx cy d0 d1 d2 d3] input intrinsics
    in_size: Tuple[int, int]    # (w, h)
    out_size: Tuple[int, int]
    K_out: Calib                # on `device`
    remap_x: np.ndarray         # [H_out, W_out] input-pixel x per out pixel
    remap_y: np.ndarray
    device: torch.device
    # Photometric calibration (optional).
    gamma_inv: Optional[np.ndarray] = None   # [256] LUT: raw -> irradiance
    vignette: Optional[np.ndarray] = None    # [h_in, w_in] normalized
    _grid: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def correct_photometric_np(self, raw: np.ndarray) -> np.ndarray:
        """Gamma + vignette on the RAW image grid (host, NumPy)."""
        img = raw.astype(np.float32)
        if self.gamma_inv is not None:
            idx = np.clip(img, 0, 255).astype(np.int32)
            img = self.gamma_inv[idx]
        if self.vignette is not None:
            img = img / self.vignette
        return img

    def grid(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The remap grid on the device, uploaded at first use."""
        if self._grid is None:
            self._grid = (torch.as_tensor(self.remap_x, device=self.device),
                          torch.as_tensor(self.remap_y, device=self.device))
        return self._grid

    def undistort(self, raw: np.ndarray) -> torch.Tensor:
        """Photometric correction (host) + geometric remap (device)."""
        img = self.correct_photometric_np(raw)
        return remap(torch.as_tensor(img, device=self.device), *self.grid())


def _optimal_crop_K(model, params, in_size, out_size):
    """"crop" output intrinsics (fx, fy, cx, cy): largest distortion-free
    rectangle (reference makeOptimalK_crop, Undistort.cpp)."""
    w_in, h_in = in_size
    w_out, h_out = out_size
    fx, fy, cx, cy = params[:4]

    # Sample rays along the border of the output image; scan candidate
    # half-extents and verify their projections stay inside the input.
    def inside(x, y):
        xd, yd = _distort(model, params, x, y)
        u = xd * fx + cx
        v = yd * fy + cy
        return (u >= 1) & (u < w_in - 2) & (v >= 1) & (v < h_in - 2)

    # Binary search the maximal symmetric normalized extents.
    lo, hi = 0.01, 4.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        xs = np.linspace(-mid, mid, 65)
        aspect = (h_out / w_out)
        ys = np.linspace(-mid * aspect, mid * aspect, 65)
        border_x = np.concatenate([xs, xs, np.full(65, -mid),
                                   np.full(65, mid)])
        border_y = np.concatenate([np.full(65, -mid * aspect),
                                   np.full(65, mid * aspect), ys, ys])
        if inside(border_x, border_y).all():
            lo = mid
        else:
            hi = mid
    ext_x = lo
    ext_y = lo * (h_out / w_out)
    fx_o = w_out / (2 * ext_x)
    fy_o = h_out / (2 * ext_y)
    return fx_o, fy_o, w_out / 2 - 0.5, h_out / 2 - 0.5


def _read_vignette(path: str) -> np.ndarray:
    """Vignette image as float32 (8- or 16-bit PNG through io/image_rw, so
    no imaging package is needed; other formats through PIL). A colour
    PNG is averaged over its channels (the reference takes channel 0)."""
    if path.lower().endswith(".png"):
        from dmvio_tpu_torch.io import image_rw

        return np.asarray(image_rw.read_png_gray(path), np.float32)
    from PIL import Image

    vim = np.asarray(Image.open(path)).astype(np.float32)
    return vim[..., 0] if vim.ndim == 3 else vim


def load_undistorter(calib_file: str,
                     gamma_file: Optional[str] = None,
                     vignette_file: Optional[str] = None,
                     device=None) -> Undistorter:
    """Parse the reference camera.txt format (getUndistorterForFile,
    Undistort.h:84):

        line 1: [Model] p0 p1 p2 p3 [d...]    (or 5/8 raw numbers = legacy)
        line 2: in_w in_h
        line 3: "crop" | "full" | fx fy cx cy 0
        line 4: out_w out_h

    First-line intrinsics may be RELATIVE (fx<=1 -> multiply by size, the
    reference's convention) or absolute. The output intrinsics and the
    remap grid go to `device` (None means CUDA, and raises without it)."""
    dev = dmvio_tpu_torch.device(device)
    with open(calib_file) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    toks = lines[0].split()
    if toks[0][0].isalpha():
        model = toks[0].lower()
        vals = np.array([float(t) for t in toks[1:]], np.float64)
    else:
        vals = np.array([float(t) for t in toks], np.float64)
        model = "fov" if len(vals) == 5 and abs(vals[4]) > 1e-9 else \
            ("radtan" if len(vals) == 8 else "pinhole")
    in_w, in_h = [int(float(x)) for x in lines[1].split()]
    out_mode = lines[2].split()
    out_w, out_h = [int(float(x)) for x in lines[3].split()]

    if vals[0] <= 1.0 and vals[1] <= 1.0:   # relative intrinsics
        vals = vals.copy()
        vals[0] *= in_w
        vals[1] *= in_h
        vals[2] = vals[2] * in_w - 0.5
        vals[3] = vals[3] * in_h - 0.5
    params = np.zeros(8)
    params[:len(vals)] = vals
    if model == "pinhole":
        params[4:] = 0

    if out_mode[0] in ("crop", "full"):
        k_out = _optimal_crop_K(model, params, (in_w, in_h), (out_w, out_h))
    else:
        ofx, ofy, ocx, ocy = [float(x) for x in out_mode[:4]]
        if ofx <= 1.0:
            ofx *= out_w
            ofy *= out_h
            ocx = ocx * out_w - 0.5
            ocy = ocy * out_h - 0.5
        k_out = (ofx, ofy, ocx, ocy)
    # The output intrinsics are float32 (Calib's type); the grid is built
    # from those rounded values, as the reference builds it from its Calib.
    fx_o, fy_o, cx_o, cy_o = (float(np.float32(k)) for k in k_out)
    K_out = Calib.create(fx_o, fy_o, cx_o, cy_o, device=dev)

    # Remap: for each output pixel, ideal ray -> distort -> input pixel.
    v_idx, u_idx = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    x = (u_idx - cx_o) / fx_o
    y = (v_idx - cy_o) / fy_o
    xd, yd = _distort(model, params, x, y)
    remap_x = (xd * params[0] + params[2]).astype(np.float32)
    remap_y = (yd * params[1] + params[3]).astype(np.float32)

    gamma_inv = None
    if gamma_file and os.path.exists(gamma_file):
        g = np.loadtxt(gamma_file).astype(np.float32)   # 256 response values
        # G maps irradiance->pixel; build inverse LUT pixel->irradiance.
        g = (g - g.min()) / (g.max() - g.min()) * 255.0
        gamma_inv = np.interp(np.arange(256), g, np.arange(256)).astype(
            np.float32)
    vignette = None
    if vignette_file and os.path.exists(vignette_file):
        vim = _read_vignette(vignette_file)
        vignette = vim / vim.max()

    return Undistorter(model=model, params=params, in_size=(in_w, in_h),
                       out_size=(out_w, out_h), K_out=K_out,
                       remap_x=remap_x, remap_y=remap_y, device=dev,
                       gamma_inv=gamma_inv, vignette=vignette)


# ---------------------------------------------------------------------------
# Folder reader
# ---------------------------------------------------------------------------


def _no_samples():
    """(acc [0, 3], gyr [0, 3], dts [0]): an interval without IMU data."""
    return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
            np.zeros(0, np.float32))


@dataclass
class Frame:
    frame_id: int
    timestamp: float
    exposure: float
    image_path: str


@dataclass
class DatasetReader:
    """DSO-format dataset folder (ImageFolderReader parity). Images come
    back as float32 [H, W] tensors on the undistorter's device."""

    folder: str
    undist: Undistorter
    frames: List[Frame] = field(default_factory=list)
    imu: Optional[np.ndarray] = None       # [M, 7]: ts gx gy gz ax ay az
    gt: Optional[np.ndarray] = None        # [K, 8]: ts x y z qx qy qz qw
    _zip: Optional[zipfile.ZipFile] = None
    _native = None
    _native_next: int = -1

    def __len__(self):
        return len(self.frames)

    @property
    def device(self) -> torch.device:
        return self.undist.device

    def start_native(self, n_threads: int = 4) -> bool:
        """Start the C++ prefetch pipeline (decode + photometric + remap on
        host worker threads, overlapped with device compute). Only for
        sequential folder reads of PNG files; returns False when
        unavailable (io/native.load_error() says why the library is)."""
        from dmvio_tpu_torch.io import native as nat

        if self._zip is not None or not nat.available():
            return False
        if any(not fr.image_path.lower().endswith(".png")
               for fr in self.frames):
            return False
        w_in, h_in = self.undist.in_size
        w_out, h_out = self.undist.out_size
        self._native = nat.NativeLoader(
            [fr.image_path for fr in self.frames],
            (w_in, h_in), (w_out, h_out),
            self.undist.remap_x, self.undist.remap_y,
            gamma_lut=self.undist.gamma_inv, vignette=self.undist.vignette,
            n_threads=n_threads)
        self._native_next = 0
        return True

    def get_image(self, i: int) -> torch.Tensor:
        if self._native is not None and i == self._native_next:
            img = self._native.next()
            self._native_next += 1
            if img is not None:
                # One host-to-device copy of the finished frame.
                return torch.from_numpy(img).to(self.device)
        return self._get_image_py(i)

    def _get_image_py(self, i: int) -> torch.Tensor:
        from PIL import Image
        import io as _io

        fr = self.frames[i]
        if self._zip is not None:
            with self._zip.open(fr.image_path) as f:
                raw = np.asarray(Image.open(_io.BytesIO(f.read())))
        else:
            raw = np.asarray(Image.open(fr.image_path))
        if raw.ndim == 3:
            raw = raw.mean(axis=-1)
        if raw.dtype == np.uint16:
            raw = (raw / 256.0)
        return self.undist.undistort(raw)

    def get_imu_chunk(self, i: int) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
        """IMU samples between frame i-1 and frame i: (acc, gyr, dts).

        Mirrors getIMUData's association with boundary interpolation
        (DatasetReader.h:250)."""
        if self.imu is None or i == 0:
            return _no_samples()
        t0 = self.frames[i - 1].timestamp
        t1 = self.frames[i].timestamp
        ts = self.imu[:, 0]
        sel = (ts > t0) & (ts <= t1)
        idx = np.where(sel)[0]
        samples = []
        prev_t = t0
        for j in idx:
            samples.append((ts[j] - prev_t, self.imu[j, 1:4],
                            self.imu[j, 4:7]))
            prev_t = ts[j]
        if prev_t < t1 and len(idx) > 0:
            # End-boundary sample: interpolate between the last in-interval
            # measurement and the next one (DatasetReader.h:250 interpolates
            # the boundary rather than copying the next sample).
            j_prev = idx[-1]
            j = min(j_prev + 1, len(ts) - 1)
            span = ts[j] - ts[j_prev]
            if j > j_prev and span > 1e-9:
                a = np.clip((t1 - ts[j_prev]) / span, 0.0, 1.0)
            else:
                a = 1.0
            gyr_b = (1 - a) * self.imu[j_prev, 1:4] + a * self.imu[j, 1:4]
            acc_b = (1 - a) * self.imu[j_prev, 4:7] + a * self.imu[j, 4:7]
            samples.append((t1 - prev_t, gyr_b, acc_b))
        if not samples:
            # No sample fell inside (t0, t1], but measurements may straddle
            # the interval (low-rate IMU / dropped samples): synthesize one
            # sample spanning the frame gap from the nearest measurements
            # so the interval is not treated as inertial-data-free.
            before = np.where(ts <= t0)[0]
            after = np.where(ts > t1)[0]
            if len(before) and len(after):
                j0, j1 = before[-1], after[0]
                span = ts[j1] - ts[j0]
                a = np.clip((0.5 * (t0 + t1) - ts[j0]) / max(span, 1e-9),
                            0.0, 1.0)
                gyr_m = (1 - a) * self.imu[j0, 1:4] + a * self.imu[j1, 1:4]
                acc_m = (1 - a) * self.imu[j0, 4:7] + a * self.imu[j1, 4:7]
                samples.append((t1 - t0, gyr_m, acc_m))
        if not samples:
            return _no_samples()
        dts = np.array([s[0] for s in samples], np.float32)
        gyr = np.array([s[1] for s in samples], np.float32)
        acc = np.array([s[2] for s in samples], np.float32)
        return acc, gyr, dts


def _read_rows(path: str, width: int) -> np.ndarray:
    """Numeric rows of a text file (comments and short rows skipped)."""
    rows = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            vals = [float(x) for x in ln.replace(",", " ").split()]
            if len(vals) >= width:
                rows.append(vals[:width])
    return np.asarray(rows)


def open_dataset(files: str, calib: str,
                 gamma: Optional[str] = None,
                 vignette: Optional[str] = None,
                 imu_file: Optional[str] = None,
                 ts_file: Optional[str] = None,
                 gt_file: Optional[str] = None,
                 device=None) -> DatasetReader:
    """Open a DSO-format dataset (files dir or images.zip + sidecars) whose
    images load onto `device` (None means CUDA, and raises without it)."""
    undist = load_undistorter(calib, gamma, vignette, device=device)
    rd = DatasetReader(folder=files, undist=undist)

    names: List[str] = []
    if files.endswith(".zip"):
        rd._zip = zipfile.ZipFile(files)
        names = sorted(n for n in rd._zip.namelist()
                       if n.lower().endswith((".png", ".jpg")))
    else:
        names = sorted(
            os.path.join(files, n) for n in os.listdir(files)
            if n.lower().endswith((".png", ".jpg")))

    times = {}
    exposures = {}
    if ts_file and os.path.exists(ts_file):
        with open(ts_file) as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                parts = ln.split()
                fid = parts[0]
                times[fid] = float(parts[1])
                if len(parts) > 2:
                    exposures[fid] = float(parts[2])

    for i, path in enumerate(names):
        stem = os.path.splitext(os.path.basename(path))[0]
        ts = times.get(stem, float(i) / 20.0)
        rd.frames.append(Frame(
            frame_id=i, timestamp=ts,
            exposure=exposures.get(stem, 1.0), image_path=path))
    rd.frames.sort(key=lambda fr: fr.timestamp)

    if imu_file and os.path.exists(imu_file):
        rd.imu = _read_rows(imu_file, 7)
    if gt_file and os.path.exists(gt_file):
        rd.gt = _read_rows(gt_file, 8)
    return rd
