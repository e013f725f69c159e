"""Write a synthetic VIO dataset in the DSO folder format.

Usage:
    python -m dmvio_tpu_torch.tools.make_synthetic out=DIR [n=60 w=320
        h=256 seed=0 photometric=0 exposure_var=0 device=cuda]

Counterpart of dmvio_tpu/tools/make_synthetic.py, with the same keys,
defaults and files: images/ PNG frames, times.txt (id ts exposure),
camera.txt (Pinhole), imu.txt (ts gyro acc), gt.csv (TUM body poses) and
meta.npz with exact ground truth; with photometric=1 also pcalib.txt (the
response) and vignette.png (16-bit). Frames are rendered by the port's
utils/synthetic on `device` (None or absent means CUDA) and written with
io/image_rw, so no imaging package is needed.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from dmvio_tpu_torch.io import image_rw
from dmvio_tpu_torch.utils import lie, synthetic


def main(argv=None):
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:]) if "=" in a)
    if "out" not in args:
        raise SystemExit(__doc__)
    out = args["out"]
    n = int(args.get("n", 60))
    w = int(args.get("w", 320))
    h = int(args.get("h", 256))
    seed = int(args.get("seed", 0))

    seq = synthetic.generate_vio_sequence(
        n_frames=n, h=h, w=w, seed=seed,
        accel_scale=float(args.get("accel", 0.8)),
        rot_scale=float(args.get("rot", 0.45)),
        excite=float(args.get("excite", 0.0)),
        excite_until=float(args.get("excite_until", 0.0)),
        s_dso=float(args.get("s_dso", 1.0)),
        device=args.get("device"))
    fx, fy, cx, cy = (float(v) for v in seq["calib"].as_vec().cpu())

    # Auto-exposure emulation: exposure_var=V > 0 modulates the shutter
    # time smoothly by up to +-V around 1.0 (a TUM-VI-like auto-exposure
    # sweep); image values scale with the shutter, and the true exposure
    # is written to times.txt column 3 (the reference's dataset format;
    # its brightness model is exposure-relative, NumType.h:174).
    exp_var = float(args.get("exposure_var", 0.0))
    rng = np.random.default_rng(seed + 101)
    phase = rng.uniform(0, 2 * np.pi)
    exposures = 1.0 + exp_var * np.sin(
        0.35 * np.arange(n) + phase).astype(np.float64)

    # Photometric-calibration emulation (photometric=1): bake a known
    # camera response (gamma) and lens vignette into the raw frames and
    # write the calibration files in the reference's formats: pcalib.txt
    # with the 256-value response G (TUM monoVO format) and a 16-bit
    # vignette.png. The raw pixel model is the reference's,
    #   I_raw = G(exposure * V(x) * irradiance),
    # so gammaCalib= / vignette= recover the clean sequence (up to 8-bit
    # quantization).
    photometric = int(args.get("photometric", 0))
    gamma_pow = float(args.get("gamma", 0.7))
    vig_strength = float(args.get("vig", 0.35))
    vignette_map = None
    response = None
    os.makedirs(out, exist_ok=True)
    if photometric:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        r2 = (((xx - w / 2) / (w / 2)) ** 2
              + ((yy - h / 2) / (h / 2)) ** 2) / 2.0
        vignette_map = 1.0 - vig_strength * r2
        # Response: G maps irradiance [0,255] -> pixel value [0,255].
        response = 255.0 * (np.linspace(0, 1, 256) ** gamma_pow)
        np.savetxt(os.path.join(out, "pcalib.txt"),
                   response[None], fmt="%.6f")
        image_rw.write_png(os.path.join(out, "vignette.png"),
                           (vignette_map * 65535.0).astype(np.uint16))

    img_dir = os.path.join(out, "images")
    os.makedirs(img_dir, exist_ok=True)

    with open(os.path.join(out, "times.txt"), "w") as tf:
        for i, ts in enumerate(seq["timestamps"]):
            name = f"{i:05d}"
            frame = seq["images"][i].cpu().numpy() * exposures[i]
            if photometric:
                irr = np.clip(frame * vignette_map, 0, 255)
                img = np.interp(irr, np.arange(256), response)
                img = np.clip(np.round(img), 0, 255).astype(np.uint8)
            else:
                img = np.clip(frame, 0, 255).astype(np.uint8)
            image_rw.write_png(os.path.join(img_dir, name + ".png"), img)
            tf.write(f"{name} {ts:.6f} {exposures[i]:.6f}\n")

    with open(os.path.join(out, "camera.txt"), "w") as cf:
        cf.write(f"Pinhole {fx} {fy} {cx} {cy} 0\n")
        cf.write(f"{w} {h}\n")
        cf.write(f"{fx} {fy} {cx} {cy} 0\n")
        cf.write(f"{w} {h}\n")

    with open(os.path.join(out, "imu.txt"), "w") as mf:
        for k in range(len(seq["imu_ts"])):
            g = seq["gyr"][k]
            a = seq["acc"][k]
            # Sample covers (t, t+dt]; the reader associates by timestamp.
            ts = seq["imu_ts"][k] + seq["imu_dt"]
            mf.write(f"{ts:.6f} {g[0]:.9f} {g[1]:.9f} {g[2]:.9f} "
                     f"{a[0]:.9f} {a[1]:.9f} {a[2]:.9f}\n")

    with open(os.path.join(out, "gt.csv"), "w") as gf:
        for i, ts in enumerate(seq["timestamps"]):
            Rb = seq["R_body"][i]
            p = seq["p_gt"][i]
            q = lie.quat_from_rot(
                torch.as_tensor(np.asarray(Rb), dtype=torch.float32)).numpy()
            gf.write(f"{ts:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                     f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")

    np.savez(os.path.join(out, "meta.npz"),
             p_gt=seq["p_gt"], v_gt=seq["v_gt"],
             timestamps=seq["timestamps"],
             s_dso=seq["s_dso"], g2=seq["g2"])
    print(f"wrote {n} frames to {out}")


if __name__ == "__main__":
    main()
