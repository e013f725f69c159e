"""Accuracy reference for chip_smoke.py's main path, from dmvio_tpu.

Runs the JAX reference (dmvio_tpu, XLA on the CPU, under the test suite's
8-virtual-device setup) on the exact sequence that chip_smoke.py drives
through the PyTorch port: 40 frames of `default_scene(depth=2.0)` at
512x512 (fx = fy = 380) along bench.py's warm-up path, with
Config(f_max=8, p_max=2048, i_max=2048, max_frames=7, levels=6,
ba_iters=6). Prints one JSON line with the sim3 ATE, the path length and
the run's health counters. chip_smoke.py's ATE gate is the larger of 3% of
the path and 1.5x the ATE printed here (recorded in PERF.md).

    python tools/reference_smoke_ate.py [n_frames]
"""

import json
import os
import sys
import time

os.environ["DMVIO_XLA_CACHE"] = "off"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dmvio_tpu.models import full_system, window  # noqa: E402
from dmvio_tpu.utils import lie, synthetic, trajectory  # noqa: E402
from dmvio_tpu.utils.camera import Calib  # noqa: E402

H = W = 512


def pose(i):
    """bench.py `_warm_pose_fn`: world-to-cam pose of frame i."""
    center = np.array([0.035 * i, 0.015 * np.sin(i * 0.4), 0.004 * i])
    w_vec = np.array([0.002 * i, -0.004 * i, 0.001 * i])
    R_wc = np.asarray(lie.so3_exp(jnp.asarray(w_vec)))
    R_cw = R_wc.T
    return (jnp.asarray(R_cw, jnp.float32),
            jnp.asarray(-R_cw @ center, jnp.float32))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    calib = Calib.create(380.0, 380.0, W / 2 - 0.5, H / 2 - 0.5)
    scene = synthetic.default_scene(depth=2.0)
    cfg = window.Config(f_max=8, p_max=2048, i_max=2048, max_frames=7,
                        levels=6, ba_iters=6, realtime=False)
    fs = full_system.FullSystem(calib, H, W, cfg)
    gt = []
    t0 = time.perf_counter()
    for i in range(n):
        R, t = pose(i)
        fs.add_frame(synthetic.render(scene, R, t, calib, H, W),
                     timestamp=i * 0.05)
        R_wc, t_wc = lie.se3_inv(R, t)
        gt.append((i * 0.05, np.asarray(R_wc), np.asarray(t_wc)))
    wall = time.perf_counter() - t0
    est = fs.trajectory()
    centers = np.stack([g[2] for g in gt])
    print(json.dumps({
        "frames": n, "ate_sim3": trajectory.ate_rmse(est, gt),
        "path_length": float(np.linalg.norm(np.diff(centers, axis=0),
                                            axis=1).sum()),
        "keyframes": fs.stats_kf, "resets": fs.stats_resets,
        "lost_frames": fs.stats_lost_frames,
        "initialized": bool(fs.initialized), "is_lost": bool(fs.is_lost),
        "wall_s_cpu": wall}))


if __name__ == "__main__":
    main()
