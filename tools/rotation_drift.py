"""How far the tracked rotations drift from orthonormality, and where the
port's realtime run parts from the reference's.

Runs the port's realtime VIO (dmvio_tpu_torch, on the CPU) on the seed-3
fixture of tests/test_torch_full_vio_rt.py (192x256, 48 frames,
async_fetch=False; with `--serial`, the serial VIO of
tests/test_torch_full_vio_seed3.py on the same fixture) and prints, per
frame, det(R_c_ref) of the tracked shell, and det(R_cw) of every window
keyframe at the end. With `--ref N` (realtime only) it also runs the JAX
reference's realtime run over the first N frames of the same images and
prints, per shell, the largest difference of R_c_ref and t_c_ref between
the two, and the reference's own determinants. One JSON line each.

    python tools/rotation_drift.py [--serial | --ref N]
"""

import json
import os
import sys

# The reference under the test suite's setup (tests/conftest.py): XLA on
# the CPU with 8 virtual devices, set before anything imports jax.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from test_torch_full_vio_rt import (CFG, H, N_FRAMES, SEQ, W,  # noqa: E402
                                    imu_chunk, run_port_rt)
from test_torch_full_vio_seed3 import run_port  # noqa: E402


def main():
    args = sys.argv[1:]
    if "--serial" in args:
        port, _ = run_port(N_FRAMES)
    else:
        port, _ = run_port_rt(N_FRAMES, seed=SEQ["seed"])
    print(json.dumps({
        "shell_det": [round(float(np.linalg.det(sh.R_c_ref)), 6)
                      for sh in port.shells],
        "keyframe_det": {int(f): round(float(np.linalg.det(v[0])), 6)
                         for f, v in sorted(port.kf_poses.items())}}))
    if "--ref" in args:
        n = int(args[args.index("--ref") + 1])
        import jax

        jax.config.update("jax_platforms", "cpu")
        from dmvio_tpu.models import full_system, imu_system, window
        from dmvio_tpu.utils import synthetic

        seq = synthetic.generate_vio_sequence(
            n_frames=n, scene=synthetic.default_scene(depth=2.0), **SEQ)
        ref = full_system.FullSystem(seq["calib"], H, W,
                                     window.Config(**CFG),
                                     imu_calib=imu_system.IMUCalib())
        for i in range(n):
            ref.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                          imu_data=imu_chunk(seq, i))
        ref.finish()
        diff = [{"frame": a.frame_id, "ref_kf": [a.ref_kf_id, b.ref_kf_id],
                 "R": float(np.abs(a.R_c_ref - np.asarray(b.R_c_ref)).max()),
                 "t": float(np.abs(a.t_c_ref - np.asarray(b.t_c_ref)).max())}
                for a, b in zip(port.shells[:n], ref.shells)]
        print(json.dumps({
            "ref_shell_det": [round(float(np.linalg.det(np.asarray(
                sh.R_c_ref))), 6) for sh in ref.shells],
            "ref_keyframe_det": {
                int(f): round(float(np.linalg.det(np.asarray(v[0]))), 6)
                for f, v in sorted(ref.kf_poses.items())},
            "shell_diff": diff}))


if __name__ == "__main__":
    main()
