"""Where two VIO runs of the seed-3 fixture part, frame by frame.

Runs the hard VIO fixture of tests/test_full_vio.py (192x256, 48 frames,
seed 3, `excite=` in its sequence recipe) through two FullSystems side by
side on the CPU, under the test suite's setup (8 virtual devices), and
prints per frame each run's keyframe count and IMU phase and the largest
difference of their newest tracked poses, then both final scales.

    python tools/vio_lockstep.py [excite] [n_frames]
        the port (dmvio_tpu_torch) against the reference (dmvio_tpu), both
        fed the reference's rendered frames and IMU samples;
    python tools/vio_lockstep.py --perturb SIGMA [excite] [n_frames]
        the reference against itself, the second run's frames perturbed
        by Gaussian noise of SIGMA intensity units (numpy seed 0): how far
        an input difference of that size moves the reference alone.
    python tools/vio_lockstep.py --cli OUT_DIR
        tests/test_torch_hard_eval.py's CLI comparison: the reference's
        make_synthetic writes the hard evaluation's recipe at 36 frames,
        192x256, seed 7 into OUT_DIR; the JAX CLI reads it clean and with
        1e-5 intensity noise on every loaded frame (numpy seeds 0, 1 and
        2), the port's CLI reads it on the CPU; per frame, the largest
        result.txt position gap of each noisy run and of the port to the
        clean reference, and the keyframe counts (~6 min on the CPU).
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import conftest  # noqa: E402,F401  (JAX on the CPU, 8 virtual devices)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from dmvio_tpu.models import full_system as jfs  # noqa: E402
from dmvio_tpu.models import imu_system as jimu  # noqa: E402
from dmvio_tpu.models import window as jwin  # noqa: E402
from dmvio_tpu.utils import synthetic as jsyn  # noqa: E402

H, W = 192, 256
CFG = dict(f_max=6, p_max=512, i_max=512, max_frames=4, levels=4,
           ba_iters=6)


def scale(fs):
    st = fs.imu.states
    if st is None:
        return None
    if isinstance(st.s_log, torch.Tensor):
        return float(torch.exp(st.s_log))
    return float(np.exp(np.asarray(jax.device_get(st.s_log))))


def main(argv):
    sigma = None
    if argv and argv[0] == "--perturb":
        sigma = float(argv[1])
        argv = argv[2:]
    excite = float(argv[0]) if argv else 2.0
    n = int(argv[1]) if len(argv) > 1 else 48
    seq = jsyn.generate_vio_sequence(
        n_frames=n, frame_dt=0.05, h=H, w=W, s_dso=1.4, g2=(0.06, -0.04),
        accel_scale=0.8, rot_scale=0.45, seed=3, excite=excite,
        scene=jsyn.default_scene(depth=2.0))
    a = jfs.FullSystem(seq["calib"], H, W, jwin.Config(**CFG),
                       imu_calib=jimu.IMUCalib())
    if sigma is None:
        from dmvio_tpu_torch import convert
        from dmvio_tpu_torch.models import full_system as tfs
        from dmvio_tpu_torch.models import imu_system as timu
        from dmvio_tpu_torch.models import window as twin

        torch.set_num_threads(2)
        b = tfs.FullSystem(convert.calib(seq["calib"], "cpu"), H, W,
                           twin.Config(**CFG), device="cpu",
                           imu_calib=timu.IMUCalib())

        def image_b(img):
            return torch.as_tensor(np.asarray(img))
    else:
        b = jfs.FullSystem(seq["calib"], H, W, jwin.Config(**CFG),
                           imu_calib=jimu.IMUCalib())
        rng = np.random.default_rng(0)

        def image_b(img):
            return img + jnp.asarray(rng.normal(0, sigma, img.shape),
                                     jnp.float32)
    spf = seq["steps_per_frame"]
    for i in range(n):
        chunk = None
        if i > 0:
            s0, s1 = (i - 1) * spf, i * spf
            chunk = (seq["acc"][s0:s1], seq["gyr"][s0:s1],
                     np.full(s1 - s0, seq["imu_dt"], np.float32))
        ts = float(seq["timestamps"][i])
        a.add_frame(seq["images"][i], ts, imu_data=chunk)
        b.add_frame(image_b(seq["images"][i]), ts, imu_data=chunk)
        pa, pb = a.trajectory()[-1], b.trajectory()[-1]
        dR = np.abs(np.asarray(pa[1]) - np.asarray(pb[1])).max()
        dt = np.abs(np.asarray(pa[2]) - np.asarray(pb[2])).max()
        print(f"frame {i} keyframes {a.stats_kf}/{b.stats_kf} imu phase "
              f"{a.imu.phase}/{b.imu.phase} pose diff R {dR:.3e} t "
              f"{dt:.3e}", flush=True)
    print(f"final scale {scale(a)} / {scale(b)}, resets {a.stats_resets} "
          f"/ {b.stats_resets}", flush=True)


def cli(out_dir):
    """Both CLIs on one folder written by the reference (see the module
    docstring)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_hard_eval import ARGS, CLI_FRAMES, RECIPE

    from dmvio_tpu import run_dataset as jrun
    from dmvio_tpu.io import dataset as jds
    from dmvio_tpu.tools import make_synthetic as jsynth
    from dmvio_tpu_torch import run_dataset as trun

    torch.set_num_threads(1)
    data = os.path.join(out_dir, "data")
    jsynth.main([f"out={data}", f"n={CLI_FRAMES}", *RECIPE])
    args = [f"files={data}/images", f"calib={data}/camera.txt",
            f"gammaCalib={data}/pcalib.txt", f"vignette={data}/vignette.png",
            f"tsFile={data}/times.txt", f"imuFile={data}/imu.txt", *ARGS]
    get_image = jds.DatasetReader.get_image
    runs = {}
    for noise_seed in (None, 0, 1, 2):
        rng = None if noise_seed is None \
            else np.random.default_rng(noise_seed)

        def noisy(self, i, rng=rng):
            img = get_image(self, i)
            if rng is None:
                return img
            return img + jnp.asarray(rng.normal(0, 1e-5, img.shape),
                                     jnp.float32)

        prefix = os.path.join(out_dir, f"ref_noise{noise_seed}_")
        jds.DatasetReader.get_image = noisy
        try:
            summary = jrun.run(args + [f"resultsPrefix={prefix}"])
        finally:
            jds.DatasetReader.get_image = get_image
        runs[f"ref noise {noise_seed}"] = (prefix, summary["keyframes"])
    prefix = os.path.join(out_dir, "port_")
    summary = trun.run(args + [f"resultsPrefix={prefix}", "device=cpu"])
    runs["port"] = (prefix, summary["keyframes"])
    res = {k: np.loadtxt(p + "result.txt") for k, (p, _) in runs.items()}
    clean = res.pop("ref noise None")
    print("keyframes: " + ", ".join(f"{k} {kf}" for k, (_, kf)
                                     in runs.items()))
    print("frame " + " ".join(f"{k:>12}" for k in res))
    for i in range(len(clean)):
        gaps = [np.abs(r[i, 1:4] - clean[i, 1:4]).max() for r in res.values()]
        print(f"{i:5d} " + " ".join(f"{g:12.3e}" for g in gaps), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli"]:
        cli(sys.argv[2])
    else:
        main(sys.argv[1:])
