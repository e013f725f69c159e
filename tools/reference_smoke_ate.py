"""Accuracy references for chip_smoke.py's phases, from dmvio_tpu.

Runs the JAX reference (dmvio_tpu, XLA on the CPU, under the test suite's
8-virtual-device setup) on the exact sequences that chip_smoke.py drives
through the PyTorch port, and prints one JSON line per run.

VO phase (default): 40 frames of `default_scene(depth=2.0)` at 512x512
(fx = fy = 380) along bench.py's warm-up path, with Config(f_max=8,
p_max=2048, i_max=2048, max_frames=7, levels=6, ba_iters=6). The line holds
the sim3 ATE, the path length and the run's health counters. chip_smoke.py's
VO gate is the larger of 3% of the path and 1.5x the ATE printed here.

VIO phase (`--vio`): bench.py's VIO sequence (seed 2, s_dso 1.3, g2 (0.05,
-0.03), accel_scale 0.5, rot_scale 0.3, default_scene(2.0), 20 Hz frames,
200 Hz IMU) at 512x512 with the same Config and the IMU on, three runs:
the clean sequence and the sequence with 1e-2 intensity noise from numpy
seeds 1 and 2. Each run prints the frame at which the IMU became ACTIVE,
the frame that completed the first PGBA cycle, and, at every frame count
from `--from` on, the se3 and sim3 ATE of `metric_trajectory()` from
first_kf + 5 on (as tests/test_full_vio.py scores it) with its path length.
chip_smoke.py's VIO gates are the larger of the test suite's scale
(sim3 0.04 dist + 0.01, se3 0.08 dist + 0.01) and 1.5x the worst of these
runs at its frame count.

`--rt` runs the same in the realtime pipeline (Config realtime=True with
the reference's rt_* defaults and async_fetch=False, which makes the run
deterministic; flushed with finish()): the gates of chip_smoke.py's
rt-vo-512 and rt-vio-512 phases. Its VIO runs print the ATE after the last
frame only: scoring a realtime run mid-way flushes its pipeline.

`--cli` runs the JAX CLI (dmvio_tpu.run_dataset, in-process) on the
dataset that chip_smoke.py's cli-vio-512 phase writes: the JAX
make_synthetic at w=512 h=512 photometric=1 with the phase's seed (written
to build/cli_ref_data/), read with the phase's arguments (useimu=1
preset=0 nativeLoader=1, gammaCalib= and vignette=, nogui=1 since the
viewers do not change the estimate). Three runs: clean, and with 1e-2
intensity noise (numpy seeds 1 and 2) added to every loaded frame. Each
prints the frame at which the IMU turned ACTIVE, the frame that completed
the first PGBA cycle, and, at every frame count from `--from` on, the sim3
ATE of trajectory() and the se3 ATE of metric_trajectory() against the
ground truth over all frames (what result.txt and resultScaled.txt give
against gt.csv), with the path length. The phase's frame count is the
smallest at which every run is ACTIVE with a PGBA cycle done; its gates
are max(the CLI test suite's share of path, 1.5x the worst of the runs).

`--cli-rt7` runs the JAX CLI the same way (clean and the two noise seeds)
on the files of tests/test_torch_cli_vio_rt.py: the PORT's make_synthetic
(on the CPU) at its defaults with seed 7 (256x320, 60 frames;
build/cli_ref_rt7/), so the reference reads the very files the port's
test reads, with useimu=1 preset=1 (realtime) async_fetch=0, as the
reference's own test_cli_vio_realtime_second_seed runs it; each run prints
the sim3 ATE of result.txt and the se3 ATE of resultScaled.txt against
gt.csv after the last frame, with the path length. The port's test gates
are max(that test's gates, 1.5x the worst of these runs).

    python tools/reference_smoke_ate.py [--rt] [n_frames]
    python tools/reference_smoke_ate.py [--rt] --vio [n_frames] [--from N]
    python tools/reference_smoke_ate.py --cli [n_frames] [--from N]
        [--noise K]     (one run: K = 0 clean, or a noise seed)
    python tools/reference_smoke_ate.py --cli-rt7 [--noise K]
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

from dmvio_tpu.models import full_system, imu_system, window  # noqa: E402
from dmvio_tpu.utils import lie, synthetic, trajectory  # noqa: E402
from dmvio_tpu.utils.camera import Calib  # noqa: E402

H = W = 512
CFG = dict(f_max=8, p_max=2048, i_max=2048, max_frames=7, levels=6,
           ba_iters=6, realtime=False)
# bench.py's VIO sequence (bench_vio), also chip_smoke.py's VIO phase.
VIO_SEQ = dict(frame_dt=0.05, h=H, w=W, s_dso=1.3, g2=(0.05, -0.03),
               accel_scale=0.5, rot_scale=0.3, seed=2)
NOISE_SEEDS = (None, 1, 2)     # clean, then 1e-2 intensity noise


def pose(i):
    """bench.py `_warm_pose_fn`: world-to-cam pose of frame i."""
    center = np.array([0.035 * i, 0.015 * np.sin(i * 0.4), 0.004 * i])
    w_vec = np.array([0.002 * i, -0.004 * i, 0.001 * i])
    R_wc = np.asarray(lie.so3_exp(jnp.asarray(w_vec)))
    R_cw = R_wc.T
    return (jnp.asarray(R_cw, jnp.float32),
            jnp.asarray(-R_cw @ center, jnp.float32))


def config(rt):
    if rt:
        return window.Config(**dict(CFG, realtime=True, async_fetch=False))
    return window.Config(**CFG)


def run_vo(n, rt):
    calib = Calib.create(380.0, 380.0, W / 2 - 0.5, H / 2 - 0.5)
    scene = synthetic.default_scene(depth=2.0)
    cfg = config(rt)
    fs = full_system.FullSystem(calib, H, W, cfg)
    gt = []
    t0 = time.perf_counter()
    for i in range(n):
        R, t = pose(i)
        fs.add_frame(synthetic.render(scene, R, t, calib, H, W),
                     timestamp=i * 0.05)
        R_wc, t_wc = lie.se3_inv(R, t)
        gt.append((i * 0.05, np.asarray(R_wc), np.asarray(t_wc)))
    fs.finish()
    wall = time.perf_counter() - t0
    est = fs.trajectory()
    centers = np.stack([g[2] for g in gt])
    print(json.dumps({
        "frames": n, "realtime": rt, "ate_sim3": trajectory.ate_rmse(est, gt),
        "path_length": float(np.linalg.norm(np.diff(centers, axis=0),
                                            axis=1).sum()),
        "keyframes": fs.stats_kf, "resets": fs.stats_resets,
        "lost_frames": fs.stats_lost_frames,
        "initialized": bool(fs.initialized), "is_lost": bool(fs.is_lost),
        "wall_s_cpu": wall}))


def vio_ate(fs, seq, n):
    """(se3, sim3, path) of metric_trajectory() over frames 0..n-1, from
    first_kf + 5 on; None before the IMU is active."""
    est = fs.metric_trajectory()
    if est is None:
        return None
    gt = [(float(seq["timestamps"][i]), np.asarray(seq["R_body"][i]),
           seq["p_gt"][i]) for i in range(n)]
    first_kf = min(fs.kf_poses.keys())
    keep = [k for k, sh in enumerate(fs.shells)
            if sh.frame_id >= first_kf + 5]
    est_t = [est[k] for k in keep]
    gt_t = [gt[k] for k in keep]
    if len(est_t) < 3:
        return None
    dist = float(np.sum(np.linalg.norm(np.diff(
        np.stack([g[2] for g in gt_t]), axis=0), axis=1)))
    return (trajectory.ate_rmse(est_t, gt_t, with_scale=False),
            trajectory.ate_rmse(est_t, gt_t, with_scale=True), dist)


def run_vio(n, n_from, noise_seed, rt):
    seq = synthetic.generate_vio_sequence(
        n_frames=n, scene=synthetic.default_scene(depth=2.0), **VIO_SEQ)
    rng = None if noise_seed is None else np.random.default_rng(noise_seed)
    fs = full_system.FullSystem(seq["calib"], H, W, config(rt),
                                imu_calib=imu_system.IMUCalib())
    spf = seq["steps_per_frame"]
    active_at = pgba_at = None
    ates = {}
    t0 = time.perf_counter()
    for i in range(n):
        chunk = None
        if i > 0:
            s0, s1 = (i - 1) * spf, i * spf
            chunk = (seq["acc"][s0:s1], seq["gyr"][s0:s1],
                     np.full(s1 - s0, seq["imu_dt"], np.float32))
        img = seq["images"][i]
        if rng is not None:
            img = img + jnp.asarray(rng.normal(0, 1e-2, img.shape),
                                    jnp.float32)
        fs.add_frame(img, float(seq["timestamps"][i]), imu_data=chunk)
        if active_at is None and fs.imu.phase == imu_system.ACTIVE:
            active_at = i
        if pgba_at is None and getattr(fs.imu, "pgba_count", 0) >= 1:
            pgba_at = i
        if i + 1 >= (n if rt else n_from):
            a = vio_ate(fs, seq, i + 1)
            if a is not None:
                ates[i + 1] = {"se3": a[0], "sim3": a[1], "dist": a[2]}
    print(json.dumps({
        "frames": n, "realtime": rt, "noise_seed": noise_seed,
        "active_at": active_at,
        "pgba_at": pgba_at, "pgba_count": getattr(fs.imu, "pgba_count", 0),
        "keyframes": fs.stats_kf, "resets": fs.stats_resets,
        "lost_frames": fs.stats_lost_frames,
        "wall_s_cpu": time.perf_counter() - t0, "ate_by_frames": ates}),
        flush=True)


# chip_smoke.py's cli-vio-512 phase: make_synthetic's arguments (its seed
# is used by no other phase) and the CLI's.
CLI_SYNTH = ["w=512", "h=512", "photometric=1", "seed=4"]
CLI_ARGS = ["useimu=1", "preset=0", "nativeLoader=1", "quiet=1"]
# tests/test_torch_cli_vio_rt.py's run (the reference's second-seed test).
RT7_SYNTH = ["seed=7"]
RT7_ARGS = ["useimu=1", "preset=1", "quiet=1", "async_fetch=0"]


def run_cli(n, n_from, noise_seed, rt7=False):
    from dmvio_tpu import run_dataset
    from dmvio_tpu.io import dataset as ds
    from dmvio_tpu.tools import make_synthetic

    data = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "build", "cli_ref_rt7" if rt7 else "cli_ref_data")
    if not os.path.exists(os.path.join(data, "meta.npz")):
        if rt7:
            from dmvio_tpu_torch.tools import make_synthetic as port_synth

            port_synth.main([f"out={data}", *RT7_SYNTH, "device=cpu"])
        else:
            make_synthetic.main([f"out={data}", f"n={n}", *CLI_SYNTH])
    gt = trajectory.read_tum(os.path.join(data, "gt.csv"))
    rng = None if noise_seed is None else np.random.default_rng(noise_seed)
    get_image = ds.DatasetReader.get_image
    add_frame = full_system.FullSystem.add_frame
    rec = {"active_at": None, "pgba_at": None, "ates": {}}

    def noisy_get_image(self, i):
        img = get_image(self, i)
        if rng is not None:
            img = img + jnp.asarray(rng.normal(0, 1e-2, img.shape),
                                    jnp.float32)
        return img

    def scored_add_frame(self, *a, **k):
        add_frame(self, *a, **k)
        if rt7:
            return      # scoring a realtime run mid-way flushes it
        i = len(self.shells) - 1
        if rec["active_at"] is None and self.imu.phase == imu_system.ACTIVE:
            rec["active_at"] = i
        if rec["pgba_at"] is None \
                and getattr(self.imu, "pgba_count", 0) >= 1:
            rec["pgba_at"] = i
        if i + 1 >= n_from and self.imu.phase == imu_system.ACTIVE:
            m = i + 1
            dist = float(np.sum(np.linalg.norm(np.diff(
                np.stack([g[2] for g in gt[:m]]), axis=0), axis=1)))
            rec["ates"][m] = {
                "sim3": trajectory.ate_rmse(self.trajectory(), gt[:m]),
                "se3": trajectory.ate_rmse(self.metric_trajectory(), gt[:m],
                                           with_scale=False),
                "dist": dist}

    ds.DatasetReader.get_image = noisy_get_image
    full_system.FullSystem.add_frame = scored_add_frame
    t0 = time.perf_counter()
    try:
        out = os.path.join(data, f"out_noise{noise_seed}_")
        args = [f"files={data}/images", f"calib={data}/camera.txt",
                f"tsFile={data}/times.txt", f"imuFile={data}/imu.txt",
                f"resultsPrefix={out}"]
        if rt7:
            args += RT7_ARGS
        else:
            args += [f"gammaCalib={data}/pcalib.txt",
                     f"vignette={data}/vignette.png", f"maxFrames={n}",
                     *CLI_ARGS]
        summary = run_dataset.run(args)
    finally:
        ds.DatasetReader.get_image = get_image
        full_system.FullSystem.add_frame = add_frame
    est = trajectory.read_tum(out + "result.txt")
    est_s = trajectory.read_tum(out + "resultScaled.txt")
    print(json.dumps({
        "cli": "rt7" if rt7 else "smoke", "frames": summary["frames"],
        "noise_seed": noise_seed,
        "sim3_result": trajectory.ate_rmse(est, gt[:len(est)]),
        "se3_result_scaled": trajectory.ate_rmse(est_s, gt[:len(est_s)],
                                                 with_scale=False),
        "path_length": float(np.sum(np.linalg.norm(np.diff(np.stack(
            [g[2] for g in gt[:len(est)]]), axis=0), axis=1))),
        "active_at": rec["active_at"], "pgba_at": rec["pgba_at"],
        "keyframes": summary["keyframes"],
        "wall_s_cpu": time.perf_counter() - t0, "ate_by_frames": rec["ates"]}),
        flush=True)


def main():
    args = sys.argv[1:]
    if args and args[0] in ("--cli", "--cli-rt7"):
        rt7 = args[0] == "--cli-rt7"
        args = args[1:]
        n_from = 0
        if "--from" in args:
            k = args.index("--from")
            n_from = int(args[k + 1])
            del args[k:k + 2]
        seeds = NOISE_SEEDS
        if "--noise" in args:
            k = args.index("--noise")
            seeds = [None if int(args[k + 1]) == 0 else int(args[k + 1])]
            del args[k:k + 2]
        for seed in seeds:
            run_cli(int(args[0]) if args else 90, n_from, seed, rt7)
        return
    rt = "--rt" in args
    if rt:
        args.remove("--rt")
    if args and args[0] == "--vio":
        args = args[1:]
        n_from = 0
        if "--from" in args:
            k = args.index("--from")
            n_from = int(args[k + 1])
            del args[k:k + 2]
        n = int(args[0]) if args else 80
        for seed in NOISE_SEEDS:
            run_vio(n, n_from, seed, rt)
    else:
        run_vo(int(args[0]) if args else 40, rt)


if __name__ == "__main__":
    main()
