"""Dataset-mode CLI: run odometry over a DSO-format dataset folder.

Counterpart of dmvio_tpu/run_dataset.py, the equivalent of DM-VIO's
dmvio_dataset main (src/main_dmvio_dataset.cpp): parse `key=value`
arguments (same names and defaults: files=, calib=, gammaCalib=,
vignette=, imuFile=, tsFile=, gtFile=, resultsPrefix=, settingsFile=,
preset=, nogui=, quiet=, every window.Config knob, and the reference's
IMU yaml names, so configs/*.yaml apply unchanged), run the pipeline frame
by frame, and write result.txt / resultKFs.txt (TUM format, printResult
parity, FullSystem.cpp:256-298), resultScaled.txt once the IMU is active,
timings.txt and usedSettings.txt, plus the inertial streams with useimu=1
and viz/ with nogui=0.

`device=` (default cuda) picks the card; without CUDA the run raises
unless device=cpu is passed. The JAX package's persistent compilation
cache has no counterpart (the port's kernels are built once into
build/kernels/). Under DMVIO_COORDINATOR / DMVIO_NUM_PROCESSES /
DMVIO_PROCESS_ID (or DMVIO_DIST=auto) each process joins a
torch.distributed group before it touches a device (NCCL on CUDA, gloo
with device=cpu), and the window BA's point axis is sharded over every
rank; mesh_devices=N shards it over N devices within one process.

Usage:
    python -m dmvio_tpu_torch.run_dataset files=DIR calib=camera.txt \
        [imuFile=imu.txt tsFile=times.txt useimu=1 resultsPrefix=out/ \
         device=cpu]
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

_REPO = Path(__file__).resolve().parent.parent
# The prewarm sequence's cache: the port's own, never the JAX package's.
PREWARM_CACHE = _REPO / "build" / "prewarm"


def _prewarm_sequence(h, w, n, seed, device):
    """The prewarm's throwaway synthetic sequence, disk-cached under
    build/prewarm/ (DMVIO_TORCH_PREWARM_CACHE=<dir> moves it, =off
    disables it), keyed by shape and seed; a cache hit uploads host arrays
    instead of rendering."""
    from dmvio_tpu_torch.utils import synthetic
    from dmvio_tpu_torch.utils.camera import Calib

    cache_root = os.environ.get("DMVIO_TORCH_PREWARM_CACHE",
                                str(PREWARM_CACHE))
    path = None
    if cache_root.strip().lower() not in ("", "0", "off", "none"):
        path = os.path.join(cache_root, f"seq_{h}x{w}_n{n}_s{seed}.npz")
        if os.path.exists(path):
            z = np.load(path, allow_pickle=False)
            seq = {k: z[k] for k in z.files if k != "calib_vec"}
            seq["images"] = torch.as_tensor(seq["images"]).to(device)
            seq["calib"] = Calib.from_vec(
                torch.as_tensor(z["calib_vec"]).to(device))
            seq["steps_per_frame"] = int(seq["steps_per_frame"])
            seq["imu_dt"] = float(seq["imu_dt"])
            return seq
    seq = synthetic.generate_vio_sequence(
        n_frames=n, frame_dt=0.05, h=h, w=w, s_dso=1.3, g2=(0.05, -0.03),
        accel_scale=0.5, rot_scale=0.3, seed=seed,
        scene=synthetic.default_scene(depth=2.0, device=device))
    if path is not None:
        os.makedirs(cache_root, exist_ok=True)
        save = {}
        for k, v in seq.items():
            if k == "calib":
                save["calib_vec"] = v.as_vec().cpu().numpy()
            elif k == "scene":
                continue
            elif k in ("images", "R_dso", "t_dso"):
                save[k] = torch.stack(v).cpu().numpy()
            else:
                save[k] = np.asarray(v)
        np.savez(path + ".tmp.npz", **save)
        os.replace(path + ".tmp.npz", path)
    return seq


def _prewarm(cfg, h, w, imu_calib, quiet=False, n=60, seed=2, device=None):
    """One throwaway pass at the SAME shapes and config before the real
    stream, up to an active IMU and a PGBA cycle (visual-only: a full
    window plus a few marginalizations). In the port it loads the kernel
    libraries and fills the CUDA caching allocator and library handles, so
    the real system starts warm at frame 0."""
    import copy

    from dmvio_tpu_torch.models import full_system, imu_system

    dev = torch.device(device) if device is not None else None
    t0 = time.perf_counter()
    seq = _prewarm_sequence(h, w, n, seed, dev)
    t_gen = time.perf_counter() - t0
    fs = full_system.FullSystem(seq["calib"], h, w, copy.deepcopy(cfg),
                                device=dev,
                                imu_calib=copy.deepcopy(imu_calib))
    spf = seq["steps_per_frame"]
    # DMVIO_PREWARM_LOG=1: per-frame wall times of the prewarm pass on
    # stderr.
    plog = bool(os.environ.get("DMVIO_PREWARM_LOG"))
    fts = []
    for i in range(n):
        chunk = None
        if i > 0 and imu_calib is not None:
            s0, s1 = (i - 1) * spf, i * spf
            chunk = (seq["acc"][s0:s1], seq["gyr"][s0:s1],
                     np.full(s1 - s0, seq["imu_dt"], np.float32))
        ft = time.perf_counter()
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=chunk)
        fts.append(time.perf_counter() - ft)
        warm_kfs = fs.initialized and fs.stats_kf >= cfg.max_frames + 3
        if fs.imu is None:
            if warm_kfs:
                break
        elif warm_kfs and fs.imu.phase == imu_system.ACTIVE \
                and fs.imu.pgba_count >= 1:
            break
    ft = time.perf_counter()
    fs.finish()
    t_fin = time.perf_counter() - ft
    if plog:
        top = sorted(enumerate(fts), key=lambda kv: -kv[1])[:10]
        print(f"# prewarm split: gen={t_gen:.1f}s frames={sum(fts):.1f}s "
              f"({len(fts)}) finish={t_fin:.1f}s; top frames: "
              + " ".join(f"f{i}={t:.1f}s" for i, t in top),
              file=sys.stderr)
    if not quiet:
        print(f"prewarm: done in {time.perf_counter() - t0:.1f}s "
              f"({fs.stats_kf} keyframes)", file=sys.stderr)


def run(argv=None) -> dict:
    argv = argv if argv is not None else sys.argv[1:]
    import dmvio_tpu_torch
    from dmvio_tpu_torch.io import dataset as ds
    from dmvio_tpu_torch.io import native
    from dmvio_tpu_torch.models import full_system, window
    from dmvio_tpu_torch.parallel import dist_init
    from dmvio_tpu_torch.utils import trajectory
    from dmvio_tpu_torch.utils.settings import SettingsUtil
    from dmvio_tpu_torch.utils.timing import TimeMeasurement, save_results

    su = SettingsUtil()
    for name, default in [
        ("files", ""), ("calib", ""), ("gammaCalib", ""), ("vignette", ""),
        ("imuFile", ""), ("tsFile", ""), ("gtFile", ""),
        ("resultsPrefix", "./"), ("settingsFile", ""), ("camchain", ""),
        ("preset", 0), ("nogui", 1), ("quiet", 0), ("useimu", 0),
        ("maxFrames", -1), ("start", 0), ("nativeLoader", 1),
        ("prewarm", 0),      # one throwaway pass before frame 0
        ("viewerPort", 8765),   # nogui=0 live HTTP viewer (0 = ephemeral)
        ("device", "cuda"),     # the port's device; cpu must be asked for
        # IMU noise model + init knobs under the REFERENCE's yaml names so
        # the stock per-dataset configs (configs/tumvi.yaml etc.) apply
        # unchanged (IMUSettings.h:126-135, IMUInitSettings.h:64-65).
        ("accelerometer_noise_density", 2.0e-3),
        ("gyroscope_noise_density", 1.6968e-4),
        ("accelerometer_random_walk", 3.0e-3),
        ("gyroscope_random_walk", 8.0e-5),
        ("integration_sigma", 1e-8),
        ("init_transitionModel", 2),
        ("init_coarseScaleUncertaintyThresh", 1.0),
        ("init_pgba_scaleUncertaintyThresh", 1.0),
        ("init_pgba_reinitScaleUncertaintyThresh", 0.5),
        ("init_pgbaDelay", 100),
        ("init_pgbaEvery", 6),
    ]:
        su.register(name, default)
    cfg = window.Config()
    su.register_from(cfg, prefix="")

    leftover = [a for a in argv if not su.parse_arg(a)]
    if su["settingsFile"]:
        su.try_read_yaml(su["settingsFile"])
        for a in argv:       # command line beats yaml (reference precedence)
            su.parse_arg(a)
    if leftover:
        print(f"ignored arguments: {leftover}", file=sys.stderr)
    dev = dmvio_tpu_torch.device(su["device"])
    # Multi-process seam: with the DMVIO_* variables set every process
    # joins the group before it first touches a device; the FullSystem
    # below then shards its window BA over every rank.
    dist_init.maybe_initialize(device=dev)
    # Presets (settingsDefault, MainSettings.cpp:206-258): 0/1 = default
    # quality tier (2000 points, 7-KF window, 6 LM iterations; 1 enforces
    # realtime), 2/3 = fast tier (800 points, 6-KF window, 4 iterations;
    # 3 enforces realtime). Realtime enforcement maps to the pipelined
    # tracking/mapping mode (Config.realtime).
    preset = int(su["preset"])
    if preset in (0, 1):
        cfg.i_max = 1536
        cfg.p_max = 2048
        cfg.max_frames = 7
        cfg.ba_iters = 6
        cfg.realtime = preset == 1
    elif preset in (2, 3):
        cfg.i_max = 1024
        cfg.p_max = 1024
        cfg.max_frames = 6
        cfg.f_max = 7
        cfg.ba_iters = 4
        cfg.realtime = preset == 3
    su.apply_to(cfg, only_overridden=True)  # explicit settings beat preset

    reader = ds.open_dataset(
        su["files"], su["calib"],
        gamma=su["gammaCalib"] or None,
        vignette=su["vignette"] or None,
        imu_file=su["imuFile"] or None,
        ts_file=su["tsFile"] or None,
        gt_file=su["gtFile"] or None,
        device=dev,
    )
    h, w = reader.undist.out_size[1], reader.undist.out_size[0]
    imu_calib = None
    if su["useimu"] and reader.imu is not None:
        from dmvio_tpu_torch.models.imu_system import IMUCalib

        imu_calib = IMUCalib(
            sigma_acc=su["accelerometer_noise_density"],
            sigma_gyro=su["gyroscope_noise_density"],
            sigma_acc_walk=su["accelerometer_random_walk"],
            sigma_gyro_walk=su["gyroscope_random_walk"],
            sigma_integration=su["integration_sigma"],
            transition_model=su["init_transitionModel"],
            coarse_scale_th=su["init_coarseScaleUncertaintyThresh"],
            pgba_scale_th=su["init_pgba_scaleUncertaintyThresh"],
            pgba_delay=su["init_pgbaDelay"],
            pgba_max_kfs=max(su["init_pgbaDelay"], 8),
            pgba_every=su["init_pgbaEvery"],
        )
        if su["camchain"]:
            import yaml

            with open(su["camchain"]) as f:
                cc = yaml.safe_load(f)
            # kalibr camchain convention: cam0/T_cam_imu = body->cam.
            T = np.asarray(cc["cam0"]["T_cam_imu"], np.float32)
            imu_calib.R_cb = T[:3, :3]
            imu_calib.t_cb = T[:3, 3]
    fs = full_system.FullSystem(reader.undist.K_out, h, w, cfg, device=dev,
                                imu_calib=imu_calib)
    viewer = None
    live = None
    if not su["nogui"]:
        # The reference opens a Pangolin window here; headless, both
        # live-content consumers attach: the HTTP live viewer (a browser
        # shows trajectory/keyframes/depth while running) and the artifact
        # renderer (resultsPrefix + viz/).
        from dmvio_tpu_torch.io.live_viewer import LiveViewer
        from dmvio_tpu_torch.io.viewer import HeadlessViewer

        try:
            live = LiveViewer(port=int(su["viewerPort"]))
            print(f"live viewer: http://127.0.0.1:{live.port}/",
                  file=sys.stderr)
            fs.output_wrappers.append(live)
        except OSError as e:
            print(f"live viewer disabled ({e})", file=sys.stderr)
        viewer = HeadlessViewer(su["resultsPrefix"] + "viz")
        fs.output_wrappers.append(viewer)
    streams = None
    if imu_calib is not None:
        # Per-keyframe scale/bias/gravity/velocity streams, reference file
        # names (scalesdso.txt etc., BAIMULogic.cpp:88-91).
        from dmvio_tpu_torch.io.output_wrapper import StateStreamWriter

        streams = StateStreamWriter(su["resultsPrefix"])
        fs.output_wrappers.append(streams)

    n = len(reader)
    if su["maxFrames"] > 0:
        n = min(n, su["start"] + su["maxFrames"])
    native_on = False
    if su["nativeLoader"] and su["start"] == 0:
        native_on = reader.start_native()
        if native_on:
            if not su["quiet"]:
                print("native prefetch pipeline active")
        else:
            why = native.load_error() or (
                "it reads sequential folders of PNG files only")
            print(f"native prefetch pipeline not started ({why}); "
                  "reading with the Python loader", file=sys.stderr)

    if su["prewarm"]:
        _prewarm(cfg, h, w, imu_calib, quiet=bool(su["quiet"]), device=dev)

    # DMVIO_FRAMELOG=path: per-frame host-side state (no extra device
    # reads), the diagnostic stream for reset/starvation forensics; line
    # buffered so its newest lines survive a kill.
    framelog = None
    if os.environ.get("DMVIO_FRAMELOG"):
        framelog = open(os.environ["DMVIO_FRAMELOG"], "w", buffering=1)
        framelog.write("# fid ts kf n_active resets lost phase\n")

    t_start = time.perf_counter()
    try:
        for i in range(su["start"], n):
            with TimeMeasurement("frame_total"):
                with TimeMeasurement("load_image"):
                    img = reader.get_image(i)
                imu_chunk = None
                if imu_calib is not None:
                    acc, gyr, dts = reader.get_imu_chunk(i)
                    if len(dts):
                        imu_chunk = (acc, gyr, dts)
                fs.add_frame(img, reader.frames[i].timestamp,
                             imu_data=imu_chunk,
                             exposure=reader.frames[i].exposure)
            if framelog is not None:
                phase = fs.imu.phase if fs.imu is not None else -1
                framelog.write(
                    f"{i} {reader.frames[i].timestamp:.4f} {fs.stats_kf} "
                    f"{fs._n_active:.0f} {fs.stats_resets} "
                    f"{int(fs.is_lost)} {phase}\n")
            if not su["quiet"] and i % 50 == 0:
                print(f"frame {i}/{n} kf={fs.stats_kf} "
                      f"init={fs.initialized} lost={fs.is_lost}")
        fs.finish()   # flush the realtime pipeline (no-op otherwise)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        if framelog is not None:
            framelog.close()
    wall = time.perf_counter() - t_start

    prefix = su["resultsPrefix"]
    est = fs.trajectory()
    trajectory.write_tum(prefix + "result.txt", est)
    kf_est = [e for e, sh in zip(est, fs.shells) if sh.is_kf]
    trajectory.write_tum(prefix + "resultKFs.txt", kf_est)
    metric = fs.metric_trajectory()
    if metric is not None:
        # Metric (gravity-aligned, true-scale) poses: the reference's
        # resultScaled.txt (main_dmvio_dataset.cpp:298-300).
        trajectory.write_tum(prefix + "resultScaled.txt", metric)
    save_results(prefix + "timings.txt")
    with open(prefix + "usedSettings.txt", "w") as f:
        su.print_all(f.write)
    if streams is not None:
        streams.join()
    if live is not None:
        live.close()
    if viewer is not None:
        viewer.join()
        if not su["quiet"]:
            print(f"visualization written to {prefix}viz/index.html")

    n_proc = n - su["start"]
    fps = n_proc / wall if wall > 0 else 0.0
    summary = {
        "frames": n_proc, "keyframes": fs.stats_kf, "fps": fps,
        "wall_s": wall, "initialized": fs.initialized, "lost": fs.is_lost,
        "lost_frames": fs.stats_lost_frames, "resets": fs.stats_resets,
        "imu_phase": fs.imu.phase if fs.imu is not None else None,
        "pgba_count": fs.imu.pgba_count if fs.imu is not None else 0,
        "scale": float(np.exp(fs.imu.s_log)) if fs.imu is not None else None,
        "native_loader": native_on, "device": str(dev),
        "result": prefix + "result.txt",
    }
    if not su["quiet"]:
        print(f"processed {n_proc} frames in {wall:.2f}s = {fps:.2f} fps; "
              f"{fs.stats_kf} keyframes")
    return summary


if __name__ == "__main__":
    run()
